// Empty kernels. One launch of `empty_kernel` on the card is the floor under
// every kernel time in chip_smoke.py (the card's own per-launch cost, without
// the Python wrapper's); no path launches it.
//
// The stage markers: `Vio.step` launches `hv_mark_imu_done` after the IMU
// propagation and `hv_mark_frontend_done` after the front end, so that each
// run of the step, eager or a CUDA graph's replay, carries its stage
// boundaries onto the profiler's timeline by name. They touch no memory.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void hv_mark_imu_done() {}

__global__ void hv_mark_frontend_done() {}

}  // namespace

extern "C" int hv_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// stage 0: the IMU propagation is done; 1: the front end is done
extern "C" int hv_mark_stage(int stage, void* stream) {
  if (stage == 0) {
    hv_mark_imu_done<<<1, 1, 0, (cudaStream_t)stream>>>();
  } else {
    hv_mark_frontend_done<<<1, 1, 0, (cudaStream_t)stream>>>();
  }
  return (int)cudaGetLastError();
}
