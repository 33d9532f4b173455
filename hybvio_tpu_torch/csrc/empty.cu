// An empty kernel: one launch of it on the card is the floor under every
// kernel time in chip_smoke.py (the card's own per-launch cost, without the
// Python wrapper's). It replaces no TPU kernel and no path launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int hv_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
