// Greedy min-distance selection: walk K response-sorted candidates in order
// and take candidate i if it is eligible and no already-taken j has
// d2[i, j] < min_d2.
//
// Replaces the Pallas kernel hybvio_tpu/ops/nms_pallas.py
// greedy_min_distance_pallas (body _greedy_kernel), which runs the loop over
// a (1, K) mask in VMEM.
//
// What bounds it on the H100: latency. The walk is inherently sequential
// (K = 192 steps per lane) and moves only K^2 floats per lane; as K tiny
// launches of a per-step loop it would be pure launch overhead. The design
// is one thread block per lane, the taken mask in shared memory, a loop over
// i with threads over j, and one block-wide OR (__syncthreads_or) per step:
// K barriers instead of K launches. Bit-exact with the sequential loop (only
// comparisons). d2 may have batch stride 0 (one candidate set for every
// lane).
#include <cuda_runtime.h>

namespace {

__global__ void greedy_nms_kernel(const float* __restrict__ d2,
                                  long long batch_stride,
                                  const unsigned char* __restrict__ ok, int K,
                                  float min_d2, unsigned char* __restrict__ taken) {
  extern __shared__ unsigned char sel[];
  const int b = blockIdx.x;
  const float* D = d2 + (long long)b * batch_stride;
  for (int j = threadIdx.x; j < K; j += blockDim.x) sel[j] = 0;
  __syncthreads();
  for (int i = 0; i < K; ++i) {
    int near = 0;
    for (int j = threadIdx.x; j < i; j += blockDim.x)
      near |= (sel[j] && D[(long long)i * K + j] < min_d2);
    near = __syncthreads_or(near);
    if (threadIdx.x == 0) sel[i] = (ok[(long long)b * K + i] && !near) ? 1 : 0;
    __syncthreads();
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) taken[(long long)b * K + j] = sel[j];
}

}  // namespace

extern "C" int hv_greedy_nms(const float* d2, long long batch_stride,
                             const unsigned char* ok, int B, int K,
                             float min_d2, unsigned char* taken, void* stream) {
  if (B == 0 || K == 0) return 0;
  int threads = K < 1024 ? ((K + 31) / 32) * 32 : 1024;
  greedy_nms_kernel<<<B, threads, K, (cudaStream_t)stream>>>(
      d2, batch_stride, ok, K, min_d2, taken);
  return (int)cudaGetLastError();
}
