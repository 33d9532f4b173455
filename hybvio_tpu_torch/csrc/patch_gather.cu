// Patch gather: copy one (ps, ps) window per feature out of a batch of images.
//
// Replaces the Pallas kernel hybvio_tpu/ops/patch_gather_pallas.py
// (_gather_batched / _kernel, behind gather_patches_pallas), which DMAs a
// tile-aligned block per feature into VMEM and extracts the window there.
//
// What bounds it on the H100: bytes. A window is at most 50 x 50 floats
// (10 KB) and a step gathers about 30 sets of 16 x 96 windows, a few tens of
// MB in all; there is no arithmetic. The design is the simple one: one
// thread block per (lane, feature), threads striding over the window
// row-major, so neighbouring threads read neighbouring pixels of one image
// row (coalesced) and write one contiguous output window. The image's batch
// stride is an argument and may be 0: with shared frames every lane reads
// the same pyramid level, which stays one copy in memory (the reference's
// vmap rule materializes B copies). Origins are clamped to [0, dim - ps] like
// lax.dynamic_slice, so the kernel equals its plain version for any input.
// Fusing the gather into the LK iterations (the window never touching
// device memory) is left for later work.
#include <cuda_runtime.h>

namespace {

__global__ void patch_gather_kernel(const float* __restrict__ img,
                                    long long batch_stride, int H, int W,
                                    const int* __restrict__ y0,
                                    const int* __restrict__ x0, int N, int ps,
                                    float* __restrict__ out) {
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const long long f = (long long)b * N + n;
  int y = y0[f];
  int x = x0[f];
  y = min(max(y, 0), H - ps);
  x = min(max(x, 0), W - ps);
  const float* src = img + (long long)b * batch_stride + (long long)y * W + x;
  float* dst = out + f * ps * ps;
  const int count = ps * ps;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i / ps;
    const int c = i - r * ps;
    dst[i] = __ldg(src + (long long)r * W + c);
  }
}

}  // namespace

extern "C" int hv_patch_gather(const float* img, long long batch_stride, int H,
                               int W, const int* y0, const int* x0, int B,
                               int N, int ps, float* out, void* stream) {
  if (B == 0 || N == 0) return 0;
  dim3 grid(N, B);
  int threads = ps * ps < 256 ? ((ps * ps + 31) / 32) * 32 : 256;
  patch_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      img, batch_stride, H, W, y0, x0, N, ps, out);
  return (int)cudaGetLastError();
}
