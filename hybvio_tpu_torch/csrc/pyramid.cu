// Pyramid stencils: the 5-tap [1,4,6,4,1]/16 blur with 2x decimation, and
// Scharr gradients (d = [-1,0,1] x s = [3,10,3]/32).
//
// Replaces the Pallas kernels in hybvio_tpu/ops/pyramid_pallas.py:
// pyr_down_pallas (body _pyr_down_tile) and scharr_pallas (body
// _scharr_tile), which fuse each stencil per row band in VMEM.
//
// What bounds them on the H100: bytes and launch latency. A 752 x 480 f32
// level is 1.4 MB read once and written once (Scharr: twice); a few flops
// per byte. The design is one thread per output pixel, reading its
// neighbourhood straight from global memory (the L1/L2 caches serve the
// reuse). Each value is composed exactly like the reference's XLA path
// (frontend/pyramid.py _sep_conv2d): the x pass with clamp-to-edge columns,
// then the y pass over clamp-to-edge rows of the x-pass result, each sum
// accumulated left to right. Built with -fmad=false, so every product is
// rounded on its own like the plain PyTorch version, which the kernel then
// matches over the whole image (the Pallas kernels differ in border rows).
// Fusing pyr_down and Scharr per level is left for later work.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// 5-tap x pass of row r at column c (clamped).
__device__ __forceinline__ float pyr_row(const float* __restrict__ img, int W,
                                         int r, int c) {
  const float k[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
  const float* row = img + (long long)r * W;
  float acc = k[0] * __ldg(row + clampi(c - 2, 0, W - 1));
  for (int i = 1; i < 5; ++i) acc = acc + k[i] * __ldg(row + clampi(c + i - 2, 0, W - 1));
  return acc;
}

__global__ void pyr_down_kernel(const float* __restrict__ img, int H, int W,
                                float* __restrict__ out, int Ho, int Wo) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Ho || j >= Wo) return;
  const float k[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
  const int r = 2 * i;
  const int c = 2 * j;
  float acc = k[0] * pyr_row(img, W, clampi(r - 2, 0, H - 1), c);
  for (int t = 1; t < 5; ++t) acc = acc + k[t] * pyr_row(img, W, clampi(r + t - 2, 0, H - 1), c);
  out[(long long)i * Wo + j] = acc;
}

__global__ void scharr_kernel(const float* __restrict__ img, int H, int W,
                              float* __restrict__ ix, float* __restrict__ iy) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= H || c >= W) return;
  const float s0 = 0.09375f, s1 = 0.3125f, s2 = 0.09375f;
  const int cl = clampi(c - 1, 0, W - 1);
  const int cr = clampi(c + 1, 0, W - 1);
  float xd[3], xs[3];
  for (int t = 0; t < 3; ++t) {
    const float* row = img + (long long)clampi(r + t - 1, 0, H - 1) * W;
    const float a = __ldg(row + cl), b = __ldg(row + c), e = __ldg(row + cr);
    float d = -a;
    d = d + 0.0f * b;
    xd[t] = d + e;
    float s = s0 * a;
    s = s + s1 * b;
    xs[t] = s + s2 * e;
  }
  float gx = s0 * xd[0];
  gx = gx + s1 * xd[1];
  gx = gx + s2 * xd[2];
  float gy = -xs[0];
  gy = gy + 0.0f * xs[1];
  gy = gy + xs[2];
  ix[(long long)r * W + c] = gx;
  iy[(long long)r * W + c] = gy;
}

}  // namespace

extern "C" int hv_pyr_down(const float* img, int H, int W, float* out,
                           void* stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  dim3 block(32, 8);
  dim3 grid((Wo + block.x - 1) / block.x, (Ho + block.y - 1) / block.y);
  pyr_down_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, H, W, out, Ho, Wo);
  return (int)cudaGetLastError();
}

extern "C" int hv_scharr(const float* img, int H, int W, float* ix, float* iy,
                         void* stream) {
  dim3 block(32, 8);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  scharr_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, H, W, ix, iy);
  return (int)cudaGetLastError();
}
