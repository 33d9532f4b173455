// Shi-Tomasi corner response: unnormalized Sobel gradients, the structure
// products Ixx / Iyy / Ixy, a block_size^2 box mean, then the minimum
// eigenvalue tr/2 - sqrt((tr/2)^2 - det).
//
// Replaces the Pallas kernel hybvio_tpu/ops/gftt_pallas.py
// corner_response_pallas (body _response_tile), which fuses the whole
// stencil per row band in VMEM.
//
// What bounds it on the H100: bytes and latency, not flops. One 752 x 480
// f32 frame (1.4 MB) is read and one response map written per step. The
// simple design is one thread per output pixel that recomputes the Sobel
// gradients of every pixel of its box from global memory (81 reads for
// block 3, all hitting L1/L2), so no intermediate map touches device
// memory. Every stage uses clamp-to-edge indices and sums left to right,
// exactly the composition of the reference's XLA path (frontend/gftt.py
// corner_response over pyramid.py _sep_conv2d: Sobel x then y pass, products,
// box x then y pass, each with its own edge replication). Built with
// -fmad=false, so the kernel matches the plain PyTorch version over the
// whole image. Sobel stays unnormalized (weights +-1, +-2), the units
// gfttMinResponse is calibrated to. A shared-memory tile would cut the
// redundant reads; that is later work.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void sobel(const float* __restrict__ img, int H,
                                      int W, int r, int c, float* gx,
                                      float* gy) {
  const int cl = clampi(c - 1, 0, W - 1);
  const int cr = clampi(c + 1, 0, W - 1);
  float xd[3], xs[3];
  for (int t = 0; t < 3; ++t) {
    const float* row = img + (long long)clampi(r + t - 1, 0, H - 1) * W;
    const float a = __ldg(row + cl), b = __ldg(row + c), e = __ldg(row + cr);
    float d = -a;
    d = d + 0.0f * b;
    xd[t] = d + e;
    float s = a;
    s = s + 2.0f * b;
    xs[t] = s + e;
  }
  float x = xd[0];
  x = x + 2.0f * xd[1];
  *gx = x + xd[2];
  float y = -xs[0];
  y = y + 0.0f * xs[1];
  *gy = y + xs[2];
}

__global__ void corner_response_kernel(const float* __restrict__ img, int H,
                                       int W, int block_size,
                                       float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= H || c >= W) return;
  const int R = block_size / 2;
  float sxx = 0.f, syy = 0.f, sxy = 0.f;
  for (int dy = -R; dy <= R; ++dy) {
    const int rr = clampi(r + dy, 0, H - 1);
    float rxx = 0.f, ryy = 0.f, rxy = 0.f;
    for (int dx = -R; dx <= R; ++dx) {
      float gx, gy;
      sobel(img, H, W, rr, clampi(c + dx, 0, W - 1), &gx, &gy);
      const float pxx = gx * gx, pyy = gy * gy, pxy = gx * gy;
      if (dx == -R) {
        rxx = pxx; ryy = pyy; rxy = pxy;
      } else {
        rxx = rxx + pxx; ryy = ryy + pyy; rxy = rxy + pxy;
      }
    }
    if (dy == -R) {
      sxx = rxx; syy = ryy; sxy = rxy;
    } else {
      sxx = sxx + rxx; syy = syy + ryy; sxy = sxy + rxy;
    }
  }
  const float n = (float)(block_size * block_size);
  sxx = sxx / n;
  syy = syy / n;
  sxy = sxy / n;
  const float tr2 = 0.5f * (sxx + syy);
  const float det = sxx * syy - sxy * sxy;
  const float disc = sqrtf(fmaxf(tr2 * tr2 - det, 0.0f));
  out[(long long)r * W + c] = tr2 - disc;
}

}  // namespace

extern "C" int hv_corner_response(const float* img, int H, int W,
                                  int block_size, float* out, void* stream) {
  dim3 block(32, 8);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  corner_response_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, H, W, block_size, out);
  return (int)cudaGetLastError();
}
