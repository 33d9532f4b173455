// Shi-Tomasi corner response: unnormalized Sobel gradients, the structure
// products Ixx / Iyy / Ixy, a block_size^2 box mean, then the minimum
// eigenvalue tr/2 - sqrt((tr/2)^2 - det).
//
// Replaces the Pallas kernel hybvio_tpu/ops/gftt_pallas.py
// corner_response_pallas (body _response_tile), which fuses the whole
// stencil per row band in VMEM.
//
// What bounds it on the H100: one 752 x 480 f32 frame (1.4 MB) is read and
// one response map written per step (per lane with per-lane frames, one lane
// per gridDim.z: 46 MB at 16 lanes), so bytes set the floor; what held the
// first design back was its loads (each thread recomputed the Sobel
// gradients of every pixel of its box from global memory: 81 loads a pixel
// at block 3), and then the instructions and shared-memory accesses of
// the stages. Here a block of 32 x 8 threads owns a tile of TH = 32 rows by
// TW = 32 - 2R columns (R = block_size / 2), so that the gradient region
// (TH + 2R) x 32 matches a warp's width:
//   1. it stages the (TH + 2R + 2) x 34 input pixels the tile needs in
//      shared memory, with coalesced loads;
//   2. each thread walks down one column of the gradient region, runs the
//      Sobel x pass once per input row into registers and the y pass from
//      them, and keeps the products Ixx, Iyy, Ixy in shared memory (every
//      gradient computed once per tile);
//   3. each thread walks down one output column: the box x pass of the
//      kOut + 2R region rows it needs into registers, then for each output
//      the y pass, the mean, the eigenvalue and a coalesced store.
// Every stage has its own edge rule, that of the reference's XLA path
// (frontend/gftt.py corner_response over pyramid.py _sep_conv2d): a box
// position outside the image takes the gradient at the clamped index, and
// that gradient comes from the input at the clamped indices around that
// in-image position (so the tile is not an input padded once). Blocks whose
// tile and halo lie inside the image take a path without clamps. Sums are
// formed afresh in the reference's order (Sobel x then y pass, box x then y
// pass, left to right), the mean is an IEEE division and the root sqrtf;
// built with -fmad=false, the kernel matches the plain PyTorch version over
// the whole image. Sobel stays unnormalized (weights +-1, +-2), the units
// gfttMinResponse is calibrated to.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;   // thread rows of a block (blockDim = 32 x kRows)
constexpr int kOut = 4;    // output rows per thread
constexpr int kMaxR = 7;   // block sizes up to 15
constexpr int kTH = kRows * kOut;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Sobel x pass of three input values: (d, s) = (-a + 0 b + e, a + 2 b + e).
__device__ __forceinline__ void xpass(float a, float b, float e, float* d, float* s) {
  float x = -a;
  x = x + 0.0f * b;
  *d = x + e;
  float y = a;
  y = y + 2.0f * b;
  *s = y + e;
}

// Sobel y pass: gx = d0 + 2 d1 + d2, gy = -s0 + 0 s1 + s2.
__device__ __forceinline__ void ypass(float d0, float d1, float d2, float s0, float s1,
                                      float s2, float* gx, float* gy) {
  float x = d0;
  x = x + 2.0f * d1;
  *gx = x + d2;
  float y = -s0;
  y = y + 0.0f * s1;
  *gy = y + s2;
}

template <int R>
__global__ void __launch_bounds__(32 * kRows)
corner_response_kernel(const float* __restrict__ img, long long lane_stride, int H, int W,
                       float* __restrict__ out) {
  img += blockIdx.z * lane_stride;  // lane z's image and response
  out += (long long)blockIdx.z * H * W;
  constexpr int TW = 32 - 2 * R, GH = kTH + 2 * R;  // output tile; gradient region rows
  constexpr int IH = GH + 2, IW = 34;                // input tile
  constexpr int KG = (GH + kRows - 1) / kRows;       // gradient rows per thread
  constexpr int KI = (IH * IW + 32 * kRows - 1) / (32 * kRows);
  __shared__ float in[IH * IW];
  __shared__ float pxx[GH * 32], pyy[GH * 32], pxy[GH * 32];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * TW;
  const int ir0 = r0 - R - 1, ic0 = c0 - R - 1;  // input tile origin
  // no index of the tile or its halo is clamped: a block-uniform fast path
  const bool inside = ir0 >= 0 && ic0 >= 0 && ir0 + IH <= H && ic0 + IW <= W;

  // 1. input tile; index (a, b) holds pixel (clamp(ir0 + a), clamp(ic0 + b))
  float v[KI];
#pragma unroll
  for (int k = 0; k < KI; ++k) {
    const int idx = tid + k * 32 * kRows;
    if (idx < IH * IW) {
      const int a = idx / IW, b = idx - a * IW;
      v[k] = __ldg(img + (long long)clampi(ir0 + a, 0, H - 1) * W + clampi(ic0 + b, 0, W - 1));
    }
  }
#pragma unroll
  for (int k = 0; k < KI; ++k) {
    const int idx = tid + k * 32 * kRows;
    if (idx < IH * IW) in[idx] = v[k];
  }
  __syncthreads();

  // 2. region (i, j) = (ty * KG + g, tx): the gradient at (clamp(r0 - R + i),
  //    clamp(c0 - R + j)), from the input at the clamped indices around it
  const int i0 = ty * KG;
  if (inside) {
    float d[KG + 2], s[KG + 2];
#pragma unroll
    for (int t = 0; t < KG + 2; ++t) {
      if (i0 + t < IH) {
        const float* row = in + (i0 + t) * IW + tx;
        xpass(row[0], row[1], row[2], &d[t], &s[t]);
      }
    }
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (i0 + g < GH) {
        float gx, gy;
        ypass(d[g], d[g + 1], d[g + 2], s[g], s[g + 1], s[g + 2], &gx, &gy);
        const int q = (i0 + g) * 32 + tx;
        pxx[q] = gx * gx;
        pyy[q] = gy * gy;
        pxy[q] = gx * gy;
      }
    }
  } else {
    const int cc = clampi(c0 - R + tx, 0, W - 1);
    const int cl = clampi(cc - 1, 0, W - 1) - ic0, cm = cc - ic0, cr = clampi(cc + 1, 0, W - 1) - ic0;
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (i0 + g < GH) {
        const int rr = clampi(r0 - R + i0 + g, 0, H - 1);
        float d[3], s[3];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const float* row = in + (clampi(rr + t - 1, 0, H - 1) - ir0) * IW;
          xpass(row[cl], row[cm], row[cr], &d[t], &s[t]);
        }
        float gx, gy;
        ypass(d[0], d[1], d[2], s[0], s[1], s[2], &gx, &gy);
        const int q = (i0 + g) * 32 + tx;
        pxx[q] = gx * gx;
        pyy[q] = gy * gy;
        pxy[q] = gx * gy;
      }
    }
  }
  __syncthreads();

  // 3. output column tx < TW, rows ty * kOut + o: the box x pass over region
  //    columns tx .. tx + 2R of region rows ty * kOut .. + kOut + 2R - 1,
  //    then per output the y pass over 2R + 1 of them, the mean, the eigenvalue
  const int c = c0 + tx;
  if (tx >= TW || c >= W) return;
  float bxx[kOut + 2 * R], byy[kOut + 2 * R], bxy[kOut + 2 * R];
#pragma unroll
  for (int t = 0; t < kOut + 2 * R; ++t) {
    const int q = (ty * kOut + t) * 32 + tx;
    float sxx = pxx[q], syy = pyy[q], sxy = pxy[q];
#pragma unroll
    for (int dx = 1; dx <= 2 * R; ++dx) {
      sxx = sxx + pxx[q + dx];
      syy = syy + pyy[q + dx];
      sxy = sxy + pxy[q + dx];
    }
    bxx[t] = sxx;
    byy[t] = syy;
    bxy[t] = sxy;
  }
  const float n = (float)((2 * R + 1) * (2 * R + 1));
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int r = r0 + ty * kOut + o;
    if (r < H) {
      float sxx = bxx[o], syy = byy[o], sxy = bxy[o];
#pragma unroll
      for (int dy = 1; dy <= 2 * R; ++dy) {
        sxx = sxx + bxx[o + dy];
        syy = syy + byy[o + dy];
        sxy = sxy + bxy[o + dy];
      }
      sxx = sxx / n;
      syy = syy / n;
      sxy = sxy / n;
      const float tr2 = 0.5f * (sxx + syy);
      const float det = sxx * syy - sxy * sxy;
      const float disc = sqrtf(fmaxf(tr2 * tr2 - det, 0.0f));
      out[(long long)r * W + c] = tr2 - disc;
    }
  }
}

template <int R>
int launch(const float* img, int lanes, long long lane_stride, int H, int W, float* out,
           cudaStream_t s) {
  constexpr int TW = 32 - 2 * R;
  dim3 grid((W + TW - 1) / TW, (H + kTH - 1) / kTH, lanes);
  corner_response_kernel<R><<<grid, dim3(32, kRows), 0, s>>>(img, lane_stride, H, W, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The responses of `lanes` (H, W) images, lane b's at img + b * lane_stride
// (rows contiguous), into out (lanes x H x W), at an odd block_size from 1
// to 15. Returns cudaErrorInvalidValue for other arguments.
extern "C" int hv_corner_response(const float* img, int lanes, long long lane_stride, int H,
                                  int W, int block_size, float* out, void* stream) {
  if (block_size < 1 || block_size % 2 == 0 || block_size > 2 * kMaxR + 1 || H < 1 || W < 1 ||
      lanes < 1 || lanes > 65535 || lane_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block_size / 2) {
    case 0: return launch<0>(img, lanes, lane_stride, H, W, out, s);
    case 1: return launch<1>(img, lanes, lane_stride, H, W, out, s);
    case 2: return launch<2>(img, lanes, lane_stride, H, W, out, s);
    case 3: return launch<3>(img, lanes, lane_stride, H, W, out, s);
    case 4: return launch<4>(img, lanes, lane_stride, H, W, out, s);
    case 5: return launch<5>(img, lanes, lane_stride, H, W, out, s);
    case 6: return launch<6>(img, lanes, lane_stride, H, W, out, s);
    default: return launch<7>(img, lanes, lane_stride, H, W, out, s);
  }
}
