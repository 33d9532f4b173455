// Pyramid stencils: the 5-tap [1,4,6,4,1]/16 blur with 2x decimation, and
// Scharr gradients (d = [-1,0,1] x s = [3,10,3]/32).
//
// Replaces the Pallas kernels in hybvio_tpu/ops/pyramid_pallas.py:
// pyr_down_pallas (body _pyr_down_tile) and scharr_pallas (body
// _scharr_tile), which fuse each stencil per row band in VMEM.
//
// What bounds them on the H100: launch latency first, then bytes. A
// 752 x 480 f32 level is 1.4 MB read once and written once (Scharr:
// twice); a few flops per byte, and the smaller levels take less time than
// a launch. So one launch builds levels 1..L of the images of one or two
// cameras in each of B lanes (gridDim.z = B x cameras; a shared frame is
// B = 1) and, in its fused form, the Scharr gradients of levels 0..L of
// camera 0 of every lane. With per-lane frames (B = 16 stereo: 46 MB read,
// 75 MB written) bytes, not latency, set the floor. A block owns a th x tw
// tile of level L and computes,
// in shared memory, the region of every earlier level that the tile needs
// (level l-1 spans 2 n + 3 rows for n rows of level l); it writes its own
// share of every level and recomputes the small halo its neighbours also
// compute. Scharr of a level needs one more row and column around the
// share: the earlier levels' regions have it already, the last level's
// region grows by one on each side when the block computes gradients (and
// every earlier region by two). Level 0 is read through L1, for the blur
// and for its gradients (the rows the x pass has just read). The x pass
// runs only at the even columns that decimation keeps, the y pass only at
// the even rows. Each value is composed exactly like the reference's XLA
// path (frontend/pyramid.py _sep_conv2d): the x pass with clamp-to-edge
// columns, then the y pass over clamp-to-edge rows of the x-pass result,
// each sum accumulated left to right; a level's halo takes the previous
// level at the clamped index, never a stencil run past its edge. Built with
// -fmad=false, so every product is rounded on its own like the plain
// PyTorch version, which the kernels then match over the whole image (the
// Pallas kernels differ in border rows).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 3;  // per launch; deeper pyramids chain launches
constexpr int kThreads = 256;
constexpr int kMaxSmem = 48 * 1024;

// Rows x cols of level L that one block owns: the fastest of 4x16, 8x16,
// 8x32, 16x16 and 16x32 for one and two levels of a 480 x 752 stereo pair
// on the H100 (PERF.md); three levels take two levels' tile.
__host__ __device__ constexpr int tile_rows(int L) { return L == 1 ? 16 : 8; }
__host__ __device__ constexpr int tile_cols(int L) { return L == 1 ? 32 : 16; }

// Shared floats of a block of L levels whose last-level region has a halo
// of h: the largest x pass (level l-1 rows at level l columns), plus one
// level region (level 1's, the largest) where a level is kept.
constexpr int smem_floats(int L, int h) {
  int rn[kMaxLevels + 1] = {}, cn[kMaxLevels + 1] = {};
  rn[L] = tile_rows(L) + 2 * h;
  cn[L] = tile_cols(L) + 2 * h;
  for (int l = L - 1; l >= 0; --l) {
    rn[l] = 2 * rn[l + 1] + 3;
    cn[l] = 2 * cn[l + 1] + 3;
  }
  int xf = 0;
  for (int l = 1; l <= L; ++l) xf = rn[l - 1] * cn[l] > xf ? rn[l - 1] * cn[l] : xf;
  return xf + (L > 1 || h > 0 ? rn[1] * cn[1] : 0);
}
static_assert(sizeof(float) * smem_floats(1, 1) <= kMaxSmem &&
                  sizeof(float) * smem_floats(2, 1) <= kMaxSmem &&
                  sizeof(float) * smem_floats(3, 1) <= kMaxSmem,
              "a pyramid tile needs more shared memory than a block may take by default");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Region of every level that a tile of level L needs: rows [a, a + n) of
// level l in unclamped coordinates (index i reads row clamp(a + i)).
struct Regions {
  int H[kMaxLevels + 1], W[kMaxLevels + 1];
  int ra[kMaxLevels + 1], rn[kMaxLevels + 1], ca[kMaxLevels + 1], cn[kMaxLevels + 1];
};

// h: the halo of the last level's region (1 where the block computes its
// gradients).
__host__ __device__ inline void regions(int H, int W, int L, int h, int ty, int tx, int th,
                                        int tw, Regions* g) {
  g->H[0] = H;
  g->W[0] = W;
  for (int l = 1; l <= L; ++l) {
    g->H[l] = (g->H[l - 1] + 1) / 2;
    g->W[l] = (g->W[l - 1] + 1) / 2;
  }
  g->ra[L] = ty * th - h;
  g->rn[L] = th + 2 * h;
  g->ca[L] = tx * tw - h;
  g->cn[L] = tw + 2 * h;
  for (int l = L - 1; l >= 0; --l) {
    g->ra[l] = 2 * g->ra[l + 1] - 2;
    g->rn[l] = 2 * g->rn[l + 1] + 3;
    g->ca[l] = 2 * g->ca[l + 1] - 2;
    g->cn[l] = 2 * g->cn[l + 1] + 3;
  }
}

// Shared floats of the x-pass buffer; one level region follows it.
__device__ inline int x_floats(const Regions& g, int L) {
  int xf = 0;
  for (int l = 1; l <= L; ++l) {
    const int f = g.rn[l - 1] * g.cn[l];
    xf = f > xf ? f : xf;
  }
  return xf;
}

// The share of level l that a block writes: the rows and columns that its
// tile of level L covers, scaled up by 2^sh (sh = L - l).
struct Share {
  int r0, r1, c0, c1;
};

__device__ inline Share share(int ty, int tx, int th, int tw, int sh, int Hl, int Wl) {
  return {(ty * th) << sh, min(((ty + 1) * th) << sh, Hl), (tx * tw) << sh,
          min(((tx + 1) * tw) << sh, Wl)};
}

// Row and column (i, j) of the items idx = start, start + step, ... of a
// row-major region w wide, without a division per item.
struct Walk {
  int i, j, di, dj, w;
  __device__ Walk(int start, int step, int w_) : w(w_) {
    i = start / w;
    j = start - i * w;
    di = step / w;
    dj = step - di * w;
  }
  __device__ void next() {
    i += di;
    j += dj;
    if (j >= w) {
      j -= w;
      ++i;
    }
  }
};

constexpr int kUnroll = 4;  // level-0 items whose loads a thread issues together
// Rows of a gradient strip whose loads a thread issues together: a strip of
// level 0 is 8 rows long at the kernels' tiles; those of the shared
// regions are 1 or 2 (PERF.md).
constexpr int kImageStrip = 8, kRegionStrip = 2;

// Tap s of the blur [1,4,6,4,1]/16; s is a constant in every unrolled loop.
__device__ __forceinline__ float blur(int s) {
  return s == 2 ? 0.375f : (s == 1 || s == 3) ? 0.25f : 0.0625f;
}

// x pass of level 1: the blur along the rows of the level-0 region, read
// through L1, at the columns level 1 keeps; the loads of kUnroll items go
// out together.
__device__ __forceinline__ void x_pass_image(const float* __restrict__ img, const Regions& g,
                                             float* X) {
  const int H = g.H[0], W = g.W[0], W1 = g.W[1];
  const int ra_p = g.ra[0], ca = g.ca[1], cn = g.cn[1];
  const int nx = g.rn[0] * cn;
  Walk p(threadIdx.x, blockDim.x, cn);
  for (int base = threadIdx.x; base < nx; base += kUnroll * blockDim.x) {
    float v[kUnroll][5];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * (int)blockDim.x < nx) {
        const float* row = img + (long long)clampi(ra_p + p.i, 0, H - 1) * W;
        const int c2 = 2 * clampi(ca + p.j, 0, W1 - 1);
#pragma unroll
        for (int s = 0; s < 5; ++s) v[u][s] = __ldg(row + clampi(c2 + s - 2, 0, W - 1));
      }
      p.next();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < nx) {
        float acc = blur(0) * v[u][0];
#pragma unroll
        for (int s = 1; s < 5; ++s) acc = acc + blur(s) * v[u][s];
        X[idx] = acc;
      }
    }
  }
}

// x pass of level l >= 2 from the shared region V of level l - 1.
__device__ __forceinline__ void x_pass_region(const float* V, const Regions& g, int l, float* X) {
  const int Wp = g.W[l - 1], Wl = g.W[l];
  const int cn_p = g.cn[l - 1], ca_p = g.ca[l - 1], ca = g.ca[l], cn = g.cn[l];
  const int nx = g.rn[l - 1] * cn;
  Walk p(threadIdx.x, blockDim.x, cn);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nx; idx += blockDim.x, p.next()) {
    const float* row = V + p.i * cn_p;
    const int c2 = 2 * clampi(ca + p.j, 0, Wl - 1);
    float acc = blur(0) * row[clampi(c2 - 2, 0, Wp - 1) - ca_p];
#pragma unroll
    for (int s = 1; s < 5; ++s) acc = acc + blur(s) * row[clampi(c2 + s - 2, 0, Wp - 1) - ca_p];
    X[idx] = acc;
  }
}

// y pass of level l at the rows it keeps: the region into V (when V is
// given) and the block's share s into dst (level l of the output).
__device__ __forceinline__ void y_pass(const float* X, const Regions& g, int l, Share s,
                                       float* V, float* __restrict__ dst) {
  const int Hp = g.H[l - 1], Hl = g.H[l], Wl = g.W[l];
  const int ra_p = g.ra[l - 1], ra = g.ra[l], ca = g.ca[l], rn = g.rn[l], cn = g.cn[l];
  Walk q(threadIdx.x, blockDim.x, cn);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rn * cn; idx += blockDim.x, q.next()) {
    const int r2 = 2 * clampi(ra + q.i, 0, Hl - 1);
    float acc = blur(0) * X[(clampi(r2 - 2, 0, Hp - 1) - ra_p) * cn + q.j];
#pragma unroll
    for (int t = 1; t < 5; ++t)
      acc = acc + blur(t) * X[(clampi(r2 + t - 2, 0, Hp - 1) - ra_p) * cn + q.j];
    if (V) V[idx] = acc;
    const int r = ra + q.i, c = ca + q.j;
    if (r >= s.r0 && r < s.r1 && c >= s.c0 && c < s.c1) dst[(long long)r * Wl + c] = acc;
  }
}

// x pass of Scharr on row `row` of a level whose value at (row, col) is
// at(row, col), at the clamped columns (cl, c, cr) of column c: the
// derivative d and the smoothing m, in the reference's order of sums (the 0
// tap included).
template <class At>
__device__ __forceinline__ void scharr_x(At at, int row, int cl, int c, int cr, float& d,
                                         float& m) {
  const float a = at(row, cl), b = at(row, c), e = at(row, cr);
  d = -a;
  d = d + 0.0f * b;
  d = d + e;
  m = 0.09375f * a;
  m = m + 0.3125f * b;
  m = m + 0.09375f * e;
}

// y pass of Scharr over the x passes of rows (r - 1, r, r + 1), clamped.
__device__ __forceinline__ void scharr_y(const float d[3], const float m[3], float& gx,
                                         float& gy) {
  gx = 0.09375f * d[0];
  gx = gx + 0.3125f * d[1];
  gx = gx + 0.09375f * d[2];
  gy = -m[0];
  gy = gy + 0.0f * m[1];
  gy = gy + m[2];
}

// Scharr of a block's share s of an H x W level into ix, iy (row-major
// H x W), each pixel written once. A thread walks a strip of one column
// down the share, K rows at a time: it first reads the K + 2 rows they need
// (so the loads go out together) and computes each row's x pass once for
// the three outputs that use it; neighbouring threads take neighbouring
// columns. Rows past the strip's end + 1 read that row again.
template <int K, class At>
__device__ __forceinline__ void scharr_share(At at, int H, int W, Share s, float* __restrict__ ix,
                                             float* __restrict__ iy) {
  const int w = s.c1 - s.c0, h = s.r1 - s.r0;
  const int strips = max(1, (int)blockDim.x / w);  // per column
  const int len = (h + strips - 1) / strips;
  for (int t = threadIdx.x; t < w * strips; t += blockDim.x) {
    const int c = s.c0 + t % w, r0 = s.r0 + t / w * len, r1 = min(r0 + len, s.r1);
    const int cl = clampi(c - 1, 0, W - 1), cr = clampi(c + 1, 0, W - 1);
    for (int rb = r0; rb < r1; rb += K) {
      float d[K + 2], m[K + 2];
#pragma unroll
      for (int k = 0; k < K + 2; ++k)
        scharr_x(at, clampi(min(rb - 1 + k, r1), 0, H - 1), cl, c, cr, d[k], m[k]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (rb + k < r1) {
          float gx, gy;
          scharr_y(d + k, m + k, gx, gy);
          ix[(long long)(rb + k) * W + c] = gx;
          iy[(long long)(rb + k) * W + c] = gy;
        }
      }
    }
  }
}

// L levels at compile time, so the level loop unrolls and the regions live
// in registers. Block z works on camera z % n_cams of lane z / n_cams: the
// camera's image of lane b starts at img_c + b * lane_stride, and its levels
// go to out + z * per_image. G: the fused form, which also writes the
// gradients of levels 0..L (level 0 only when grad_base) of camera 0 of
// lane b into grad + b * grad_per_lane (per level, Ix then Iy, row-major,
// from level grad_base ? 0 : 1 on).
template <int L, bool G>
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const float* __restrict__ img0, const float* __restrict__ img1, int n_cams,
               long long lane_stride, int H, int W, float* __restrict__ out, long long per_image,
               float* __restrict__ grad, long long grad_per_lane, int grad_base) {
  constexpr int th = tile_rows(L), tw = tile_cols(L);
  extern __shared__ float smem[];
  const int ty = blockIdx.y, tx = blockIdx.x;
  const int lane = blockIdx.z / n_cams, cam = blockIdx.z - lane * n_cams;
  const bool grads = G && cam == 0;
  Regions g;
  regions(H, W, L, grads ? 1 : 0, ty, tx, th, tw, &g);
  float* X = smem;                   // x pass of level l-1 at the columns level l keeps
  float* V = smem + x_floats(g, L);  // region of level l
  const float* img = (cam == 0 ? img0 : img1) + lane * lane_stride;
  float* dst = out + blockIdx.z * per_image;
  if (grads) grad += lane * grad_per_lane;
  long long off = 0;                             // of level l in this image's output
  long long goff = grad_base ? 2LL * H * W : 0;  // of level l's gradients in grad
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    const int Hl = g.H[l], Wl = g.W[l];
    if (l == 1) {
      x_pass_image(img, g, X);
      if (grads && grad_base) {  // level 0 through L1: the rows the x pass just read
        const auto at = [&](int r, int c) { return __ldg(img + (long long)r * W + c); };
        scharr_share<kImageStrip>(at, H, W, share(ty, tx, th, tw, L, H, W), grad,
                                  grad + (long long)H * W);
      }
    } else {
      x_pass_region(V, g, l, X);
    }
    __syncthreads();
    const Share s = share(ty, tx, th, tw, L - l, Hl, Wl);
    y_pass(X, g, l, s, (l < L || grads) ? V : nullptr, dst + off);
    __syncthreads();
    if (grads) {
      // reads V beside the next level's x pass; the next y pass, which
      // overwrites V, comes after a barrier
      const int ra = g.ra[l], ca = g.ca[l], cn = g.cn[l];
      const auto at = [&](int r, int c) { return V[(r - ra) * cn + c - ca]; };
      scharr_share<kRegionStrip>(at, Hl, Wl, s, grad + goff, grad + goff + (long long)Hl * Wl);
    }
    off += (long long)Hl * Wl;
    goff += 2LL * Hl * Wl;
  }
}

// Scharr of lane z's image (img + z * lane_stride) into ix, iy + z * H * W.
__global__ void scharr_kernel(const float* __restrict__ img, long long lane_stride, int H, int W,
                              float* __restrict__ ix, float* __restrict__ iy) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= H || c >= W) return;
  img += blockIdx.z * lane_stride;
  ix += (long long)blockIdx.z * H * W;
  iy += (long long)blockIdx.z * H * W;
  const auto at = [&](int row, int col) { return __ldg(img + (long long)row * W + col); };
  const int cl = clampi(c - 1, 0, W - 1), cr = clampi(c + 1, 0, W - 1);
  float d[3], m[3], gx, gy;
#pragma unroll
  for (int t = 0; t < 3; ++t) scharr_x(at, clampi(r + t - 1, 0, H - 1), cl, c, cr, d[t], m[t]);
  scharr_y(d, m, gx, gy);
  ix[(long long)r * W + c] = gx;
  iy[(long long)r * W + c] = gy;
}

template <bool G>
int launch_pyramid(const float* img0, const float* img1, int n_cams, int lanes,
                   long long lane_stride, int H, int W, int levels, float* out, float* grad,
                   int grad_base, void* stream) {
  if (n_cams < 1 || n_cams > 2 || lanes < 1 || (long long)lanes * n_cams > 65535 ||
      lane_stride < 0 || levels < 1 || levels > kMaxLevels || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int th = tile_rows(levels), tw = tile_cols(levels);
  Regions g;
  regions(H, W, levels, 0, 0, 0, th, tw, &g);
  const size_t smem = sizeof(float) * (size_t)smem_floats(levels, G ? 1 : 0);
  long long per_image = 0, grad_per_lane = 0;
  for (int l = 1; l <= levels; ++l) per_image += (long long)g.H[l] * g.W[l];
  for (int l = grad_base ? 0 : 1; l <= levels; ++l) grad_per_lane += 2LL * g.H[l] * g.W[l];
  dim3 grid((g.W[levels] + tw - 1) / tw, (g.H[levels] + th - 1) / th, lanes * n_cams);
  cudaStream_t s = (cudaStream_t)stream;
  const float* img1_ = n_cams > 1 ? img1 : img0;
  if (levels == 1)
    pyramid_kernel<1, G><<<grid, kThreads, smem, s>>>(img0, img1_, n_cams, lane_stride, H, W, out,
                                                      per_image, grad, grad_per_lane, grad_base);
  else if (levels == 2)
    pyramid_kernel<2, G><<<grid, kThreads, smem, s>>>(img0, img1_, n_cams, lane_stride, H, W, out,
                                                      per_image, grad, grad_per_lane, grad_base);
  else
    pyramid_kernel<3, G><<<grid, kThreads, smem, s>>>(img0, img1_, n_cams, lane_stride, H, W, out,
                                                      per_image, grad, grad_per_lane, grad_base);
  return (int)cudaGetLastError();
}

}  // namespace

// Levels 1..levels of the (H, W) images of n_cams (1 or 2) cameras in each
// of `lanes` lanes, in one launch of tiles of the last level: camera c's
// image of lane b starts at img_c + b * lane_stride (rows contiguous; a
// shared frame is lanes = 1). out holds, per lane and camera (lane-major),
// every level row-major one after the other. Returns cudaErrorInvalidValue
// if the arguments are out of range.
extern "C" int hv_pyramid(const float* img0, const float* img1, int n_cams, int lanes,
                          long long lane_stride, int H, int W, int levels, float* out,
                          void* stream) {
  return launch_pyramid<false>(img0, img1, n_cams, lanes, lane_stride, H, W, levels, out, nullptr,
                               0, stream);
}

// hv_pyramid, and in the same launch the Scharr gradients of levels
// (grad_base ? 0 : 1)..levels of camera 0 of every lane into grad: per lane,
// per level, Ix then Iy, each row-major.
extern "C" int hv_pyramid_scharr(const float* img0, const float* img1, int n_cams, int lanes,
                                 long long lane_stride, int H, int W, int levels, float* out,
                                 float* grad, int grad_base, void* stream) {
  return launch_pyramid<true>(img0, img1, n_cams, lanes, lane_stride, H, W, levels, out, grad,
                              grad_base, stream);
}

// The Scharr gradients of `lanes` (H, W) images, lane b's at
// img + b * lane_stride, into ix and iy (lanes x H x W each).
extern "C" int hv_scharr(const float* img, int lanes, long long lane_stride, int H, int W,
                         float* ix, float* iy, void* stream) {
  if (lanes < 1 || lanes > 65535 || lane_stride < 0 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, lanes);
  scharr_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, lane_stride, H, W, ix, iy);
  return (int)cudaGetLastError();
}
