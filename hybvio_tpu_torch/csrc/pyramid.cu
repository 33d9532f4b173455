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
// a launch. So the pyramid kernel builds levels 1..L of one or two images
// (gridDim.z) in one launch: a block owns a th x tw tile of level L and
// computes, in shared memory, the region of every earlier level that the
// tile needs (level l-1 spans 2 n + 3 rows for n rows of level l); it
// writes its own share of every level and recomputes the small halo its
// neighbours also compute. Level 0 is read through L1. The x pass runs only
// at the even columns that decimation keeps, the y pass only at the even
// rows. Each value is composed exactly like the reference's XLA path
// (frontend/pyramid.py _sep_conv2d): the x pass with clamp-to-edge columns,
// then the y pass over clamp-to-edge rows of the x-pass result, each sum
// accumulated left to right; a level's halo takes the previous level at
// the clamped index, never a blur run past its edge. Built with -fmad=false,
// so every product is rounded on its own like the plain PyTorch version,
// which the kernels then match over the whole image (the Pallas kernels
// differ in border rows). Scharr is still one thread per output pixel,
// reading its neighbourhood straight from global memory.
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

// Shared floats of a block of L levels: the largest x pass (level l-1 rows
// at level l columns), plus level 1's region when L > 1. Level l-1's region
// spans 2 n + 3 rows and columns for n of level l.
constexpr int smem_floats(int L) {
  int rn[kMaxLevels + 1] = {}, cn[kMaxLevels + 1] = {};
  rn[L] = tile_rows(L);
  cn[L] = tile_cols(L);
  for (int l = L - 1; l >= 0; --l) {
    rn[l] = 2 * rn[l + 1] + 3;
    cn[l] = 2 * cn[l + 1] + 3;
  }
  int xf = 0;
  for (int l = 1; l <= L; ++l) xf = rn[l - 1] * cn[l] > xf ? rn[l - 1] * cn[l] : xf;
  return xf + (L > 1 ? rn[1] * cn[1] : 0);
}
static_assert(sizeof(float) * smem_floats(1) <= kMaxSmem &&
                  sizeof(float) * smem_floats(2) <= kMaxSmem &&
                  sizeof(float) * smem_floats(3) <= kMaxSmem,
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

__host__ __device__ inline void regions(int H, int W, int L, int ty, int tx, int th,
                                        int tw, Regions* g) {
  g->H[0] = H;
  g->W[0] = W;
  for (int l = 1; l <= L; ++l) {
    g->H[l] = (g->H[l - 1] + 1) / 2;
    g->W[l] = (g->W[l - 1] + 1) / 2;
  }
  g->ra[L] = ty * th;
  g->rn[L] = th;
  g->ca[L] = tx * tw;
  g->cn[L] = tw;
  for (int l = L - 1; l >= 0; --l) {
    g->ra[l] = 2 * g->ra[l + 1] - 2;
    g->rn[l] = 2 * g->rn[l + 1] + 3;
    g->ca[l] = 2 * g->ca[l + 1] - 2;
    g->cn[l] = 2 * g->cn[l + 1] + 3;
  }
}

// Shared floats of the x-pass buffer; one level region (levels 1..L-1)
// follows it.
__device__ inline int x_floats(const Regions& g, int L) {
  int xf = 0;
  for (int l = 1; l <= L; ++l) {
    const int f = g.rn[l - 1] * g.cn[l];
    xf = f > xf ? f : xf;
  }
  return xf;
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

// L levels at compile time, so the level loop unrolls and the regions live
// in registers.
template <int L>
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const float* __restrict__ img0, const float* __restrict__ img1, int H,
               int W, float* __restrict__ out, long long per_image) {
  constexpr int th = tile_rows(L), tw = tile_cols(L);
  const float k[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
  extern __shared__ float smem[];
  const int ty = blockIdx.y, tx = blockIdx.x;
  Regions g;
  regions(H, W, L, ty, tx, th, tw, &g);
  float* X = smem;                   // x pass of level l-1 at the columns level l keeps
  float* V = smem + x_floats(g, L);  // region of level l (l < L)
  const float* img = blockIdx.z == 0 ? img0 : img1;
  float* dst = out + blockIdx.z * per_image;
  long long off = 0;  // of level l in this image's output
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    const int Hp = g.H[l - 1], Wp = g.W[l - 1], Hl = g.H[l], Wl = g.W[l];
    const int ra_p = g.ra[l - 1], rn_p = g.rn[l - 1], ca_p = g.ca[l - 1], cn_p = g.cn[l - 1];
    const int ra = g.ra[l], rn = g.rn[l], ca = g.ca[l], cn = g.cn[l];
    const int nx = rn_p * cn;
    Walk p(threadIdx.x, blockDim.x, cn);
    if (l == 1) {
      // level 0 from device memory: the loads of kUnroll items go out together
      for (int base = threadIdx.x; base < nx; base += kUnroll * blockDim.x) {
        float v[kUnroll][5];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (base + u * (int)blockDim.x < nx) {
            const float* row = img + (long long)clampi(ra_p + p.i, 0, H - 1) * W;
            const int c2 = 2 * clampi(ca + p.j, 0, Wl - 1);
#pragma unroll
            for (int s = 0; s < 5; ++s) v[u][s] = __ldg(row + clampi(c2 + s - 2, 0, W - 1));
          }
          p.next();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int idx = base + u * blockDim.x;
          if (idx < nx) {
            float acc = k[0] * v[u][0];
#pragma unroll
            for (int s = 1; s < 5; ++s) acc = acc + k[s] * v[u][s];
            X[idx] = acc;
          }
        }
      }
    } else {
#pragma unroll 4
      for (int idx = threadIdx.x; idx < nx; idx += blockDim.x, p.next()) {
        const float* row = V + p.i * cn_p;
        const int c2 = 2 * clampi(ca + p.j, 0, Wl - 1);
        float acc = k[0] * row[clampi(c2 - 2, 0, Wp - 1) - ca_p];
#pragma unroll
        for (int s = 1; s < 5; ++s) acc = acc + k[s] * row[clampi(c2 + s - 2, 0, Wp - 1) - ca_p];
        X[idx] = acc;
      }
    }
    __syncthreads();
    // this block's share of level l: the rows and columns that its tile of
    // level L covers, scaled up by 2^(L - l)
    const int sh = L - l;
    const int r_lo = (ty * th) << sh, r_hi = min(((ty + 1) * th) << sh, Hl);
    const int c_lo = (tx * tw) << sh, c_hi = min(((tx + 1) * tw) << sh, Wl);
    Walk q(threadIdx.x, blockDim.x, cn);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rn * cn; idx += blockDim.x, q.next()) {
      const int r2 = 2 * clampi(ra + q.i, 0, Hl - 1);
      float acc = k[0] * X[(clampi(r2 - 2, 0, Hp - 1) - ra_p) * cn + q.j];
#pragma unroll
      for (int t = 1; t < 5; ++t)
        acc = acc + k[t] * X[(clampi(r2 + t - 2, 0, Hp - 1) - ra_p) * cn + q.j];
      if (l < L) V[idx] = acc;
      const int r = ra + q.i, c = ca + q.j;
      if (r >= r_lo && r < r_hi && c >= c_lo && c < c_hi) dst[off + (long long)r * Wl + c] = acc;
    }
    __syncthreads();
    off += (long long)Hl * Wl;
  }
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

// Levels 1..levels of n_images (1 or 2) images of one (H, W) shape, in one
// launch of tiles of the last level. out holds, per image, every level
// row-major one after the other. Returns cudaErrorInvalidValue if the
// arguments are out of range.
extern "C" int hv_pyramid(const float* img0, const float* img1, int n_images, int H,
                          int W, int levels, float* out, void* stream) {
  if (n_images < 1 || n_images > 2 || levels < 1 || levels > kMaxLevels || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int th = tile_rows(levels), tw = tile_cols(levels);
  Regions g;
  regions(H, W, levels, 0, 0, th, tw, &g);
  const size_t smem = sizeof(float) * (size_t)smem_floats(levels);
  long long per_image = 0;
  for (int l = 1; l <= levels; ++l) per_image += (long long)g.H[l] * g.W[l];
  dim3 grid((g.W[levels] + tw - 1) / tw, (g.H[levels] + th - 1) / th, n_images);
  cudaStream_t s = (cudaStream_t)stream;
  const float* img1_ = n_images > 1 ? img1 : img0;
  if (levels == 1)
    pyramid_kernel<1><<<grid, kThreads, smem, s>>>(img0, img1_, H, W, out, per_image);
  else if (levels == 2)
    pyramid_kernel<2><<<grid, kThreads, smem, s>>>(img0, img1_, H, W, out, per_image);
  else
    pyramid_kernel<3><<<grid, kThreads, smem, s>>>(img0, img1_, H, W, out, per_image);
  return (int)cudaGetLastError();
}

extern "C" int hv_scharr(const float* img, int H, int W, float* ix, float* iy,
                         void* stream) {
  dim3 block(32, 8);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  scharr_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, H, W, ix, iy);
  return (int)cudaGetLastError();
}
