// Patch gather: copy one (ps, ps) window per feature out of up to three
// images at the same origins (the LK template, Ix and Iy in one launch).
//
// Replaces the Pallas kernel hybvio_tpu/ops/patch_gather_pallas.py
// (_gather_batched / _kernel, behind gather_patches_pallas), which DMAs a
// tile-aligned block per feature into VMEM and extracts the window there.
//
// What bounds it on the H100: bytes, and the main path's launch count. A
// step gathers about 30 sets of 16 x 96 windows of 18 to 50 floats square;
// one set of 34 x 34 windows writes 7.1 MB, 2.1 us at 3.35 TB/s, and there is
// no arithmetic. A first design (one 256-thread block per window, one
// element per thread with an integer division each) reached 39% of that
// bound. This one:
//   * gathers up to three images at the same origins in one launch (the LK
//     template, Ix and Iy), a third of the launches of a level;
//   * keeps four windows per block, 64 threads per window;
//   * writes each window as 16-byte stores: a thread owns four consecutive
//     output floats, loads them through L1 (neighbouring threads read
//     neighbouring pixels of one or two image rows) and steps its (row,
//     column) by a constant, so no element costs a division; the at most
//     three floats before the window's first 16-byte boundary and after
//     its last are written one by one.
// Staging the rows' 16-byte-aligned spans in shared memory by cp.async
// first was slower on the H100 at every window size of the main path: the
// loads hit L2, and the extra shared-memory pass only lengthens each
// window's chain.
// Each image's batch stride may be 0: with shared frames every lane reads the
// same pyramid level, one copy in memory. Origins are clamped to
// [0, dim - ps] like lax.dynamic_slice, so the kernel equals its plain
// version for any input, bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 64;   // threads per window
constexpr int kWindows = 4;  // windows per block
constexpr int kMaxImages = 3;

struct Images {
  const float* p[kMaxImages];
  long long batch_stride[kMaxImages];  // floats; may be 0
};

__global__ void __launch_bounds__(kGroup * kWindows)
patch_gather_kernel(Images imgs, int H, int W, const int* __restrict__ y0,
                    const int* __restrict__ x0, long long windows, int N,
                    int n_img, int ps, float* __restrict__ out) {
  const int t = threadIdx.x % kGroup;
  const long long g = (long long)blockIdx.x * kWindows + threadIdx.x / kGroup;
  if (g >= windows * n_img) return;  // g: (image, lane, feature)
  const int m = (int)(g / windows);
  const long long f = g - m * windows;
  const int y = min(max(y0[f], 0), H - ps);
  const int x = min(max(x0[f], 0), W - ps);
  const float* base = m == 0 ? imgs.p[0] : m == 1 ? imgs.p[1] : imgs.p[2];
  const long long stride = m == 0   ? imgs.batch_stride[0]
                           : m == 1 ? imgs.batch_stride[1]
                                    : imgs.batch_stride[2];
  const float* src = base + (f / N) * stride + (long long)y * W + x;
  const int count = ps * ps;
  float* o = out + g * count;  // out is 16-byte aligned
  const int head = min((int)(-(g * count) & 3), count);  // to a 16-byte boundary
  const int body = (count - head) >> 2;      // 16-byte stores
  const int rest = head + 4 * body;          // first float of the tail

  if (t < head || (t >= 4 && t - 4 + rest < count)) {
    const int e = t < head ? t : t - 4 + rest;
    const int r = e / ps;
    o[e] = __ldg(src + (long long)r * W + (e - r * ps));
  }
  const int step = 4 * kGroup;
  const int step_r = step / ps, step_c = step - step_r * ps;
  int e = head + 4 * t;
  int r = e / ps, c = e - r * ps;
  for (int q = t; q < body; q += kGroup) {
    float v[4];
    int rr = r, cc = c;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = __ldg(src + (long long)rr * W + cc);
      if (++cc == ps) {
        cc = 0;
        ++rr;
      }
    }
    *reinterpret_cast<float4*>(o + e) = make_float4(v[0], v[1], v[2], v[3]);
    e += step;
    r += step_r;
    c += step_c;
    if (c >= ps) {
      c -= ps;
      ++r;
    }
  }
}

}  // namespace

extern "C" int hv_patch_gather(const float* img0, const float* img1,
                               const float* img2, long long stride0,
                               long long stride1, long long stride2, int n_img,
                               int H, int W, const int* y0, const int* x0,
                               int B, int N, int ps, float* out, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (n_img < 1 || n_img > kMaxImages || ps < 1 || ps > H || ps > W ||
      reinterpret_cast<unsigned long long>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Images imgs = {{img0, img1, img2}, {stride0, stride1, stride2}};
  const long long windows = (long long)B * N;
  const long long blocks = (windows * n_img + kWindows - 1) / kWindows;
  patch_gather_kernel<<<(unsigned)blocks, kGroup * kWindows, 0,
                        (cudaStream_t)stream>>>(imgs, H, W, y0, x0, windows, N,
                                                n_img, ps, out);
  return (int)cudaGetLastError();
}
