// Multi-scale FAST + rotated-BRIEF (ORB) keypoint detector for the SLAM
// host thread.
//
// Semantics mirror hybvio_tpu_torch/slam/keypoints.py (the torch
// detector): an orbScaleLevels-level x orbScaleFactor antialiased-bilinear
// pyramid, FAST-9/16 with the dual-threshold per-cell fallback (a 16x16 cell
// keeps its best >=thr_min corner, preferring corners that clear thr_init),
// static per-level top-k budgets, intensity-centroid orientation on a 5-tap
// binomial-smoothed patch, and a caller-supplied BRIEF-256 pattern sampled
// bilinearly on the keypoint's own pyramid level (reference behavior:
// slam.orb* parameter family, codegen/parameter_definitions.c:479-484).
//
// Why native: the SLAM worker runs at keyframe rate beside the VIO step
// and shares its host; the torch detector, a few hundred small launches a
// keyframe, holds that worker for hundreds of ms a keyframe on the card.
// This C++ implementation runs the same contract in milliseconds on the
// host (the reference runs its SLAM thread as C++ too). The PyTorch port's
// copy of native/orb_detect.cpp, compiled with the other native sources of
// this directory into build/libhybvio_native.so by
// hybvio_tpu_torch/utils/native.py (g++ -O3 -march=native -shared -fPIC).
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx) —
// same tap order as frontend/fast.py _CIRCLE.
static const int kCircle[16][2] = {
    {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3},  {1, 3},  {2, 2},  {3, 1},
    {3, 0},  {3, -1}, {2, -2}, {1, -3}, {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};

constexpr int kPatchR = 15;  // 31x31 ORB patch

struct ResizeAxis {
  // per output index: first input tap + normalized triangle weights
  std::vector<int> first;
  std::vector<float> w;  // taps per output, flattened
  int taps = 0;
};

// jax.image.resize(..., "bilinear") with antialias (the default): output
// center o maps to input x = (o + 0.5) / s - 0.5 with s = out/in; weights
// tri((i - x) * s) for downscale (kernel widened by 1/s), tri(i - x) else.
ResizeAxis make_axis(int in, int out) {
  ResizeAxis ax;
  const double s = static_cast<double>(out) / in;
  const double support = s < 1.0 ? 1.0 / s : 1.0;
  ax.taps = static_cast<int>(std::ceil(2.0 * support)) + 1;
  ax.first.resize(out);
  ax.w.resize(static_cast<size_t>(out) * ax.taps, 0.0f);
  for (int o = 0; o < out; ++o) {
    const double x = (o + 0.5) / s - 0.5;
    int f = static_cast<int>(std::floor(x - support + 0.5));
    ax.first[o] = f;
    double sum = 0.0;
    std::vector<double> tw(ax.taps, 0.0);
    for (int t = 0; t < ax.taps; ++t) {
      const double d = (f + t - x) * (s < 1.0 ? s : 1.0);
      const double v = std::max(0.0, 1.0 - std::abs(d));
      tw[t] = v;
      sum += v;
    }
    for (int t = 0; t < ax.taps; ++t)
      ax.w[static_cast<size_t>(o) * ax.taps + t] =
          static_cast<float>(sum > 0 ? tw[t] / sum : 0.0);
  }
  return ax;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Level {
  int H = 0, W = 0, k = 0;
  ResizeAxis ax_x, ax_y;            // from the previous level
  std::vector<float> img, tmp, smooth, resp;
};

struct Detector {
  int H, W, cell, n_bits, capacity;
  float thr_init, thr_min;
  std::vector<Level> levels;
  std::vector<float> pa, pb;  // (n_bits, 2) each, pattern in patch coords
};

void resize_from(const Level& src, Level& dst) {
  // separable: rows (x axis) then columns (y axis)
  dst.tmp.assign(static_cast<size_t>(src.H) * dst.W, 0.0f);
  for (int y = 0; y < src.H; ++y) {
    const float* row = &src.img[static_cast<size_t>(y) * src.W];
    float* orow = &dst.tmp[static_cast<size_t>(y) * dst.W];
    for (int o = 0; o < dst.W; ++o) {
      const int f = dst.ax_x.first[o];
      const float* w = &dst.ax_x.w[static_cast<size_t>(o) * dst.ax_x.taps];
      float acc = 0.0f;
      for (int t = 0; t < dst.ax_x.taps; ++t)
        acc += w[t] * row[clampi(f + t, 0, src.W - 1)];
      orow[o] = acc;
    }
  }
  dst.img.assign(static_cast<size_t>(dst.H) * dst.W, 0.0f);
  for (int o = 0; o < dst.H; ++o) {
    const int f = dst.ax_y.first[o];
    const float* w = &dst.ax_y.w[static_cast<size_t>(o) * dst.ax_y.taps];
    float* orow = &dst.img[static_cast<size_t>(o) * dst.W];
    for (int t = 0; t < dst.ax_y.taps; ++t) {
      const float* irow =
          &dst.tmp[static_cast<size_t>(clampi(f + t, 0, src.H - 1)) * dst.W];
      const float wt = w[t];
      for (int x = 0; x < dst.W; ++x) orow[x] += wt * irow[x];
    }
  }
}

// FAST-9/16 response (frontend/fast.py fast_score): score = max over the 16
// cyclic 9-windows whose taps are ALL brighter (or all darker) than center
// by > thr of the window's min |d|; 0 elsewhere; 3-px border zeroed.
void fast_rows(const Level& lv, float thr, int y_begin, int y_end) {
  const int H = lv.H, W = lv.W;
  (void)H;
  float* resp = const_cast<float*>(lv.resp.data());
  const float* img = lv.img.data();
  int off[16];
  for (int t = 0; t < 16; ++t) off[t] = kCircle[t][0] * W + kCircle[t][1];
  float d[16];
  for (int y = y_begin; y < y_end; ++y) {
    const float* prow = img + static_cast<size_t>(y) * W;
    for (int x = 3; x < W - 3; ++x) {
      const float* p = prow + x;
      const float c = *p;
      // compass pretest: a 9-contiguous arc always covers two ADJACENT taps
      // of {0, 4, 8, 12} (spacing 4 on a 16-ring), both on the same side
      const float d0 = p[off[0]] - c;
      const float d4 = p[off[4]] - c;
      const float d8 = p[off[8]] - c;
      const float d12 = p[off[12]] - c;
      const bool b0 = d0 > thr, b4 = d4 > thr, b8 = d8 > thr, b12 = d12 > thr;
      const bool k0 = d0 < -thr, k4 = d4 < -thr, k8 = d8 < -thr,
                 k12 = d12 < -thr;
      const bool pre_b = (b0 & b4) | (b4 & b8) | (b8 & b12) | (b12 & b0);
      const bool pre_d = (k0 & k4) | (k4 & k8) | (k8 & k12) | (k12 & k0);
      if (!pre_b && !pre_d) continue;
      uint32_t mb = 0, md = 0;
      for (int t = 0; t < 16; ++t) {
        d[t] = p[off[t]] - c;
        mb |= static_cast<uint32_t>(d[t] > thr) << t;
        md |= static_cast<uint32_t>(d[t] < -thr) << t;
      }
      float best = 0.0f;
      for (int sign = 0; sign < 2; ++sign) {
        const uint32_t m = sign ? md : mb;
        if (__builtin_popcount(m) < 9) continue;
        // 9-contiguous-run detection on the doubled 32-bit ring
        uint32_t runs = m | (m << 16);
        for (int k = 1; k < 9; ++k) runs &= (m | (m << 16)) >> k;
        runs &= 0xFFFFu;
        if (!runs) continue;
        // score only the (rare) windows that actually qualify
        while (runs) {
          const int s = __builtin_ctz(runs);
          runs &= runs - 1;
          float mmin = 1e30f;
          for (int j = 0; j < 9; ++j) {
            const float v = sign ? -d[(s + j) & 15] : d[(s + j) & 15];
            mmin = std::min(mmin, v);
          }
          best = std::max(best, mmin);
        }
      }
      resp[static_cast<size_t>(y) * W + x] = best;
    }
  }
}

// FAST-9/16 response over the full level, parallelized over row bands (the
// per-pixel work is branchy scalar code; threads are the honest lever here,
// and the SLAM worker holds no GIL during the call).
void fast_response(const Level& lv, float thr) {
  float* resp = const_cast<float*>(lv.resp.data());
  std::memset(resp, 0, sizeof(float) * lv.H * lv.W);
  const int rows = lv.H - 6;
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = std::min<int>(std::max(1u, hw), 8);
  n_threads = std::min(n_threads, std::max(rows / 32, 1));
  if (n_threads <= 1) {
    fast_rows(lv, thr, 3, lv.H - 3);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const int band = (rows + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    const int y0 = 3 + i * band;
    const int y1 = std::min(y0 + band, lv.H - 3);
    if (y0 >= y1) break;
    ts.emplace_back(fast_rows, std::cref(lv), thr, y0, y1);
  }
  for (auto& t : ts) t.join();
}

inline float bilinear(const float* img, int H, int W, float xf, float yf) {
  // clamp semantics of frontend/pyramid.bilinear_sample
  xf = std::min(std::max(xf, 0.0f), W - 1.001f);
  yf = std::min(std::max(yf, 0.0f), H - 1.001f);
  const int x0 = static_cast<int>(xf), y0 = static_cast<int>(yf);
  const int x1 = std::min(x0 + 1, W - 1), y1 = std::min(y0 + 1, H - 1);
  const float fx = xf - x0, fy = yf - y0;
  const float v00 = img[static_cast<size_t>(y0) * W + x0];
  const float v01 = img[static_cast<size_t>(y0) * W + x1];
  const float v10 = img[static_cast<size_t>(y1) * W + x0];
  const float v11 = img[static_cast<size_t>(y1) * W + x1];
  return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) +
         v10 * (1 - fx) * fy + v11 * fx * fy;
}

// 5-tap binomial separable smoothing with replicate edges
// (frontend/pyramid._sep_conv2d with [1,4,6,4,1]/16).
void smooth5(const std::vector<float>& src, std::vector<float>& tmp,
             std::vector<float>& dst, int H, int W) {
  static const float k[5] = {1.f / 16, 4.f / 16, 6.f / 16, 4.f / 16, 1.f / 16};
  tmp.resize(static_cast<size_t>(H) * W);
  dst.resize(static_cast<size_t>(H) * W);
  for (int y = 0; y < H; ++y) {
    const float* row = &src[static_cast<size_t>(y) * W];
    float* orow = &tmp[static_cast<size_t>(y) * W];
    for (int x = 0; x < W; ++x) {
      float acc = 0.0f;
      for (int t = -2; t <= 2; ++t)
        acc += k[t + 2] * row[clampi(x + t, 0, W - 1)];
      orow[x] = acc;
    }
  }
  for (int y = 0; y < H; ++y) {
    float* orow = &dst[static_cast<size_t>(y) * W];
    for (int t = -2; t <= 2; ++t) {
      const float* irow = &tmp[static_cast<size_t>(clampi(y + t, 0, H - 1)) * W];
      const float wt = k[t + 2];
      if (t == -2)
        for (int x = 0; x < W; ++x) orow[x] = wt * irow[x];
      else
        for (int x = 0; x < W; ++x) orow[x] += wt * irow[x];
    }
  }
}

}  // namespace

extern "C" {

void* orb_create(int H, int W, int n_levels, double scale_factor,
                 double thr_init, double thr_min, int total_kps, int cell,
                 const float* pairs_a, const float* pairs_b, int n_bits) {
  auto* det = new Detector();
  det->H = H;
  det->W = W;
  det->cell = cell;
  det->n_bits = n_bits;
  det->thr_init = static_cast<float>(thr_init);
  det->thr_min = static_cast<float>(thr_min);
  det->pa.assign(pairs_a, pairs_a + 2 * n_bits);
  det->pb.assign(pairs_b, pairs_b + 2 * n_bits);

  // level geometry: keypoints.py _level_geometry (min_dim 48, budgets
  // proportional to 1/scale^l, floor 8, banker's rounding like np.round)
  std::vector<std::pair<int, int>> shapes;
  for (int l = 0; l < n_levels; ++l) {
    const double s = std::pow(scale_factor, l);
    const int Hl = static_cast<int>(std::lround(H / s));
    const int Wl = static_cast<int>(std::lround(W / s));
    if (std::min(Hl, Wl) < 48) break;
    shapes.emplace_back(Hl, Wl);
  }
  const int n = static_cast<int>(shapes.size());
  double inv_sum = 0.0;
  for (int l = 0; l < n; ++l) inv_sum += 1.0 / std::pow(scale_factor, l);
  det->levels.resize(n);
  det->capacity = 0;
  int prevH = H, prevW = W;
  for (int l = 0; l < n; ++l) {
    Level& lv = det->levels[l];
    lv.H = shapes[l].first;
    lv.W = shapes[l].second;
    const double frac = (1.0 / std::pow(scale_factor, l)) / inv_sum;
    lv.k = std::max(static_cast<int>(std::nearbyint(frac * total_kps)), 8);
    det->capacity += lv.k;
    lv.resp.resize(static_cast<size_t>(lv.H) * lv.W);
    if (l > 0) {
      lv.ax_x = make_axis(prevW, lv.W);
      lv.ax_y = make_axis(prevH, lv.H);
    }
    prevH = lv.H;
    prevW = lv.W;
  }
  return det;
}

void orb_destroy(void* h) { delete static_cast<Detector*>(h); }

int orb_capacity(void* h) { return static_cast<Detector*>(h)->capacity; }

// img: (H, W) float32 row-major in [0, 1].
// Outputs (capacity rows): pts (N,2) float32 level-0 xy, levels (N) int32,
// desc (N, n_bits) int8 in {-1,+1}, valid (N) uint8. Returns capacity.
int orb_detect(void* h, const float* img, float* out_pts, int32_t* out_lvl,
               int8_t* out_desc, uint8_t* out_valid) {
  Detector* det = static_cast<Detector*>(h);
  const int cell = det->cell;
  int row = 0;
  std::vector<float> smooth_tmp;
  const bool prof = std::getenv("HYBVIO_ORB_PROFILE") != nullptr;
  double t_resize = 0, t_fast = 0, t_block = 0, t_smooth = 0, t_desc = 0;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto ms = [](auto a, auto b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };
  for (size_t l = 0; l < det->levels.size(); ++l) {
    Level& lv = det->levels[l];
    auto t0 = now();
    if (l == 0) {
      lv.img.assign(img, img + static_cast<size_t>(lv.H) * lv.W);
    } else {
      resize_from(det->levels[l - 1], lv);
    }
    auto t1 = now();
    t_resize += ms(t0, t1);
    fast_response(lv, det->thr_min);
    auto t2 = now();
    t_fast += ms(t1, t2);

    // per-cell packed block max (gftt.block_max_packed: 16-bit quantized
    // score, larger in-cell index wins ties)
    const int Hc = lv.H / cell, Wc = lv.W / cell;
    struct Cand { float sel; int order; float x, y; };
    std::vector<Cand> cands;
    cands.reserve(static_cast<size_t>(Hc) * Wc);
    for (int cy = 0; cy < Hc; ++cy) {
      for (int cx = 0; cx < Wc; ++cx) {
        int bq = -1, bidx = -1;
        for (int dy = 0; dy < cell; ++dy) {
          const float* rrow =
              &lv.resp[static_cast<size_t>(cy * cell + dy) * lv.W + cx * cell];
          for (int dx = 0; dx < cell; ++dx) {
            const float r = std::min(std::max(rrow[dx], 0.0f), 1.0f);
            const int q = static_cast<int>(std::lround(r * 65535.0f));
            const int idx = dy * cell + dx;
            if (q > bq || (q == bq && idx > bidx)) {
              bq = q;
              bidx = idx;
            }
          }
        }
        const float s_lo = bq / 65535.0f;
        if (s_lo <= 0.0f) continue;
        const bool strong = s_lo > det->thr_init;
        Cand c;
        c.sel = s_lo + (strong ? 1.0f : 0.0f);
        c.order = cy * Wc + cx;  // stable tie-break like lax.top_k
        c.x = static_cast<float>(cx * cell + bidx % cell);
        c.y = static_cast<float>(cy * cell + bidx / cell);
        cands.push_back(c);
      }
    }
    const int kk = std::min<int>(lv.k, static_cast<int>(cands.size()));
    std::partial_sort(cands.begin(), cands.begin() + kk, cands.end(),
                      [](const Cand& a, const Cand& b) {
                        return a.sel > b.sel ||
                               (a.sel == b.sel && a.order < b.order);
                      });
    auto t3 = now();
    t_block += ms(t2, t3);

    smooth5(lv.img, smooth_tmp, lv.smooth, lv.H, lv.W);
    auto t4 = now();
    t_smooth += ms(t3, t4);
    const float* sm = lv.smooth.data();
    const float sx = static_cast<float>(det->W) / lv.W;
    const float sy = static_cast<float>(det->H) / lv.H;

    for (int i = 0; i < lv.k; ++i, ++row) {
      out_lvl[row] = static_cast<int32_t>(l);
      int8_t* drow = out_desc + static_cast<size_t>(row) * det->n_bits;
      if (i >= kk) {
        out_pts[2 * row] = 0.0f;
        out_pts[2 * row + 1] = 0.0f;
        out_valid[row] = 0;
        std::memset(drow, 0, det->n_bits);
        continue;
      }
      const float x = cands[i].x, y = cands[i].y;
      out_pts[2 * row] = x * sx;
      out_pts[2 * row + 1] = y * sy;
      const bool in_bounds = x >= kPatchR + 1 && x < lv.W - kPatchR - 1 &&
                             y >= kPatchR + 1 && y < lv.H - kPatchR - 1;
      if (!in_bounds) {
        out_valid[row] = 0;
        std::memset(drow, 0, det->n_bits);
        continue;
      }
      // intensity-centroid orientation over the circular 31x31 patch
      // (integer keypoint coords: direct reads)
      const int xi = static_cast<int>(x), yi = static_cast<int>(y);
      float m10 = 0.0f, m01 = 0.0f;
      for (int oy = -kPatchR; oy <= kPatchR; ++oy) {
        const float* prow = &sm[static_cast<size_t>(yi + oy) * lv.W + xi];
        const int lim2 = kPatchR * kPatchR - oy * oy;
        for (int ox = -kPatchR; ox <= kPatchR; ++ox) {
          if (ox * ox > lim2) continue;
          const float v = prow[ox];
          m10 += v * ox;
          m01 += v * oy;
        }
      }
      const float theta = std::atan2(m01, m10);
      const float c = std::cos(theta), s = std::sin(theta);
      for (int b = 0; b < det->n_bits; ++b) {
        const float pax = det->pa[2 * b], pay = det->pa[2 * b + 1];
        const float pbx = det->pb[2 * b], pby = det->pb[2 * b + 1];
        const float va = bilinear(sm, lv.H, lv.W, x + c * pax - s * pay,
                                  y + s * pax + c * pay);
        const float vb = bilinear(sm, lv.H, lv.W, x + c * pbx - s * pby,
                                  y + s * pbx + c * pby);
        drow[b] = va > vb ? 1 : -1;
      }
      out_valid[row] = 1;
    }
    t_desc += ms(t4, now());
  }
  if (prof)
    std::fprintf(stderr,
                 "orb_detect: resize %.1f fast %.1f block %.1f smooth %.1f "
                 "desc %.1f ms\n",
                 t_resize, t_fast, t_block, t_smooth, t_desc);
  return det->capacity;
}

}  // extern "C"
