// Greedy min-distance selection: walk K response-sorted candidates in order
// and take candidate i if it is eligible and no already-taken j has
// d2[i, j] < min_d2.
//
// Replaces the Pallas kernel hybvio_tpu/ops/nms_pallas.py
// greedy_min_distance_pallas (body _greedy_kernel), which runs the loop over
// a (1, K) mask in VMEM.
//
// What bounds it on the H100: latency, not bytes. The walk is K = 192
// dependent steps per lane; the bytes (one 192 x 192 f32 matrix, shared by
// the lanes on the main path) take 0.05 us at 3.35 TB/s. A first design
// (one block-wide OR per step) paid a global load and two block barriers
// per step, ~70 us a launch. This one is a bitmask walk, one cluster of
// eight blocks per lane:
//   phase 1, parallel over the cluster: the 64 warps of the cluster take
//     rows i = 64 n + w, up to four rows at a time; lane l loads
//     d2[i, 32 k + l] for eight words k of each row at once (independent,
//     coalesced loads), and __ballot_sync packs the tests d2[i, j] < min_d2
//     with j < i into 32-bit conflict words, stored straight into the
//     shared memory of the cluster's first block (distributed shared
//     memory), which also packs the eligibility words. Built by one block,
//     the 18k tests of a lane took most of the kernel's time, bound by
//     that one SM's instruction throughput; eight SMs share them here;
//   one cluster barrier;
//   phase 2, one warp of the first block, one word of 32 candidates at a
//     time: lane l drops candidate i = 32 w + l if a conflict word k < w
//     meets the final taken word k; the rest of the word is resolved in
//     rounds of two ballots: a candidate is taken once no earlier candidate
//     of the word that it conflicts with is taken or undecided, and
//     rejected once one is taken. Each round decides at least the first
//     undecided candidate, and a word of candidates 35 px apart rarely
//     chains more than a few.
// Bit-exact with the sequential loop: the same `<` comparisons, the same
// order of decisions. d2 may have batch stride 0 (one candidate set for
// every lane; L2 serves the shared rows). K <= 1024 (32 words).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                  // blocks per lane
constexpr int kThreads = 256;                // per block
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = kCluster * kWarps;  // warps sharing a lane's rows
constexpr int kRows = 4;                     // rows of a warp loaded at once
constexpr int kBatch = 8;                    // words of a row loaded at once
constexpr int kMaxWords = 32;                // K <= 1024
constexpr unsigned kFull = 0xffffffffu;

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
greedy_nms_kernel(const float* __restrict__ d2, long long batch_stride,
                  const unsigned char* __restrict__ ok, int K, float min_d2,
                  unsigned char* __restrict__ taken) {
  extern __shared__ unsigned smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int nw = (K + 31) >> 5;
  unsigned* conflict = cluster.map_shared_rank(smem, 0);  // (K, nw), first block's
  unsigned* ok_words = smem + K * nw;                     // (nw,), first block
  unsigned* taken_words = ok_words + nw;                  // (nw,), first block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* D = d2 + (long long)b * batch_stride;
  const unsigned char* okb = ok + (long long)b * K;
  const bool ok0 = rank == 0 && warp < nw && 32 * warp + lane < K &&
                   okb[32 * warp + lane] != 0;
  // the first block's shared memory is written only once every block of the
  // cluster has started
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");

  // phase 1: conflict words of rows i = rw, rw + kRowWarps, ...
  const int rw = rank * kWarps + warp;
  for (int i0 = rw; i0 < K; i0 += kRows * kRowWarps) {
    const int last = min(i0 + (kRows - 1) * kRowWarps, K - 1);
    for (int k0 = 0; 32 * k0 <= last; k0 += kBatch) {  // words past i/32: never read
      float v[kRows][kBatch];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = i0 + q * kRowWarps;
        const int lim = i < K ? i : 0;  // tested columns j < lim
        const float* row = D + (long long)(i < K ? i : 0) * K;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = 32 * (k0 + u) + lane;
          v[q][u] = j < lim ? __ldg(row + j) : CUDART_INF_F;
        }
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        unsigned mine = 0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const unsigned word = __ballot_sync(kFull, v[q][u] < min_d2);
          if (lane == u) mine = word;
        }
        const int i = i0 + q * kRowWarps;
        if (i < K && lane < kBatch && k0 + lane < nw) conflict[i * nw + k0 + lane] = mine;
      }
    }
  }
  if (rank == 0) {
    for (int k = warp; k < nw; k += kWarps) {
      const int j = 32 * k + lane;
      const bool o = k == warp ? ok0 : j < K && okb[j] != 0;
      const unsigned word = __ballot_sync(kFull, o);
      if (lane == 0) ok_words[k] = word;
    }
  }
  cluster.sync();
  if (rank != 0 || warp != 0) return;

  // phase 2: the walk, one word of candidates at a time
  for (int w = 0; w < nw; ++w) {
    const int i = 32 * w + lane;
    const unsigned* ci = smem + (i < K ? i : 0) * nw;
    unsigned near = 0;  // a taken candidate of an earlier word is too close
    for (int k = 0; k < w; ++k) near |= ci[k] & taken_words[k];
    unsigned undecided = __ballot_sync(kFull, i < K && near == 0u) & ok_words[w];
    const unsigned blockers = (i < K ? ci[w] : 0u) & undecided;  // earlier only
    unsigned tw = 0;
    while (undecided != 0u) {
      const bool mine = (undecided >> lane) & 1u;
      const bool reject = mine && (blockers & tw) != 0u;
      const bool take = mine && !reject && (blockers & undecided) == 0u;
      tw |= __ballot_sync(kFull, take);
      undecided &= ~__ballot_sync(kFull, take || reject);
    }
    if (lane == 0) taken_words[w] = tw;
    __syncwarp();
  }

  // taken bits -> the bool (K,) of this lane
  unsigned char* out = taken + (long long)b * K;
  for (int k = 0; k < nw; ++k)
    if (32 * k + lane < K) out[32 * k + lane] = (taken_words[k] >> lane) & 1u;
}

}  // namespace

extern "C" int hv_greedy_nms(const float* d2, long long batch_stride,
                             const unsigned char* ok, int B, int K,
                             float min_d2, unsigned char* taken, void* stream) {
  if (B == 0 || K == 0) return 0;
  if (K > 32 * kMaxWords) return (int)cudaErrorInvalidValue;
  const int nw = (K + 31) / 32;
  const size_t smem = sizeof(unsigned) * ((size_t)K * nw + 2 * nw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_nms_kernel<<<B * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      d2, batch_stride, ok, K, min_d2, taken);
  return (int)cudaGetLastError();
}
