// Exact filtered k-NN in one pass over the corpus: RR predicate + squared
// L2 + a running top-k, without the (Q, N) distance matrix.
//
// Replaces: src/repro/kernels/fused_topk.py, fused_topk_l2 (the
// pallas_call at line 85), over a float32 or float16 corpus (the Pallas
// body upcasts any corpus type; this one widens float16 as it multiplies).
//
// Bound on an H100: operations. At Q = 256, N = 1M, d = 128 the product is
// 2*Q*N*d = 67 GFLOP, taken on the tensor cores as 3xTF32 (float32 corpus:
// three TF32 passes, 0.40 ms at 495 TFLOP/s) or 2xTF32 (float16: 0.27 ms),
// against ~0.16 ms for its 0.5 GB of traffic (the corpus once; the output
// is (Q, k)). The tile is pairwise_tile.cuh's, so the distances are
// bit-equal to pairwise_l2_masked's and keep float32 accuracy.
//
// Design. The TPU kernel walks the corpus in a sequential grid and folds
// every block into one (Q, k) output block that all steps alias; a GPU grid
// runs its blocks in parallel, so the walk is split instead:
//
// 1. fused_topk_partial: a 2-D grid of (split, 64-query block). Each block
//    walks its contiguous range of 128-row corpus tiles with
//    pairwise_tile.cuh (tensor-core fragments fed by a two-stage ring of
//    16-byte cp.async copies that runs on across tiles; the queries are
//    split, and |q|^2 summed, once per call), masks each 64 x 128 distance
//    tile with the RR
//    predicate into shared memory, and folds it into a per-query top-k. The
//    top-k lists live in registers: warp w owns queries 8w..8w+7, and lane
//    p holds entry p of each, sorted by (dist, id). A chunk of 32
//    candidates is compared with the list's k-th entry in one ballot; each
//    survivor is inserted with a ballot (its rank), a popc and a
//    shuffle-up. The block writes its (64, k) lists as partials (Q, splits,
//    k).
// 2. fused_topk_merge: one warp per query folds the query's splits * k
//    partials the same way into the final (Q, k).
//
// The wrapper picks the split count so that the first grid is one wave of
// the card (blocks per SM at this kernel's occupancy, with its dynamic
// shared memory, times the SMs): every block walks the same number of
// tiles (to one), so no SM idles at the tail, and the corpus is read once.
// Order is (dist, id) compared as a pair, so ties go to the lowest id
// wherever the tied entries meet. A non-finite distance (a failed
// predicate, a NaN endpoint, a row past N) never enters a list; unfilled
// entries stay (NO_EDGE, +inf).
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "pairwise_tile.cuh"
#include "rr_predicate.cuh"

namespace {

using tile::BN;
using tile::BQ;
using tile::kOutPitch;
using tile::kThreads;

constexpr int kMaxK = 32;       // a list is one warp wide
constexpr int kNoEdge = -1;
constexpr int kWarps = tile::kWarps;
constexpr int kRowsPerWarp = BQ / kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Fold one candidate per lane into the warp's sorted list (lane p < k
// holds entry p). Warp-uniform: every lane calls it with the same k.
__device__ __forceinline__ void fold(float& ld, int& li, float cd, int ci,
                                     int k, int lane) {
  float wd = __shfl_sync(kFull, ld, k - 1);
  int wi = __shfl_sync(kFull, li, k - 1);
  unsigned m = __ballot_sync(kFull, before(cd, ci, wd, wi));
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const float bd = __shfl_sync(kFull, cd, b);
    const int bi = __shfl_sync(kFull, ci, b);
    if (!before(bd, bi, wd, wi)) continue;     // an earlier insert beat it
    // the entries before it form a prefix of the sorted list
    const int pos =
        __popc(__ballot_sync(kFull, lane < k && before(ld, li, bd, bi)));
    const float ud = __shfl_up_sync(kFull, ld, 1);
    const int ui = __shfl_up_sync(kFull, li, 1);
    if (lane == pos) {
      ld = bd;
      li = bi;
    } else if (lane > pos && lane < k) {
      ld = ud;
      li = ui;
    }
    wd = __shfl_sync(kFull, ld, k - 1);
    wi = __shfl_sync(kFull, li, k - 1);
  }
}

template <typename Row>
struct PartialSmem {
  tile::Smem<Row> t;
  float dt[BQ][kOutPitch];
};

template <typename Row, bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_topk_partial(const float* __restrict__ scratch,
                   const Row* __restrict__ corpus,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ ql, const float* __restrict__ qh,
                   float* __restrict__ part_d, int* __restrict__ part_i,
                   int Q, int N, int d, int mask, int k, int splits,
                   int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PartialSmem<Row>& s = *reinterpret_cast<PartialSmem<Row>*>(smem_raw);
  const tile::Split q = tile::split_planes(scratch, Q, d);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rq = tile::qrow(), rc = tile::ccol();
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tiles = (N + BN - 1) / BN;
  const int t0 = min(tiles, split * tiles_per_split);
  const int t1 = min(tiles, t0 + tiles_per_split);

  // this thread's fragment rows rq + 16 i + g + 8 h
  float qli[2][2], qhi[2][2], qn[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = min(q0 + rq + 16 * i + g + 8 * h, Q - 1);
      qli[i][h] = ql[gq];
      qhi[i][h] = qh[gq];
      qn[i][h] = q.qn[gq];
    }
  float ld[kRowsPerWarp];
  int li[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    ld[j] = CUDART_INF_F;
    li[j] = kNoEdge;
  }

  tile::walk<Row, kVec>(
      s.t, q, corpus, Q, N, d, t1 - t0,
      [=](int u) { return tile::At{q0, (t0 + u) * BN, true}; },
      [&](int u, const tile::Acc& acc) {
        const int n0 = (t0 + u) * BN;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = rc + 8 * j + 2 * t4;
          float lo_n[2], hi_n[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int gn = n0 + c + e;
            lo_n[e] = gn < N ? lo[gn] : CUDART_NAN_F;
            hi_n[e] = gn < N ? hi[gn] : CUDART_NAN_F;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rq + 16 * i + g + 8 * h;
              float2 v;
              v.x = rr::predicate(mask, lo_n[0], hi_n[0], qli[i][h],
                                  qhi[i][h])
                        ? tile::distance(qn[i][h], acc[i][j][2 * h],
                                         s.t.cn[c])
                        : CUDART_INF_F;
              v.y = rr::predicate(mask, lo_n[1], hi_n[1], qli[i][h],
                                  qhi[i][h])
                        ? tile::distance(qn[i][h], acc[i][j][2 * h + 1],
                                         s.t.cn[c + 1])
                        : CUDART_INF_F;
              *reinterpret_cast<float2*>(&s.dt[r][c]) = v;
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          if (q0 + r >= Q) continue;               // warp-uniform
#pragma unroll
          for (int c0 = 0; c0 < BN; c0 += 32)
            fold(ld[j], li[j], s.dt[r][c0 + lane], n0 + c0 + lane, k, lane);
        }
        // the walk's barrier comes before the next tile rewrites dt
      });

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int gq = q0 + warp * kRowsPerWarp + j;
    if (gq < Q && lane < k) {
      const long long o = (static_cast<long long>(gq) * splits + split) * k
                          + lane;
      part_d[o] = ld[j];
      part_i[o] = li[j];
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
fused_topk_merge(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, int Q, int splits, int k) {
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x)
                      * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (q >= Q) return;                            // the whole warp
  const long long total = static_cast<long long>(splits) * k;
  const float* pd = part_d + q * total;
  const int* pi = part_i + q * total;
  float ld = CUDART_INF_F;
  int li = kNoEdge;
  for (long long c0 = 0; c0 < total; c0 += 32) {
    const long long c = c0 + lane;
    const float cd = c < total ? pd[c] : CUDART_INF_F;
    const int ci = c < total ? pi[c] : kNoEdge;
    fold(ld, li, cd, ci, k, lane);
  }
  if (lane < k) {
    out_d[q * k + lane] = ld;
    out_i[q * k + lane] = li;
  }
}

// Dynamic shared memory of a fused_topk_partial block; the attribute is
// set before every launch and occupancy query.
template <typename Row, bool kVec>
int partial_smem() {
  const int bytes = static_cast<int>(sizeof(PartialSmem<Row>));
  const cudaError_t err = cudaFuncSetAttribute(
      fused_topk_partial<Row, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

template <typename Row, bool kVec>
cudaError_t launch_partial(dim3 grid, cudaStream_t st, const void* scratch,
                           const void* corpus, const void* lo,
                           const void* hi, const void* ql, const void* qh,
                           void* part_d, void* part_i, int Q, int N, int d,
                           int mask, int k, int splits, int per) {
  const int smem = partial_smem<Row, kVec>();
  if (smem < 0) return static_cast<cudaError_t>(-smem);
  fused_topk_partial<Row, kVec><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(scratch), static_cast<const Row*>(corpus),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(ql), static_cast<const float*>(qh),
      static_cast<float*>(part_d), static_cast<int*>(part_i), Q, N, d, mask,
      k, splits, per);
  return cudaGetLastError();
}

template <typename Row>
int launch(const void* queries, const void* corpus, const void* lo,
           const void* hi, const void* ql, const void* qh, void* part_d,
           void* part_i, void* out_d, void* out_i, void* scratch, int Q,
           int N, int d, int mask, int k, int splits, void* stream) {
  if (Q == 0) return 0;
  if (k < 1 || k > kMaxK || splits < 1 || N < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (static_cast<long long>(N) + BN - 1) / BN;
  const long long per = (tiles + splits - 1) / splits;
  const long long qblocks = (static_cast<long long>(Q) + BQ - 1) / BQ;
  if (qblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(qblocks));
  const long long row = static_cast<long long>(d) * sizeof(Row);
  const int p = static_cast<int>(per > 0 ? per : 1);
  cudaError_t err = tile::launch_split(queries, scratch, Q, d, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tile::vec16(scratch, 4LL * d) && tile::vec16(corpus, row)
            ? launch_partial<Row, true>(grid, st, scratch, corpus, lo, hi,
                                        ql, qh, part_d, part_i, Q, N, d, mask,
                                        k, splits, p)
            : launch_partial<Row, false>(grid, st, scratch, corpus, lo, hi,
                                         ql, qh, part_d, part_i, Q, N, d,
                                         mask, k, splits, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps_per_block = kMergeThreads / 32;
  const long long blocks = (Q + warps_per_block - 1) / warps_per_block;
  fused_topk_merge<<<static_cast<unsigned>(blocks), kMergeThreads, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), Q, splits, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename Row>
int slots() {
  int dev = 0, sms = 0, per_sm = 0;
  const int smem = partial_smem<Row, true>();
  if (smem < 0) return smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_topk_partial<Row, true>, kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * per_sm;
}

}  // namespace

// scratch: tile::scratch_floats(Q, d) floats for the split queries.
extern "C" int fused_topk_l2(const void* queries, const void* corpus,
                             const void* lo, const void* hi, const void* ql,
                             const void* qh, void* part_d, void* part_i,
                             void* out_d, void* out_i, void* scratch, int Q,
                             int N, int d, int mask, int k, int splits,
                             void* stream) {
  return launch<float>(queries, corpus, lo, hi, ql, qh, part_d, part_i, out_d,
                       out_i, scratch, Q, N, d, mask, k, splits, stream);
}

extern "C" int fused_topk_l2_f16(const void* queries, const void* corpus,
                                 const void* lo, const void* hi,
                                 const void* ql, const void* qh, void* part_d,
                                 void* part_i, void* out_d, void* out_i,
                                 void* scratch, int Q, int N, int d, int mask,
                                 int k, int splits, void* stream) {
  return launch<__half>(queries, corpus, lo, hi, ql, qh, part_d, part_i,
                        out_d, out_i, scratch, Q, N, d, mask, k, splits,
                        stream);
}

// Blocks of the first grid the current device runs at once (blocks per SM
// at its occupancy, times the SMs); a negative cudaError_t on failure.
extern "C" int fused_topk_l2_slots(int f16) {
  return f16 ? slots<__half>() : slots<float>();
}
