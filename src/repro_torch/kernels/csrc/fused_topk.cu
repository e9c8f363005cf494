// Exact filtered k-NN in one pass over the corpus: RR predicate + squared
// L2 + a running top-k, without the (Q, N) distance matrix.
//
// Replaces: src/repro/kernels/fused_topk.py, fused_topk_l2 (the
// pallas_call at line 85), over a float32 or float16 corpus (the Pallas
// body upcasts any corpus type; this one widens float16 as it multiplies).
//
// Bound on an H100: operations. At Q = 256, N = 1M, d = 128 the product is
// 2*Q*N*d = 67 GFLOP, taken on the tensor cores as 3xTF32 (float32 corpus:
// three TF32 passes, 0.397 ms at 495 TFLOP/s) or 2xTF32 (float16: 0.27
// ms), against ~0.16 ms for its 0.5 GB of traffic (the corpus once; the
// output is (Q, k)). The tile is pairwise_tile.cuh's, so the distances are
// bit-equal to pairwise_l2_masked's and keep float32 accuracy.
//
// What held the first design back (PERF.md, chip_smoke.py's scan_sweep on
// an H100 at 700 W): 2.46 ms at the shape above, 1.26 ms of it already at
// d = 16, against ~0.37 ms of product per 32 values of d. Its epilogue
// evaluated the predicate and the distance of all 64 x 128 entries of a
// tile into a 34.8 KB shared tile, then every warp folded all 128 columns
// of its 8 queries in chunks of 32 (two shuffles for the k-th entry and a
// ballot each): Q*N/32 = 8.2M warp-level fold rounds a call, of which
// almost none insert anything (a running top-10 admits ~k(1 + ln(m/k)) =
// ~70 of the ~3k qualifying rows a split walks). The shared tile and 205
// registers held it to one block per SM, so nothing kept the tensor cores
// busy while the block's 8 warps masked and folded.
//
// Design. The TPU kernel walks the corpus in a sequential grid and folds
// every block into one (Q, k) output block that all steps alias; a GPU grid
// runs its blocks in parallel, so the walk is split instead:
//
// 1. fused_topk_partial: a 2-D grid of (split, 64-query block). Each block
//    walks its contiguous range of 128-row corpus tiles with
//    pairwise_tile.cuh (tensor-core fragments fed by a two-stage ring of
//    16-byte cp.async copies that runs on across tiles). Each query row's
//    top-k list, sorted by (dist, id), lives in shared memory with its k-th
//    distance; warp w owns rows 8w..8w+7. Each tile's epilogue scores,
//    filters, then folds only the survivors:
//    - each thread forms the distances of its 32 fragment entries from its
//      accumulators (tile::distance, so they stay bit-equal to the scan's)
//      and compares each with its row's k-th distance: one compare an
//      entry, and a 32-bit mask of the entries that reach it;
//    - only those are tested against the RR predicate (the tile's lo and
//      hi were staged in shared memory a tile ahead) and appended to the
//      row's survivor queue with a shared atomic;
//    - the queue is folded at the start of the next tile's epilogue by the
//      warp that owns the row (two queue buffers, by tile parity), so the
//      fold needs no barrier of its own; the owner keeps the k-th entry in
//      a register as it inserts and publishes the new k-th distance.
//    A tile in which no entry reaches its row's k-th distance costs the
//    distances, 32 compares a thread and one block-wide vote.
// 2. fused_topk_merge: one warp per query folds the query's splits * k
//    partials the same way into the final (Q, k).
//
// Why the filter is exact: a row's k-th distance only falls, so an entry
// that does not reach it now would never enter the list later, and one
// read a tile late (another warp's row not yet folded) only admits more;
// the fold itself orders by (dist, id), a total order over distinct ids,
// so neither the order of the appends nor a tie at the k-th distance can
// change the list; NaN and +inf never reach a finite k-th distance and
// never beat (+inf, NO_EDGE) in the fold, so a non-finite distance (a NaN
// row, a padded row) never enters. Rows past Q get a k-th distance of
// -inf and columns past N are dropped, so neither is ever offered.
// Unfilled entries stay (NO_EDGE, +inf).
//
// Queue overflow. In a split's first tiles the k-th distance is still
// +inf, so all 128 qualifying entries of a row can survive (and, on a
// corpus whose distance falls as the id grows, in every tile). Two queues
// sized to a tile row (128 KB for the block) would not fit two blocks per
// SM, so a row's queue holds kQueue = 16 entries a tile, and an entry that
// finds it full stays pending in its thread: the block votes after the
// offers, and if any entry waits, every row's queue is folded at once and
// the waiting entries are offered again against the new k-th distances,
// until none waits.
//
// Occupancy. Without a shared distance tile a block needs 107 KB of
// shared memory (float32 corpus), so two blocks fit on an SM when the
// kernel keeps to 128 registers a thread (__launch_bounds__(kThreads, 2)):
// one block's epilogue then runs under the other's product. Two blocks per
// SM measured faster than one at every d and for both corpus types
// (PERF.md, kernel 7's findings). The wrapper asks the card for the blocks
// it runs at once (fused_topk_l2_slots), so that the split count makes the
// first grid one wave: every block walks the same number of tiles (to
// one), no SM idles at the tail, and the corpus is read once.
//
// What the designs tried before this one taught (PERF.md): a
// per-survivor pass that indexed the 32 distances at run time spilled them
// to local memory; folding in place behind two more barriers a tile, or
// under a per-row lock by whichever warp held the survivor, cost more than
// the deferred fold by the owner; a bitonic merge of full queues and
// dealing the rows to fold evenly across warps did not pay.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "pairwise_tile.cuh"
#include "rr_predicate.cuh"

namespace {

using tile::BN;
using tile::BQ;
using tile::kThreads;

constexpr int kMaxK = 32;       // a list is one warp wide
constexpr int kQueue = 16;      // survivors a row holds per tile parity
constexpr int kNoEdge = -1;
constexpr int kWarps = tile::kWarps;
constexpr int kRowsPerWarp = BQ / kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeThreads = 128;
static_assert(kThreads == 2 * BN, "a thread stages one end of one column");

__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Fold one candidate per lane into the warp's sorted list (lane p < k
// holds entry p); (wd, wi), the list's k-th entry, is kept in step.
// Warp-uniform: every lane calls it with the same k.
__device__ __forceinline__ void fold(float& ld, int& li, float& wd, int& wi,
                                     float cd, int ci, int k, int lane) {
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
  float list_d[BQ][kMaxK];       // row r's top-k, sorted by (dist, id)
  int list_i[BQ][kMaxK];
  float queue_d[2][BQ][kQueue];  // row r's survivors, by tile parity
  int queue_i[2][BQ][kQueue];
  int count[2][BQ];              // survivors offered to row r (may pass
                                 // kQueue: the rest wait)
  float ends[2][BN];             // lo and hi of the tile's columns
  float kth_d[BQ];               // row r's k-th distance
  float qn[BQ];                  // row r's |q|^2 and query range
  float ql[BQ];
  float qh[BQ];
};

// Bit of fragment entry (i, h, j, e) in a thread's pending mask: row
// qrow + 16 i + g + 8 h, column ccol + 8 j + 2 t + e (pairwise_tile.cuh).
__device__ __forceinline__ int entry(int i, int h, int j, int e) {
  return ((i * 2 + h) * 4 + j) * 2 + e;
}

// v[b] for a b known only at run time, without leaving registers: a tree
// of selects on b's bits (every loop has a constant trip count, so it
// unrolls and nothing is indexed at run time).
__device__ __forceinline__ float pick(const float (&v)[32], int b) {
  float a[16], c[8], e[4], f[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = (b & 1) ? v[2 * i + 1] : v[2 * i];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = (b & 2) ? a[2 * i + 1] : a[2 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = (b & 4) ? c[2 * i + 1] : c[2 * i];
#pragma unroll
  for (int i = 0; i < 2; ++i) f[i] = (b & 8) ? e[2 * i + 1] : e[2 * i];
  return (b & 16) ? f[1] : f[0];
}

// The end of column threadIdx.x % BN of corpus tile `tile` that this
// thread stages: lo for the first BN threads, hi for the rest (NaN past N,
// which fails every predicate).
__device__ __forceinline__ float tile_end(const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          int tile, int N) {
  const long long gn =
      static_cast<long long>(tile) * BN + (threadIdx.x & (BN - 1));
  return gn < N ? (threadIdx.x < BN ? lo : hi)[gn] : CUDART_NAN_F;
}

// Warp `warp` folds queue buffer `b` of each of its rows into the row's
// list, publishes the row's k-th distance and empties the queue.
template <typename Row>
__device__ __forceinline__ void fold_rows(PartialSmem<Row>& s, int b,
                                          int warp, int lane, int k) {
  // which of the warp's rows have survivors: one read of the counts
  const int r0 = warp * kRowsPerWarp;
  unsigned rows = __ballot_sync(
      kFull, lane < kRowsPerWarp && s.count[b][r0 + (lane & 7)] > 0);
  for (; rows; rows &= rows - 1) {
    const int r = r0 + __ffs(rows) - 1;
    const int n = min(s.count[b][r], kQueue);
    float ld = s.list_d[r][lane];
    int li = s.list_i[r][lane];
    float wd = __shfl_sync(kFull, ld, k - 1);
    int wi = __shfl_sync(kFull, li, k - 1);
    fold(ld, li, wd, wi, lane < n ? s.queue_d[b][r][lane] : CUDART_INF_F,
         lane < n ? s.queue_i[b][r][lane] : kNoEdge, k, lane);
    s.list_d[r][lane] = ld;
    s.list_i[r][lane] = li;
    __syncwarp();                                // every lane read count
    if (lane == 0) {
      s.kth_d[r] = wd;
      s.count[b][r] = 0;
    }
  }
}

template <typename Row, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
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

  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int gq = min(q0 + r, Q - 1);
    s.qn[r] = q.qn[gq];
    s.ql[r] = ql[gq];
    s.qh[r] = qh[gq];
    // no entry reaches a row past Q
    s.kth_d[r] = q0 + r < Q ? CUDART_INF_F : -CUDART_INF_F;
    s.count[0][r] = 0;
    s.count[1][r] = 0;
  }
  // a row's list is only ever touched by its own warp, lane p at entry p
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    s.list_d[warp * kRowsPerWarp + j][lane] = CUDART_INF_F;
    s.list_i[warp * kRowsPerWarp + j][lane] = kNoEdge;
  }
  // the first tile's ends now; each epilogue stages the next tile's, loaded
  // a tile ahead
  s.ends[threadIdx.x / BN][threadIdx.x % BN] = tile_end(lo, hi, t0, N);
  float next_end = tile_end(lo, hi, t0 + 1, N);
  // the walk's first barrier publishes all of it

  tile::walk<Row, kVec>(
      s.t, q, corpus, Q, N, d, t1 - t0,
      [=](int u) { return tile::At{q0, (t0 + u) * BN, true}; },
      [&](int u, const tile::Acc& acc) {
        const int n0 = (t0 + u) * BN;
        const int cur = u & 1;
        // the previous tile's survivors into this warp's lists: their
        // offers lie behind the walk's barriers, and this tile's go to the
        // other buffer
        fold_rows(s, cur ^ 1, warp, lane, k);
        // the distances, each against its row's k-th distance (another
        // warp's row may lag a tile, which only admits more): only an
        // entry that reaches it can survive
        float dist[32];                 // by entry(i, h, j, e)
        unsigned pend = 0u;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rq + 16 * i + g + 8 * h;
            const float qn = s.qn[r];
            const float kd = s.kth_d[r];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 cn =
                  *reinterpret_cast<const float2*>(&s.t.cn[rc + 8 * j + 2 * t4]);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float dv = tile::distance(qn, acc[i][j][2 * h + e],
                                                e ? cn.y : cn.x);
                dist[entry(i, h, j, e)] = dv;
                if (dv <= kd) pend |= 1u << entry(i, h, j, e);  // not NaN
              }
            }
          }
        if (pend && n0 + BN > N) {      // the last tile: no column past N
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n0 + rc + 8 * j + 2 * t4 + e >= N)
                pend &= ~(0x01010101u << (2 * j + e));
        }
        for (;;) {
          // offer each pending entry that still reaches its row's k-th
          // distance and passes the predicate; the rest leave for good
          for (unsigned todo = pend; todo; todo &= todo - 1) {
            const int b = __ffs(todo) - 1;
            const int r = rq + 16 * (b >> 4) + g + 8 * ((b >> 3) & 1);
            const int c = rc + 8 * ((b >> 1) & 3) + 2 * t4 + (b & 1);
            const float dv = pick(dist, b);
            if (dv <= s.kth_d[r] &&
                rr::predicate(mask, s.ends[0][c], s.ends[1][c], s.ql[r],
                              s.qh[r])) {
              const int slot = atomicAdd(&s.count[cur][r], 1);
              if (slot >= kQueue) continue;        // full: after a fold
              s.queue_d[cur][r][slot] = dv;
              s.queue_i[cur][r][slot] = n0 + c;
            }
            pend &= ~(1u << b);
          }
          if (!__syncthreads_or(pend != 0u)) break;
          // a queue overflowed (a split's first tiles, or a corpus whose
          // distance keeps falling): fold this tile's queues now, then
          // offer what waits against the new k-th distances
          fold_rows(s, cur, warp, lane, k);
          __syncthreads();
        }
        // every read of this tile's ends lies behind the last barrier; the
        // walk's barriers publish the next tile's before its epilogue
        s.ends[threadIdx.x / BN][threadIdx.x % BN] = next_end;
        next_end = tile_end(lo, hi, t0 + u + 2, N);
      });

  // the last tile's survivors (behind its epilogue's last barrier)
  if (t1 > t0) fold_rows(s, (t1 - t0 - 1) & 1, warp, lane, k);
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    if (q0 + r < Q && lane < k) {
      const long long o =
          (static_cast<long long>(q0 + r) * splits + split) * k + lane;
      part_d[o] = s.list_d[r][lane];
      part_i[o] = s.list_i[r][lane];
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
  float ld = CUDART_INF_F, wd = CUDART_INF_F;
  int li = kNoEdge, wi = kNoEdge;
  // each chunk's loads are in flight while the one before it folds
  float cd = lane < total ? pd[lane] : CUDART_INF_F;
  int ci = lane < total ? pi[lane] : kNoEdge;
  for (long long c0 = 0; c0 < total; c0 += 32) {
    const long long c = c0 + 32 + lane;
    const float nd = c < total ? pd[c] : CUDART_INF_F;
    const int ni = c < total ? pi[c] : kNoEdge;
    fold(ld, li, wd, wi, cd, ci, k, lane);
    cd = nd;
    ci = ni;
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
            ? launch_partial<Row, true>(
                  grid, st, scratch, corpus, lo, hi, ql, qh, part_d, part_i,
                  Q, N, d, mask, k, splits, p)
            : launch_partial<Row, false>(
                  grid, st, scratch, corpus, lo, hi, ql, qh, part_d, part_i,
                  Q, N, d, mask, k, splits, p);
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
// at the kernel's occupancy, times the SMs); a negative cudaError_t on
// failure.
extern "C" int fused_topk_l2_slots(int f16) {
  return f16 ? slots<__half>() : slots<float>();
}
