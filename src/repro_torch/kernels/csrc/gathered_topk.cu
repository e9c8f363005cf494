// Fused wavefront step: gather by id + squared L2 + label mask + beam merge.
//
// Replaces: src/repro/kernels/gathered_topk.py, gathered_topk (the
// pallas_call at line 130), one step of the MSTG beam search, and
// gathered_topk_quant (line 159, pallas_call at line 186), the same step
// over an int8 or float16 code table with per-dimension affine dequant
// params (x_hat = code * scale + offset).
//
// Bound on an H100: device-memory bytes (ops.gathered_stream_bytes). Per
// query the step reads the M candidate ids and labels (13 bytes each), the
// row of every candidate that survives the mask (d * itemsize bytes: 4
// float32, 2 float16, 1 int8), and the (L) beam in and out. There is almost
// no arithmetic (3*d flops per live candidate, 5*d on a code table). At the
// graph route's step on the 50k index (Q = 256, M = 4 * 497 = 1,988,
// L = 64) that is ~3.5 us: ~35 of a query's 1,988 candidates survive the
// mask, and ~55 entries of [beam | candidates] are finite.
//
// The first design ran one block of 256 threads per query: one warp per
// candidate for the mask and the distance, then L rounds of block-wide
// argmin over all L + M entries. It took 0.120-0.127 ms at that step in
// every tier. Its clock64() split there (median block, each tier):
// 59-61% of the cycles in the mask-and-distance loop, where each warp walks
// ~249 candidates one after another, each starting with four scalar loads
// that all 32 lanes issue to the same address; 38-41% in the argmin rounds
// (55 of the 64 ran before the early exit, each scanning 2,052 entries for
// ~55 finite ones); under 1% staging. (At n = 5,000, M = 368, the merge
// took 70%.) The row bytes set neither: the int8 and float16 tables took the
// same time as float32.
//
// This design makes the work follow the live entries:
//   1. Mask pass, one thread per candidate. A thread issues the id, avail
//      and label loads of its 8 candidates of a 2,048-candidate chunk
//      together (coalesced across the block), before the beam and the
//      query are staged, so one memory latency covers them all. Survivors
//      are compacted into shared memory in position order with warp
//      ballots and a scan over the (round, warp) counts: no atomics, so
//      the output is the same on every run.
//   2. Distances for the survivors only. A group of lanes reads a row in
//      16-byte loads (float32 at d = 128: 32 lanes x float4; float16: 16
//      lanes x 8 halves; int8: 8 lanes x 16 codes), each lane keeping 8
//      rows in flight; a ragged d or a row address that is not 16-byte
//      aligned takes the same path one element per load. A code is widened
//      to float in registers and dequantized as __fmul_rn then __fadd_rn:
//      nvcc may not contract that into an FMA, so x_hat is bit-equal to the
//      plain version's multiply-then-add (the distance sum itself is taken
//      in another order than the plain version's, within its 1e-5
//      tolerance).
//   3. Selection over the finite entries only. Each finite entry of
//      [beam | candidates] is a 64-bit key: order-preserving bits of the
//      distance above its position, so the lower position wins a tie, which
//      is lax.top_k's rule (beam entries beat candidates), and no two keys
//      are equal. The beam's finite entries (it need not be sorted) are
//      keyed first, then each chunk's survivors. When more than one chunk
//      remains to come, a bitonic network sorts the list and keeps its first
//      L as the running top-L. At the end, a list of at most 256 keys (the
//      route's steps) is placed by rank: each thread counts the keys below
//      its own, and that count is its output slot, with no sort; a longer
//      list is sorted by the bitonic network. Slots past the finite entries
//      get (NO_EDGE, +inf, 0).
// At the route's step this takes 0.012-0.014 ms in every tier, ~11,000
// cycles a block (PERF.md). The launch bounds hold a thread to 128
// registers, so two blocks fit an SM and Q = 256 runs as one wave on 132
// SMs (at the ~170 registers nvcc chose unbounded, one block fit an SM and
// the launch took two waves).
// Shared memory: q (+ scale and offset on a code table), then one 8-byte
// slot per list entry for L + min(M, 2,048) entries; a survivor's slot
// holds (id, position) until its distance replaces it with its key. That
// is less than the first design's 12 bytes per entry of L + M, so every
// step it took still fits; above 48 KB the launcher opts in with
// cudaFuncSetAttribute, and it refuses sizes above the 227 KB a block can
// have.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                    // candidates a thread loads at once
constexpr int kChunk = kThreads * kRounds;    // candidates compacted per pass
constexpr int kRowsInFlight = 8;              // rows a lane reads at once
constexpr int kMaxShared = 232448;
constexpr int kNoEdge = -1;
constexpr unsigned long long kEmpty = ~0ull;  // after every finite key
static_assert(kRounds * kWarps == 64, "the count scan takes two per lane");

__device__ __forceinline__ unsigned long long make_key(float dist, int pos) {
  unsigned u = __float_as_uint(dist == 0.f ? 0.f : dist);   // -0 ties +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ float key_dist(unsigned long long key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_pos(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffu);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// Writes val[u] for every set ok[u] to dst[0 .. count), in item order
// (item u * kThreads + threadIdx.x), and returns count in every thread.
// Warp ballots, then one warp scans the (round, warp) counts: no atomics.
__device__ __forceinline__ int compact(const bool (&ok)[kRounds],
                                       const unsigned long long (&val)[kRounds],
                                       unsigned long long* dst, int* scan_s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned bal[kRounds];
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    bal[u] = __ballot_sync(0xffffffffu, ok[u]);
    if (lane == 0) scan_s[u * kWarps + warp] = __popc(bal[u]);
  }
  __syncthreads();
  if (warp == 0) {
    const int a = scan_s[2 * lane];
    const int b = scan_s[2 * lane + 1];
    int incl = a + b;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    scan_s[2 * lane] = incl - a - b;
    scan_s[2 * lane + 1] = incl - b;
    if (lane == 31) scan_s[kRounds * kWarps] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kRounds; ++u)
    if (ok[u]) dst[scan_s[u * kWarps + warp] + __popc(bal[u] & below)] = val[u];
  const int count = scan_s[kRounds * kWarps];
  __syncthreads();  // scan_s is written again by the next call
  return count;
}

// The id, avail and label words of one chunk's candidates, kRounds a thread.
struct ChunkLoads {
  int id[kRounds], lb[kRounds], le[kRounds];
  unsigned char av[kRounds];
};

__device__ __forceinline__ void load_chunk(
    ChunkLoads& c, const int* ids, const unsigned char* avail,
    const int* lab_b, const int* lab_e, long long row0, int c0, int M) {
#pragma unroll
  for (int u = 0; u < kRounds; ++u) {
    const int j = c0 + u * kThreads + threadIdx.x;
    const bool in = j < M;
    const long long g = row0 + j;
    c.id[u] = in ? ids[g] : kNoEdge;
    c.av[u] = in ? avail[g] : 0;
    c.lb[u] = in ? lab_b[g] : 0;
    c.le[u] = in ? lab_e[g] : 0;
  }
}

// Squared L2 from q to the rows of the ns survivors whose (id, position)
// sit in slots[0 .. ns); each slot is replaced by the survivor's key, or by
// kEmpty where the distance is not finite. kVec: rows are read 16 bytes a
// load (the launcher checks d * sizeof(Row) % 16 == 0 and the table's
// alignment); otherwise one element a load.
template <typename Row, bool kQuant, bool kVec>
__device__ __forceinline__ void distances(
    const Row* __restrict__ table, int d, const float* q_s,
    const float* sc_s, const float* of_s, unsigned long long* slots,
    int ns) {
  using Load = typename std::conditional<kVec, uint4, Row>::type;
  constexpr int V = sizeof(Load) / sizeof(Row);  // elements per load
  const int nload = d / V;
  int G = 1;                                     // lanes per row
  while (G < nload && G < 32) G <<= 1;
  const int P = 32 / G;                          // rows per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int sub = lane - grp * G;
  const int stride = kWarps * P;                 // rows per block per step
  for (int base = 0; base < ns; base += stride * kRowsInFlight) {
    int rid[kRowsInFlight];                      // row id, -1: no row
    float acc[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const int s = base + r * stride + warp * P + grp;
      rid[r] = s < ns ? static_cast<int>(slots[s] >> 32) : -1;
      acc[r] = 0.f;
    }
    for (int c = sub; c < nload; c += G) {
      Load raw[kRowsInFlight];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        if (rid[r] >= 0)
          raw[r] = reinterpret_cast<const Load*>(
              table + static_cast<long long>(rid[r]) * d)[c];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (rid[r] < 0) continue;
        const Row* e = reinterpret_cast<const Row*>(&raw[r]);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const int k = c * V + t;
          float x = widen(e[t]);
          if (kQuant) x = __fadd_rn(__fmul_rn(x, sc_s[k]), of_s[k]);
          const float diff = x - q_s[k];
          acc[r] = fmaf(diff, diff, acc[r]);
        }
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    __syncwarp();  // every lane of a group has read its slot
    if (sub == 0) {
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (rid[r] < 0) continue;
        const int s = base + r * stride + warp * P + grp;
        slots[s] = isfinite(acc[r]) ? make_key(acc[r], key_pos(slots[s]))
                                    : kEmpty;
      }
    }
  }
}

// Sorts keys[0 .. count) ascending and returns how many of the first L
// are finite (not kEmpty). A bitonic network over the next power of two
// whose comparators all put the smaller key at the lower index: the
// entries past count would be kEmpty and never move, so any comparator
// that reaches past count is skipped.
__device__ int select_top(unsigned long long* keys, int count, int L,
                          int* nfin_s) {
  int P2 = 1;
  while (P2 < count) P2 <<= 1;
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (P2 >> 1); i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = (j == (k >> 1)) ? (lo ^ (k - 1)) : (lo + j);
        if (hi < count) {
          const unsigned long long a = keys[lo];
          const unsigned long long b = keys[hi];
          if (b < a) {
            keys[lo] = b;
            keys[hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) *nfin_s = count;
  __syncthreads();
  const int lim = min(count, L + 1);
  for (int i = threadIdx.x; i < lim; i += kThreads)
    if (keys[i] == kEmpty && (i == 0 || keys[i - 1] != kEmpty)) *nfin_s = i;
  __syncthreads();
  const int ntop = min(*nfin_s, L);
  __syncthreads();  // *nfin_s is written again by the next call
  return ntop;
}

// One block per query. kQuant: the table holds codes, dequantized with the
// (d,) scale/offset.
template <typename Row, bool kQuant, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) gathered_topk_kernel(
    const float* __restrict__ queries, const Row* __restrict__ table,
    const float* __restrict__ scale, const float* __restrict__ offset,
    const int* __restrict__ ids, const unsigned char* __restrict__ avail,
    const int* __restrict__ lab_b, const int* __restrict__ lab_e,
    const int* __restrict__ version, const int* __restrict__ pool_ids,
    const float* __restrict__ pool_d, const unsigned char* __restrict__ pool_exp,
    int* __restrict__ out_ids, float* __restrict__ out_d,
    unsigned char* __restrict__ out_exp, int n, int d, int M, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);     // d
  float* sc_s = q_s + d;                           // d (code tables only)
  float* of_s = sc_s + (kQuant ? d : 0);           // d (code tables only)
  const int planes = kQuant ? 3 : 1;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(
      smem + ((planes * d * 4 + 7) & ~7));         // L + min(M, kChunk)
  __shared__ int scan_s[kRounds * kWarps + 1];
  __shared__ int nfin_s;

  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const long long qoff = qi;
  const long long crow = qoff * M;
  const int ver = version[qi];

  // the first chunk's loads go out first; the beam and q follow
  ChunkLoads cl;
  load_chunk(cl, ids, avail, lab_b, lab_e, crow, 0, M);
  for (int k = tid; k < d; k += kThreads) {
    q_s[k] = queries[qoff * d + k];
    if (kQuant) {
      sc_s[k] = scale[k];
      of_s[k] = offset[k];
    }
  }

  // the beam's finite entries, keyed at their positions 0 .. L-1
  int count = 0;                                   // entries in keys[]
  for (int j0 = 0; j0 < L; j0 += kChunk) {
    bool ok[kRounds];
    unsigned long long val[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int j = j0 + u * kThreads + tid;
      const float x = j < L ? pool_d[qoff * L + j] : CUDART_INF_F;
      ok[u] = isfinite(x);
      val[u] = make_key(x, j);
    }
    count += compact(ok, val, keys + count, scan_s);
  }

  for (int c0 = 0; c0 < M; c0 += kChunk) {
    bool ok[kRounds];
    unsigned long long val[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int id = cl.id[u];
      ok[u] = (cl.av[u] != 0) & (id >= 0) & (id < n) & (cl.lb[u] <= ver) &
              (ver <= cl.le[u]);
      val[u] = (static_cast<unsigned long long>(static_cast<unsigned>(id))
                << 32) |
               static_cast<unsigned>(L + c0 + u * kThreads + tid);
    }
    const int ns = compact(ok, val, keys + count, scan_s);
    distances<Row, kQuant, kVec>(table, d, q_s, sc_s, of_s, keys + count, ns);
    __syncthreads();
    count += ns;
    if (c0 + kChunk < M) {
      // keep the running top L sorted at the front, room for a chunk after
      if (count > L) count = select_top(keys, count, L, &nfin_s);
      load_chunk(cl, ids, avail, lab_b, lab_e, crow, c0 + kChunk, M);
    }
  }

  // keys[0 .. count) hold every entry still in the running (in no order,
  // kEmpty where a distance was not finite); out[i] gets the key of rank i
  auto put = [&](int i, unsigned long long key) {
    const long long o = qoff * L + i;
    const int pos = key_pos(key);
    out_d[o] = key_dist(key);
    if (pos < L) {
      out_ids[o] = pool_ids[qoff * L + pos];
      out_exp[o] = pool_exp[qoff * L + pos] != 0;
    } else {
      out_ids[o] = ids[crow + (pos - L)];
      out_exp[o] = 0;
    }
  };
  int nfin;
  if (count <= kThreads) {
    // one key a thread: its rank is how many keys are below it (keys are
    // distinct, their positions differ), so no sort is needed
    const unsigned long long key = tid < count ? keys[tid] : kEmpty;
    int rank = 0;
    if (key != kEmpty)
      for (int i = 0; i < count; ++i) rank += keys[i] < key;
    nfin = __syncthreads_count(key != kEmpty);
    if (key != kEmpty && rank < L) put(rank, key);
  } else {
    nfin = select_top(keys, count, L, &nfin_s);
    for (int i = tid; i < nfin; i += kThreads) put(i, keys[i]);
  }
  for (int i = nfin + tid; i < L; i += kThreads) {
    const long long o = qoff * L + i;
    out_d[o] = CUDART_INF_F;
    out_ids[o] = kNoEdge;
    out_exp[o] = 0;
  }
}

template <typename Row, bool kQuant, bool kVec>
int launch_as(const void* queries, const void* table, const void* scale,
              const void* offset, const void* ids, const void* avail,
              const void* lab_b, const void* lab_e, const void* version,
              const void* pool_ids, const void* pool_d, const void* pool_exp,
              void* out_ids, void* out_d, void* out_exp, int Q, int n, int d,
              int M, int L, int smem, cudaStream_t stream) {
  auto kernel = gathered_topk_kernel<Row, kQuant, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<Q, kThreads, smem, stream>>>(
      static_cast<const float*>(queries), static_cast<const Row*>(table),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<const int*>(ids), static_cast<const unsigned char*>(avail),
      static_cast<const int*>(lab_b), static_cast<const int*>(lab_e),
      static_cast<const int*>(version), static_cast<const int*>(pool_ids),
      static_cast<const float*>(pool_d),
      static_cast<const unsigned char*>(pool_exp), static_cast<int*>(out_ids),
      static_cast<float*>(out_d), static_cast<unsigned char*>(out_exp), n, d,
      M, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename Row, bool kQuant>
int launch(const void* queries, const void* table, const void* scale,
           const void* offset, const void* ids, const void* avail,
           const void* lab_b, const void* lab_e, const void* version,
           const void* pool_ids, const void* pool_d, const void* pool_exp,
           void* out_ids, void* out_d, void* out_exp, int Q, int n, int d,
           int M, int L, void* stream) {
  if (Q == 0 || L == 0) return 0;
  // q (+ scale, offset), 8-byte aligned, then one key per list entry
  const long long smem = ((static_cast<long long>(kQuant ? 3 : 1) * d * 4 + 7) & ~7LL) +
                         8LL * (L + (M < kChunk ? M : kChunk));
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   (static_cast<long long>(d) * sizeof(Row)) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    return launch_as<Row, kQuant, true>(queries, table, scale, offset, ids,
                                        avail, lab_b, lab_e, version, pool_ids,
                                        pool_d, pool_exp, out_ids, out_d,
                                        out_exp, Q, n, d, M, L,
                                        static_cast<int>(smem), s);
  return launch_as<Row, kQuant, false>(queries, table, scale, offset, ids,
                                       avail, lab_b, lab_e, version, pool_ids,
                                       pool_d, pool_exp, out_ids, out_d,
                                       out_exp, Q, n, d, M, L,
                                       static_cast<int>(smem), s);
}

}  // namespace

extern "C" int gathered_topk(const void* queries, const void* table,
                             const void* ids, const void* avail,
                             const void* lab_b, const void* lab_e,
                             const void* version, const void* pool_ids,
                             const void* pool_d, const void* pool_exp,
                             void* out_ids, void* out_d, void* out_exp, int Q,
                             int n, int d, int M, int L, void* stream) {
  return launch<float, false>(queries, table, nullptr, nullptr, ids, avail,
                              lab_b, lab_e, version, pool_ids, pool_d,
                              pool_exp, out_ids, out_d, out_exp, Q, n, d, M,
                              L, stream);
}

// The quantized step; the arguments follow gathered_topk's, with the (d,)
// float32 scale and offset after the code table.
#define GATHERED_TOPK_QUANT(NAME, ROW)                                         \
  extern "C" int NAME(const void* queries, const void* codes,                 \
                      const void* scale, const void* offset, const void* ids, \
                      const void* avail, const void* lab_b,                   \
                      const void* lab_e, const void* version,                 \
                      const void* pool_ids, const void* pool_d,               \
                      const void* pool_exp, void* out_ids, void* out_d,       \
                      void* out_exp, int Q, int n, int d, int M, int L,       \
                      void* stream) {                                         \
    return launch<ROW, true>(queries, codes, scale, offset, ids, avail, lab_b, \
                           lab_e, version, pool_ids, pool_d, pool_exp,        \
                           out_ids, out_d, out_exp, Q, n, d, M, L, stream);   \
  }

GATHERED_TOPK_QUANT(gathered_topk_quant_int8, int8_t)
GATHERED_TOPK_QUANT(gathered_topk_quant_f16, __half)
