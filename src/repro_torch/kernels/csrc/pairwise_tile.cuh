// One 64 x 128 tile of q.c on the H100's tensor cores, and the ring of
// asynchronous copies that feeds it. Shared by the masked scan
// (pairwise_l2.cu), which writes every tile out, and the fused top-k
// (fused_topk.cu), which folds each tile into a running top-k; both get
// bit-equal distances from it. The int8 scan (pairwise_l2_int8.cu) uses
// the copy helpers and the ring only.
//
// Product: mma.sync.m16n8k8 in TF32 with fp32 accumulators, split so that
// the result keeps float32 accuracy (3xTF32). Each float32 value x is cut
// into big = rna_tf32(x) and small = rna_tf32(x - big) (cvt.rna.tf32.f32's
// rounding, done with integer ops); per step of 8 over d a warp forms
// small_q.big_c, then big_q.small_c, then big_q.big_c in fresh
// accumulators (the small.small term is below float32's rounding), and
// adds them to its running sums with IEEE round-to-nearest adds. The
// tensor cores' own accumulation truncates toward zero: carried across all
// of d it drifted 1e-4 on the cross term of a row with itself (|q|^2 =
// 128), which breaks the 1e-4 limit at distance 0; a step's sum of 8
// products is small enough for its truncation not to show. One TF32 pass
// alone keeps ~11 bits and misses the flat route's 1e-4 limit against
// float64 (tests/test_torch_tf32_split.py measures both). A float16 corpus
// value converts to TF32 exactly, so its small part is 0 and two passes do:
// small_q.c, then big_q.c.
//
// The instruction is the warp-level mma.sync, not Hopper's warpgroup
// wgmma. Two wgmma m64n64k8 versions of this tile gave the same answers
// but ran slower: one with both operands in shared memory (no-swizzle
// K-major layout; the corpus slice split there by the whole block, an
// extra pass and barrier every step), and one with the corpus fragments
// split in registers (wgmma's register-A form) against the query planes
// in shared memory, where each warpgroup waits on its partial sums every
// 16 values of d. PERF.md has the measured split of the time.
//
// The queries' split is taken once per call, by split_queries, a small
// launch before the tile kernel: it writes big and small (Q, d) planes and
// |q|^2 into scratch the wrapper allocates, so the four warps that share a
// query fragment do not each split it again. A corpus value is split where
// its fragment is read.
//
// Layout: a 256-thread block is 8 warps, 2 along the queries by 4 along the
// corpus, each owning a 32 x 32 sub-tile as 2 x 4 m16n8 fragments. Queries
// (Q, d) and corpus (N, d) are both K-major, which is what the row.col
// instruction reads, so nothing is transposed. Each step over d stages a
// (64, 32) slice of each query plane and a (128, 32) slice of the corpus in
// shared memory, rows padded by 16 bytes so that fragment reads hit 32
// distinct banks. The copies are 16-byte cp.async with zero-fill, through a
// ring of kStages buffers that runs straight across tile boundaries: the
// next tile's first slices are in flight while a tile's epilogue runs. The
// 16-byte path is taken only when each row is a whole number of 16-byte
// pieces and both bases start on 16 bytes; otherwise an element path fills
// the same buffers. Rows past Q or N and columns past d are zeros.
//
// Norms: |q|^2 (split_queries, once per row) and |c|^2 (from the staged
// slices, once per row per block: the caller says which tiles need it) are
// fp32 sums over d in steps of 8, as the cross term is (add_squares), in
// the same order for every row wherever it lies: equal rows get equal
// distances and ties go to the lowest id, as in the plain version, and a
// row's distance to itself is the difference of two sums rounded alike.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile {

constexpr int BQ = 64;            // query rows of a tile
constexpr int BN = 128;           // corpus rows of a tile
constexpr int BK = 32;            // elements of d per step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kOutPitch = BN + 8; // floats a row of an epilogue tile

// ---- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;       // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The kStages ring: issue(step) starts the copies of one step into buffer
// step % kStages, consume(step) reads that buffer once every thread's
// copies have landed. Every thread of the block must call it.
template <typename Issue, typename Consume>
__device__ __forceinline__ void ring(int steps, Issue issue,
                                     Consume consume) {
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < steps) issue(p);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    if (step + kStages - 1 < steps) issue(step + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    consume(step);
    __syncthreads();   // the buffer is free for the copies of step + kStages
  }
  cp_async_wait<0>();
}

// True when rows of `bytes_per_row` bytes from `p` can move in 16-byte
// pieces.
__device__ __host__ __forceinline__ bool vec16(const void* p,
                                               long long bytes_per_row) {
  return bytes_per_row % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- the tensor-core product -----------------------------------------------

// cvt.rna.tf32.f32 on the integer pipe, bit for bit for finite x: add
// half a TF32 ulp to the magnitude and drop the 13 low bits (ties away from
// zero). Two integer ops instead of a conversion, which runs at a quarter
// of their rate.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}


template <typename Row>
struct Stage {
  float qb[BQ][BK + 4];       // the queries' big plane
  float qs[BQ][BK + 4];       // and small plane
  Row c[BN][BK + 16 / sizeof(Row)];
};

template <typename Row>
struct Smem {
  Stage<Row> st[kStages];
  float cn[BN];
};

// The query planes split_queries writes: big, small and |q|^2, in scratch of
// scratch_floats(Q, d) floats (each plane starts on 16 bytes).
struct Split {
  const float* big;
  const float* small;
  const float* qn;
};

__host__ __device__ __forceinline__ long long plane_floats(int Q, int d) {
  return (static_cast<long long>(Q) * d + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ long long scratch_floats(int Q, int d) {
  return 2 * plane_floats(Q, d) + Q;
}

__host__ __device__ __forceinline__ Split split_planes(const float* scratch,
                                                       int Q, int d) {
  const long long p = plane_floats(Q, d);
  return Split{scratch, scratch + p, scratch + 2 * p};
}

namespace {

// One warp per query row: its big and small planes, and |q|^2 summed as
// add_squares sums a staged corpus row: lane m takes the squares of values
// 8m .. 8m + 7 (an FMA chain from 0; zeros past d), and lane 0 adds those
// in m order with round-to-nearest adds.
__global__ void __launch_bounds__(kThreads)
split_queries(const float* __restrict__ queries, float* __restrict__ scratch,
              int Q, int d) {
  const long long p = plane_floats(Q, d);
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= Q) return;
  const float* q = queries + row * d;
  for (int k = lane; k < d; k += 32) {
    uint32_t big, small;
    split(q[k], big, small);
    scratch[row * d + k] = __uint_as_float(big);
    scratch[p + row * d + k] = __uint_as_float(small);
  }
  float sum = 0.f;
  for (int m0 = 0; m0 < d; m0 += 8 * 32) {
    float part = 0.f;
    const int k0 = m0 + 8 * lane;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = k0 + j < d ? q[k0 + j] : 0.f;
      part = fmaf(x, x, part);
    }
    const int steps = min(32, (d - m0 + 7) / 8);
    for (int m = 0; m < steps; ++m)
      sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, part, m));
  }
  if (lane == 0) scratch[2 * p + row] = sum;
}

}  // namespace

// Launches split_queries for (Q, d) queries into scratch.
static inline cudaError_t launch_split(const void* queries, void* scratch,
                                       int Q, int d, cudaStream_t st) {
  const long long blocks = (static_cast<long long>(Q) + kWarps - 1) / kWarps;
  if (blocks == 0) return cudaSuccess;
  split_queries<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(queries), static_cast<float*>(scratch), Q, d);
  return cudaGetLastError();
}

// The fragment of lane (g = lane / 4, t = lane % 4) of warp w: m16n8 tile
// (i, j) covers rows qrow(w) + 16 i + g (+8) and columns ccol(w) + 8 j +
// 2 t (+1); acc[i][j] = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
using Acc = float[2][4][4];
__device__ __forceinline__ int qrow() { return (threadIdx.x >> 7) * 32; }
__device__ __forceinline__ int ccol() {
  return ((threadIdx.x >> 5) & 3) * 32;
}

// Starts the copies of the (BQ, BK) query slice and the (BN, BK) corpus
// slice at (q0, n0, k0) into st.
template <typename Row, bool kVec>
__device__ __forceinline__ void load(Stage<Row>& st, const Split& q,
                                     const Row* __restrict__ corpus, int q0,
                                     int n0, int k0, int Q, int N, int d) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int QP = BK / 4;                 // 16-byte pieces a row
    for (int e = tid; e < 2 * BQ * QP; e += kThreads) {
      const int plane = e / (BQ * QP);
      const int r = e / QP % BQ, p = e % QP;
      const int gq = q0 + r, gk = k0 + 4 * p;
      const bool ok = gq < Q && gk < d;
      const float* src = plane ? q.small : q.big;
      cp_async16(plane ? &st.qs[r][4 * p] : &st.qb[r][4 * p],
                 ok ? src + static_cast<long long>(gq) * d + gk : src, ok);
    }
    constexpr int CE = 16 / sizeof(Row);       // elements a piece
    constexpr int CP = BK / CE;
    for (int e = tid; e < BN * CP; e += kThreads) {
      const int r = e / CP, p = e % CP;
      const int gn = n0 + r, gk = k0 + CE * p;
      const bool ok = gn < N && gk < d;
      cp_async16(&st.c[r][CE * p],
                 ok ? corpus + static_cast<long long>(gn) * d + gk : corpus,
                 ok);
    }
  } else {
    // consecutive threads read consecutive k of one row
    for (int e = tid; e < BQ * BK; e += kThreads) {
      const int r = e / BK, k = e % BK;
      const int gq = q0 + r, gk = k0 + k;
      const bool ok = gq < Q && gk < d;
      const long long i = static_cast<long long>(gq) * d + gk;
      st.qb[r][k] = ok ? q.big[i] : 0.f;
      st.qs[r][k] = ok ? q.small[i] : 0.f;
    }
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int r = e / BK, k = e % BK;
      const int gn = n0 + r, gk = k0 + k;
      if (gn < N && gk < d)
        st.c[r][k] = corpus[static_cast<long long>(gn) * d + gk];
      else if constexpr (std::is_same<Row, float>::value)
        st.c[r][k] = 0.f;
      else
        st.c[r][k] = __ushort_as_half(0);
    }
  }
}

// acc += q.c over one staged slice. Per step of 8 over d the eight m16n8
// partials go through each pass in turn, so that consecutive mma
// instructions of a warp do not wait on each other.
template <typename Row>
__device__ __forceinline__ void product(const Stage<Row>& st, Acc& acc) {
  constexpr bool kF32 = std::is_same<Row, float>::value;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rq = qrow(), rc = ccol();
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rq + 16 * i + g;
#pragma unroll
      for (int h = 0; h < 4; ++h) {    // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
        const int rr = r + 8 * (h & 1), kx = kk + t + 4 * (h >> 1);
        ab[i][h] = __float_as_uint(st.qb[rr][kx]);
        as[i][h] = __float_as_uint(st.qs[rr][kx]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = rc + 8 * j + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (kF32) {
          split(st.c[n][kk + t + 4 * h], bb[j][h], bs[j][h]);
        } else {
          // a float16 value is a TF32 value: no small part
          bb[j][h] = __float_as_uint(__half2float(st.c[n][kk + t + 4 * h]));
        }
      }
    }
    float p[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[i][j][e] = 0.f;
        mma_tf32(p[i][j], as[i], bb[j]);
      }
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(p[i][j], ab[i], bs[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(p[i][j], ab[i], bb[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], p[i][j][e]);
      }
  }
}

// sum + the squares of one staged corpus row's BK values, read 16 bytes at
// a time (with the 16-byte row padding, 8 consecutive rows hit 32 banks).
// As the cross term is formed, each step of 8 is summed apart (an FMA chain
// from 0) and added with a round-to-nearest add, in k order; split_queries
// sums |q|^2 the same way, so a row's |q|^2 and |c|^2 are bit-equal.
__device__ __forceinline__ float add_squares(const float* row, float sum) {
#pragma unroll
  for (int m = 0; m < BK / 8; ++m) {
    const float4 x = reinterpret_cast<const float4*>(row)[2 * m];
    const float4 y = reinterpret_cast<const float4*>(row)[2 * m + 1];
    float p = fmaf(x.x, x.x, 0.f);
    p = fmaf(x.y, x.y, p);
    p = fmaf(x.z, x.z, p);
    p = fmaf(x.w, x.w, p);
    p = fmaf(y.x, y.x, p);
    p = fmaf(y.y, y.y, p);
    p = fmaf(y.z, y.z, p);
    p = fmaf(y.w, y.w, p);
    sum = __fadd_rn(sum, p);
  }
  return sum;
}

__device__ __forceinline__ float add_squares(const __half* row, float sum) {
#pragma unroll
  for (int m = 0; m < BK / 8; ++m) {
    const uint4 x = reinterpret_cast<const uint4*>(row)[m];
    const __half2* h = reinterpret_cast<const __half2*>(&x);
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __half22float2(h[j]);
      p = fmaf(f.x, f.x, p);
      p = fmaf(f.y, f.y, p);
    }
    sum = __fadd_rn(sum, p);
  }
  return sum;
}

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Where a tile lies, and whether its steps must sum |c|^2.
struct At {
  int q0, n0;
  bool cnorm;
};

// Walks `tiles` output tiles through the ring, ceil(d / BK) steps each
// (one step of zeros when d == 0). at(u) places tile u. When tile u's
// steps are done, acc holds its q.c and s.cn its rows' |c|^2 (if
// at(u).cnorm; else what an earlier tile left there), and epi(u, acc)
// runs after a barrier. Every thread of the block must call it; epi may
// hold barriers of its own.
template <typename Row, bool kVec, typename Place, typename Epi>
__device__ __forceinline__ void walk(Smem<Row>& s, const Split& q,
                                     const Row* __restrict__ corpus, int Q,
                                     int N, int d, int tiles, Place at,
                                     Epi epi) {
  const int tid = threadIdx.x;
  const int kc = d > 0 ? (d + BK - 1) / BK : 1;
  Acc acc;
  float nsum = 0.f;   // thread tid < BN: |c|^2 of row tid
  ring(
      tiles * kc,
      [&](int step) {
        const At a = at(step / kc);
        load<Row, kVec>(s.st[step % kStages], q, corpus, a.q0, a.n0,
                        (step % kc) * BK, Q, N, d);
      },
      [&](int step) {
        const int u = step / kc, kci = step % kc;
        const At a = at(u);
        const Stage<Row>& st = s.st[step % kStages];
        if (kci == 0) {
          zero(acc);
          nsum = 0.f;
        }
        if (a.cnorm && tid < BN) nsum = add_squares(st.c[tid], nsum);
        product(st, acc);
        if (kci == kc - 1) {
          if (a.cnorm && tid < BN) s.cn[tid] = nsum;
          __syncthreads();
          epi(u, acc);
        }
      });
}

// Writes a thread's fragments of acc (float or int) into an epilogue tile
// (BQ rows of kOutPitch) as 8-byte pairs: with kOutPitch = BN + 8, the 16
// lanes of a half-warp hit 32 distinct banks.
template <typename T>
__device__ __forceinline__ void store_fragments(T (*dst)[kOutPitch],
                                                const T (&acc)[2][4][4]) {
  using Pair = typename std::conditional<std::is_same<T, float>::value,
                                         float2, int2>::type;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rq = qrow(), rc = ccol();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rq + 16 * i + g, c = rc + 8 * j + 2 * t;
      Pair lo2, hi2;
      lo2.x = acc[i][j][0];
      lo2.y = acc[i][j][1];
      hi2.x = acc[i][j][2];
      hi2.y = acc[i][j][3];
      *reinterpret_cast<Pair*>(&dst[r][c]) = lo2;
      *reinterpret_cast<Pair*>(&dst[r + 8][c]) = hi2;
    }
}

// The distance from a tile's sums, rounded step by step in the plain
// version's order (2 * cross is exact; neither step may fuse into an FMA).
__device__ __forceinline__ float distance(float qn, float cross, float cn) {
  return __fadd_rn(__fsub_rn(qn, 2.0f * cross), cn);
}

}  // namespace tile
