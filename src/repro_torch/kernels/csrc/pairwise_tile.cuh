// One 64 x 64 tile of squared L2 distances, |q|^2 - 2 q.c + |c|^2, as
// fp32 SIMT arithmetic. Shared by the masked scan (pairwise_l2.cu), which
// writes every tile out, and the fused top-k (fused_topk.cu), which folds
// each tile into a running top-k; both get bit-equal distances from it.
//
// A 256-thread block stages, per step over d, a (64, 32) slice of the
// queries and of the corpus in shared memory (transposed, padded by one
// column so neither the stores nor the loads conflict on banks), and each
// thread accumulates a 4 x 4 register tile of q.c: rows 4*ty + i, columns
// tx + 16*j, with tx = tid & 15 and ty = tid >> 4. The squared norms |q|^2
// and |c|^2 are summed from the same staged slices by 128 of the threads.
// A float16 corpus row is widened with __half2float as it is staged; the
// arithmetic stays float32.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace tile {

constexpr int BQ = 64;
constexpr int BN = 64;
constexpr int DK = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

struct Smem {
  float q[DK][BQ + 1];
  float c[DK][BN + 1];
  float qn[BQ];
  float cn[BN];
};

// Accumulates q.c of queries q0.. q0+63 against rows n0.. n0+63 into acc,
// and their squared norms into s.qn and s.cn. Rows past Q or N, and
// columns past d, count as zeros. Every thread of the block must call it.
// It opens with a barrier, so a caller may read the previous tile's
// s.qn / s.cn right up to the next call.
template <typename Row>
__device__ __forceinline__ void accumulate(Smem& s, float (&acc)[4][4],
                                           const float* __restrict__ queries,
                                           const Row* __restrict__ corpus,
                                           int q0, int n0, int Q, int N,
                                           int d) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  __syncthreads();
  if (tid < BQ) s.qn[tid] = 0.f;
  else if (tid < BQ + BN) s.cn[tid - BQ] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    // stage: consecutive threads read consecutive k of one row
    for (int e = tid; e < BQ * DK; e += kThreads) {
      const int r = e / DK, k = e % DK;
      const int gq = q0 + r, gk = k0 + k;
      s.q[k][r] = (gq < Q && gk < d)
                      ? queries[static_cast<long long>(gq) * d + gk] : 0.f;
    }
    for (int e = tid; e < BN * DK; e += kThreads) {
      const int r = e / DK, k = e % DK;
      const int gn = n0 + r, gk = k0 + k;
      s.c[k][r] = (gn < N && gk < d)
                      ? widen(corpus[static_cast<long long>(gn) * d + gk])
                      : 0.f;
    }
    __syncthreads();
    if (tid < BQ) {
      float a = s.qn[tid];
      for (int k = 0; k < DK; ++k) a = fmaf(s.q[k][tid], s.q[k][tid], a);
      s.qn[tid] = a;
    } else if (tid < BQ + BN) {
      const int r = tid - BQ;
      float a = s.cn[r];
      for (int k = 0; k < DK; ++k) a = fmaf(s.c[k][r], s.c[k][r], a);
      s.cn[r] = a;
    }
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.q[k][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.c[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  __syncthreads();   // the norms of the last step are complete
}

// The distance from a tile's sums, rounded step by step in the plain
// version's order (2 * cross is exact; neither step may fuse into an FMA).
__device__ __forceinline__ float distance(float qn, float cross, float cn) {
  return __fadd_rn(__fsub_rn(qn, 2.0f * cross), cn);
}

}  // namespace tile
