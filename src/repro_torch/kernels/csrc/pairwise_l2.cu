// Fused RR-predicate + pairwise squared L2: the flat route's full scan.
//
// Replaces: src/repro/kernels/pairwise_l2.py, pairwise_l2_masked (the
// pallas_call at line 64), over a float32 corpus or, for the float16
// storage tier's flat scan, over the float16 codes (the Pallas body takes
// any corpus type and upcasts it; so does this one, at load time).
//
// Bound on an H100: operations. At Q = 256, N = 1M, d = 128 the product is
// 2*Q*N*d = 67 GFLOP, ~1.0 ms at the 67 TFLOP/s of fp32 outside the tensor
// cores, against ~0.46 ms for its 1.5 GB of traffic (the corpus once and
// the (Q, N) output once). TF32 tensor cores would be faster but keep only
// ~10 mantissa bits and change the numbers against the reference, so this
// kernel stays on fp32 FMAs.
//
// Design: a tiled SIMT product, one 256-thread block per 64 x 64 tile of
// the output, with the tile arithmetic of pairwise_tile.cuh. The epilogue
// evaluates the RR predicate from lo/hi/ql/qh with the six mask bits of
// intervals.eval_predicate (a NaN endpoint fails every comparison, so
// padded rows never qualify) and writes +inf where it fails. Output
// columns are spread over the threads of a half-warp so that stores are
// contiguous.
//
// float16 corpus (pairwise_l2_masked_f16): the same kernel, instantiated for
// __half rows. Each element is widened with __half2float as it is staged;
// the query, the products and the norms stay float32, so the arithmetic is
// the float32 kernel's. Only the corpus bytes halve (N*d*2), which leaves
// the kernel bound by operations at the main path's shape.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "pairwise_tile.cuh"
#include "rr_predicate.cuh"

namespace {

using tile::BN;
using tile::BQ;
using tile::kThreads;

template <typename Row>
__global__ void __launch_bounds__(kThreads)
pairwise_l2_kernel(const float* __restrict__ queries,
                   const Row* __restrict__ corpus,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ ql, const float* __restrict__ qh,
                   float* __restrict__ out, int Q, int N, int d, int mask) {
  __shared__ tile::Smem s;
  const int tx = threadIdx.x & 15;   // output columns tx + 16*j
  const int ty = threadIdx.x >> 4;   // output rows 4*ty + i
  const int n0 = blockIdx.x * BN;
  const int q0 = blockIdx.y * BQ;

  float acc[4][4];
  tile::accumulate(s, acc, queries, corpus, q0, n0, Q, N, d);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int gq = q0 + r;
    if (gq >= Q) continue;
    const float qli = ql[gq], qhi = qh[gq], qn = s.qn[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int gn = n0 + c;
      if (gn >= N) continue;
      const float dist = tile::distance(qn, acc[i][j], s.cn[c]);
      const bool sel = rr::predicate(mask, lo[gn], hi[gn], qli, qhi);
      out[static_cast<long long>(gq) * N + gn] = sel ? dist : CUDART_INF_F;
    }
  }
}

template <typename Row>
int launch(const void* queries, const void* corpus, const void* lo,
           const void* hi, const void* ql, const void* qh, void* out, int Q,
           int N, int d, int mask, void* stream) {
  if (Q == 0 || N == 0) return 0;
  const long long gx = (static_cast<long long>(N) + BN - 1) / BN;
  const long long gy = (static_cast<long long>(Q) + BQ - 1) / BQ;
  if (gx > 0x7fffffffLL || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  pairwise_l2_kernel<Row>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(queries), static_cast<const Row*>(corpus),
          static_cast<const float*>(lo), static_cast<const float*>(hi),
          static_cast<const float*>(ql), static_cast<const float*>(qh),
          static_cast<float*>(out), Q, N, d, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pairwise_l2_masked(const void* queries, const void* corpus,
                                  const void* lo, const void* hi,
                                  const void* ql, const void* qh, void* out,
                                  int Q, int N, int d, int mask, void* stream) {
  return launch<float>(queries, corpus, lo, hi, ql, qh, out, Q, N, d, mask,
                       stream);
}

extern "C" int pairwise_l2_masked_f16(const void* queries, const void* corpus,
                                      const void* lo, const void* hi,
                                      const void* ql, const void* qh,
                                      void* out, int Q, int N, int d,
                                      int mask, void* stream) {
  return launch<__half>(queries, corpus, lo, hi, ql, qh, out, Q, N, d, mask,
                        stream);
}
