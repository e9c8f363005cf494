// Fused RR-predicate + int8 compressed scan: the int8 tier's flat route.
//
// Replaces: src/repro/kernels/pairwise_l2_int8.py, pairwise_l2_int8 (the
// pallas_call at line 81). As there, the query-side prologue (w = q*scale
// quantized to int8 with a per-query step alpha, and cq = |q|^2 -
// 2 q.offset) runs outside the kernel, in plain torch
// (kernels/ref.py::quantize_query_weights_ref); the kernel takes its
// outputs and writes
//
//     out[q, n] = cq[q] - 2 alpha[q] (wq[q] . code[n]) + sq_norm[n]
//
// or +inf where the RR predicate fails.
//
// Bound on an H100: device-memory bytes. At Q = 256, N = 1M, d = 128 the
// kernel reads 128 MB of codes but writes the (Q, N) float32 output, 1.02
// GB; the 67 G int8 multiply-adds take 0.034 ms at the tensor cores' 1,979
// TOP/s against ~0.35 ms for the bytes. The output, not the code width,
// sets the floor; a fused top-k (the fused_topk_l2 port) is what removes it.
//
// Design: the tiled SIMT product of pairwise_l2.cu with int8 operands. Each
// 256-thread block owns a 64 x 64 output tile. Per step over d it stages a
// (64, 64-byte) slice of wq and of the codes in shared memory as 32-bit
// words of four consecutive components (transposed, padded by one column).
// The rows are read byte by byte and packed in registers: a code row is d
// bytes long, so for d not a multiple of 4 (d = 17) rows are not 4-byte
// aligned, and the tail past d is packed as zeros. Each thread accumulates
// a 4 x 4 register tile with __dp4a (four int8 x int8 products summed into
// an int32). Int32 accumulation is exact, so acc equals the plain
// version's in any order. The epilogue is written as __fmul_rn / __fsub_rn
// / __fadd_rn in the plain version's order, which nvcc may not contract
// into FMAs, so the output is bit-equal to the plain version's. Tensor-core
// IMMA (mma.sync s8 or wgmma) is later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "rr_predicate.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BN = 64;
constexpr int DK = 64;          // bytes of d per step
constexpr int DW = DK / 4;      // 32-bit words per row and step
constexpr int kThreads = 256;

// Four consecutive int8 components of row r starting at k, as one word
// (component k in the low byte); components at or past d are 0.
__device__ __forceinline__ int pack4(const int8_t* __restrict__ row, int k,
                                     int d) {
  unsigned w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const unsigned byte =
        (k + b < d) ? static_cast<unsigned char>(row[k + b]) : 0u;
    w |= byte << (8 * b);
  }
  return static_cast<int>(w);
}

__global__ void __launch_bounds__(kThreads)
pairwise_l2_int8_kernel(const int8_t* __restrict__ wq,
                        const int8_t* __restrict__ codes,
                        const float* __restrict__ alpha,
                        const float* __restrict__ cq,
                        const float* __restrict__ sq_norm,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi,
                        const float* __restrict__ ql,
                        const float* __restrict__ qh, float* __restrict__ out,
                        int Q, int N, int d, int mask) {
  __shared__ int q_s[DW][BQ + 1];
  __shared__ int c_s[DW][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // output columns tx + 16*j
  const int ty = tid >> 4;   // output rows 4*ty + i
  const int n0 = blockIdx.x * BN;
  const int q0 = blockIdx.y * BQ;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < d; k0 += DK) {
    // stage: consecutive threads pack consecutive words of one row
    for (int e = tid; e < BQ * DW; e += kThreads) {
      const int r = e / DW, w = e % DW;
      const int gq = q0 + r;
      q_s[w][r] = gq < Q ? pack4(wq + static_cast<long long>(gq) * d,
                                 k0 + 4 * w, d)
                         : 0;
    }
    for (int e = tid; e < BN * DW; e += kThreads) {
      const int r = e / DW, w = e % DW;
      const int gn = n0 + r;
      c_s[w][r] = gn < N ? pack4(codes + static_cast<long long>(gn) * d,
                                 k0 + 4 * w, d)
                         : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < DW; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[w][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = c_s[w][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + 4 * ty + i;
    if (gq >= Q) continue;
    const float two_alpha = __fmul_rn(2.0f, alpha[gq]);
    const float cqi = cq[gq], qli = ql[gq], qhi = qh[gq];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float t = __fmul_rn(two_alpha, static_cast<float>(acc[i][j]));
      const float dist = __fadd_rn(__fsub_rn(cqi, t), sq_norm[gn]);
      const bool sel = rr::predicate(mask, lo[gn], hi[gn], qli, qhi);
      out[static_cast<long long>(gq) * N + gn] = sel ? dist : CUDART_INF_F;
    }
  }
}

}  // namespace

extern "C" int pairwise_l2_int8(const void* wq, const void* codes,
                                const void* alpha, const void* cq,
                                const void* sq_norm, const void* lo,
                                const void* hi, const void* ql,
                                const void* qh, void* out, int Q, int N,
                                int d, int mask, void* stream) {
  if (Q == 0 || N == 0) return 0;
  const long long gx = (static_cast<long long>(N) + BN - 1) / BN;
  const long long gy = (static_cast<long long>(Q) + BQ - 1) / BQ;
  if (gx > 0x7fffffffLL || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  pairwise_l2_int8_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(wq), static_cast<const int8_t*>(codes),
      static_cast<const float*>(alpha), static_cast<const float*>(cq),
      static_cast<const float*>(sq_norm), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(ql),
      static_cast<const float*>(qh), static_cast<float*>(out), Q, N, d, mask);
  return static_cast<int>(cudaGetLastError());
}
