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
// GB: ~0.35 ms at 3.35 TB/s, against 0.034 ms for the 67 G int8
// multiply-adds at the tensor cores' 1,979 TOP/s. The output, not the code
// width, sets the floor; a fused top-k over the codes is what would remove
// it. Measured (PERF.md, chip_smoke.py's scan_sweep): ~0.55 ms does not
// grow with d, the epilogue's per-entry work and the output write done in
// turn with the product; the product itself is ~0.17 ms per 128 bytes of d.
//
// Design: the masked scan's (pairwise_l2.cu) on int8 operands. One
// 256-thread block per 128-row corpus tile walks every 64-row query block,
// so the codes are read from device memory once. Per step over d it stages
// a (64, 128-byte) slice of wq and a (128, 128-byte) slice of the codes in
// shared memory through pairwise_tile.cuh's two-stage ring of 16-byte
// cp.async copies (rows padded by 16 bytes: fragment reads hit 32 distinct
// banks). A row of d bytes moves in 16-byte pieces only when d is a
// multiple of 16 and both bases start on 16 bytes; otherwise (d = 17, a
// view) the bytes are copied one by one, with zeros past d. Each warp owns
// a 32 x 32 sub-tile and multiplies on the tensor cores with
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (int8 x int8 summed into int32).
// Integer sums are exact in any order, so acc equals the plain version's.
// The epilogue parks acc in shared memory, then each warp takes whole
// output rows and forms __fmul_rn / __fsub_rn / __fadd_rn in the plain
// version's order (nvcc may not contract them into FMAs), so the output is
// bit-equal to the plain version's; it stores full 128-byte lines with
// streaming 16-byte stores.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "pairwise_tile.cuh"
#include "rr_predicate.cuh"

namespace {

using tile::BN;
using tile::BQ;
using tile::kOutPitch;
using tile::kStages;
using tile::kThreads;
using tile::kWarps;

constexpr int BKB = 128;            // bytes of d per step
constexpr int kRows = BQ / kWarps;  // output rows a warp stores per tile
constexpr int kPitch = BKB + 16;    // bytes a staged row

struct Stage8 {
  int8_t q[BQ][kPitch];
  int8_t c[BN][kPitch];
};

struct Smem8 {
  Stage8 st[kStages];
  int out[BQ][kOutPitch];
  float sq[BN];
  float lo[BN];
  float hi[BN];
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__device__ __forceinline__ void load(Stage8& st,
                                     const int8_t* __restrict__ wq,
                                     const int8_t* __restrict__ codes,
                                     int q0, int n0, int k0, int Q, int N,
                                     int d) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int P = BKB / 16;                // 16-byte pieces a row
    for (int e = tid; e < (BQ + BN) * P; e += kThreads) {
      const int r = e / P, p = e % P;
      const int gk = k0 + 16 * p;
      const bool is_q = r < BQ;
      const int gr = is_q ? q0 + r : n0 + r - BQ;
      const bool ok = gr < (is_q ? Q : N) && gk < d;
      const int8_t* base = is_q ? wq : codes;
      const int8_t* src =
          ok ? base + static_cast<long long>(gr) * d + gk : base;
      tile::cp_async16(is_q ? &st.q[r][16 * p] : &st.c[r - BQ][16 * p], src,
                       ok);
    }
  } else {
    // consecutive threads copy consecutive bytes of one row
    for (int e = tid; e < (BQ + BN) * BKB; e += kThreads) {
      const int r = e / BKB, k = e % BKB;
      const int gk = k0 + k;
      const bool is_q = r < BQ;
      const int gr = is_q ? q0 + r : n0 + r - BQ;
      const bool ok = gr < (is_q ? Q : N) && gk < d;
      const int8_t v =
          ok ? (is_q ? wq : codes)[static_cast<long long>(gr) * d + gk] : 0;
      if (is_q) st.q[r][k] = v;
      else st.c[r - BQ][k] = v;
    }
  }
}

__device__ __forceinline__ uint32_t word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += wq . codes over one staged slice (the fragment layout of
// pairwise_tile.cuh, with k32 steps of four bytes a register).
__device__ __forceinline__ void product(const Stage8& st,
                                        int (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rq = tile::qrow(), rc = tile::ccol();
#pragma unroll
  for (int kk = 0; kk < BKB; kk += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rq + 16 * i + g;
      a[i][0] = word(&st.q[r][kk + 4 * t]);
      a[i][1] = word(&st.q[r + 8][kk + 4 * t]);
      a[i][2] = word(&st.q[r][kk + 16 + 4 * t]);
      a[i][3] = word(&st.q[r + 8][kk + 16 + 4 * t]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = rc + 8 * j + g;
      const uint32_t b[2] = {word(&st.c[n][kk + 4 * t]),
                             word(&st.c[n][kk + 16 + 4 * t])};
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_l2_int8_kernel(const int8_t* __restrict__ wq,
                        const int8_t* __restrict__ codes,
                        const float* __restrict__ alpha,
                        const float* __restrict__ cq,
                        const float* __restrict__ sq_norm,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi,
                        const float* __restrict__ ql,
                        const float* __restrict__ qh, float* __restrict__ out,
                        int Q, int N, int d, int mask, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem8& s = *reinterpret_cast<Smem8*>(smem_raw);
  const int n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < BN; c += kThreads) {
    const int gn = n0 + c;
    s.sq[c] = gn < N ? sq_norm[gn] : 0.f;
    s.lo[c] = gn < N ? lo[gn] : CUDART_NAN_F;
    s.hi[c] = gn < N ? hi[gn] : CUDART_NAN_F;
  }
  const int kc = d > 0 ? (d + BKB - 1) / BKB : 1;
  int acc[2][4][4];
  tile::ring(
      (Q + BQ - 1) / BQ * kc,
      [&](int step) {
        load<kVec>(s.st[step % kStages], wq, codes, step / kc * BQ, n0,
                   step % kc * BKB, Q, N, d);
      },
      [&](int step) {
        const int u = step / kc, kci = step % kc;
        if (kci == 0) tile::zero(acc);
        product(s.st[step % kStages], acc);
        if (kci != kc - 1) return;
        // this warp's rows' inputs, all loads in flight at once
        float two_alpha[kRows], cqi[kRows], qli[kRows], qhi[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int gq = min(u * BQ + warp + kWarps * j, Q - 1);
          two_alpha[j] = __fmul_rn(2.0f, alpha[gq]);
          cqi[j] = cq[gq];
          qli[j] = ql[gq];
          qhi[j] = qh[gq];
        }
        tile::store_fragments(s.out, acc);
        __syncthreads();
        // this lane's four columns, the same in every row
        const int c = 4 * lane;
        const float4 sq4 = *reinterpret_cast<const float4*>(&s.sq[c]);
        const float4 lo4 = *reinterpret_cast<const float4*>(&s.lo[c]);
        const float4 hi4 = *reinterpret_cast<const float4*>(&s.hi[c]);
        const float sq_c[4] = {sq4.x, sq4.y, sq4.z, sq4.w};
        const float lo_c[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
        const float hi_c[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = warp + kWarps * j;
          const int gq = u * BQ + r;
          if (gq >= Q) break;              // warp-uniform
          const int4 x = *reinterpret_cast<const int4*>(&s.out[r][c]);
          const int dot[4] = {x.x, x.y, x.z, x.w};
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float t =
                __fmul_rn(two_alpha[j], static_cast<float>(dot[e]));
            const float dist = __fadd_rn(__fsub_rn(cqi[j], t), sq_c[e]);
            v[e] = rr::predicate(mask, lo_c[e], hi_c[e], qli[j], qhi[j])
                       ? dist : CUDART_INF_F;
          }
          float* dst = out + static_cast<long long>(gq) * N + n0 + c;
          if (vec_out && n0 + c + 3 < N) {
            __stcs(reinterpret_cast<float4*>(dst),
                   make_float4(v[0], v[1], v[2], v[3]));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n0 + c + e < N) __stcs(dst + e, v[e]);
          }
        }
      });
}

template <bool kVec>
int launch_as(const void* wq, const void* codes, const void* alpha,
              const void* cq, const void* sq_norm, const void* lo,
              const void* hi, const void* ql, const void* qh, void* out,
              int Q, int N, int d, int mask, cudaStream_t st) {
  auto kernel = pairwise_l2_int8_kernel<kVec>;
  const int smem = static_cast<int>(sizeof(Smem8));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (static_cast<long long>(N) + BN - 1) / BN;
  const int vec_out = N % 4 == 0 && tile::vec16(out, 16);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const int8_t*>(wq), static_cast<const int8_t*>(codes),
      static_cast<const float*>(alpha), static_cast<const float*>(cq),
      static_cast<const float*>(sq_norm), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(ql),
      static_cast<const float*>(qh), static_cast<float*>(out), Q, N, d, mask,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pairwise_l2_int8(const void* wq, const void* codes,
                                const void* alpha, const void* cq,
                                const void* sq_norm, const void* lo,
                                const void* hi, const void* ql,
                                const void* qh, void* out, int Q, int N,
                                int d, int mask, void* stream) {
  if (Q == 0 || N == 0) return 0;
  if (d < 0 || (static_cast<long long>(N) + BN - 1) / BN > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile::vec16(wq, d) && tile::vec16(codes, d))
    return launch_as<true>(wq, codes, alpha, cq, sq_norm, lo, hi, ql, qh, out,
                           Q, N, d, mask, st);
  return launch_as<false>(wq, codes, alpha, cq, sq_norm, lo, hi, ql, qh, out,
                          Q, N, d, mask, st);
}
