// Fused RR-predicate + pairwise squared L2: the flat route's full scan.
//
// Replaces: src/repro/kernels/pairwise_l2.py, pairwise_l2_masked (the
// pallas_call at line 64), over a float32 corpus or, for the float16
// storage tier's flat scan, over the float16 codes (the Pallas body takes
// any corpus type and upcasts it; so does this one).
//
// Bound on an H100: device-memory bytes. At Q = 256, N = 1M, d = 128 the
// kernel must read the corpus once (512 MB in float32, 256 MB in float16)
// and write the (Q, N) float32 output once (1.02 GB): 0.46 / 0.38 ms at
// 3.35 TB/s. The product, 2*Q*N*d = 67 GFLOP, runs on the tensor cores as
// 3xTF32 (float32 corpus: three passes, 0.40 ms at the 495 TFLOP/s TF32
// rate) or 2xTF32 (float16 corpus: 0.27 ms), which keeps float32 accuracy
// (pairwise_tile.cuh); single-pass TF32 would not hold the 1e-4 limits.
// Measured (PERF.md, chip_smoke.py's scan_sweep): the product runs at about
// half the rate mma.sync TF32 sustains alone, and ~0.5 ms that does not
// grow with d (the epilogue's per-entry work and the output write, done in
// turn with the product) holds the kernel above its bound.
//
// Design: one 256-thread block per 128-row corpus tile walks every 64-row
// query block in turn, so the corpus is read from device memory once and
// its tile's repeats come from L2, and |c|^2 is summed once per row. Each
// (query block, corpus tile) pair is a tile of pairwise_tile.cuh: mma.sync
// m16n8k8 TF32 fragments fed by a two-stage ring of 16-byte cp.async
// copies, which runs on across query blocks, so one tile's epilogue
// overlaps the next tile's loads. The epilogue parks q.c in shared memory,
// then each warp takes whole output rows: it evaluates the RR predicate
// with the six mask bits of intervals.eval_predicate (lo, hi and |c|^2 of
// the tile's columns were staged once; a NaN endpoint fails every
// comparison, so padded rows never qualify), writes +inf where it fails,
// and stores the row's 128 floats as full 128-byte lines with streaming
// (evict-first) 16-byte stores, so that the output does not push the
// corpus out of L2. Rows whose length is not a multiple of 4 floats take
// scalar stores.
//
// float16 corpus (pairwise_l2_masked_f16): the same kernel, instantiated
// for __half rows; the query, the products and the norms stay float32.
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
using tile::kWarps;

constexpr int kRows = BQ / kWarps;   // output rows a warp stores per tile

template <typename Row>
struct ScanSmem {
  tile::Smem<Row> t;
  float out[BQ][kOutPitch];
  float lo[BN];
  float hi[BN];
};

template <typename Row, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_l2_kernel(const float* __restrict__ scratch,
                   const Row* __restrict__ corpus,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ ql, const float* __restrict__ qh,
                   float* __restrict__ out, int Q, int N, int d, int mask,
                   int vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem<Row>& s = *reinterpret_cast<ScanSmem<Row>*>(smem_raw);
  const tile::Split q = tile::split_planes(scratch, Q, d);
  const int n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < BN; c += kThreads) {
    const int gn = n0 + c;
    s.lo[c] = gn < N ? lo[gn] : CUDART_NAN_F;
    s.hi[c] = gn < N ? hi[gn] : CUDART_NAN_F;
  }
  // the first barrier of the walk publishes lo and hi
  tile::walk<Row, kVec>(
      s.t, q, corpus, Q, N, d, (Q + BQ - 1) / BQ,
      [=](int u) { return tile::At{u * BQ, n0, u == 0}; },
      [&](int u, const tile::Acc& acc) {
        // this warp's rows' inputs, all loads in flight at once
        float qli[kRows], qhi[kRows], qnr[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int gq = min(u * BQ + warp + kWarps * j, Q - 1);
          qli[j] = ql[gq];
          qhi[j] = qh[gq];
          qnr[j] = q.qn[gq];
        }
        tile::store_fragments(s.out, acc);
        __syncthreads();
        // this lane's four columns, the same in every row
        const int c = 4 * lane;
        const float4 lo4 = *reinterpret_cast<const float4*>(&s.lo[c]);
        const float4 hi4 = *reinterpret_cast<const float4*>(&s.hi[c]);
        const float4 cn4 = *reinterpret_cast<const float4*>(&s.t.cn[c]);
        const float lo_c[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
        const float hi_c[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
        const float cn_c[4] = {cn4.x, cn4.y, cn4.z, cn4.w};
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int r = warp + kWarps * j;
          const int gq = u * BQ + r;
          if (gq >= Q) break;              // warp-uniform
          const float4 x = *reinterpret_cast<const float4*>(&s.out[r][c]);
          const float cross[4] = {x.x, x.y, x.z, x.w};
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = rr::predicate(mask, lo_c[e], hi_c[e], qli[j], qhi[j])
                       ? tile::distance(qnr[j], cross[e], cn_c[e])
                       : CUDART_INF_F;
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

template <typename Row, bool kVec>
int launch_as(const void* scratch, const void* corpus, const void* lo,
              const void* hi, const void* ql, const void* qh, void* out,
              int Q, int N, int d, int mask, cudaStream_t st) {
  auto kernel = pairwise_l2_kernel<Row, kVec>;
  const int smem = static_cast<int>(sizeof(ScanSmem<Row>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (static_cast<long long>(N) + BN - 1) / BN;
  const int vec_out = N % 4 == 0 && tile::vec16(out, 16);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const float*>(scratch), static_cast<const Row*>(corpus),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(ql), static_cast<const float*>(qh),
      static_cast<float*>(out), Q, N, d, mask, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Row>
int launch(const void* queries, const void* corpus, const void* lo,
           const void* hi, const void* ql, const void* qh, void* out,
           void* scratch, int Q, int N, int d, int mask, void* stream) {
  if (Q == 0 || N == 0) return 0;
  if (d < 0 || (static_cast<long long>(N) + BN - 1) / BN > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tile::launch_split(queries, scratch, Q, d, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row = static_cast<long long>(d) * sizeof(Row);
  if (tile::vec16(scratch, 4LL * d) && tile::vec16(corpus, row))
    return launch_as<Row, true>(scratch, corpus, lo, hi, ql, qh, out, Q, N,
                                d, mask, st);
  return launch_as<Row, false>(scratch, corpus, lo, hi, ql, qh, out, Q, N, d,
                               mask, st);
}

}  // namespace

// scratch: tile::scratch_floats(Q, d) floats for the split queries.
extern "C" int pairwise_l2_masked(const void* queries, const void* corpus,
                                  const void* lo, const void* hi,
                                  const void* ql, const void* qh, void* out,
                                  void* scratch, int Q, int N, int d,
                                  int mask, void* stream) {
  return launch<float>(queries, corpus, lo, hi, ql, qh, out, scratch, Q, N,
                       d, mask, stream);
}

extern "C" int pairwise_l2_masked_f16(const void* queries, const void* corpus,
                                      const void* lo, const void* hi,
                                      const void* ql, const void* qh,
                                      void* out, void* scratch, int Q,
                                      int N, int d, int mask, void* stream) {
  return launch<__half>(queries, corpus, lo, hi, ql, qh, out, scratch, Q, N,
                        d, mask, stream);
}
