// Fused wavefront step: gather by id + squared L2 + label mask + beam merge.
//
// Replaces: src/repro/kernels/gathered_topk.py, gathered_topk (the
// pallas_call at line 130), one step of the MSTG beam search, and
// gathered_topk_quant (line 159, pallas_call at line 186), the same step
// over an int8 or float16 code table with per-dimension affine dequant
// params (x_hat = code * scale + offset).
//
// Bound on an H100: device-memory bytes. Per query the step reads the M
// candidate ids and labels (13 bytes each), the row of every candidate that
// survives the mask (d * itemsize bytes: 4 float32, 2 float16, 1 int8), and
// the (L) beam in and out. There is almost no arithmetic (3*d flops per
// live candidate, 5*d on a code table). The Pallas kernel presented the
// whole (n, d) table to every grid step (a VMEM workaround); here a block
// reads only the rows it needs, straight from HBM. Most slots of a wide
// step are NO_EDGE or already visited, so the row loads are skipped for
// masked candidates: their distance is +inf anyway.
//
// Design: one block per query, one template over the row type.
//   1. stage q in shared memory (and, on a code table, scale and offset
//      next to it); copy the L beam entries into a shared
//      (dist, id, expanded) list;
//   2. one warp per candidate: lanes stride over d, then a shuffle
//      reduction; the result goes to list position L + j. A candidate
//      whose id is NO_EDGE or not below n counts as masked, so no row
//      outside the table is ever read. A code is widened to float in
//      registers and dequantized as __fmul_rn then __fadd_rn: nvcc may not
//      contract that into an FMA, so x_hat is bit-equal to the plain
//      version's multiply-then-add (the distance sum itself is taken in
//      another order than the plain version's, as on the float32 table);
//   3. L rounds of block-wide argmin on the key (dist, position): the
//      lowest position wins a tie, which is lax.top_k's rule on the
//      concatenation [beam | candidates]. The winner is written out and its
//      slot set to +inf. Once the minimum is +inf every later round would
//      emit (NO_EDGE, +inf, 0) too, so the block writes those and stops.
// The list needs 12 bytes per entry: (L + M) * 12 bytes of dynamic shared
// memory, above the 48 KB default once L + M > ~4000 (fanout 8 at S = 767),
// so the launcher opts in with cudaFuncSetAttribute and refuses sizes above
// the 227 KB a block can have.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNoEdge = -1;

__device__ __forceinline__ bool key_less(float da, int pa, float db, int pb) {
  return da < db || (da == db && pa < pb);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// kQuant: the table holds codes, dequantized with the (d,) scale/offset.
template <typename Row, bool kQuant>
__global__ void gathered_topk_kernel(
    const float* __restrict__ queries, const Row* __restrict__ table,
    const float* __restrict__ scale, const float* __restrict__ offset,
    const int* __restrict__ ids, const unsigned char* __restrict__ avail,
    const int* __restrict__ lab_b, const int* __restrict__ lab_e,
    const int* __restrict__ version, const int* __restrict__ pool_ids,
    const float* __restrict__ pool_d, const unsigned char* __restrict__ pool_exp,
    int* __restrict__ out_ids, float* __restrict__ out_d,
    unsigned char* __restrict__ out_exp, int n, int d, int M, int L) {
  extern __shared__ float smem[];
  const int T = L + M;
  float* q_s = smem;                               // d
  float* sc_s = q_s + d;                           // d (code tables only)
  float* of_s = sc_s + (kQuant ? d : 0);           // d (code tables only)
  float* dist_s = of_s + (kQuant ? d : 0);         // T
  int* id_s = reinterpret_cast<int*>(dist_s + T);  // T
  int* exp_s = id_s + T;                           // T
  __shared__ float red_d[kWarps];
  __shared__ int red_p[kWarps];

  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long qoff = static_cast<long long>(qi);

  for (int k = tid; k < d; k += kThreads) {
    q_s[k] = queries[qoff * d + k];
    if (kQuant) {
      sc_s[k] = scale[k];
      of_s[k] = offset[k];
    }
  }
  for (int j = tid; j < L; j += kThreads) {
    dist_s[j] = pool_d[qoff * L + j];
    id_s[j] = pool_ids[qoff * L + j];
    exp_s[j] = pool_exp[qoff * L + j];
  }
  __syncthreads();

  const int ver = version[qi];
  for (int j = warp; j < M; j += kWarps) {
    const long long c = qoff * M + j;
    const int id = ids[c];
    const bool ok = avail[c] != 0 && id >= 0 && id < n && lab_b[c] <= ver &&
                    ver <= lab_e[c];
    float acc = 0.f;
    if (ok) {
      const Row* row = table + static_cast<long long>(id) * d;
      for (int k = lane; k < d; k += 32) {
        float x = widen(row[k]);
        if (kQuant) x = __fadd_rn(__fmul_rn(x, sc_s[k]), of_s[k]);
        const float diff = x - q_s[k];
        acc = fmaf(diff, diff, acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      dist_s[L + j] = ok ? acc : CUDART_INF_F;
      id_s[L + j] = ok ? id : kNoEdge;
      exp_s[L + j] = 0;
    }
  }
  __syncthreads();

  for (int r = 0; r < L; ++r) {
    float best_d = CUDART_INF_F;
    int best_p = 0x7fffffff;
    for (int p = tid; p < T; p += kThreads) {
      const float v = dist_s[p];
      if (key_less(v, p, best_d, best_p)) { best_d = v; best_p = p; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d, off);
      const int op = __shfl_xor_sync(0xffffffffu, best_p, off);
      if (key_less(od, op, best_d, best_p)) { best_d = od; best_p = op; }
    }
    if (lane == 0) { red_d[warp] = best_d; red_p[warp] = best_p; }
    __syncthreads();
    if (warp == 0) {
      best_d = lane < kWarps ? red_d[lane] : CUDART_INF_F;
      best_p = lane < kWarps ? red_p[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best_d, off);
        const int op = __shfl_xor_sync(0xffffffffu, best_p, off);
        if (key_less(od, op, best_d, best_p)) { best_d = od; best_p = op; }
      }
      if (lane == 0) {
        const long long o = qoff * L + r;
        if (isfinite(best_d)) {
          out_d[o] = best_d;
          out_ids[o] = id_s[best_p];
          out_exp[o] = exp_s[best_p] != 0;
          dist_s[best_p] = CUDART_INF_F;
        }
        red_d[0] = best_d;
      }
    }
    __syncthreads();
    const bool done = !isfinite(red_d[0]);
    __syncthreads();  // every thread has read red_d[0] before it is reused
    if (done) {
      for (int j = r + tid; j < L; j += kThreads) {
        out_d[qoff * L + j] = CUDART_INF_F;
        out_ids[qoff * L + j] = kNoEdge;
        out_exp[qoff * L + j] = 0;
      }
      return;
    }
  }
}

template <typename Row, bool kQuant>
int launch(const void* queries, const void* table, const void* scale,
           const void* offset, const void* ids, const void* avail,
           const void* lab_b, const void* lab_e, const void* version,
           const void* pool_ids, const void* pool_d, const void* pool_exp,
           void* out_ids, void* out_d, void* out_exp, int Q, int n, int d,
           int M, int L, void* stream) {
  if (Q == 0) return 0;
  // q (+ scale, offset), then (dist, id, expanded) per list entry
  const int smem = ((kQuant ? 3 : 1) * d + 3 * (L + M)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gathered_topk_kernel<Row, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gathered_topk_kernel<Row, kQuant>
      <<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(queries), static_cast<const Row*>(table),
          static_cast<const float*>(scale), static_cast<const float*>(offset),
          static_cast<const int*>(ids), static_cast<const unsigned char*>(avail),
          static_cast<const int*>(lab_b), static_cast<const int*>(lab_e),
          static_cast<const int*>(version), static_cast<const int*>(pool_ids),
          static_cast<const float*>(pool_d),
          static_cast<const unsigned char*>(pool_exp),
          static_cast<int*>(out_ids), static_cast<float*>(out_d),
          static_cast<unsigned char*>(out_exp), n, d, M, L);
  return static_cast<int>(cudaGetLastError());
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
