// Squared L2 between each query and its S gathered candidate rows.
//
// Replaces: src/repro/kernels/gathered_l2.py, gathered_l2 (the pallas_call
// at line 49, VPU form), used for the beam search's entry-point distances.
//
// Bound on an H100: device-memory bytes. The (Q, S, d) candidate tile is
// read once and reduced to (Q, S); each element costs 3 flops, far below
// the card's ~20 flops per byte balance point for fp32.
//
// Design: one warp per (q, s) pair. Lanes stride over d, so a warp reads
// one candidate row as contiguous 128-byte segments, and the partial sums
// are combined with a shuffle reduction. Accumulation is fp32, as a
// diff-square-sum (the reference's form, not the |q|^2 - 2q.c + |c|^2
// expansion), so results match the plain version to rounding order.
//
// Candidate rows come in float32, float16 or bfloat16 (the reference's
// kernels take any float type and upcast); each element is widened to
// float32 as it is loaded (__half2float, __bfloat162float) and the sums
// stay float32, so a float16 row's bytes halve and its arithmetic does not
// change. The entry points take the element type as a code (0: float32, 1:
// float16, 2: bfloat16); the query is float32 (the wrapper widens others).
//
// gathered_l2_dot replaces src/repro/kernels/gathered_l2.py,
// gathered_l2_dot (the same pallas_call at line 49, with the MXU body
// _kernel_mxu): the same (Q, S) result in the contraction form
// |q|^2 - 2 q.c + |c|^2. On the TPU the cross term is a batched matrix
// product; here it is as byte-bound as the diff form (each element costs
// three FMAs), so it keeps the same design: a warp per (q, s) sums the
// three fp32 terms over d and reduces each with shuffles.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void gathered_l2_kernel(const float* __restrict__ queries,
                                   const T* __restrict__ cand,
                                   float* __restrict__ out, int Q, int S,
                                   int d) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= static_cast<long long>(Q) * S) return;
  const long long qi = pair / S;
  const float* q = queries + qi * d;
  const T* c = cand + pair * d;
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float diff = widen(c[k]) - q[k];
    acc = fmaf(diff, diff, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[pair] = acc;
}

template <typename T>
__global__ void gathered_l2_dot_kernel(const float* __restrict__ queries,
                                       const T* __restrict__ cand,
                                       float* __restrict__ out, int Q, int S,
                                       int d) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= static_cast<long long>(Q) * S) return;
  const long long qi = pair / S;
  const float* q = queries + qi * d;
  const T* c = cand + pair * d;
  float qq = 0.f, cc = 0.f, qc = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float a = q[k], b = widen(c[k]);
    qq = fmaf(a, a, qq);
    cc = fmaf(b, b, cc);
    qc = fmaf(a, b, qc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qq += __shfl_xor_sync(0xffffffffu, qq, off);
    cc += __shfl_xor_sync(0xffffffffu, cc, off);
    qc += __shfl_xor_sync(0xffffffffu, qc, off);
  }
  // rounded in the plain version's order: (qq - 2 qc) + cc
  if (lane == 0) out[pair] = __fadd_rn(__fsub_rn(qq, 2.0f * qc), cc);
}

template <typename T>
int launch_as(bool dot, const void* queries, const void* cand, void* out,
              int Q, int S, int d, void* stream) {
  const long long pairs = static_cast<long long>(Q) * S;
  if (pairs == 0) return 0;
  const long long blocks = (pairs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dot ? gathered_l2_dot_kernel<T> : gathered_l2_kernel<T>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const T*>(cand),
      static_cast<float*>(out), Q, S, d);
  return static_cast<int>(cudaGetLastError());
}

int launch(bool dot, const void* queries, const void* cand, void* out, int Q,
           int S, int d, int elem, void* stream) {
  switch (elem) {
    case 0:
      return launch_as<float>(dot, queries, cand, out, Q, S, d, stream);
    case 1:
      return launch_as<__half>(dot, queries, cand, out, Q, S, d, stream);
    case 2:
      return launch_as<__nv_bfloat16>(dot, queries, cand, out, Q, S, d,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int gathered_l2(const void* queries, const void* cand, void* out,
                           int Q, int S, int d, int elem, void* stream) {
  return launch(false, queries, cand, out, Q, S, d, elem, stream);
}

extern "C" int gathered_l2_dot(const void* queries, const void* cand,
                               void* out, int Q, int S, int d, int elem,
                               void* stream) {
  return launch(true, queries, cand, out, Q, S, d, elem, stream);
}
