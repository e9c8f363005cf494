// Squared L2 between each query and its S gathered candidate rows.
//
// Replaces src/repro/kernels/gathered_l2.py: gathered_l2 (the pallas_call at
// line 49 with the VPU body _kernel_vpu), the beam search's entry-point
// distances as a diff-square-sum, and gathered_l2_dot (the same pallas_call
// with the MXU body _kernel_mxu), the same (Q, S) result in the contraction
// form |q|^2 - 2 q.c + |c|^2. Both take a (Q, d) float32 query and (Q, S, d)
// float32, float16 or bfloat16 candidates and write (Q, S) float32.
//
// Bound on an H100: bytes. The (Q, S, d) candidate tile is read once and
// reduced to (Q, S); each element costs 3 flops, far below the card's ~20
// flops per byte balance point for fp32. On the graph route the tile was
// written by the gather just before the call, so it is read warm from the
// 50 MB L2: at the route's 11.5 MB the card streams it from L2 at ~7 TB/s
// (chip_smoke.py's gathered_sweep), and a fixed cost (a launch and one
// round trip to memory) comes on top. So the design keeps many bytes in
// flight for each instruction and does little else per byte.
//
// Design:
// - A block of kWarps warps owns a strip of one query's candidate rows;
//   the blocks walk the Q x strips work items with a grid-stride loop, so
//   no grid dimension limits Q or S. Each warp loads the query's units it
//   needs once into registers, beside its first candidate loads.
// - Vector path: when a row is a whole number of 16-byte units (d *
//   itemsize % 16 == 0) and the query and the candidates start on 16
//   bytes, each lane loads 16-byte units (4 float32 or 8 float16 /
//   bfloat16 values). G lanes share a row (G, a power of two, the largest
//   that is at most the row's unit count and 32), lane column c taking
//   units c, c + G, ...: at d = 128 one warp load covers one float32 row or
//   two 16-bit rows. Each lane holds kUnroll rows' loads in flight at once
//   (rows u * 32/G + lane / G of the warp's set, u < kUnroll).
// - Element path, the same kernel with one-element units and G = 32, for
//   rows that are no whole number of 16-byte units or a query or
//   candidates that do not start on 16 bytes. Rows past S in the last
//   strip are predicated off on both paths (no load, no store).
// - Transpose-reduce: each lane sums its units of each of its kUnroll rows
//   into one float32 partial; then each shuffle round across the row's G
//   lanes halves the number of rows a lane carries (it keeps one half and
//   adds its partner's copy of it) until one is left, and plain butterfly
//   rounds finish the group. Then every row of the warp's set sits in its
//   own lane (or in G / kUnroll copies of it), and one store instruction
//   writes the set to contiguous addresses. Per row the rounds add the
//   partials in halves (column c with c + G/2, then with c + G/4, ...),
//   the order tests/test_torch_gathered_order.py emulates on the CPU.
// - Arithmetic: each element is widened to float32 as loaded
//   (__half2float, __bfloat162float) and every sum is float32 with fmaf;
//   gathered_l2_dot sums q.c and |c|^2 per row the same way and |q|^2 once
//   per lane group, and rounds its result in the plain version's order:
//   (qq - 2 qc) + cc with __fsub_rn / __fadd_rn.
// - kWarps = 4 and kUnroll = 4 measured fastest at the route's shape; more
//   rows a lane (8, 16), a query staged in shared memory, loads that skip
//   L1 and a TMA bulk copy of each warp's rows were no faster there.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;      // rows whose loads a lane holds in flight

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void zero(uint4& r) { r = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void zero(float& r) { r = 0.f; }
__device__ __forceinline__ void zero(__half& r) { r = __ushort_as_half(0); }
__device__ __forceinline__ void zero(__nv_bfloat16& r) {
  r = __ushort_as_bfloat16(0);
}

// What one lane loads at a time: a 16-byte unit, or one element.
template <typename T, int EPV>
struct Unit {
  using type = uint4;
};
template <typename T>
struct Unit<T, 1> {
  using type = T;
};

// Transpose-reduce of N partials per lane over the lanes O, O/2, .., 1
// apart: while a lane carries more than one row it keeps one half (the
// upper one where its bit O is set) and adds its partner's copy of that
// half; then butterflies. Returns the index, among the N, of the first row
// the lane ends up holding (with N > 2 * O it holds the next N / (2 * O) - 1
// rows too).
template <int O, int N, int U>
__device__ __forceinline__ int reduce_rows(float (&v)[U], int lane) {
  if constexpr (O == 0) {
    return 0;
  } else if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool upper = lane & O;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float keep = upper ? v[k + H] : v[k];
      const float send = upper ? v[k] : v[k + H];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return (upper ? H : 0) + reduce_rows<O / 2, H, U>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    return reduce_rows<O / 2, 1, U>(v, lane);
  }
}

// EPV: elements per unit (1 on the element path); G: lanes per row.
template <typename T, int EPV, int G, bool DOT>
__global__ void __launch_bounds__(kThreads)
    gathered_l2_kernel(const float* __restrict__ queries,
                       const T* __restrict__ cand, float* __restrict__ out,
                       int S, int d, long long strips, long long items) {
  using Raw = typename Unit<T, EPV>::type;
  constexpr int kSlots = 32 / G;            // rows one warp load covers
  constexpr int kRows = kUnroll * kSlots;   // rows of one warp
  constexpr int kStrip = kWarps * kRows;    // rows of one work item
  // rows each lane holds after the transpose rounds, and the butterfly
  // lanes that hold copies of them (those with these bits clear store)
  constexpr int kLeft = kUnroll > G ? kUnroll / G : 1;
  constexpr int kCopies = G > kUnroll ? G / kUnroll : 1;
  const int lane = threadIdx.x & 31;
  const int col = lane % G;
  const int slot = lane / G;
  const int warp_row = (threadIdx.x >> 5) * kRows;
  const int units = d / EPV;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long qi = item / strips;
    const int s0 = static_cast<int>(item % strips) * kStrip + warp_row;
    const float* q = queries + qi * d;
    const T* c = cand + qi * S * d;
    float acc[kUnroll], cc[kUnroll];
    float qq = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = cc[u] = 0.f;
    for (int unit = col; unit < units; unit += G) {
      // the query's unit and the kUnroll rows' units, all in flight at once
      float qv[EPV];
      if constexpr (EPV == 1) {
        qv[0] = q[unit];
      } else {
        const float4* qp = reinterpret_cast<const float4*>(q + unit * EPV);
#pragma unroll
        for (int e = 0; e < EPV; e += 4) {
          const float4 v = qp[e / 4];
          qv[e] = v.x, qv[e + 1] = v.y, qv[e + 2] = v.z, qv[e + 3] = v.w;
        }
      }
      Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * kSlots + slot;
        if (s < S)
          raw[u] = reinterpret_cast<const Raw*>(
              c + static_cast<long long>(s) * d)[unit];
        else
          zero(raw[u]);
      }
      if constexpr (DOT) {
#pragma unroll
        for (int e = 0; e < EPV; ++e) qq = fmaf(qv[e], qv[e], qq);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* x = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          const float b = widen(x[e]);
          if constexpr (DOT) {
            acc[u] = fmaf(qv[e], b, acc[u]);
            cc[u] = fmaf(b, b, cc[u]);
          } else {
            const float diff = b - qv[e];
            acc[u] = fmaf(diff, diff, acc[u]);
          }
        }
      }
    }
    const int base = reduce_rows<G / 2, kUnroll, kUnroll>(acc, lane);
    if constexpr (DOT) {
      reduce_rows<G / 2, kUnroll, kUnroll>(cc, lane);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        qq += __shfl_xor_sync(0xffffffffu, qq, o);
    }
    if (lane % kCopies == 0) {
#pragma unroll
      for (int k = 0; k < kLeft; ++k) {
        const int s = s0 + (base + k) * kSlots + slot;
        if (s < S) {
          // rounded in the plain version's order: (qq - 2 qc) + cc
          out[qi * S + s] =
              DOT ? __fadd_rn(__fsub_rn(qq, 2.0f * acc[k]), cc[k]) : acc[k];
        }
      }
    }
  }
}

template <typename T, int EPV, int G>
int launch_with(bool dot, const float* queries, const T* cand, float* out,
                int Q, int S, int d, cudaStream_t stream) {
  constexpr int strip = kWarps * kUnroll * (32 / G);
  const long long strips = (static_cast<long long>(S) + strip - 1) / strip;
  const long long items = static_cast<long long>(Q) * strips;
  const unsigned grid =
      static_cast<unsigned>(items < INT_MAX ? items : INT_MAX);
  auto kernel = dot ? gathered_l2_kernel<T, EPV, G, true>
                    : gathered_l2_kernel<T, EPV, G, false>;
  kernel<<<grid, kThreads, 0, stream>>>(queries, cand, out, S, d, strips,
                                        items);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_as(bool dot, const void* queries, const void* cand, void* out,
              int Q, int S, int d, void* stream) {
  if (static_cast<long long>(Q) * S == 0) return 0;
  const auto* qp = static_cast<const float*>(queries);
  const auto* cp = static_cast<const T*>(cand);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  constexpr int epv = 16 / sizeof(T);
  const bool vec = (static_cast<long long>(d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(cand) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(queries) % 16 == 0;
  if (!vec) return launch_with<T, 1, 32>(dot, qp, cp, op, Q, S, d, st);
  const int units = d / epv;
  if (units >= 32) return launch_with<T, epv, 32>(dot, qp, cp, op, Q, S, d, st);
  if (units >= 16) return launch_with<T, epv, 16>(dot, qp, cp, op, Q, S, d, st);
  if (units >= 8) return launch_with<T, epv, 8>(dot, qp, cp, op, Q, S, d, st);
  if (units >= 4) return launch_with<T, epv, 4>(dot, qp, cp, op, Q, S, d, st);
  if (units >= 2) return launch_with<T, epv, 2>(dot, qp, cp, op, Q, S, d, st);
  return launch_with<T, epv, 1>(dot, qp, cp, op, Q, S, d, st);
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
