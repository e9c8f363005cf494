// The warp-level tensor-core rate this card gives the float and int8 scans'
// instructions, measured alone: no route calls it; chip_smoke.py's
// scan_sweep phase times it beside the scans, so that their product time
// can be read against what mma.sync itself sustains.
//
// Each warp keeps eight independent m16n8 accumulators and issues
// `iters` rounds of eight mma.sync on register operands (no memory
// traffic, no dependent chains shorter than eight), then writes its sums
// so that nothing is dead code. kind 0: m16n8k8 TF32 with fp32
// accumulators (2,048 flops each), the float scans' instruction; kind 1:
// m16n8k32 s8 with s32 accumulators (8,192 ops each), the int8 scan's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mma_probe_tf32(int iters, float* __restrict__ out) {
  const uint32_t seed = threadIdx.x * 2654435761u + blockIdx.x;
  uint32_t a[4], b[2];
#pragma unroll
  for (int h = 0; h < 4; ++h) a[h] = (seed ^ (h * 0x9e3779b9u)) & 0x3f7fe000u;
  b[0] = a[1];
  b[1] = a[2];
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[m][0]), "+f"(acc[m][1]), "+f"(acc[m][2]),
            "+f"(acc[m][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m)
    s += acc[m][0] + acc[m][1] + acc[m][2] + acc[m][3];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
mma_probe_s8(int iters, float* __restrict__ out) {
  const uint32_t seed = threadIdx.x * 2654435761u + blockIdx.x;
  uint32_t a[4], b[2];
#pragma unroll
  for (int h = 0; h < 4; ++h) a[h] = seed ^ (h * 0x9e3779b9u);
  b[0] = a[1];
  b[1] = a[2];
  int acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(acc[m][0]), "+r"(acc[m][1]), "+r"(acc[m][2]),
            "+r"(acc[m][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  int s = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m)
    s += acc[m][0] + acc[m][1] + acc[m][2] + acc[m][3];
  out[blockIdx.x * kThreads + threadIdx.x] = static_cast<float>(s);
}

}  // namespace

// Launches `blocks` blocks of 256 threads; out holds blocks * 256 floats.
// Each warp issues 8 * iters mma instructions.
extern "C" int mma_probe(int kind, int blocks, int iters, void* out,
                         void* stream) {
  if (blocks < 1 || iters < 1 || kind < 0 || kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    mma_probe_tf32<<<blocks, kThreads, 0, st>>>(iters,
                                               static_cast<float*>(out));
  else
    mma_probe_s8<<<blocks, kThreads, 0, st>>>(iters,
                                             static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
