// The six RR predicate bits of intervals.eval_predicate, on float32
// endpoints. A NaN endpoint fails every comparison, so NaN-padded rows
// never qualify. Shared by the masked scans (pairwise_l2.cu,
// pairwise_l2_int8.cu) and the fused top-k (fused_topk.cu).
//
// Branch-free: the eight comparisons are taken once, each relation's bit
// is formed with bitwise ands, and the mask selects among them. The scans
// evaluate this for every one of their Q x N entries, where short-circuit
// branches cost more than the distance itself.
#pragma once

namespace rr {

constexpr int LEFT_OVERLAP = 1;
constexpr int QUERY_CONTAINED = 2;
constexpr int RIGHT_OVERLAP = 4;
constexpr int QUERY_CONTAINING = 8;
constexpr int BEFORE = 16;
constexpr int AFTER = 32;

__device__ __forceinline__ bool predicate(int mask, float lo, float hi,
                                          float ql, float qh) {
  const unsigned lo_ql = lo <= ql, ql_hi = ql <= hi, hi_qh = hi <= qh;
  const unsigned qh_hi = qh <= hi, ql_lo = ql <= lo, lo_qh = lo <= qh;
  const unsigned bits = ((lo_ql & ql_hi & hi_qh) * LEFT_OVERLAP) |
                        ((lo_ql & qh_hi) * QUERY_CONTAINED) |
                        ((ql_lo & lo_qh & qh_hi) * RIGHT_OVERLAP) |
                        ((ql_lo & hi_qh) * QUERY_CONTAINING) |
                        (static_cast<unsigned>(qh < lo) * BEFORE) |
                        (static_cast<unsigned>(hi < ql) * AFTER);
  return (bits & static_cast<unsigned>(mask)) != 0u;
}

}  // namespace rr
