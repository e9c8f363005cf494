// The six RR predicate bits of intervals.eval_predicate, on float32
// endpoints. A NaN endpoint fails every comparison, so NaN-padded rows
// never qualify. Shared by the masked scans (pairwise_l2.cu,
// pairwise_l2_int8.cu).
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
  bool out = false;
  if (mask & LEFT_OVERLAP) out |= (lo <= ql) && (ql <= hi) && (hi <= qh);
  if (mask & QUERY_CONTAINED) out |= (lo <= ql) && (qh <= hi);
  if (mask & RIGHT_OVERLAP) out |= (ql <= lo) && (lo <= qh) && (qh <= hi);
  if (mask & QUERY_CONTAINING) out |= (ql <= lo) && (hi <= qh);
  if (mask & BEFORE) out |= qh < lo;
  if (mask & AFTER) out |= hi < ql;
  return out;
}

}  // namespace rr
