"""Range-range (RR) predicates and the MSTG query planner (paper §2, §4.4, Thm 4.1).

Four atomic predicates between an object range ``[lo, hi]`` and a query range
``[ql, qh]`` (paper Fig. 1), encoded as a bitmask so arbitrary disjunctions are a
single int:

    ① LEFT_OVERLAP     lo <= ql <= hi <= qh          (query left-overlap)
    ② QUERY_CONTAINED  lo <= ql <= qh <= hi          (object covers query)
    ③ RIGHT_OVERLAP    ql <= lo <= qh <= hi          (query right-overlap)
    ④ QUERY_CONTAINING ql <= lo <= hi <= qh          (query covers object)

plus the two disjoint Allen relations (Appendix A), supported standalone:

    BEFORE  qh <  lo        AFTER  hi <  ql

Attribute values live in a finite ordered domain ``A`` (paper's a_1 < ... < a_|A|).
All index structures work on integer *ranks* into A; float query endpoints are
mapped with searchsorted so predicate evaluation is exact.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np

LEFT_OVERLAP = 1        # case ①
QUERY_CONTAINED = 2     # case ②
RIGHT_OVERLAP = 4       # case ③
QUERY_CONTAINING = 8    # case ④
BEFORE = 16             # Allen <  : whole object strictly after query
AFTER = 32              # Allen >  : whole object strictly before query

ANY_OVERLAP = LEFT_OVERLAP | QUERY_CONTAINED | RIGHT_OVERLAP | QUERY_CONTAINING

_ATOMIC = (LEFT_OVERLAP, QUERY_CONTAINED, RIGHT_OVERLAP, QUERY_CONTAINING)

# Problem-variant shorthands (paper Table 1).
RFANN_MASK = QUERY_CONTAINING   # point object attr, a_i in [ql, qh]
IFANN_MASK = QUERY_CONTAINING   # [l_i, r_i] subset of [ql, qh]
TSANN_MASK = QUERY_CONTAINED    # ql = qh = t_q in [l_i, r_i]


def mask_name(mask: int) -> str:
    parts = []
    for bit, nm in ((1, "1"), (2, "2"), (4, "3"), (8, "4"), (16, "<"), (32, ">")):
        if mask & bit:
            parts.append(nm)
    return "|".join(parts) if parts else "none"


# Token vocabulary for :func:`parse_mask`. Single digits follow the paper's
# case numbering (so "4" is case ④ = QUERY_CONTAINING, not raw bit 4);
# multi-digit tokens are raw integer masks.
_MASK_TOKENS = {
    "1": LEFT_OVERLAP, "left_overlap": LEFT_OVERLAP,
    "2": QUERY_CONTAINED, "query_contained": QUERY_CONTAINED,
    "contains": QUERY_CONTAINED,
    "3": RIGHT_OVERLAP, "right_overlap": RIGHT_OVERLAP,
    "4": QUERY_CONTAINING, "query_containing": QUERY_CONTAINING,
    "contained_by": QUERY_CONTAINING, "containedby": QUERY_CONTAINING,
    "<": BEFORE, "before": BEFORE,
    ">": AFTER, "after": AFTER,
    "any_overlap": ANY_OVERLAP, "overlap": ANY_OVERLAP, "overlaps": ANY_OVERLAP,
    "rfann": RFANN_MASK, "ifann": IFANN_MASK, "tsann": TSANN_MASK,
    "none": 0,
}

FULL_MASK = ANY_OVERLAP | BEFORE | AFTER


def parse_mask(text) -> int:
    """Inverse of :func:`mask_name`: parse ``"1|2|<"``, ``"any_overlap"``,
    ``"before,after"``, a raw integer mask (``"15"`` or an int), or any
    ``|``/``,``/``+``/whitespace-separated mix of those tokens.

    Caution: in *strings*, the single digits ``"1"``–``"4"`` are the paper's
    case numbers (``"4"`` -> QUERY_CONTAINING, bit 8) so that ``mask_name``
    output round-trips; only multi-digit string tokens (``"15"``) and actual
    ints are raw bitmasks — ``parse_mask("3") != parse_mask(3)``."""
    if isinstance(text, (int, np.integer)):
        mask = int(text)
        if not 0 <= mask <= FULL_MASK:
            raise ValueError(f"mask {mask} outside [0, {FULL_MASK}]")
        return mask
    if not isinstance(text, str):
        raise TypeError(f"predicate mask must be an int or str, got "
                        f"{type(text).__name__}")
    s = text.strip().lower()
    if not s:
        raise ValueError("empty predicate mask string")
    mask = 0
    for tok in (t for t in _split_mask_tokens(s) if t):
        if tok in _MASK_TOKENS:
            mask |= _MASK_TOKENS[tok]
        elif tok.isdigit():
            val = int(tok)
            if not 0 <= val <= FULL_MASK:
                raise ValueError(f"mask {val} outside [0, {FULL_MASK}]")
            mask |= val
        else:
            raise ValueError(
                f"unknown predicate token {tok!r} "
                f"(known: {sorted(_MASK_TOKENS)} or an integer mask)")
    return mask


def _split_mask_tokens(s: str) -> List[str]:
    for sep in (",", "+", " ", "\t"):
        s = s.replace(sep, "|")
    return [t.strip() for t in s.split("|")]


def eval_predicate(mask, lo, hi, ql, qh):
    """Vectorized truth of the RR predicate. Works for numpy arrays or torch
    tensors.

    ``lo/hi`` are object endpoints, ``ql/qh`` query endpoints; any mix of floats
    and integer ranks is fine as long as the two sides share one coordinate
    system.
    """
    out = (lo <= ql) & False  # typed all-false of broadcast shape (numpy or torch)
    if mask & LEFT_OVERLAP:
        out = out | ((lo <= ql) & (ql <= hi) & (hi <= qh))
    if mask & QUERY_CONTAINED:
        out = out | ((lo <= ql) & (qh <= hi))
    if mask & RIGHT_OVERLAP:
        out = out | ((ql <= lo) & (lo <= qh) & (qh <= hi))
    if mask & QUERY_CONTAINING:
        out = out | ((ql <= lo) & (hi <= qh))
    if mask & BEFORE:
        out = out | (qh < lo)
    if mask & AFTER:
        out = out | (hi < ql)
    return out


class AttributeDomain:
    """The finite ordered attribute domain A with exact float<->rank mapping."""

    def __init__(self, values: np.ndarray):
        vals = np.unique(np.asarray(values))
        if vals.size == 0:
            raise ValueError("empty attribute domain")
        self.values = vals.astype(np.float64)
        self.K = int(vals.size)

    @classmethod
    def from_ranges(cls, lo: np.ndarray, hi: np.ndarray) -> "AttributeDomain":
        return cls(np.concatenate([np.asarray(lo).ravel(), np.asarray(hi).ravel()]))

    def rank(self, x) -> np.ndarray:
        """Exact rank of values known to be in A."""
        r = np.searchsorted(self.values, x, side="left")
        return r.astype(np.int32)

    # Query endpoints may fall between domain values.
    def floor_rank(self, x) -> np.ndarray:
        """Largest rank i with A[i] <= x, or -1."""
        return (np.searchsorted(self.values, x, side="right") - 1).astype(np.int64)

    def ceil_rank(self, x) -> np.ndarray:
        """Smallest rank i with A[i] >= x, or K."""
        return np.searchsorted(self.values, x, side="left").astype(np.int64)


class SelectivityIndex:
    """Exact O(1)-per-query RR-predicate selectivity over a fixed object set.

    Every atomic predicate (and the Allen BEFORE/AFTER bits) is a conjunction
    of comparisons between the object's ``(lo_rank, hi_rank)`` and the
    query's floor/ceil ranks, so its truth region is an axis-aligned
    rectangle in rank space and a *mask* (any disjunction) is a union of such
    rectangles. This index answers "how many objects satisfy mask" with a
    handful of lookups into a 2-D prefix-sum table ``P[a, b] =
    #{lo_rank < a and hi_rank < b}``: the query's cut points split each rank
    axis into at most 4 intervals, the union is evaluated cell-by-cell on the
    resulting (disjoint) <= 4x4 grid, so overlapping predicate bits are never
    double-counted and the count is exact — no per-object work at query time.

    The table is ``(K+1)^2`` int32 (~16 MB at K=2048); callers should fall
    back to :func:`eval_predicate` scans for larger domains.
    """

    def __init__(self, lo_rank: np.ndarray, hi_rank: np.ndarray, K: int):
        lo_rank = np.asarray(lo_rank, np.int64).ravel()
        hi_rank = np.asarray(hi_rank, np.int64).ravel()
        if lo_rank.shape != hi_rank.shape:
            raise ValueError("lo_rank and hi_rank must align")
        if lo_rank.size and (min(lo_rank.min(), hi_rank.min()) < 0
                             or max(lo_rank.max(), hi_rank.max()) >= K):
            raise ValueError("ranks must lie in [0, K)")
        self.K = int(K)
        self.m = int(lo_rank.size)
        H = np.zeros((K + 1, K + 1), np.int32)
        np.add.at(H, (lo_rank + 1, hi_rank + 1), 1)
        self.P = H.cumsum(0).cumsum(1)

    def _rect(self, a0, a1, b0, b1) -> np.ndarray:
        """#objects with lo_rank in [a0, a1] and hi_rank in [b0, b1]
        (vectorized; inverted or out-of-range rectangles count 0)."""
        K, P = self.K, self.P
        a0c = np.clip(a0, 0, K)
        a1c = np.clip(a1 + 1, 0, K)
        b0c = np.clip(b0, 0, K)
        b1c = np.clip(b1 + 1, 0, K)
        cnt = (P[a1c, b1c] - P[a0c, b1c] - P[a1c, b0c] + P[a0c, b0c])
        return np.where((a1c > a0c) & (b1c > b0c), cnt, 0).astype(np.int64)

    @staticmethod
    def _segments(ends: np.ndarray, K: int):
        """Split [0, K-1] at per-query cut ``ends`` -> 4 inclusive
        (start, end) segment pairs (some may be empty)."""
        e = np.sort(np.concatenate(
            [ends, np.full((ends.shape[0], 1), K - 1)], axis=1), axis=1)
        s = np.concatenate(
            [np.zeros((e.shape[0], 1), np.int64), e[:, :-1] + 1], axis=1)
        return s, e

    def count(self, mask: int, fl, cl, fr, cr) -> np.ndarray:
        """(Q,) exact number of objects satisfying ``mask`` for queries given
        by their endpoint ranks (``fl/cl`` = floor/ceil rank of qlo, ``fr/cr``
        of qhi, as produced by :class:`AttributeDomain`). All <= 16 grid
        cells are evaluated in one broadcast pass."""
        fl = np.asarray(fl, np.int64)
        cl = np.asarray(cl, np.int64)
        fr = np.asarray(fr, np.int64)
        cr = np.asarray(cr, np.int64)
        K = self.K
        zero = np.zeros_like(fl)
        top = np.full_like(fl, K - 1)
        # single-rectangle masks skip the grid decomposition entirely
        if mask == ANY_OVERLAP:  # closed ranges overlap <=> lo<=qh & ql<=hi
            return self._rect(zero, fr, cl, top)
        if mask == LEFT_OVERLAP:
            return self._rect(zero, fl, cl, fr)
        if mask == QUERY_CONTAINED:
            return self._rect(zero, fl, cr, top)
        if mask == RIGHT_OVERLAP:
            return self._rect(cl, fr, cr, top)
        if mask == QUERY_CONTAINING:
            return self._rect(cl, top, zero, fr)
        if mask == BEFORE:
            return self._rect(fr + 1, top, zero, top)
        if mask == AFTER:
            return self._rect(zero, top, zero, cl - 1)
        lo_s, lo_e = self._segments(np.stack([fl, cl - 1, fr], 1), self.K)
        hi_s, hi_e = self._segments(np.stack([cl - 1, fr, cr - 1], 1), self.K)
        a0, a1 = lo_s[:, :, None], lo_e[:, :, None]        # (Q, 4, 1)
        b0, b1 = hi_s[:, None, :], hi_e[:, None, :]        # (Q, 1, 4)
        flq, clq = fl[:, None, None], cl[:, None, None]
        frq, crq = fr[:, None, None], cr[:, None, None]
        # atomic truth is constant inside a cell; test it at the lower corner
        hit = np.zeros((fl.shape[0], a0.shape[1], b0.shape[2]), bool)
        if mask & LEFT_OVERLAP:
            hit |= (a0 <= flq) & (b0 >= clq) & (b0 <= frq)
        if mask & QUERY_CONTAINED:
            hit |= (a0 <= flq) & (b0 >= crq)
        if mask & RIGHT_OVERLAP:
            hit |= (a0 >= clq) & (a0 <= frq) & (b0 >= crq)
        if mask & QUERY_CONTAINING:
            hit |= (a0 >= clq) & (b0 <= frq)
        if mask & BEFORE:
            hit |= np.broadcast_to(a0 >= frq + 1, hit.shape)
        if mask & AFTER:
            hit |= np.broadcast_to(b0 <= clq - 1, hit.shape)
        cells = np.where(hit, self._rect(a0, a1, b0, b1), 0)
        return cells.sum(axis=(1, 2))

    def fraction(self, mask: int, fl, cl, fr, cr) -> np.ndarray:
        """(Q,) fraction of the indexed objects satisfying ``mask``."""
        if self.m == 0:
            return np.zeros(np.asarray(fl).shape[0], np.float64)
        return self.count(mask, fl, cl, fr, cr) / float(self.m)


# MSTG index variants (paper §4.4).
VARIANT_T = "T"       # versions: ascending l   (objects with l_i <= a_x); tree key r_i
VARIANT_TP = "Tp"     # versions: descending r  (objects with r_i >= a_x); tree key l_i
VARIANT_TPP = "Tpp"   # versions: descending l  (objects with l_i >= a_x); tree key r_i


@dataclasses.dataclass(frozen=True)
class SearchTask:
    """One beam search on one MSTG variant.

    version   : max transformed sort-rank that is valid (objects with
                sort_rank <= version participate); version < 0 means empty.
    key_lo/hi : inclusive tree-key rank range (raw rank space, 0..K-1);
                key_lo > key_hi means empty.
    """

    variant: str
    version: int
    key_lo: int
    key_hi: int

    def is_empty(self, K: int) -> bool:
        return self.version < 0 or self.key_lo > self.key_hi or self.key_lo >= K


def variants_required(mask: int) -> List[str]:
    """Which MSTG variants a deployment must build to serve ``mask``."""
    return sorted({t.variant for t in plan_searches_ranked(mask, 0, 0, 1, 1, 4)},
                  reverse=True)


def plan_searches(domain: AttributeDomain, mask: int, ql: float, qh: float) -> List[SearchTask]:
    """Theorem 4.1 planner: any RR disjunction -> at most two SearchTasks.

    (The Allen BEFORE/AFTER bits each add one more task; they reduce to RFANN
    threshold filters, Appendix A.)
    """
    if ql > qh:
        raise ValueError("query range must have ql <= qh")
    fl = int(domain.floor_rank(ql))   # max rank with A[rank] <= ql  (or -1)
    cl = int(domain.ceil_rank(ql))    # min rank with A[rank] >= ql  (or K)
    fr = int(domain.floor_rank(qh))
    cr = int(domain.ceil_rank(qh))
    return [t for t in plan_searches_ranked(mask, fl, cl, fr, cr, domain.K)
            if not t.is_empty(domain.K)]


def plan_searches_ranked(mask: int, fl: int, cl: int, fr: int, cr: int, K: int) -> List[SearchTask]:
    """Planner on pre-computed rank bounds (see ``plan_searches``).

    Returns the UNFILTERED task list — the task sequence depends only on
    ``mask``, so batched planning can align per-query parameters slot by slot;
    per-query-empty tasks keep their slot (version < 0 or key_lo > key_hi)."""
    tasks: List[SearchTask] = []
    top = K - 1
    atomic = mask & ANY_OVERLAP

    def T(version, key_lo, key_hi):
        tasks.append(SearchTask(VARIANT_T, version, key_lo, key_hi))

    def Tp(version, key_lo, key_hi):
        tasks.append(SearchTask(VARIANT_TP, version, key_lo, key_hi))

    def Tpp(version, key_lo, key_hi):
        tasks.append(SearchTask(VARIANT_TPP, version, key_lo, key_hi))

    # -- the 15 non-empty atomic combinations, each <= 2 searches (Thm 4.1) --
    if atomic == QUERY_CONTAINED:                       # {2}: l<=ql, r>=qh
        T(fl, cr, top)
    elif atomic == LEFT_OVERLAP:                        # {1}: l<=ql, ql<=r<=qh
        T(fl, cl, fr)
    elif atomic == RIGHT_OVERLAP:                       # {3}: ql<=l<=qh, r>=qh
        Tp(top - cr, cl, fr)
    elif atomic == QUERY_CONTAINING:                    # {4}: l>=ql, r<=qh
        Tpp(top - cl, 0, fr)
    elif atomic == LEFT_OVERLAP | QUERY_CONTAINED:      # {1,2}: l<=ql, r>=ql
        T(fl, cl, top)
    elif atomic == QUERY_CONTAINED | RIGHT_OVERLAP:     # {2,3}: l<=qh, r>=qh
        T(fr, cr, top)
    elif atomic == RIGHT_OVERLAP | QUERY_CONTAINING:    # {3,4}: ql<=l<=qh (r>=l free'd to r>=ql)
        Tp(top - cl, cl, fr)
    elif atomic == LEFT_OVERLAP | RIGHT_OVERLAP:        # {1,3}
        T(fl, cl, fr)
        Tp(top - cr, cl, fr)
    elif atomic == LEFT_OVERLAP | QUERY_CONTAINING:     # {1,4}
        T(fl, cl, fr)
        Tpp(top - cl, 0, fr)
    elif atomic == QUERY_CONTAINED | QUERY_CONTAINING:  # {2,4}
        T(fl, cr, top)
        Tpp(top - cl, 0, fr)
    elif atomic == LEFT_OVERLAP | QUERY_CONTAINED | RIGHT_OVERLAP:      # {1,2,3}
        T(fl, cl, top)
        Tp(top - cr, cl, fr)
    elif atomic == LEFT_OVERLAP | QUERY_CONTAINED | QUERY_CONTAINING:   # {1,2,4}
        T(fl, cl, top)
        Tpp(top - cl, 0, fr)
    elif atomic == LEFT_OVERLAP | RIGHT_OVERLAP | QUERY_CONTAINING:     # {1,3,4}
        T(fl, cl, fr)
        Tp(top - cl, cl, fr)
    elif atomic == QUERY_CONTAINED | RIGHT_OVERLAP | QUERY_CONTAINING:  # {2,3,4}
        T(fr, cr, top)
        Tpp(top - cl, 0, fr)
    elif atomic == ANY_OVERLAP:                         # {1,2,3,4}: any intersection
        T(fl, cl, top)
        Tp(top - cl, cl, fr)
    elif atomic != 0:
        raise AssertionError(f"unhandled atomic mask {atomic}")

    # -- Allen disjoint relations (Appendix A): RFANN threshold filters --
    if mask & BEFORE:   # object strictly after query: l_i > qh
        # l_i >= A[rank] where rank = first rank with value > qh
        lo_rank = fr + 1 if cr == fr else cr  # first rank with A[rank] > qh
        Tpp(top - lo_rank, 0, top)
    if mask & AFTER:    # object strictly before query: r_i < ql
        hi_rank = cl - 1 if cl == fl else fl  # last rank with A[rank] < ql
        T(top, 0, hi_rank)

    return tasks


class PlanSlot(NamedTuple):
    """One task slot of a batched plan: ``version``/``key_lo``/``key_hi`` are
    (Q,) int64 arrays; a query's slot is empty when ``version < 0`` or
    ``key_lo > key_hi`` (same convention as :class:`SearchTask`)."""

    variant: str
    version: np.ndarray
    key_lo: np.ndarray
    key_hi: np.ndarray

    def empty_mask(self, K: int) -> np.ndarray:
        return (self.version < 0) | (self.key_lo > self.key_hi) | (self.key_lo >= K)


def plan_batch_ranked(mask: int, fl, cl, fr, cr, K: int) -> List[PlanSlot]:
    """Vectorized Theorem 4.1 planner over (Q,) rank-bound arrays.

    Array-native twin of :func:`plan_searches_ranked`: for a fixed ``mask`` the
    task sequence (variant per slot) is query-independent, so every slot's
    ``(version, key_lo, key_hi)`` is a pure arithmetic function of the per-query
    rank bounds ``fl``/``cl``/``fr``/``cr`` — no per-query Python. Slot order
    and per-slot values agree exactly with the scalar planner (property-tested
    in tests/test_engine.py); per-query-empty tasks keep their slot.
    """
    fl = np.asarray(fl, dtype=np.int64)
    cl = np.asarray(cl, dtype=np.int64)
    fr = np.asarray(fr, dtype=np.int64)
    cr = np.asarray(cr, dtype=np.int64)
    shape = np.broadcast_shapes(fl.shape, cl.shape, fr.shape, cr.shape)
    top = K - 1
    atomic = mask & ANY_OVERLAP
    slots: List[PlanSlot] = []

    def _b(x) -> np.ndarray:
        return np.broadcast_to(np.asarray(x, dtype=np.int64), shape).copy()

    def T(version, key_lo, key_hi):
        slots.append(PlanSlot(VARIANT_T, _b(version), _b(key_lo), _b(key_hi)))

    def Tp(version, key_lo, key_hi):
        slots.append(PlanSlot(VARIANT_TP, _b(version), _b(key_lo), _b(key_hi)))

    def Tpp(version, key_lo, key_hi):
        slots.append(PlanSlot(VARIANT_TPP, _b(version), _b(key_lo), _b(key_hi)))

    # -- the 15 non-empty atomic combinations (same dispatch as the scalar
    #    planner; expressions are element-wise so they broadcast over (Q,)) --
    if atomic == QUERY_CONTAINED:                       # {2}
        T(fl, cr, top)
    elif atomic == LEFT_OVERLAP:                        # {1}
        T(fl, cl, fr)
    elif atomic == RIGHT_OVERLAP:                       # {3}
        Tp(top - cr, cl, fr)
    elif atomic == QUERY_CONTAINING:                    # {4}
        Tpp(top - cl, 0, fr)
    elif atomic == LEFT_OVERLAP | QUERY_CONTAINED:      # {1,2}
        T(fl, cl, top)
    elif atomic == QUERY_CONTAINED | RIGHT_OVERLAP:     # {2,3}
        T(fr, cr, top)
    elif atomic == RIGHT_OVERLAP | QUERY_CONTAINING:    # {3,4}
        Tp(top - cl, cl, fr)
    elif atomic == LEFT_OVERLAP | RIGHT_OVERLAP:        # {1,3}
        T(fl, cl, fr)
        Tp(top - cr, cl, fr)
    elif atomic == LEFT_OVERLAP | QUERY_CONTAINING:     # {1,4}
        T(fl, cl, fr)
        Tpp(top - cl, 0, fr)
    elif atomic == QUERY_CONTAINED | QUERY_CONTAINING:  # {2,4}
        T(fl, cr, top)
        Tpp(top - cl, 0, fr)
    elif atomic == LEFT_OVERLAP | QUERY_CONTAINED | RIGHT_OVERLAP:      # {1,2,3}
        T(fl, cl, top)
        Tp(top - cr, cl, fr)
    elif atomic == LEFT_OVERLAP | QUERY_CONTAINED | QUERY_CONTAINING:   # {1,2,4}
        T(fl, cl, top)
        Tpp(top - cl, 0, fr)
    elif atomic == LEFT_OVERLAP | RIGHT_OVERLAP | QUERY_CONTAINING:     # {1,3,4}
        T(fl, cl, fr)
        Tp(top - cl, cl, fr)
    elif atomic == QUERY_CONTAINED | RIGHT_OVERLAP | QUERY_CONTAINING:  # {2,3,4}
        T(fr, cr, top)
        Tpp(top - cl, 0, fr)
    elif atomic == ANY_OVERLAP:                         # {1,2,3,4}
        T(fl, cl, top)
        Tp(top - cl, cl, fr)
    elif atomic != 0:
        raise AssertionError(f"unhandled atomic mask {atomic}")

    # -- Allen disjoint relations: the scalar planner's conditionals become
    #    np.where over the exact-endpoint predicate --
    if mask & BEFORE:   # l_i > qh
        lo_rank = np.where(cr == fr, fr + 1, cr)
        Tpp(top - lo_rank, 0, top)
    if mask & AFTER:    # r_i < ql
        hi_rank = np.where(cl == fl, cl - 1, fl)
        T(top, 0, hi_rank)

    return slots


def check_plan_cover(mask: int, tasks: Sequence[SearchTask], rl: np.ndarray,
                     rr: np.ndarray, fl: int, cl: int, fr: int, cr: int, K: int) -> bool:
    """Test helper: does the union of task-candidate sets equal the predicate set?

    ``rl``/``rr`` are the objects' endpoint ranks. Membership of a task is
    evaluated on the variant's (sort_rank, tree_key) encoding.
    """
    top = K - 1
    sel = np.zeros(rl.shape[0], dtype=bool)
    for t in tasks:
        if t.variant == VARIANT_T:
            s, k = rl, rr
        elif t.variant == VARIANT_TP:
            s, k = top - rr, rl
        else:
            s, k = top - rl, rr
        sel |= (s <= t.version) & (k >= t.key_lo) & (k <= t.key_hi)
    want = eval_predicate(mask, rl, rr,
                          np.float64(_rank_interp(fl, cl)), np.float64(_rank_interp(fr, cr)))
    return bool(np.array_equal(sel, want))


def _rank_interp(floor_r: int, ceil_r: int) -> float:
    """A synthetic query coordinate in rank space: exact rank if floor==ceil,
    else halfway between the two surrounding ranks."""
    if floor_r == ceil_r:
        return float(floor_r)
    return (floor_r + ceil_r) / 2.0
