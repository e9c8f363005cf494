"""First-class RR predicate algebra — the declarative face of paper §2.

The paper's four atomic range-range relations (Fig. 1) plus the two Allen
disjoint relations (Appendix A) become small immutable objects that compose
with ``|`` into arbitrary disjunctions, replacing hand-assembled int bitmasks
at every public entry point:

    >>> pred = LeftOverlap() | QueryContained() | Before()
    >>> pred.mask
    19
    >>> pred.variants_required()
    ['Tpp', 'T']

Every :class:`Predicate` is a thin wrapper over the exact bitmask encoding of
:mod:`repro_torch.core.intervals` — ``Predicate.from_mask(p.mask) == p`` and
``eval(repr(p))`` both round-trip, and ``Predicate.parse`` accepts everything
:func:`repro_torch.core.intervals.parse_mask` does (``"1|2|<"``, ``"any_overlap"``,
raw integers). Engines only ever see ``.mask``, so the algebra adds zero
planning or execution cost.

Naming follows the object-vs-query reading used throughout the paper:
``QueryContained`` / ``Contains`` — the object range covers the query range
(case ②); ``ContainedBy`` / ``QueryContaining`` — the query range covers the
object range (case ④); ``Overlaps`` — any intersection (cases ①|②|③|④).
"""
from __future__ import annotations

from typing import List, Union

from . import intervals as iv

__all__ = [
    "Predicate", "LeftOverlap", "RightOverlap", "QueryContained",
    "QueryContaining", "Contains", "ContainedBy", "Overlaps", "Before",
    "After", "as_predicate", "as_mask",
]

PredicateLike = Union["Predicate", int, str]


class Predicate:
    """An immutable disjunction of atomic RR relations, backed by a bitmask.

    Compose with ``|`` (accepts other predicates, raw int masks, or parseable
    strings); compare with ``==``; feed anywhere the API expects a predicate.
    """

    __slots__ = ("_mask",)

    def __init__(self, mask: int = 0):
        mask = int(mask)
        if not 0 <= mask <= iv.FULL_MASK:
            raise ValueError(f"mask {mask} outside [0, {iv.FULL_MASK}]")
        object.__setattr__(self, "_mask", mask)

    # ---- identity ----
    @property
    def mask(self) -> int:
        """The exact :mod:`repro_torch.core.intervals` bitmask this compiles to."""
        return self._mask

    @property
    def name(self) -> str:
        """Compact planner spelling, e.g. ``"1|2|<"`` (see ``mask_name``)."""
        return iv.mask_name(self._mask)

    def __eq__(self, other) -> bool:
        if isinstance(other, Predicate):
            return self._mask == other._mask
        if isinstance(other, int):
            return self._mask == other
        return NotImplemented

    def __hash__(self) -> int:
        # hash-consistent with the int equality above, so predicates and raw
        # masks interoperate as dict/set keys
        return hash(self._mask)

    def __bool__(self) -> bool:
        return self._mask != 0

    # ---- algebra ----
    def __or__(self, other: PredicateLike) -> "Predicate":
        return Predicate(self._mask | as_mask(other))

    __ror__ = __or__

    def __contains__(self, other: PredicateLike) -> bool:
        m = as_mask(other)
        return (self._mask & m) == m

    def atoms(self) -> List["Predicate"]:
        """The single-bit predicates whose disjunction equals ``self``."""
        return [Predicate(b) for b in _ATOM_ORDER if self._mask & b]

    # ---- round-trips ----
    @classmethod
    def from_mask(cls, mask: int) -> "Predicate":
        return cls(mask)

    @classmethod
    def parse(cls, text) -> "Predicate":
        """Parse any :func:`repro_torch.core.intervals.parse_mask` spelling."""
        return cls(iv.parse_mask(text))

    def __repr__(self) -> str:
        if self._mask == 0:
            return "Predicate(0)"
        if self._mask & iv.ANY_OVERLAP == iv.ANY_OVERLAP:
            parts = ["Overlaps()"]
            rest = self._mask & ~iv.ANY_OVERLAP
        else:
            parts, rest = [], self._mask
        parts += [_ATOM_REPR[b] for b in _ATOM_ORDER if rest & b]
        return " | ".join(parts)

    # ---- planner hooks ----
    def variants_required(self) -> List[str]:
        """Which MSTG variants an index must build to serve this predicate."""
        return iv.variants_required(self._mask)

    def evaluate(self, lo, hi, ql, qh):
        """Vectorized truth against object ranges (numpy arrays or torch tensors)."""
        return iv.eval_predicate(self._mask, lo, hi, ql, qh)


class _Atom(Predicate):
    """Fixed-mask predicate constructed with no arguments (``LeftOverlap()``)."""

    __slots__ = ()
    _MASK = 0

    def __init__(self):
        super().__init__(type(self)._MASK)


class LeftOverlap(_Atom):
    """Case ①: object starts before the query and ends inside it."""
    _MASK = iv.LEFT_OVERLAP


class QueryContained(_Atom):
    """Case ②: the object range covers the whole query range."""
    _MASK = iv.QUERY_CONTAINED


class RightOverlap(_Atom):
    """Case ③: object starts inside the query and ends after it."""
    _MASK = iv.RIGHT_OVERLAP


class QueryContaining(_Atom):
    """Case ④: the query range covers the whole object range."""
    _MASK = iv.QUERY_CONTAINING


class Before(_Atom):
    """Allen ``<``: the whole object lies strictly after the query."""
    _MASK = iv.BEFORE


class After(_Atom):
    """Allen ``>``: the whole object lies strictly before the query."""
    _MASK = iv.AFTER


class Overlaps(_Atom):
    """Any intersection between object and query range (①|②|③|④)."""
    _MASK = iv.ANY_OVERLAP


# Semantic aliases (object-centric reading).
Contains = QueryContained      # object ⊇ query
ContainedBy = QueryContaining  # object ⊆ query

_ATOM_ORDER = (iv.LEFT_OVERLAP, iv.QUERY_CONTAINED, iv.RIGHT_OVERLAP,
               iv.QUERY_CONTAINING, iv.BEFORE, iv.AFTER)
_ATOM_REPR = {
    iv.LEFT_OVERLAP: "LeftOverlap()",
    iv.QUERY_CONTAINED: "QueryContained()",
    iv.RIGHT_OVERLAP: "RightOverlap()",
    iv.QUERY_CONTAINING: "QueryContaining()",
    iv.BEFORE: "Before()",
    iv.AFTER: "After()",
}


def as_mask(pred: PredicateLike) -> int:
    """Normalize a Predicate | int | string to the engine bitmask."""
    if isinstance(pred, Predicate):
        return pred.mask
    return iv.parse_mask(pred)


def as_predicate(pred: PredicateLike) -> Predicate:
    """Normalize a Predicate | int | string to a :class:`Predicate`."""
    if isinstance(pred, Predicate):
        return pred
    return Predicate(iv.parse_mask(pred))
