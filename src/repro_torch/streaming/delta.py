"""Mutable in-memory delta buffer — the L0 of the streaming MSTG.

Freshly upserted objects land here and are served by an exact predicate-masked
brute-force scan (:func:`repro_torch.core.flat.flat_search`, the same
kernels as the static flat route) until
``SegmentedIndex.flush()`` freezes them into an immutable MSTG segment.

Storage is a capacity-doubling host arena: rows are appended in arrival order
and never moved, deletes mark the row dead by setting its range endpoints to
NaN (NaN fails every RR comparison, in the kernel's predicate and in the
plain :func:`repro_torch.core.intervals.eval_predicate` alike, so a dead row
can never be selected). Capacities are powers of two, so the scan sees
O(log n) distinct shapes, not one per insert. The arena is staged on the
searching device at the first search after a change and reused until the
next ``add``, ``kill`` or ``clear``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.engine import resolve_device
from ..core.flat import flat_search
from ..core.hnsw import NO_EDGE
from ..core.search import as_tensor

_MIN_CAPACITY = 64


class DeltaBuffer:
    """Append-only (vector, [lo, hi], external id) arena with dead-row marks.

    ``ext_of_row`` / ``row_of_ext`` bookkeeping guarantees at most one *live*
    row per external id; re-adding an id kills the old row first (upsert).
    """

    def __init__(self, d: Optional[int] = None):
        self.d = d
        self._cap = 0
        self._size = 0          # rows appended (live + dead)
        self.n_dead = 0
        self._vecs: Optional[np.ndarray] = None
        self._lo = np.zeros(0)
        self._hi = np.zeros(0)
        self._ext = np.zeros(0, np.int64)
        self._row_of_ext: Dict[int, int] = {}
        # (device, corpus, lo, hi) of the arena as last staged; None after
        # any change
        self._staged: Optional[tuple] = None

    # ---- sizes ----
    def __len__(self) -> int:
        """Live rows."""
        return self._size - self.n_dead

    @property
    def nbytes(self) -> int:
        if self._vecs is None:
            return 0
        return (self._vecs.nbytes + self._lo.nbytes + self._hi.nbytes
                + self._ext.nbytes)

    def bytes_breakdown(self) -> dict:
        """Per-tier byte accounting (MSTGIndex.storage_bytes schema subset).
        The delta buffer is always exact float32 — quantization happens at
        segment freeze — so codes/scales are structurally zero."""
        full = 0 if self._vecs is None else int(self._vecs.nbytes)
        return {"storage_dtype": "float32", "float32_rerank": full,
                "codes": 0, "scales": 0, "sq_norm": 0, "scan_bytes": full,
                "compression_ratio": 1.0}

    def __contains__(self, ext_id: int) -> bool:
        return int(ext_id) in self._row_of_ext

    def _grow(self, need: int, d: int) -> None:
        if self._vecs is None:
            self.d = d
        elif d != self.d:
            raise ValueError(f"vector dim {d} != buffer dim {self.d}")
        cap = max(self._cap, _MIN_CAPACITY)
        while cap < need:
            cap *= 2
        if cap == self._cap:
            return
        vecs = np.zeros((cap, self.d), np.float32)
        lo = np.full(cap, np.nan)
        hi = np.full(cap, np.nan)
        ext = np.full(cap, NO_EDGE, np.int64)
        if self._vecs is not None:
            vecs[:self._size] = self._vecs[:self._size]
            lo[:self._size] = self._lo[:self._size]
            hi[:self._size] = self._hi[:self._size]
            ext[:self._size] = self._ext[:self._size]
        self._vecs, self._lo, self._hi, self._ext = vecs, lo, hi, ext
        self._cap = cap
        self._staged = None

    # ---- mutation ----
    @staticmethod
    def validate(ext_ids, vectors, lo, hi, d: Optional[int] = None):
        """Normalize + validate one upsert batch WITHOUT mutating anything
        -> (ext_ids, vectors, lo, hi). Callers that must apply side effects
        before appending (e.g. SegmentedIndex discarding old copies) call
        this first so a rejected batch never leaves partial state."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        ext_ids = np.asarray(ext_ids, np.int64).ravel()
        lo = np.asarray(lo, np.float64).ravel()
        hi = np.asarray(hi, np.float64).ravel()
        if vectors.ndim != 2 or not (len(ext_ids) == vectors.shape[0]
                                     == len(lo) == len(hi)):
            raise ValueError("ext_ids, vectors, lo, hi must agree on rows")
        if d is not None and vectors.shape[1] != d:
            raise ValueError(f"vector dim {vectors.shape[1]} != buffer dim {d}")
        if np.any(lo > hi) or np.any(~np.isfinite(lo)) or np.any(~np.isfinite(hi)):
            raise ValueError("object ranges must be finite with lo <= hi")
        if len(np.unique(ext_ids)) != len(ext_ids):
            raise ValueError("duplicate external ids in one add() batch")
        return ext_ids, vectors, lo, hi

    def add(self, ext_ids: np.ndarray, vectors: np.ndarray,
            lo: np.ndarray, hi: np.ndarray) -> None:
        """Append rows (upsert: an id already live in the buffer is killed
        first). Callers own cross-structure upsert semantics; within the
        buffer ids stay unique."""
        self._append(*self.validate(ext_ids, vectors, lo, hi, d=self.d))

    def _append(self, ext_ids: np.ndarray, vectors: np.ndarray,
                lo: np.ndarray, hi: np.ndarray) -> None:
        """Append a batch that already went through :meth:`validate`."""
        self._grow(self._size + len(ext_ids), vectors.shape[1])
        for e in ext_ids:
            self.kill(int(e))  # in-buffer upsert
        s = self._size
        b = len(ext_ids)
        self._vecs[s:s + b] = vectors
        self._lo[s:s + b] = lo
        self._hi[s:s + b] = hi
        self._ext[s:s + b] = ext_ids
        for j, e in enumerate(ext_ids):
            self._row_of_ext[int(e)] = s + j
        self._size += b
        self._staged = None

    def kill(self, ext_id: int) -> bool:
        """Mark the live row of ``ext_id`` dead; False if not in the buffer."""
        row = self._row_of_ext.pop(int(ext_id), None)
        if row is None:
            return False
        self._lo[row] = np.nan
        self._hi[row] = np.nan
        self._ext[row] = NO_EDGE
        self.n_dead += 1
        self._staged = None
        return True

    def clear(self) -> None:
        self.__init__(self.d)

    # ---- read views (live rows, arrival order) ----
    def live(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(ext_ids, vectors, lo, hi) of live rows in arrival order."""
        alive = np.isfinite(self._lo[:self._size])
        return (self._ext[:self._size][alive].copy(),
                self._vecs[:self._size][alive].copy(),
                self._lo[:self._size][alive].copy(),
                self._hi[:self._size][alive].copy())

    # ---- search ----
    def _arena(self, device: torch.device):
        """The whole arena (capacity rows) on ``device``: float32 vectors
        and float32 endpoints, NaN on dead and unused rows."""
        if self._staged is None or self._staged[0] != device:
            self._staged = (device,
                            as_tensor(self._vecs, device,
                                      torch.float32).contiguous(),
                            as_tensor(self._lo, device, torch.float32),
                            as_tensor(self._hi, device, torch.float32))
        return self._staged[1:]

    def search(self, queries: np.ndarray, qlo: np.ndarray, qhi: np.ndarray,
               mask: int, k: int, *, device=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact predicate-masked brute force over live rows on ``device``
        (``None`` means ``"cuda"``) -> ``(Q, k')`` external ids (NO_EDGE
        pad) + squared distances, with ``k' = min(k, capacity)``. Dead and
        unused rows carry NaN ranges and are unselectable."""
        Q = queries.shape[0]
        if len(self) == 0 or Q == 0:
            return (np.full((Q, 0), NO_EDGE, np.int64),
                    np.full((Q, 0), np.inf, np.float32))
        dev = resolve_device(device)
        corpus, lo, hi = self._arena(dev)
        k_eff = min(int(k), self._cap)
        ids, d = flat_search(
            corpus, lo, hi,
            as_tensor(np.ascontiguousarray(queries, np.float32), dev,
                      torch.float32).contiguous(),
            as_tensor(qlo, dev, torch.float32),
            as_tensor(qhi, dev, torch.float32), mask=int(mask), k=k_eff)
        ids = ids.cpu().numpy()
        d = d.cpu().numpy()
        ext = np.where(ids >= 0, self._ext[np.clip(ids, 0, None)],
                       np.int64(NO_EDGE))
        return ext, d
