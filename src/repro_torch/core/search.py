"""Wavefront MSTG graph search in PyTorch (paper Algorithm 4, §4.1/§4.4).

The counterpart of the JAX reference's ``repro.core.search``. A whole query
batch advances together; each step expands the ``fanout`` closest
unexpanded pool vertices per query with

    1. one gather from the per-level labeled adjacency (the decomposition
       nodes are disjoint, so a vertex's neighbors live at exactly one
       level),
    2. label masking ``b <= version <= e`` (edges only connect qualifying
       members: the paper's "never traverse a non-qualifying vertex"),
    3. a packed visited bitmap and a first-occurrence dedupe, and
    4. the fused step kernel (:func:`repro_torch.kernels.ops.gathered_topk`,
       or :func:`~repro_torch.kernels.ops.gathered_topk_quant` over an int8
       or float16 code table): gather + squared L2 + label mask + sorted
       beam merge.

Termination matches Algorithm 4: a query is done when its L best are all
expanded. A converged row's step is the identity, so the drivers check for
convergence once per chunk of steps (each check is one device sync), never
after every step, and running past convergence changes nothing. Step counts
come from the per-row ``alive_steps`` counters, so they equal the
reference's, which stops its ``lax.while_loop`` at convergence.

Ties follow the reference: every pick that ``lax.top_k`` or the stable
``jnp.argsort`` makes there is a stable ascending sort here.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import obs
from ..kernels import ops
from . import segment_tree as st
from .hnsw import NO_EDGE
from .mstg import FrozenVariant

INF = float("inf")
# steps between convergence checks of the single-loop driver
CHECK_EVERY = 8

_FV_TENSORS = ("sort_rank", "tkey", "nbr", "lab_b", "lab_e", "entry_ids",
               "entry_ver", "members", "member_ver", "node_off")


def as_tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy -> tensor on ``device``; on the CPU a contiguous array of the
    right type is shared, not copied."""
    t = torch.as_tensor(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def device_variant(fv: FrozenVariant, vectors, device,
                   store: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """A :class:`FrozenVariant`'s arrays staged on ``device`` as a dict of
    tensors (the reference's ``DeviceVariant.tree()``). ``vectors`` is the
    staged float32 corpus, shared by every variant. With ``store`` (the
    engine's staged quantized store: ``codes``, ``scale``, ``offset`` on
    ``device``) the table is the int8 or float16 code matrix instead, with
    its (d,) dequant params as ``vec_scale`` / ``vec_offset``; the float32
    corpus is not needed (``vectors`` may be None)."""
    arrays = {f: as_tensor(getattr(fv, f), device) for f in _FV_TENSORS}
    if store is not None:
        arrays["vectors"] = store["codes"]
        arrays["vec_scale"] = store["scale"]
        arrays["vec_offset"] = store["offset"]
    else:
        arrays["vectors"] = vectors
    return arrays


def _quant(arrays: dict):
    """(scale, offset) when ``arrays`` holds a code table, else None."""
    if "vec_scale" in arrays:
        return arrays["vec_scale"], arrays["vec_offset"]
    return None


def _gather_dequant(vectors, idx, quant):
    """Gather rows by index and, on a code table, dequantize the gathered
    rows only, in the reference's order: widen, multiply, then add."""
    rows = vectors[idx]
    if quant is None:
        return rows
    scale, offset = quant
    return rows.to(torch.float32) * scale + offset


# ---- bit-packed visited sets ------------------------------------------------

def packed_words(n: int) -> int:
    """Words per query row of a packed visited bitmap (32 vertices each)."""
    return (int(n) + 31) // 32


def _visited_init(Q: int, n: int, packed: bool, device):
    # Packed words are int64 holding 32 bits each: torch has no uint32
    # scatter-add, and with the high half unused a scatter-add of distinct
    # bits can never wrap. Dense sets are int8 so a scatter can take a max.
    if packed:
        return torch.zeros((Q, packed_words(n)), dtype=torch.int64,
                           device=device)
    return torch.zeros((Q, n), dtype=torch.int8, device=device)


def _visited_get(visited, ids, packed: bool):
    """(Q, M) bool: is each (clamped, >= 0) id already visited in its row."""
    ids = ids.to(torch.int64)
    if packed:
        w = visited.gather(1, ids >> 5)
        return ((w >> (ids & 31)) & 1) != 0
    return visited.gather(1, ids) != 0


def _visited_set(visited, ids, mark, packed: bool):
    """Set the bits for ``ids`` where ``mark``. Marked ids are unique per
    row and not yet visited (the callers guarantee both), so the packed
    scatter-add touches each bit at most once and equals a scatter-OR."""
    ids = ids.to(torch.int64)
    if packed:
        upd = torch.where(mark, torch.ones_like(ids) << (ids & 31), 0)
        return visited.scatter_add(1, ids >> 5, upd)
    return visited.scatter_reduce(1, ids, mark.to(torch.int8), "amax")


def _first_occurrence(ids):
    """(Q, M) bool: True at the first occurrence of each value per row.
    A stable sort puts equal values in position order, so the first of each
    run is the earliest occurrence; O(M log M) where the reference's
    pairwise compare is O(M^2), which a wide step (M = fanout * slots in
    the thousands) cannot afford."""
    sv, order = torch.sort(ids, dim=1, stable=True)
    first = torch.ones_like(sv, dtype=torch.bool)
    first[:, 1:] = sv[:, 1:] != sv[:, :-1]
    return torch.zeros_like(first).scatter(1, order, first)


# ---- search state construction ----------------------------------------------

def _active_rows(pool_d, expanded):
    """A query is live while any finite pool entry is unexpanded."""
    return (~expanded & torch.isfinite(pool_d)).any(dim=1)


def _plan_nodes(key_lo, key_hi, Kpad: int):
    """Per-query canonical decomposition + covered key ranges."""
    levels, idxs, valid = st.decompose_batched(key_lo, key_hi, Kpad)
    start, end = st.node_ranges(levels, idxs, Kpad)
    return levels, idxs, valid, start, end


def _init_state(vectors, entry_ids, entry_ver, queries, version,
                levels, idxs, valid, *, L: int, packed: bool, quant=None):
    """Initial pool from per-node entry points + visited marking.
    ``quant`` is the code table's (scale, offset), or None."""
    Q = queries.shape[0]
    n = vectors.shape[0]
    dev = queries.device
    lv, ix = levels.to(torch.int64), idxs.to(torch.int64)
    ent = entry_ids[lv, ix]                  # (Q, P, E)
    ever = entry_ver[lv, ix]                 # (Q, P, E)
    ent_ok = (valid[:, :, None] & (ent != NO_EDGE)
              & (ever <= version[:, None, None]))
    ent = torch.where(ent_ok, ent, 0).reshape(Q, -1)
    ent_ok = ent_ok.reshape(Q, -1)
    ed = ops.gathered_l2(queries,
                         _gather_dequant(vectors, ent.to(torch.int64), quant))
    ed = torch.where(ent_ok, ed, INF)
    ent = torch.where(ent_ok, ent, NO_EDGE)

    sd, order = torch.sort(ed, dim=1, stable=True)
    take = min(L, ent.shape[1])
    pool_ids = torch.full((Q, L), NO_EDGE, dtype=torch.int32, device=dev)
    pool_d = torch.full((Q, L), INF, dtype=torch.float32, device=dev)
    pool_ids[:, :take] = ent.gather(1, order)[:, :take].to(torch.int32)
    pool_d[:, :take] = sd[:, :take]
    expanded = torch.zeros((Q, L), dtype=torch.bool, device=dev)

    mark = ent != NO_EDGE
    ent_safe = torch.where(mark, ent, 0)
    if packed:
        # entries across disjoint decomposition nodes are distinct vertices;
        # the dedupe is defensive (a duplicate would double-add its bit)
        cols = torch.arange(ent.shape[1], device=dev, dtype=ent.dtype)
        mark = mark & _first_occurrence(torch.where(mark, ent, n + cols))
    visited = _visited_init(Q, n, packed, dev)
    visited = _visited_set(visited, ent_safe, mark, packed)
    alive_steps = torch.zeros((Q,), dtype=torch.int32, device=dev)
    return pool_ids, pool_d, expanded, visited, alive_steps


def _step(arrays, queries, version, nodes, state, *, F: int, packed: bool):
    """One wavefront step over the whole batch. State: (pool_ids, pool_d,
    expanded, visited, alive_steps)."""
    vectors, tkey, nbr = arrays["vectors"], arrays["tkey"], arrays["nbr"]
    levels, idxs, valid, start, end = nodes
    pool_ids, pool_d, expanded, visited, alive_steps = state
    Q = queries.shape[0]
    S = nbr.shape[2]
    n = vectors.shape[0]
    alive_steps = alive_steps + _active_rows(pool_d, expanded).to(torch.int32)
    frontier_d = torch.where(expanded, INF, pool_d)
    # expand the F closest unexpanded pool vertices at once
    fd, slot = torch.sort(frontier_d, dim=1, stable=True)
    fd, slot = fd[:, :F], slot[:, :F]                          # (Q, F)
    act = torch.isfinite(fd)
    u = pool_ids.gather(1, slot)
    u_safe = torch.where(act, u, 0).to(torch.int64)
    expanded = expanded.scatter(1, slot, expanded.gather(1, slot) | act)

    # which decomposition node covers u -> its level   (Q, F)
    t = tkey[u_safe][..., None]                                # (Q, F, 1)
    inside = (valid[:, None, :] & (t >= start[:, None, :])
              & (t <= end[:, None, :]))                        # (Q, F, P)
    lvl = torch.where(inside, levels[:, None, :], -1).amax(dim=-1)
    lvl_safe = lvl.clamp(0, nbr.shape[0] - 1).to(torch.int64)
    tg = nbr[lvl_safe, u_safe].reshape(Q, F * S)               # (Q, F*S)
    b = arrays["lab_b"][lvl_safe, u_safe].reshape(Q, F * S)
    e = arrays["lab_e"][lvl_safe, u_safe].reshape(Q, F * S)
    ok = ((act & (lvl >= 0)).repeat_interleave(S, dim=1) & (tg != NO_EDGE)
          & (b <= version[:, None]) & (version[:, None] <= e))
    tg_safe = torch.where(ok, tg, 0)
    # dedupe within the step: keep only the first occurrence of each id (one
    # vertex's slot list never repeats a live target, so F == 1 needs no
    # dedupe). Invalid slots get out-of-range sentinels so they can never
    # shadow the real corpus vertex 0.
    seen = _visited_get(visited, tg_safe, packed)
    if F > 1:
        cols = torch.arange(F * S, dtype=tg.dtype, device=tg.device)
        ok = ok & _first_occurrence(torch.where(ok, tg, n + cols))
    new = ok & ~seen
    visited = _visited_set(visited, tg_safe, new, packed)
    quant = _quant(arrays)
    if quant is not None:
        pool_ids, pool_d, expanded = ops.gathered_topk_quant(
            queries, vectors, quant[0], quant[1], tg, new, b, e, version,
            pool_ids, pool_d, expanded)
    else:
        pool_ids, pool_d, expanded = ops.gathered_topk(
            queries, vectors, tg, new, b, e, version, pool_ids, pool_d,
            expanded)
    return pool_ids, pool_d, expanded, visited, alive_steps


def _prepare(arrays, queries, version, key_lo, key_hi, Kpad: int):
    dev = arrays["vectors"].device
    with obs.span("stage"):
        queries = torch.as_tensor(queries,
                                  dtype=torch.float32).to(dev).contiguous()
        version = torch.as_tensor(version).to(dev, torch.int32)
        key_lo = torch.as_tensor(key_lo).to(dev, torch.int32)
        key_hi = torch.as_tensor(key_hi).to(dev, torch.int32)
    return queries, version, _plan_nodes(key_lo, key_hi, Kpad)


def _graph_init(arrays, queries, version, nodes, *, ef: int, packed: bool):
    levels, idxs, valid = nodes[:3]
    return _init_state(arrays["vectors"], arrays["entry_ids"],
                       arrays["entry_ver"], queries, version, levels, idxs,
                       valid, L=ef, packed=packed, quant=_quant(arrays))


# ---- single-loop driver (runs to global convergence) -------------------------

def mstg_graph_search(arrays: dict, queries, version, key_lo, key_hi, *,
                      k: int, ef: int, max_steps: int, Kpad: int,
                      fanout: int = 1, with_steps: bool = False,
                      packed: bool = True):
    """Batched beam search on one MSTG variant.

    arrays   : :func:`device_variant` dict
    queries  : (Q, d) float32
    version  : (Q,) int — max valid sort rank (< 0 => empty task)
    key_lo/hi: (Q,) int — inclusive tree-key range (lo > hi => empty)
    fanout   : frontier vertices expanded per step
    packed   : packed visited bitmap (default) vs the dense (Q, n) set —
               identical results
    returns  : ids (Q, k) int32 (NO_EDGE pad), dists (Q, k) float32 (+inf
               pad) as tensors on the arrays' device, plus the step count
               when ``with_steps``
    """
    queries, version, nodes = _prepare(arrays, queries, version, key_lo,
                                       key_hi, Kpad)
    state = _graph_init(arrays, queries, version, nodes, ef=ef, packed=packed)
    steps = 0
    while steps < max_steps and bool(_active_rows(state[1], state[2]).any()):
        for _ in range(min(CHECK_EVERY, max_steps - steps)):
            state = _step(arrays, queries, version, nodes, state, F=fanout,
                          packed=packed)
            steps += 1
    pool_ids, pool_d = state[0], state[1]
    if with_steps:
        return pool_ids[:, :k], pool_d[:, :k], int(state[4].max()) if \
            state[4].numel() else 0
    return pool_ids[:, :k], pool_d[:, :k]


# ---- chunked driver (wavefront compaction between chunks) -------------------

def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def mstg_graph_search_chunked(arrays: dict, queries, version, key_lo, key_hi,
                              *, k: int, ef: int, max_steps: int, Kpad: int,
                              fanout: int = 1, chunk: int = 16,
                              min_bucket: int = 8, packed: bool = True,
                              with_stats: bool = False):
    """Run the beam search in ``chunk``-step slices and compact the
    still-active rows to a power-of-two bucket between slices.

    Per-row trajectories are independent (a converged row's step is the
    identity), so results equal :func:`mstg_graph_search`'s bit for bit.
    Returns ``(ids, dists)`` as numpy arrays, plus a stats dict when
    ``with_stats`` (total steps, per-query convergence steps, executed vs
    useful candidate-evaluation counts).
    """
    queries, version, nodes = _prepare(arrays, queries, version, key_lo,
                                       key_hi, Kpad)
    k = min(k, ef)
    chunk = max(int(chunk), 1)
    Q = queries.shape[0]
    S = arrays["nbr"].shape[2]

    out_ids = np.full((Q, k), NO_EDGE, np.int32)
    out_d = np.full((Q, k), np.inf, np.float32)
    conv_steps = np.zeros(Q, np.int64)

    state = _graph_init(arrays, queries, version, nodes, ef=ef, packed=packed)
    qs, ver = queries, version
    perm = np.arange(Q)                      # current row -> original query
    active_h = _active_rows(state[1], state[2]).cpu().numpy()
    total = 0
    executed_row_steps = 0
    harvested = np.zeros(Q, bool)

    def harvest(rows: np.ndarray) -> None:
        if rows.size == 0:
            return
        with obs.span("harvest"):
            r = torch.as_tensor(rows, device=qs.device)
            orig = perm[rows]
            out_ids[orig] = state[0][r, :k].cpu().numpy()
            out_d[orig] = state[1][r, :k].cpu().numpy()
            conv_steps[orig] = state[4][r].cpu().numpy()
            harvested[orig] = True

    while True:
        live = np.flatnonzero(active_h)
        done = np.flatnonzero(~active_h)
        # harvest rows not yet written (duplicated pad rows rewrite the same
        # values — their trajectories are copies of a live row's)
        harvest(done[~harvested[perm[done]]])
        if live.size == 0 or total >= max_steps:
            if live.size:
                harvest(live)                # truncated at the step budget
            break
        cur_Q = int(qs.shape[0])
        bucket = min(max(min_bucket, _next_pow2(live.size)), cur_Q)
        if bucket < cur_Q:
            pad = bucket - live.size
            idx = np.concatenate([live, live[:1].repeat(pad)]) if pad \
                else live
            ix = torch.as_tensor(idx, device=qs.device)
            qs, ver = qs[ix], ver[ix]
            nodes = tuple(a[ix] for a in nodes)
            state = tuple(a[ix] for a in state)
            perm = perm[idx]
        limit = min(chunk, max_steps - total)
        with obs.span("chunk") as csp:
            before = state[4]
            for _ in range(limit):
                state = _step(arrays, qs, ver, nodes, state, F=fanout,
                              packed=packed)
            # the reference's loop stops once every row has converged; the
            # steps it ran are the most any row was still live for
            ran = int((state[4] - before).max())
            active_h = _active_rows(state[1], state[2]).cpu().numpy()
            if obs.tracing():
                csp.set("rows", int(qs.shape[0])).set("live", int(live.size))
                csp.set("steps", ran)
                csp.set("evals_executed", int(qs.shape[0]) * ran * fanout * S)
        total += ran
        executed_row_steps += int(qs.shape[0]) * ran

    if obs.tracing():
        u = int(conv_steps.sum())
        obs.span("wavefront_totals").set("steps", total) \
            .set("evals_executed", executed_row_steps * fanout * S) \
            .set("evals_useful", u * fanout * S).stop()
    if not with_stats:
        return out_ids, out_d
    useful = int(conv_steps.sum())
    stats = {
        "steps": total,
        "conv_steps": conv_steps,
        "evals_executed": executed_row_steps * fanout * S,
        "evals_useful": useful * fanout * S,
        "wasted_eval_frac": (1.0 - useful / executed_row_steps
                             if executed_row_steps else 0.0),
    }
    return out_ids, out_d, stats


# ---- continuous-batching stream (slot refill between chunks) ---------------

def _rows(tree, idx):
    """Row-select every tensor of a nested tuple of per-row tensors."""
    if isinstance(tree, tuple):
        return tuple(_rows(a, idx) for a in tree)
    return tree[idx]


def _concat_rows(a, b):
    """Concatenate two nested tuples of per-row tensors along the rows."""
    if isinstance(a, tuple):
        return tuple(_concat_rows(x, y) for x, y in zip(a, b))
    return torch.cat([a, b], dim=0)


class WavefrontStream:
    """Continuous-batching wavefront driver over one MSTG variant.

    The chunked driver (:func:`mstg_graph_search_chunked`) compacts
    converged rows *out* of the active batch; this driver also admits newly
    arrived queries *into* the freed slots between chunks, so the device
    batch stays near-full while single queries enter and leave mid-flight.

    Correctness contract: per-row trajectories are independent (the step is
    the identity for converged rows, and init, distances and merge are all
    row-local), so every query's ``(ids, dists)`` is **bit-identical** to
    running it alone through :func:`mstg_graph_search` /
    :func:`mstg_graph_search_chunked` with the same ``ef`` / ``fanout`` /
    ``packed`` / ``max_steps``, whatever shared its batch and whenever it
    was admitted.

    Usage::

        stream = WavefrontStream(engine.graph_dev("T"), ef=64,
                                 Kpad=index.variants["T"].Kpad)
        stream.admit(tags, queries, version, key_lo, key_hi, max_steps=320)
        while not stream.idle:
            for tag, ids, dists, steps in stream.step():
                ...   # one converged (or budget-truncated) query

    ``tags`` are opaque non-negative ints the caller routes results by;
    harvested rows return the full ``ef``-wide beam and the row's step
    count (slice ``[:k]`` for a request's k).

    Batch mechanics follow the reference: rows live in power-of-two buckets
    (``min_bucket`` .. ``max_bucket``, a power of two); pad rows are
    empty-task or duplicated rows with tag -1, never harvested. A chunk's
    step budget is ``min(chunk, min remaining budget over live rows)``, so
    a truncated query stops at exactly its ``max_steps``. Within a chunk
    the stream checks every :data:`CHECK_EVERY` steps whether any row is
    still live and stops early once none is (one device sync per check);
    a converged row's step is the identity, so this changes no result, and
    the steps a chunk counts are the reference's (the most any row was
    live for, from ``alive_steps``).

    Counters read by the serving metrics: ``executed_row_steps`` (slots x
    steps paid), ``useful_row_steps`` (per-row convergence steps),
    ``refills`` / ``refilled_rows`` (admissions into a running batch),
    ``occupancy_rows`` / ``occupancy_capacity`` (live rows and bucket width
    summed per chunk), ``chunks``.
    """

    def __init__(self, arrays: dict, *, ef: int, Kpad: int, fanout: int = 1,
                 chunk: int = 16, min_bucket: int = 8, max_bucket: int = 256,
                 packed: bool = True):
        if max_bucket < 1 or (max_bucket & (max_bucket - 1)):
            raise ValueError(f"max_bucket must be a power of two, got "
                             f"{max_bucket}")
        self.arrays = arrays
        self.ef = int(ef)
        self.Kpad = int(Kpad)
        self.fanout = max(1, int(fanout))
        self.chunk = max(1, int(chunk))
        self.min_bucket = min(int(min_bucket), max_bucket)
        self.max_bucket = int(max_bucket)
        self.packed = bool(packed)
        # pending admissions (host-side, FIFO)
        self._pending: list = []
        # in-flight device rows: queries, versions, plan nodes, search
        # state; perm -1 marks pad and harvested rows
        self._rows = None
        self._perm = np.zeros(0, np.int64)
        self._steps_run = np.zeros(0, np.int64)
        self._budget = np.zeros(0, np.int64)
        self._active = np.zeros(0, bool)
        self.admitted = 0
        self.completed = 0
        self.refills = 0
        self.refilled_rows = 0
        self.chunks = 0
        self.executed_row_steps = 0
        self.useful_row_steps = 0
        self.occupancy_rows = 0
        self.occupancy_capacity = 0

    # ---- introspection ----
    @property
    def inflight(self) -> int:
        """Real (tagged) rows currently in the device batch."""
        return int((self._perm >= 0).sum())

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def idle(self) -> bool:
        return not self._pending and self.inflight == 0

    @property
    def refill_efficiency(self) -> float:
        """useful / executed row-steps (1.0: every paid slot-step advanced
        an unconverged query)."""
        if not self.executed_row_steps:
            return 1.0
        return self.useful_row_steps / self.executed_row_steps

    # ---- admission ----
    def admit(self, tags, queries, version, key_lo, key_hi,
              max_steps) -> None:
        """Queue rows for admission at the next :meth:`step`, one entry per
        row; ``max_steps`` is a scalar or per row."""
        queries = np.ascontiguousarray(queries, np.float32)
        tags = np.asarray(tags, np.int64).ravel()
        version = np.asarray(version, np.int64).ravel()
        key_lo = np.asarray(key_lo, np.int64).ravel()
        key_hi = np.asarray(key_hi, np.int64).ravel()
        budget = np.broadcast_to(np.asarray(max_steps, np.int64),
                                 tags.shape).copy()
        if np.any(tags < 0):
            raise ValueError("tags must be >= 0 (-1 is the pad sentinel)")
        if np.any(budget < 1):
            raise ValueError("max_steps must be >= 1")
        for i in range(tags.shape[0]):
            self._pending.append((int(tags[i]), queries[i], int(version[i]),
                                  int(key_lo[i]), int(key_hi[i]),
                                  int(budget[i])))
        self.admitted += int(tags.shape[0])

    # ---- internals ----
    def _init_new(self, count: int):
        """Pop ``count`` pending rows and build their search state, padded
        to a power-of-two block (pad rows carry empty tasks: version -1,
        key_lo > key_hi, converged before their first step)."""
        rows = self._pending[:count]
        del self._pending[:count]
        Nb = max(self.min_bucket, _next_pow2(count))
        d = rows[0][1].shape[0]
        q = np.zeros((Nb, d), np.float32)
        ver = np.full(Nb, -1, np.int64)
        klo = np.ones(Nb, np.int64)
        khi = np.zeros(Nb, np.int64)
        perm = np.full(Nb, -1, np.int64)
        budget = np.zeros(Nb, np.int64)
        for i, (tag, qv, v, lo, hi, b) in enumerate(rows):
            q[i], ver[i], klo[i], khi[i] = qv, v, lo, hi
            perm[i], budget[i] = tag, b
        qs, vj, nodes = _prepare(self.arrays, q, ver, klo, khi, self.Kpad)
        state = _graph_init(self.arrays, qs, vj, nodes, ef=self.ef,
                            packed=self.packed)
        active = _active_rows(state[1], state[2]).cpu().numpy()
        return (qs, vj, nodes, state), active, perm, budget

    def _compose(self) -> bool:
        """Drop dead rows, admit pending ones into the freed slots, and
        repack to a power-of-two bucket. Returns True when a runnable batch
        exists."""
        keep_mask = ((self._perm >= 0) & self._active
                     & (self._steps_run < self._budget))
        keep = np.flatnonzero(keep_mask)
        n_live = keep.size
        n_new = min(len(self._pending), max(0, self.max_bucket - n_live))
        if n_live == 0 and n_new == 0:
            self._rows = None
            self._perm = np.zeros(0, np.int64)
            self._active = np.zeros(0, bool)
            return False
        if n_new == 0:
            # no admissions: rebucket only when shrinking pays or a live but
            # budget-exhausted row must be evicted; converged rows ride
            # along as identity steps, as in the chunked driver
            cur = self._perm.shape[0]
            bucket = min(max(self.min_bucket, _next_pow2(n_live)), cur)
            zombies = bool(np.any(self._active & ~keep_mask))
            if bucket == cur and not zombies:
                return True
            idx, n_pad = self._pad_idx(keep, bucket,
                                       np.flatnonzero(~self._active))
            self._take(self._rows, self._active, self._perm, self._budget,
                       self._steps_run, idx, n_pad)
            return True
        if n_live:
            self.refills += 1
            self.refilled_rows += n_new
        new_rows, nactive, nperm, nbudget = self._init_new(n_new)
        nsteps = np.zeros(nperm.shape[0], np.int64)
        if n_live == 0:
            # nothing in flight survives: adopt the newcomer block as is
            self._rows = new_rows
            self._active, self._perm = nactive, nperm
            self._budget, self._steps_run = nbudget, nsteps
            return True
        # (kept live rows | newcomer rows | pads) from [old; newcomers]
        old_rows = self._perm.shape[0]
        active = np.concatenate([self._active, nactive])
        bucket = max(self.min_bucket, _next_pow2(n_live + n_new))
        take = np.concatenate([keep, old_rows + np.arange(n_new)])
        idx, n_pad = self._pad_idx(take, bucket, np.flatnonzero(~active))
        self._take(_concat_rows(self._rows, new_rows), active,
                   np.concatenate([self._perm, nperm]),
                   np.concatenate([self._budget, nbudget]),
                   np.concatenate([self._steps_run, nsteps]), idx, n_pad)
        return True

    @staticmethod
    def _pad_idx(take: np.ndarray, bucket: int, inactive: np.ndarray):
        """Row-index vector of length ``bucket``: the kept rows plus pad
        slots. Pads point at an inactive source row when one exists (no
        marginal work: converged rows run the identity), else duplicate the
        first kept row. Returns ``(idx, n_pad)``."""
        pad = bucket - take.size
        if pad <= 0:
            return take, 0
        src = inactive[0] if inactive.size else take[0]
        return np.concatenate([take, np.full(pad, src, np.int64)]), pad

    def _take(self, rows, active, perm, budget, steps, idx, n_pad) -> None:
        """Keep rows ``idx`` of the given batch; the last ``n_pad`` are
        pads."""
        ix = torch.as_tensor(idx, device=rows[0].device)
        self._rows = _rows(rows, ix)
        self._active = active[idx]
        perm = perm[idx]
        if n_pad:
            perm[idx.size - n_pad:] = -1
        self._perm = perm
        self._budget = budget[idx]
        self._steps_run = steps[idx]

    def _run_chunk(self, limit: int, any_live: bool) -> int:
        """Advance the batch by up to ``limit`` steps, stopping early once
        no row is live; returns the steps the reference's loop would run."""
        qs, ver, nodes, state = self._rows
        before = state[4]
        steps = 0
        while any_live and steps < limit:
            for _ in range(min(CHECK_EVERY, limit - steps)):
                state = _step(self.arrays, qs, ver, nodes, state,
                              F=self.fanout, packed=self.packed)
                steps += 1
            any_live = (steps < limit
                        and bool(_active_rows(state[1], state[2]).any()))
        self._rows = (qs, ver, nodes, state)
        return int((state[4] - before).max()) if steps else 0

    # ---- the serving loop entry point ----
    def step(self):
        """Compose (drop converged rows, refill from pending), run one
        chunk, and harvest rows that converged or used up their budget.

        Returns a list of ``(tag, ids, dists, steps)``: ids and dists are
        the full ``ef``-wide beam as numpy (NO_EDGE / +inf padded), steps
        the row's convergence (or truncation) step count.
        """
        with obs.span("chunk") as csp:
            if not self._compose():
                return []
            real = self._perm >= 0
            live = real & self._active & (self._steps_run < self._budget)
            remaining = self._budget[live] - self._steps_run[live]
            limit = (min(self.chunk, int(remaining.min())) if remaining.size
                     else self.chunk)
            bucket = self._perm.shape[0]
            n_live = int(live.sum())
            self.occupancy_rows += n_live
            self.occupancy_capacity += bucket
            ran = self._run_chunk(limit, n_live > 0)
            state = self._rows[3]
            self._active = _active_rows(state[1], state[2]).cpu().numpy()
            self._steps_run = self._steps_run + ran
            self.chunks += 1
            self.executed_row_steps += bucket * ran
            # harvest: converged, or truncated at exactly their step budget
            done = np.flatnonzero(real & (~self._active
                                          | (self._steps_run >= self._budget)))
            if obs.tracing():
                csp.set("live", n_live).set("bucket", bucket)
                csp.set("steps", ran).set("harvested", int(done.size))
                csp.set("occupancy", round(n_live / bucket, 4))
            if done.size == 0:
                return []
            r = torch.as_tensor(done, device=state[0].device)
            ids_h = state[0][r].cpu().numpy()
            d_h = state[1][r].cpu().numpy()
            steps_h = state[4][r].cpu().numpy()
            out = [(int(self._perm[row]), ids_h[j], d_h[j], int(steps_h[j]))
                   for j, row in enumerate(done)]
            self._perm[done] = -1
            self.completed += done.size
            self.useful_row_steps += int(steps_h.sum())
            return out

    def drain(self):
        """Run :meth:`step` until idle; returns every harvested row."""
        out = []
        while not self.idle:
            out.extend(self.step())
        return out


def merge_topk(ids_a, d_a, ids_b, d_b, k: int):
    """Merge two (Q, k) result sets, dropping duplicate ids (Theorem 4.1
    plans may overlap at predicate boundaries)."""
    ids = torch.cat([ids_a, ids_b], dim=1)
    d = torch.cat([d_a, d_b], dim=1)
    d, order = torch.sort(d, dim=1, stable=True)
    ids = ids.gather(1, order)
    # mark duplicates of any earlier (closer) id
    K = ids.shape[1]
    earlier = torch.ones((K, K), dtype=torch.bool,
                         device=ids.device).tril(diagonal=-1)
    dup = ids[:, :, None] == ids[:, None, :]
    is_dup = (dup & earlier[None] & (ids[:, None, :] != NO_EDGE)).any(dim=2)
    d = torch.where(is_dup, INF, d)
    ids = torch.where(is_dup, NO_EDGE, ids)
    d, order = torch.sort(d, dim=1, stable=True)
    return ids.gather(1, order)[:, :k], d[:, :k]
