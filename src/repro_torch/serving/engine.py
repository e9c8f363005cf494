"""Serving: cache seeding (prefill -> decode layout), greedy generation,
and the sync retrieval front end (the reference's ``repro.serving.engine``).

* :class:`ServeEngine` — batched greedy decoding over the port's
  :class:`repro_torch.models.LM` on a device (the card unless the caller
  asks for the CPU); :func:`seed_caches` places prefill caches into the
  decode layout.
* :class:`RetrievalServer` — queues requests and answers a whole tick at
  once: the tick's queue is embedded in one ``embed_fn`` call and executed
  grouped by predicate mask against any ``execute(SearchRequest)`` backend
  (:class:`repro_torch.core.QueryEngine`,
  :class:`repro_torch.streaming.SegmentedIndex` or
  :class:`repro_torch.distributed.ShardedDeployment`).

This module takes a model instance and never imports one, so importing
the serving layer pulls in no model code.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..core import QueryEngine, QueryHit, SearchRequest, as_mask
from ..core.engine import resolve_device
from .ops import DeleteOp, QueryOp, UpsertOp
from .scheduler import ServerMetrics


def _seed_leaf(prefill_leaf, target, prompt_len: int):
    """Place a prefill cache leaf into its decode-capacity layout: zeros of
    ``target``'s shape and dtype with the prompt's entries written in.

    ``target.seq_axis`` says where the leaf's sequence axis lies, counted
    from the end: third for a (.., B, S, Hkv, Dh) kv leaf, second for
    MLA's (.., B, S, r) leaves (the repeat axis of a stacked segment comes
    first). A recurrent state has none (``None``): it has the decode shape
    already and is taken as it is. A prompt longer than a ring cache keeps
    its last M entries at their ring slots (pos % M)."""
    x = prefill_leaf.to(target.dtype)
    if tuple(x.shape) == tuple(target.shape):
        return x
    seq_axis = getattr(target, "seq_axis", None)
    if seq_axis is None:
        raise ValueError(f"cache leaf of shape {tuple(x.shape)} has no "
                         f"sequence axis; the decode layout needs "
                         f"{tuple(target.shape)}")
    z = torch.zeros(target.shape, dtype=target.dtype, device=x.device)
    ax = x.ndim + seq_axis
    M, P = target.shape[ax], x.shape[ax]
    if P <= M:
        z.narrow(ax, 0, P).copy_(x)
        return z
    slots = torch.arange(P - M, P, device=x.device) % M
    z.index_copy_(ax, slots, x.narrow(ax, P - M, M))
    return z


def seed_caches(lm, prefill_caches, batch: int, max_len: int,
                prompt_len: int, enc_len: int = 0):
    """Convert prefill caches (prompt-length kv and latents, recurrent
    states) into the decode cache layout of ``lm.decode_cache_meta``, on
    the prefill caches' device."""
    metas = lm.decode_cache_meta(batch, max_len, enc_len)
    return [_map_tree(lambda m, leaf: _seed_leaf(leaf, m, prompt_len),
                      seg_meta, seg_cache)
            for seg_meta, seg_cache in zip(metas, prefill_caches)]


def _map_tree(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (the
    model's ``params.map_tree``; this module imports no model code)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_tree(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray        # (B, n_new) int32
    logits_last: np.ndarray   # (B, 1, vocab) float32


class ServeEngine:
    """Batched greedy decoding over the port's LM.

    ``params`` is a parameter tree (``None``: the LM's registered
    parameters), moved to ``device`` (``None`` means ``"cuda"``, which
    raises without a card). :meth:`generate` prefills, seeds the decode
    caches and decodes token by token, updating the caches in place; it
    returns host numpy arrays like the reference's. ``torch.argmax`` picks
    the first maximum, as ``jnp.argmax`` does.
    """

    def __init__(self, lm, params=None, *, device=None):
        self.lm = lm
        self.device = resolve_device(device)
        params = lm.params if params is None else params
        self.params = _map_tree(lambda t: t.to(self.device), params)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any], n_new: int,
                 max_len: int) -> GenerationResult:
        lm = self.lm
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, P = tokens.shape
        logits, prefill_caches = lm.prefill(self.params, {"tokens": tokens})
        caches = seed_caches(lm, prefill_caches, B, max_len, P)
        out = []
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for i in range(n_new):
            out.append(cur)
            logits, caches = lm.decode_step(self.params, caches, cur, P + i)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return GenerationResult(
            tokens=torch.cat(out, 1).to(torch.int32).cpu().numpy(),
            logits_last=logits.float().cpu().numpy())


class _Embedder:
    """One stacked ``embed_fn`` call per tick or round, with the reference's
    batched-vs-per-item probe: it runs once, on the first call, and a
    signature or shape error there switches to a per-item loop for the
    server's lifetime (a batched-only embedder must not raise on its first
    batch). After an embedder has proven batched, every exception
    propagates, so a transient failure never latches the per-item loop.
    This concerns the embedder only; nothing here touches the device."""

    def __init__(self, embed_fn):
        self.embed_fn = embed_fn
        self.batched: Optional[bool] = None

    def __call__(self, items: List[Any]) -> np.ndarray:
        if self.batched:
            return np.ascontiguousarray(np.asarray(self.embed_fn(items)),
                                        np.float32)
        if self.batched is None:
            try:
                vecs = np.asarray(self.embed_fn(items))
                if vecs.ndim == 2 and vecs.shape[0] == len(items):
                    self.batched = True
                    return np.ascontiguousarray(vecs, np.float32)
            except (TypeError, ValueError, IndexError, KeyError,
                    AttributeError):
                pass  # a per-item embedder given a list: loop below
            self.batched = False
        return np.stack([np.asarray(self.embed_fn(it), np.float32)
                         for it in items])


class RetrievalServer:
    """The paper's serving scenario: requests carry an item (embedded to a
    query vector by ``embed_fn``) and an RR
    :class:`repro_torch.core.Predicate`; answers come from the backend's
    ``execute``. Batched: requests are queued, the whole tick's queue is
    embedded in **one** ``embed_fn`` call, then executed grouped by
    predicate mask so each group is one vectorized plan (the engine pads
    ragged groups to bucket sizes). Each answer is a
    :class:`repro_torch.core.QueryHit`.

    Live corpora: when ``engine`` is a mutable index (anything with
    ``add``/``delete`` — i.e. :class:`repro_torch.streaming.SegmentedIndex`),
    :meth:`submit_upsert` / :meth:`submit_delete` queue corpus mutations.
    A tick applies every queued mutation in submit order *before* running the
    tick's queries, so a query always sees the mutations submitted ahead of
    it; upserted items share the tick's single batched ``embed_fn`` call.

    ``embed_fn`` should be batched — called with the list of queued items,
    returning a ``(B, d)`` array. Per-item embedders (one item -> one
    ``(d,)`` vector) are detected on the first tick and looped over, as in
    the reference; this concerns the embedder only, not the device.

    Background compaction: when the engine is mutable and compactable (a
    :class:`repro_torch.streaming.SegmentedIndex`), every tick that applied at
    least one mutation ends by offering the engine's
    :class:`repro_torch.streaming.CompactionPolicy` a ``compact()`` — the policy
    decides whether any segment tier is worth merging, so idle ticks and
    well-compacted indexes cost nothing. ``auto_compact=False`` restores
    the manual-only behavior. Per-tick counters land in ``tick_stats``
    (including ``compactions``) and accumulate in ``stats``.
    """

    def __init__(self, engine, embed_fn, k: int = 10, ef: int = 64,
                 auto_compact: bool = True):
        # ``engine`` is anything with the declarative .execute(SearchRequest)
        # entry point: QueryEngine, SegmentedIndex, or a
        # repro_torch.distributed.ShardedDeployment.
        self.engine = engine
        self.k = k
        self.ef = ef
        self.auto_compact = auto_compact
        # typed op queue (.ops) in submit order
        self.queue: List[Any] = []
        self._t_submit: List[float] = []  # perf_counter at submit, per op
        self._embed = _Embedder(embed_fn)
        self.tick_stats: Dict[str, Any] = self._zero_stats()  # last tick
        self.stats: Dict[str, Any] = self._zero_stats()       # cumulative
        # the same cumulative metrics structure the async server records, so
        # one snapshot() schema covers both front ends (queue-wait here is
        # submit -> tick dispatch; e2e is submit -> answer materialized)
        self.metrics = ServerMetrics()

    @staticmethod
    def _zero_stats() -> Dict[str, Any]:
        # counts are ints; *_s entries are wall-clock seconds for the tick's
        # phases (embed / mutations+compaction / search / whole tick), so the
        # sync server reports numbers comparable to the async ServerMetrics
        return {"ticks": 0, "queries": 0, "upserts": 0, "deletes": 0,
                "compactions": 0, "compacted_rows": 0, "degraded_queries": 0,
                "embed_s": 0.0, "mutate_s": 0.0, "search_s": 0.0,
                "tick_s": 0.0}

    @classmethod
    def from_index(cls, index, embed_fn, k: int = 10, ef: int = 64,
                   config=None, *, device=None):
        """A server over a new :class:`QueryEngine` on ``device`` (None:
        ``"cuda"``)."""
        return cls(QueryEngine(index, config=config, device=device),
                   embed_fn, k=k, ef=ef)

    @property
    def mutable(self) -> bool:
        """Whether the backing engine accepts upserts/deletes."""
        return hasattr(self.engine, "add") and hasattr(self.engine, "delete")

    def submit(self, item, qlo: float, qhi: float, predicate):
        """Queue one request; ``predicate`` is a Predicate, a raw int mask,
        or a parseable string like ``"any_overlap"``."""
        self.queue.append(QueryOp(item, float(qlo), float(qhi),
                                  as_mask(predicate)))
        self._t_submit.append(time.perf_counter())
        self.metrics.record_admitted()

    def submit_upsert(self, ext_id: int, item, lo: float, hi: float):
        """Queue a corpus upsert: ``item`` is embedded on the next tick (in
        the tick's one batched call) and inserted under stable ``ext_id``
        with object range ``[lo, hi]``."""
        if not self.mutable:
            raise TypeError("engine is a frozen index; upserts need a "
                            "repro_torch.streaming.SegmentedIndex")
        self.queue.append(UpsertOp(int(ext_id), item, float(lo), float(hi)))
        self._t_submit.append(time.perf_counter())
        self.metrics.record_admitted()

    def submit_delete(self, ext_id: int):
        """Queue a corpus delete (tombstone) of ``ext_id``."""
        if not self.mutable:
            raise TypeError("engine is a frozen index; deletes need a "
                            "repro_torch.streaming.SegmentedIndex")
        self.queue.append(DeleteOp(int(ext_id)))
        self._t_submit.append(time.perf_counter())
        self.metrics.record_admitted()

    def tick(self):
        """Apply queued mutations (submit order), auto-compact if any were
        applied (policy-gated), then execute all queued requests ->
        {submit order index: QueryHit}. Mutation entries occupy submit-order
        slots but produce no result entry; ``tick_stats`` describes what the
        tick did (queries/upserts/deletes/compactions)."""
        if not self.queue:
            # an idle tick did nothing: tick_stats must say so, not replay
            # the previous tick's counters into a caller's metrics loop
            self.tick_stats = self._zero_stats()
            return {}
        tick_stats = self._zero_stats()
        tick_stats["ticks"] = 1
        t_tick = time.perf_counter()
        t_dispatch = {i: t_tick - t for i, t in enumerate(self._t_submit)}
        degraded_idx: set = set()
        with obs.span("tick") as tsp:
            tsp.set("ops", len(self.queue))
            # one batched embed call for the whole tick: queries AND upserts
            embed_slots = [i for i, op in enumerate(self.queue)
                           if isinstance(op, (QueryOp, UpsertOp))]
            items = [self.queue[i].item for i in embed_slots]
            vec_of = {}
            if items:
                t0 = time.perf_counter()
                with obs.span("embed") as esp:
                    esp.set("items", len(items))
                    vecs = self._embed(items)
                tick_stats["embed_s"] = time.perf_counter() - t0
                vec_of = {i: vecs[j] for j, i in enumerate(embed_slots)}
            # 1) mutations, strictly in submit order
            t0 = time.perf_counter()
            with obs.span("mutate") as msp:
                for i, op in enumerate(self.queue):
                    if isinstance(op, UpsertOp):
                        self.engine.add(np.array([op.ext_id], np.int64),
                                        vec_of[i][None, :], np.array([op.lo]),
                                        np.array([op.hi]))
                        tick_stats["upserts"] += 1
                    elif isinstance(op, DeleteOp):
                        self.engine.delete(np.array([op.ext_id], np.int64),
                                           strict=False)
                        tick_stats["deletes"] += 1
                # 1b) background compaction: after a mutating tick, let the
                # engine's CompactionPolicy decide whether a segment tier is
                # worth merging (compact() no-ops when it picks no victims)
                if (self.auto_compact
                        and tick_stats["upserts"] + tick_stats["deletes"] > 0
                        and hasattr(self.engine, "compact")):
                    rep = self.engine.compact()
                    if rep.get("merged"):
                        tick_stats["compactions"] += 1
                        tick_stats["compacted_rows"] += rep.get("rows", 0)
                msp.set("upserts", tick_stats["upserts"])
                msp.set("deletes", tick_stats["deletes"])
            tick_stats["mutate_s"] = time.perf_counter() - t0
            # 2) queries, grouped by predicate mask
            t0 = time.perf_counter()
            results = {}
            by_mask: Dict[int, List[int]] = {}
            for i, op in enumerate(self.queue):
                if isinstance(op, QueryOp):
                    by_mask.setdefault(op.mask, []).append(i)
            with obs.span("search") as ssp:
                ssp.set("groups", len(by_mask))
                for mask, idxs in by_mask.items():
                    qlo = np.array([self.queue[i].qlo for i in idxs])
                    qhi = np.array([self.queue[i].qhi for i in idxs])
                    qvecs = np.stack([vec_of[i] for i in idxs])
                    res = self.engine.execute(SearchRequest(
                        qvecs, (qlo, qhi), mask, k=self.k, ef=self.ef))
                    ids, d = res.ids, res.dists
                    if getattr(res, "degraded", False):
                        # sharded backend answered with shards missing — the
                        # answers are still served, but the operator should
                        # see the count
                        tick_stats["degraded_queries"] += len(idxs)
                        degraded_idx.update(idxs)
                    for j, i in enumerate(idxs):
                        results[i] = QueryHit(ids[j], d[j])
            tick_stats["search_s"] = time.perf_counter() - t0
        tick_stats["queries"] = len(results)
        tick_stats["tick_s"] = time.perf_counter() - t_tick
        self.tick_stats = tick_stats
        for k_, v in tick_stats.items():
            self.stats[k_] += v
        # unified ServerMetrics accounting: one record per op, same meaning
        # as the async server's (queue = submit -> dispatch, e2e = submit ->
        # answer ready)
        t_end = time.perf_counter()
        for i, op in enumerate(self.queue):
            wait_s = t_dispatch.get(i, 0.0)
            e2e_s = wait_s + (t_end - t_tick)
            self.metrics.record_served(wait_s * 1e3, e2e_s * 1e3,
                                       degraded=i in degraded_idx,
                                       mutation=not isinstance(op, QueryOp))
        self.metrics.steps += 1
        self.queue.clear()
        self._t_submit.clear()
        return results

    def snapshot(self) -> Dict[str, Any]:
        """Operator metrics in the SAME schema as
        :meth:`repro_torch.serving.AsyncRetrievalServer.snapshot` (the sync server
        has no WavefrontStreams, so the occupancy/refill keys are absent —
        exactly as an idle async server's snapshot would render them)."""
        return self.metrics.snapshot()
