"""What the mesh tests' two sides share: the mesh, the configs, the weights
and the inputs, all made from seeds on the CPU.

The reference side (``tests/_mesh_reference.py``, a subprocess with four
forced host devices) and the port side (``tests/_mesh_ranks.py``, four
gloo ranks) each build the same numpy weights with the port's
``init_tree`` on a seeded CPU generator and the same numpy inputs with
``numpy.random.default_rng``; the reference takes them as jax arrays
placed by its ``sharding_tree``, the port through
``convert.lm_params_from_arrays(..., mesh=)`` and ``init_tree(..., mesh=)``.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import TRAIN_CONDITIONING  # noqa: E402  (the card's too)

MESH_SHAPE = (2, 2)
MESH_AXES = ("data", "model")
WORLD = 4

# configs served on the mesh, the smoke sizes of all ten
SERVE_ARCHS = ("qwen3-moe-30b-a3b", "olmo-1b", "gemma3-1b", "qwen3-32b",
               "qwen1.5-110b", "deepseek-v3-671b", "recurrentgemma-2b",
               "rwkv6-7b", "seamless-m4t-large-v2", "llava-next-mistral-7b")
SERVE_B, SERVE_P, SERVE_NEW, SERVE_MAX_LEN = 4, 8, 4, 32
# serving edge cases, (batch, max_len): a batch of 3, which the data axis
# does not divide (it is replicated), and a max_len of 31, which the model
# axis does not divide (kv sequences stay whole; a ring of 16 and MLA's
# latent rank still split)
SERVE_EDGE_CASES = {"batch3": (3, SERVE_MAX_LEN), "len31": (SERVE_B, 31)}
SERVE_EDGE_ARCHS = ("olmo-1b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
                    "gemma3-1b")
# a second max_len for the decode step's collectives, which must not grow
# with the caches
SERVE_LONG_MAX_LEN = 64
# The smoke models' attention scores under the init as drawn are wide
# enough that float32 rounding in another summation order alone moves the
# front-end configs' logits past the tolerance (tests/test_torch_frontends.py):
# their wq leaves are scaled, on both sides.
WQ_SCALE = {"seamless-m4t-large-v2": 0.25, "llava-next-mistral-7b": 0.25}

# MoE cases: (name, arch, capacity factor); the router is widened so that
# routing is decisive and a capacity of T_loc drops assignments
MOE_CASES = (("qwen3_moe", "qwen3-moe-30b-a3b", 1.0),
             ("deepseek", "deepseek-v3-671b", 1.0))
MOE_B, MOE_S = 4, 6
ROUTER_SCALE = 50.0
# A prefill past the full-EP limit of 16,384 tokens takes the shard_map
# branch on experts placed by SERVE_RULES (the branch's expert reshard).
PREFILL_B, PREFILL_S = 4, 4100
# qwen3-moe's smoke layer with 5 experts: the model axis (2) does not
# divide E, so a mesh runs the local path on the whole batch
LOCAL_ARCH, LOCAL_E = "qwen3-moe-30b-a3b", 5


# training on the mesh: the dense, MoE (its shard_map branch, capacity
# per batch shard at TRAIN_CF, where assignments drop) and encoder smoke
# configs, a global batch of TRAIN_B sequences of TRAIN_S tokens
TRAIN_ARCHS = ("olmo-1b", "qwen3-moe-30b-a3b", "seamless-m4t-large-v2",
               "deepseek-v3-671b", "llava-next-mistral-7b")
TRAIN_B, TRAIN_S = 4, 16
TRAIN_CF = 1.0
TRAIN_LR, TRAIN_WARMUP = 1e-3, 20
# int8 error-feedback syncs of one gradient over the data axis
COMPRESSED_N, COMPRESSED_STEPS = 64, 8


def train_config(arch: str, configs):
    """``arch``'s smoke config from ``configs`` (either package's), the
    MoE at :data:`TRAIN_CF`."""
    cfg = configs.get_smoke_config(arch)
    return cfg.scaled(capacity_factor=TRAIN_CF) if cfg.n_experts else cfg


def train_weights(arch: str, seed: int = 0):
    """``arch``'s smoke parameters as a numpy tree, drawn as
    :func:`weights` draws them, with the leaves of ``TRAIN_CONDITIONING``
    scaled (the training parity tests' weights) and every MoE ``router``
    times :data:`ROUTER_SCALE`."""
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.models.params import init_tree
    tree = init_tree(LM(configs.get_smoke_config(arch)).abstract_params(),
                     torch.Generator().manual_seed(seed), "cpu")
    for key, factor in TRAIN_CONDITIONING.items():
        tree = _scaled(tree, key, factor)
    return _numpy(_scaled(tree, "router", ROUTER_SCALE))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def train_opt_state(arch: str, seed: int = 2) -> dict:
    """An AdamW state two steps in for ``arch``'s smoke parameters, as
    numpy: ``m`` normal at 1e-3, ``v`` uniform in [5e-7, 2e-6] (the square
    of 1e-3's scale), ``step`` 2. A step from it keeps every update smooth
    in the gradient: from zero moments, or a ``v`` near zero, an update is
    about g / (|g| + eps), which turns rounding in a small gradient into a
    sign."""
    rng = np.random.default_rng(seed)
    w = train_weights(arch)
    return {"m": _map(lambda a: rng.normal(0, 1e-3, np.shape(a)).astype(
                np.float32), w),
            "v": _map(lambda a: rng.uniform(5e-7, 2e-6, np.shape(a)).astype(
                np.float32), w),
            "step": np.int32(2)}


def train_batch(arch: str, seed: int = 1) -> dict:
    """The global batch of ``arch``'s training case: the port's
    ``TokenLoader`` (the reference's draws) at step 0."""
    from repro_torch import configs
    from repro_torch.data import TokenLoader
    cfg = configs.get_smoke_config(arch)
    b = TokenLoader(vocab=cfg.vocab, batch=TRAIN_B, seq_len=TRAIN_S,
                    seed=seed, frontend=cfg.frontend,
                    n_frontend_tokens=cfg.n_frontend_tokens,
                    frontend_dim=cfg.frontend_dim).batch_at(0)
    return {k: np.asarray(v) for k, v in b.items()}


def compressed_input(d: int) -> np.ndarray:
    """Data rank ``d``'s gradient for the compressed-mean case."""
    return np.random.default_rng(40 + d).normal(
        0, 1 + d, (COMPRESSED_N,)).astype(np.float32)


def _scaled(tree, key: str, factor: float):
    if isinstance(tree, dict):
        return {k: (v * factor if k == key and not isinstance(v, (dict, list))
                    else _scaled(v, key, factor)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scaled(v, key, factor) for v in tree]
    return tree


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def weights(arch: str, seed: int = 0):
    """``arch``'s smoke parameters as a numpy tree in the reference's
    layout: the port's ``init_tree`` from ``seed``, ``wq`` scaled where
    :data:`WQ_SCALE` says and every MoE ``router`` times
    :data:`ROUTER_SCALE`."""
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.models.params import init_tree
    cfg = configs.get_smoke_config(arch)
    tree = init_tree(LM(cfg).abstract_params(),
                     torch.Generator().manual_seed(seed), "cpu")
    if arch in WQ_SCALE:
        tree = _scaled(tree, "wq", WQ_SCALE[arch])
    tree = _scaled(tree, "router", ROUTER_SCALE)
    return _numpy(tree)


def serve_inputs(arch: str, seed: int = 1, B: int = SERVE_B) -> dict:
    """The prompt (and frames or patches) of ``arch``'s serving case, B
    rows."""
    from repro_torch import configs
    cfg = configs.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, SERVE_P)
                                    ).astype(np.int32)}
    if cfg.n_enc_layers:
        batch["frames"] = rng.normal(
            0, 1, (B, 16, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.normal(
            0, 1, (B, cfg.n_frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    return batch


def moe_layer(tree) -> dict:
    """The first MoE layer's ``mlp`` subtree of a parameter tree (a
    stacked segment's first repeat)."""
    for seg in tree["segments"]:
        for unit in seg.values():
            if "router" in unit["mlp"]:
                mlp = unit["mlp"]
                stacked = mlp["router"].ndim == 3
                return {k: (_first(v) if stacked else v)
                        for k, v in mlp.items()}
    raise KeyError("no MoE layer")


def _first(v):
    if isinstance(v, dict):
        return {k: _first(x) for k, x in v.items()}
    return v[0]


def moe_input(arch: str, seed: int = 2, B: int = MOE_B,
              S: int = MOE_S) -> np.ndarray:
    from repro_torch import configs
    cfg = configs.get_smoke_config(arch)
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


def local_layer(seed: int = 4) -> dict:
    """The MoE layer of :data:`LOCAL_ARCH`'s smoke config with
    :data:`LOCAL_E` experts as a numpy tree, drawn by the port's
    ``init_tree`` from ``seed``, the router times :data:`ROUTER_SCALE`."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.params import init_tree
    cfg = configs.get_smoke_config(LOCAL_ARCH).scaled(n_experts=LOCAL_E)
    tree = init_tree(moe.moe_meta(cfg, torch.float32),
                     torch.Generator().manual_seed(seed), "cpu")
    return _numpy(_scaled(tree, "router", ROUTER_SCALE))


# ---- sharded retrieval on a (data 4) mesh --------------------------------

RET_SHAPE, RET_AXES = (4,), ("data",)
RET_INDEX = dict(variants=("T", "Tp", "Tpp"), m=8, ef_con=40)
RET_K, RET_EF, RET_FANOUT = 6, 48, 2
RET_MERGES = ("all_gather", "tournament")
RET_PER_SHARD_K = (0, 2)
RET_MASKS = (15, 48)
RET_ROUTES = ("graph", "pruned")
NEVER_S = 1e9      # a heartbeat timeout no run reaches
# the segmented index: five flushed segments (one or two a shard on four
# shards), every 13th of the first 310 rows deleted, the rest in the delta
RET_FLUSHES = ((0, 100), (100, 180), (180, 250), (250, 310), (310, 350))
RET_ROUTE_CODES = ("lost", "error", "flat", "graph", "pruned", "segmented")
# tie-laden (D, Q, w) shard lists for the merges alone, merged to RET_LIST_K
RET_LIST_Q, RET_LIST_W, RET_LIST_K = 5, 3, 7
RET_SERVE_ARGS = ["--shards", "2", "--n", "400", "--requests", "8",
                  "--device", "cpu"]


def retrieval_data():
    """The corpus and queries of the retrieval cases (the port's
    ``make_range_dataset``, as ``tests/test_torch_distributed.py``)."""
    from repro_torch.data import make_range_dataset
    return make_range_dataset(n=400, d=16, n_queries=8, quantize=32, seed=9)


def retrieval_request(ds, mask: int, request_cls, route=None):
    """A request of the retrieval cases in either package."""
    qlo, qhi = retrieval_ranges(ds, mask)
    return request_cls(ds.queries, (qlo, qhi), mask, k=RET_K, ef=RET_EF,
                       fanout=RET_FANOUT, route=route)


def retrieval_segmented(index):
    """``index`` (either package's SegmentedIndex) after the op sequence:
    :data:`RET_FLUSHES`, the deletes, the delta."""
    ds = retrieval_data()
    v, lo, hi = ds.vectors, ds.lo, ds.hi
    for a, b in RET_FLUSHES:
        index.add(np.arange(a, b), v[a:b], lo[a:b], hi[a:b])
        index.flush()
    index.delete(np.arange(0, 310, 13))
    index.add(np.arange(350, 400), v[350:400], lo[350:400], hi[350:400])
    return index


def report_rows(report) -> np.ndarray:
    """A sharded report's rows as ints: (shard, n, route code, alive,
    k_fetched, slot_count) a shard."""
    return np.array([(r.shard, r.n, RET_ROUTE_CODES.index(r.route),
                      int(r.alive), r.k_fetched, r.slot_count)
                     for r in report.shards], np.int64)


def retrieval_lists(seed: int):
    """(D, Q, w) shard lists: integer distances (ties within and across
    shards), sorted per row as a shard's top-k is, with NO_EDGE/inf tails
    on some rows."""
    D, Q, w = RET_SHAPE[0], RET_LIST_Q, RET_LIST_W
    rng = np.random.default_rng(seed)
    d = np.sort(rng.integers(0, 6, (D, Q, w)).astype(np.float32), axis=2)
    ids = rng.integers(0, 1000, (D, Q, w)).astype(np.int32)
    tail = rng.integers(0, w + 1, (D, Q))
    empty = np.arange(w)[None, None, :] >= tail[:, :, None]
    return (np.where(empty, -1, ids).astype(np.int32),
            np.where(empty, np.inf, d).astype(np.float32))


RET_LIST_ALIVE = {"all": None, "one_dead": np.array([True, False, True,
                                                     True])}


# ---- the async server on the (data 4) mesh ---------------------------------

# every clock read advances a rank's script time by ASYNC_TICK_S, so that
# a server reading its clock more or less often than the reference's
# would give other times; rank r's clock starts at ASYNC_OFFSET_S * r and
# runs (1 + r) times as fast as rank 0's
ASYNC_TICK_S = 2.5e-4
ASYNC_OFFSET_S = 100.0
ASYNC_POLICY = dict(max_queue=8, max_wait_ms=2.0, max_batch=4)
ASYNC_LAYOUTS = ("flat", "build")
ASYNC_REASONS = ("queue_full", "deadline_expired", "shutdown", "not_mutable")
# (item, mask, deadline_ms, priority) of each wave's queries; items index
# the retrieval queries, masks pick their (qlo, qhi)
ASYNC_WAVES = (
    # wave 1: 0.5 ms expires before the first dispatch; 1.8 ms does not on
    # rank 0's clock, but would on a follower's
    ((0, 15, None, 0), (1, 48, 0.5, 0), (2, 15, None, 1), (3, 48, 50.0, 0),
     (4, 15, 1.8, 0), (5, 48, None, 0)),
    # wave 2, shard 3 failed: the queue holds 8, so the last one is
    # refused; EDF dispatches the four earliest deadlines first, and 5.5 ms
    # expires in the queue behind them (one mask a wave from here: each
    # mask of a round is one execute, seconds each on the reference's
    # mesh)
    ((6, 48, 5.0, 0), (7, 48, 5.1, 0), (0, 48, 5.2, 0), (1, 48, 5.3, 0),
     (2, 48, 5.5, 0), (3, 48, None, 0), (4, 48, None, 2), (5, 48, None, 0),
     (6, 48, None, 0)),
    # wave 3: one young query, 0.1 ms old at its step
    ((6, 15, None, 0),),
    # wave 4: one round, then close() with two still queued
    ((7, 15, 30.0, 0), (0, 15, None, 0), (1, 15, None, 0), (2, 15, None, 0),
     (3, 15, None, 1), (4, 15, None, 0)),
)


class ScriptClock:
    """Rank ``rank``'s injected clock (seconds): ``ASYNC_OFFSET_S * rank +
    (1 + rank) * t``, where the script time ``t`` moves by
    :meth:`advance` and by ``ASYNC_TICK_S`` at every read."""

    def __init__(self, rank: int = 0):
        self.offset, self.rate, self.t = ASYNC_OFFSET_S * rank, 1 + rank, 0.0

    def peek(self) -> float:
        return self.offset + self.rate * self.t

    def __call__(self) -> float:
        self.t += ASYNC_TICK_S
        return self.peek()

    def advance(self, s: float) -> None:
        self.t += s


def async_script(server_cls, policy_cls, dep, clock: ScriptClock) -> dict:
    """Serve :data:`ASYNC_WAVES` through ``server_cls`` (either package's
    ``AsyncRetrievalServer``) over ``dep`` (a (data 4) deployment of the
    retrieval corpus) on ``clock``: wave 1 and two steps; shard 3 failed,
    wave 2 with an upsert (refused: not mutable) and a query too many
    (refused: queue full), drained by ``run_until_idle``; shard 3
    restored, wave 3 and one step; wave 4, one step, ``close()``, a query
    after it, ``run_until_idle`` and ``collect``. Returns arrays: each
    submit's ticket or reason, each step's record, every outcome by
    ticket, the snapshot, the embed and execute calls, and the tickets
    this rank's own clock would have shed at the first dispatch."""
    import json
    ds = retrieval_data()
    ranges = {m: retrieval_ranges(ds, m) for m in (15, 48)}
    embeds, executes = [0], [0]

    def embed(items):
        embeds[0] += 1
        return ds.queries[np.asarray(items)]

    srv = server_cls(dep, embed, k=RET_K, ef=RET_EF,
                     policy=policy_cls(**ASYNC_POLICY), clock=clock)
    execute = dep.execute

    def counted_execute(request):
        executes[0] += 1
        return execute(request)

    dep.execute = counted_execute
    steps, outcomes, submits = [], {}, []
    step = srv.step

    def recorded_step():
        before = executes[0]
        got = step()
        steps.append([srv.step_stats[k] for k in (
            "dispatched", "shed", "served", "queue_depth", "inflight")]
            + [executes[0] - before, len(got)])
        return got

    srv.step = recorded_step        # run_until_idle steps through it too

    def submit(wave):
        for item, mask, deadline, prio in ASYNC_WAVES[wave]:
            qlo, qhi = ranges[mask]
            t = srv.submit(item, qlo[item], qhi[item], mask,
                           deadline_ms=deadline, priority=prio)
            submits.append(_code(t))

    def keep(got):
        for t, o in got.items():
            outcomes[t] = o

    try:
        submit(0)
        clock.advance(1e-3)
        # what this rank's own clock says has expired at the first round
        would_shed = [e.ticket for e in srv.scheduler._queue
                      if e.deadline_abs is not None
                      and clock.peek() + 2 * ASYNC_TICK_S > e.deadline_abs]
        keep(srv.step())
        keep(srv.step())
        dep.fail(3)
        submit(1)
        submits.append(_code(srv.submit_upsert(999, 0, 0.2, 0.4)))
        clock.advance(1e-3)
        keep(srv.step())
        clock.advance(5e-3)
        keep(srv.run_until_idle())
        dep.restore(3)
        submit(2)
        clock.advance(1e-4)
        keep(srv.step())
        submit(3)
        clock.advance(5e-4)
        keep(srv.step())
        keep(srv.close())
        submits.append(_code(srv.submit(0, 0.2, 0.4, 15)))
        keep(srv.run_until_idle())
        keep(srv.collect())
    finally:
        dep.execute = execute
    tickets = sorted(outcomes)
    k = RET_K
    out = {"submits": np.asarray(submits, np.int64),
           "steps": np.asarray(steps, np.int64),
           "tickets": np.asarray(tickets, np.int64),
           "snapshot": json.dumps(srv.snapshot(), sort_keys=True),
           "embeds": embeds[0], "executes": executes[0],
           "would_shed": np.asarray(would_shed, np.int64)}
    ids = np.full((len(tickets), k), -2, np.int64)
    dists = np.full((len(tickets), k), np.nan, np.float32)
    times = np.full((len(tickets), 2), np.nan, np.float64)
    flags = np.zeros((len(tickets), 4), np.int64)
    for j, t in enumerate(tickets):
        o = outcomes[t]
        if o:
            ids[j] = np.asarray(o.hit.ids)
            dists[j] = np.asarray(o.hit.dists)
            times[j] = (o.queue_ms, o.e2e_ms)
            flags[j] = (-1, int(o.degraded), int(o.deadline_missed), 0)
        else:
            flags[j] = (ASYNC_REASONS.index(o.reason),
                        ("query", "upsert", "delete").index(o.op), 0,
                        o.queue_depth)
    out.update(ids=ids, dists=dists, times=times, flags=flags)
    return out


def _code(t) -> int:
    """A submit's ticket, or -1 - its refusal's reason code."""
    return t if isinstance(t, int) else -1 - ASYNC_REASONS.index(t.reason)


def retrieval_ranges(ds, mask: int):
    """The query ranges of :func:`retrieval_request`'s ``mask``."""
    from repro_torch.data import make_queries
    return make_queries(ds, mask, 0.2, seed=mask)
