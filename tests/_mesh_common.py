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
    from repro_torch.data import make_queries
    qlo, qhi = make_queries(ds, mask, 0.2, seed=mask)
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
