"""The port's side of the mesh tests: four gloo ranks on the CPU, started
by ``torch.multiprocessing`` with the ``spawn`` method, on a (data 2,
model 2) mesh; and :func:`run_reference`, which runs
``tests/_mesh_reference.py`` in a subprocess. Each rank writes what it
computed to ``rank<r>.npz``; a test module runs one group of cases once
and its parametrised tests read the files.

Every process has its own time limit: :func:`run_ranks` joins rank 0 for
``RANK_LIMIT_S`` and each other rank for ``GRACE_S`` more, kills what is
still alive and raises; the process group itself times out a collective
after ``PG_TIMEOUT_S``, so a rank whose peer died fails instead of waiting.
"""
import contextlib
import datetime
import math
import os
import subprocess
import sys
import traceback

import numpy as np
import torch

import _mesh_common as mc

RANK_LIMIT_S = 300
# the collectives by name, as the serve group's logs code them
COLLECTIVES = ("psum", "pmax", "all_gather", "psum_scatter", "ppermute")
GRACE_S = 60
PG_TIMEOUT_S = 120
REFERENCE_LIMIT_S = 300
HERE = os.path.dirname(os.path.abspath(__file__))


def run_reference(out: str, what: str) -> subprocess.Popen:
    """Start ``_mesh_reference.py out what`` with four forced host
    devices; :func:`finish_reference` waits for it."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(HERE), "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_mesh_reference.py"), out,
         what], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def finish_reference(proc: subprocess.Popen, out: str) -> dict:
    """Wait up to ``REFERENCE_LIMIT_S`` for the reference (killed past
    it) and load what it wrote."""
    try:
        log, _ = proc.communicate(timeout=REFERENCE_LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"the reference passed {REFERENCE_LIMIT_S} s")
    if proc.returncode != 0:
        raise RuntimeError(f"the reference failed ({proc.returncode}):\n"
                           f"{log[-4000:]}")
    with np.load(out) as f:
        return dict(f)


def run_ranks(what: str, out_dir: str) -> list:
    """Run group ``what`` on four ranks; each rank's results (a dict)."""
    from torch import multiprocessing as tmp
    store = os.path.join(out_dir, "store")
    ctx = tmp.start_processes(_rank_main, args=(store, out_dir, what),
                              nprocs=mc.WORLD, join=False,
                              start_method="spawn")
    procs = ctx.processes
    procs[0].join(RANK_LIMIT_S)
    for p in procs[1:]:
        p.join(GRACE_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r in range(mc.WORLD):
        err = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors:
        raise RuntimeError(f"ranks {hung} passed their time limit; "
                           + "\n".join(errors))
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    out = []
    for r in range(mc.WORLD):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            out.append(dict(f))
    return out


def _rank_main(rank: int, store: str, out_dir: str, what: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=mc.WORLD,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        from repro_torch.launch import make_rank_mesh
        mesh = make_rank_mesh(mc.MESH_SHAPE, mc.MESH_AXES, device="cpu")
        res = GROUPS[what](mesh, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _leaves_equal(a, b) -> bool:
    from repro_torch.models.params import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _group_moe(mesh, out_dir: str) -> dict:
    """Sharded init and carry, the MoE's paths, and what must raise."""
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import batch_rows
    from repro_torch.launch import make_host_mesh, make_production_mesh
    from repro_torch.launch import make_rank_mesh
    from repro_torch.models import LM, moe, params
    from repro_torch.training import adamw_init, make_train_step
    res = {}
    rules = {"serve": params.SERVE_RULES, "default": params.DEFAULT_RULES}
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_smoke_config(arch)
        metas = LM(cfg).abstract_params()
        for slab in (params.SLAB_ELEMS, 97):
            saved, params.SLAB_ELEMS = params.SLAB_ELEMS, slab
            try:
                whole = params.init_tree(
                    metas, torch.Generator().manual_seed(3), "cpu")
                for rn, r in rules.items():
                    got = params.init_tree(
                        metas, torch.Generator().manual_seed(3), "cpu",
                        mesh=mesh, rules=r)
                    want = params.map_tree(
                        lambda t, n: t[n.index(t.shape)], whole,
                        params.sharding_tree(metas, mesh, r))
                    key = "init" if slab != 97 else "init_slab97"
                    res[f"{key}/{arch}/{rn}"] = _leaves_equal(got, want)
            finally:
                params.SLAB_ELEMS = saved
        np_whole = params.map_tree(lambda t: t.numpy(), whole)
        for rn, r in rules.items():
            res[f"convert/{arch}/{rn}"] = _leaves_equal(
                lm_params_from_arrays(cfg, np_whole, "cpu", mesh=mesh,
                                      rules=r),
                params.map_tree(lambda t, n: t[n.index(t.shape)], whole,
                                params.sharding_tree(metas, mesh, r)))
            res[f"shard_shapes/{arch}/{rn}"] = [
                tuple(t.shape) for t in params.leaves(params.init_tree(
                    metas, torch.Generator().manual_seed(3), "cpu",
                    mesh=mesh, rules=r))] == [
                m.shape for m in params.leaves(
                    params.shard_metas(metas, mesh, r))]

    def run(key, cfg, layer, x, mode, cf):
        """``moe_apply`` on the mesh; ``layer`` as the model's per-unit
        gather leaves it: the experts this rank's shards, the rest whole.
        In every mode the rank takes its rows of x (the batch split over
        data) and gives its rows of y, gathered here to the whole."""
        mesh.counts.clear()
        x = batch_rows({"x": torch.from_numpy(x)}, mesh, ("data",))["x"]
        with torch.no_grad():
            y, aux = moe.moe_apply(layer, x, cfg=cfg,
                                   mesh=mesh, batch_axes=("data",),
                                   capacity_factor=cf, mode=mode)
            y = coll.all_gather(y, mesh, "data", 0)
        res[f"{key}/{mode}/y"] = y.numpy()
        res[f"{key}/{mode}/aux"] = aux.numpy()
        for path in ("moe_full_ep", "moe_shard_map", "moe_local"):
            res[f"{key}/{mode}/{path}"] = mesh.counts[path]

    for name, arch, cf in mc.MOE_CASES:
        cfg = configs.get_smoke_config(arch)
        tree = mc.weights(arch)
        lmetas = moe.moe_meta(cfg, cfg.pdtype)
        for mode, r, x in (
                ("decode", params.SERVE_RULES, mc.moe_input(arch)),
                ("train", params.DEFAULT_RULES, mc.moe_input(arch)),
                # past 16,384 tokens serving leaves full EP for the
                # shard_map branch, which reshards SERVE_RULES' experts
                ("prefill", params.SERVE_RULES,
                 mc.moe_input(arch, B=mc.PREFILL_B, S=mc.PREFILL_S))):
            layer = mc.moe_layer(lm_params_from_arrays(
                cfg, tree, "cpu", mesh=mesh, rules=r))
            for k in ("router", "bias", "shared"):
                if k in layer:
                    layer[k] = params.map_tree(
                        lambda t, m: coll.unshard(
                            t, params.spec_for(m, mesh, r), mesh),
                        layer[k], lmetas[k])
            run(name, cfg, layer, x, mode, cf)
        whole = lm_params_from_arrays(cfg, tree, "cpu")
        with torch.no_grad():
            y, aux = moe.moe_apply(mc.moe_layer(whole),
                                   torch.from_numpy(mc.moe_input(arch)),
                                   cfg=cfg,
                                   capacity_factor=cf)
        res[f"{name}/local/y"] = y.numpy()
        res[f"{name}/local/aux"] = aux.numpy()
    # the local branch on the mesh: the model axis does not divide E
    cfg = configs.get_smoke_config(mc.LOCAL_ARCH).scaled(
        n_experts=mc.LOCAL_E)
    lmetas = moe.moe_meta(cfg, cfg.pdtype)
    layer = params.map_tree(
        lambda a, n, m: torch.from_numpy(np.ascontiguousarray(
            a[n.index(a.shape)] if "expert" in m.axes else a)),
        mc.local_layer(), params.sharding_tree(lmetas, mesh,
                                               params.DEFAULT_RULES), lmetas)
    run("local_e5", cfg, layer, mc.moe_input(mc.LOCAL_ARCH), "train", 1.0)

    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    lm = LM(cfg)
    shard = params.init_tree(lm.abstract_params(),
                             torch.Generator().manual_seed(0), "cpu",
                             mesh=mesh, rules=params.DEFAULT_RULES)
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
             "labels": torch.zeros((4, 8), dtype=torch.int32)}
    odd = {k: v[:3] for k, v in batch.items()}
    res["raises/world_size"] = _raises(
        lambda: make_rank_mesh((2, 4), ("data", "model"), device="cpu"),
        ValueError)
    res["raises/production_mesh"] = _raises(
        lambda: make_production_mesh(device="cpu"), ValueError)
    res["raises/no_collective_for_meta"] = _raises(
        lambda: coll.psum(torch.ones(2, device="meta"), mesh, "data"),
        RuntimeError)
    res["raises/init_without_rules"] = _raises(
        lambda: params.init_tree(lm.abstract_params(),
                                 torch.Generator().manual_seed(0), "cpu",
                                 mesh=mesh), ValueError)
    # a global batch (or microbatch) that the data axis does not divide
    res["raises/train_loss"] = _raises(
        lambda: lm.train_loss(shard, odd, mesh=mesh), ValueError)
    res["raises/train_step"] = _raises(
        lambda: make_train_step(lm, mesh=mesh, microbatches=4)(
            shard, adamw_init(shard), batch), ValueError)
    res["host_mesh"] = make_host_mesh(2, 8, device="cpu").shape == {
        "data": 2, "model": 2}
    return res


@contextlib.contextmanager
def _collectives_log(coll):
    """Log (name, input shape, output shape) of every collective that runs
    outside ``coll.unshard`` (the per-unit weight gathers) in the block."""
    log, depth = [], [0]
    run, unshard = coll._run, coll.unshard

    def logged_run(mesh, name, x, fn, axes):
        out = run(mesh, name, x, fn, axes)
        if depth[0] == 0 and coll._axes(axes):
            log.append((name, tuple(x.shape), tuple(out.shape)))
        return out

    def counted_unshard(*args, **kwargs):
        depth[0] += 1
        try:
            return unshard(*args, **kwargs)
        finally:
            depth[0] -= 1

    coll._run, coll.unshard = logged_run, counted_unshard
    try:
        yield log
    finally:
        coll._run, coll.unshard = run, unshard


def _serve_caches(mesh, lm, shard, whole, batch, max_len: int) -> dict:
    """Prefill, seed and one decode step on the mesh and without it: the
    rank's cache blocks (shapes, bytes, gathered back against the
    mesh-less caches) after seeding and after the step, and the step's
    collectives but the weight gathers."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.dryrun import laid_out_bytes
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.serving import seed_caches
    B, P = batch["tokens"].shape
    enc_len = batch["frames"].shape[1] if "frames" in batch else 0
    prompt = P + (batch["patches"].shape[1] if "patches" in batch else 0)
    metas = lm.decode_cache_meta(B, max_len, enc_len)
    specs = lm.decode_cache_specs(mesh, B, max_len, enc_len)
    dims = dict(batch=B, max_len=max_len, enc_len=enc_len)
    out = {"reckoned_bytes": laid_out_bytes(metas, specs, mesh),
           "block_shapes": _in_order(lambda m, sp: NamedSharding(
               mesh, sp).shard_shape(m.shape), metas, specs)}
    with torch.no_grad():
        logits, pc = lm.prefill(shard, batch, mesh=mesh)
        caches = seed_caches(lm, pc, B, max_len, prompt, enc_len, mesh=mesh)
        wlogits, wpc = lm.prefill(whole, batch)
        wcaches = seed_caches(lm, wpc, B, max_len, prompt, enc_len)

        def record(when):
            out[f"{when}/shapes"] = _in_order(lambda m, t: tuple(t.shape),
                                              metas, caches)
            out[f"{when}/bytes"] = sum(t.numel() * t.element_size()
                                       for t in leaves(caches))
            gathered = leaves(map_tree(lambda m, t, sp: coll.unshard(
                t, sp, mesh), metas, caches, specs))
            out[f"{when}/gathered_rel_err"] = max(
                float((g.double() - w.double()).abs().max()
                      / max(1.0, float(w.double().abs().max())))
                for g, w in zip(gathered, leaves(wcaches)))

        record("seeded")
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        with _collectives_log(coll) as log:
            lm.decode_step(shard, caches, cur, prompt, mesh=mesh, **dims)
        lm.decode_step(whole, wcaches,
                       torch.argmax(wlogits[:, -1], dim=-1)[:, None], prompt)
        record("stepped")
    out["collectives"] = log
    return out


def _in_order(fn, metas, *rest) -> list:
    """``fn`` of each leaf of ``metas`` (and ``rest``'s matching leaves),
    in one traversal order."""
    from repro_torch.models.params import map_tree
    got = []
    map_tree(lambda *a: got.append(tuple(fn(*a))), metas, *rest)
    return got


def _group_serve(mesh, out_dir: str) -> dict:
    """``ServeEngine`` on the mesh and without it for each config, its
    edge cases, the rank's cache blocks through a decode step, and
    ``pmax``."""
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.distributed import collectives as coll
    from repro_torch.models import LM, params
    from repro_torch.serving import ServeEngine
    res = {}

    def serve(key, lm, shard, whole, batch, max_len):
        mesh.counts.clear()
        g = ServeEngine(lm, shard, mesh=mesh).generate(
            batch, n_new=mc.SERVE_NEW, max_len=max_len)
        res[f"{key}/tokens"] = g.tokens
        res[f"{key}/logits"] = g.logits_last
        res[f"{key}/moe_full_ep"] = mesh.counts["moe_full_ep"]
        res[f"{key}/all_gather"] = mesh.counts["all_gather"]
        g = ServeEngine(lm, whole, device="cpu").generate(
            batch, n_new=mc.SERVE_NEW, max_len=max_len)
        res[f"{key}/tokens_meshless"] = g.tokens
        res[f"{key}/logits_meshless"] = g.logits_last

    for arch in mc.SERVE_ARCHS:
        cfg = configs.get_smoke_config(arch)
        lm = LM(cfg)
        tree = mc.weights(arch)
        shard = lm_params_from_arrays(cfg, tree, "cpu", mesh=mesh,
                                      rules=params.SERVE_RULES)
        whole = lm_params_from_arrays(cfg, tree, "cpu")
        batch = mc.serve_inputs(arch)
        serve(arch, lm, shard, whole, batch, mc.SERVE_MAX_LEN)
        for case, (B, max_len) in mc.SERVE_EDGE_CASES.items():
            if arch in mc.SERVE_EDGE_ARCHS:
                serve(f"{arch}/{case}", lm, shard, whole,
                      mc.serve_inputs(arch, B=B), max_len)
        c = _serve_caches(mesh, lm, shard, whole, batch, mc.SERVE_MAX_LEN)
        for k in ("reckoned_bytes", "seeded/bytes", "stepped/bytes",
                  "seeded/gathered_rel_err", "stepped/gathered_rel_err"):
            res[f"{arch}/cache/{k}"] = c[k]
        for when in ("seeded", "stepped"):
            res[f"{arch}/cache/{when}/shapes_are_blocks"] = (
                [tuple(x) for x in c[f"{when}/shapes"]]
                == [tuple(x) for x in c["block_shapes"]])
        # (op, values in, values out, rows in, last dim out) a collective
        res[f"{arch}/cache/collectives"] = np.array(
            [(COLLECTIVES.index(n), math.prod(i), math.prod(o),
              (i or (1,))[0], (o or (1,))[-1])
             for n, i, o in c["collectives"]], dtype=np.int64).reshape(-1, 5)
        long = _serve_caches(mesh, lm, shard, whole, batch,
                             mc.SERVE_LONG_MAX_LEN)
        res[f"{arch}/cache/collectives_long_equal"] = \
            long["collectives"] == c["collectives"]
    # pmax over both axes against the max of every rank's tensor
    rank = mesh.coord["data"] * mesh.shape["model"] + mesh.coord["model"]
    draw = lambda r: torch.randn(
        3, 5, generator=torch.Generator().manual_seed(50 + r))
    res["pmax"] = coll.pmax(draw(rank), mesh, ("data", "model")).numpy()
    res["pmax_want"] = torch.stack(
        [draw(r) for r in range(mc.WORLD)]).amax(0).numpy()
    res["pmax_model"] = coll.pmax(draw(rank), mesh, "model").numpy()
    res["pmax_model_want"] = torch.stack(
        [draw(mesh.coord["data"] * mesh.shape["model"] + m)
         for m in range(mesh.shape["model"])]).amax(0).numpy()
    x = draw(rank).requires_grad_(True)
    res["pmax_backward_raises"] = _raises(
        lambda: coll.pmax(x, mesh, "model").sum().backward(), RuntimeError)
    # broadcast over both axes from the last rank, and over model from
    # index 1: the source's tensor on every rank of the axes
    res["broadcast_both"] = coll.broadcast(draw(rank), mesh,
                                           ("data", "model"), src=3).numpy()
    res["broadcast_model"] = coll.broadcast(draw(rank), mesh, "model",
                                            src=1).numpy()
    return res


def _box(n, shape) -> np.ndarray:
    """A sharding's box of a leaf of ``shape``: (start, stop) a dim."""
    return np.array([[b.start, b.stop] for b in n.index(shape)],
                    dtype=np.int64).reshape(-1, 2)


def _rule_cases(mesh) -> dict:
    """The collectives' backward rules on float64 tensors, each against
    its gradient worked out by hand: the error of each."""
    from repro_torch.distributed import collectives as coll
    d, m = mesh.coord["data"], mesh.coord["model"]
    draw = lambda seed, *shape: torch.randn(
        *shape, generator=torch.Generator().manual_seed(seed),
        dtype=torch.float64)
    err = lambda g, want: float((g.detach() - want).abs().max())
    out = {}
    # every rank's loss is the global one: its own part summed over data
    loss = lambda t, seed: coll.psum((t * draw(seed + d, *t.shape)).sum(),
                                     mesh, "data")
    # an all-gather over a batch axis: the cotangent summed and scattered
    x = draw(1, 4, 3)[2 * d:2 * d + 2].requires_grad_(True)
    y = coll.all_gather(x, mesh, "data", 0, batch_axes=("data",))
    (g,) = torch.autograd.grad(loss(y, 10), x)
    out["all_gather_batch_axis"] = err(
        g, (draw(10, 4, 3) + draw(11, 4, 3))[2 * d:2 * d + 2])
    # over a replicated axis: this rank's slice, not a sum
    w = draw(2, 4, 3)[2 * m:2 * m + 2].requires_grad_(True)
    y = coll.all_gather(w, mesh, "model", 0, batch_axes=("data",))
    (g,) = torch.autograd.grad(loss(y, 20), w)
    out["all_gather_replicated_axis"] = err(
        g, draw(20 + d, 4, 3)[2 * m:2 * m + 2])
    # a leaf over (model, data) on two dims: both rules at once
    w = draw(3, 4, 6)[2 * m:2 * m + 2, 3 * d:3 * d + 3].requires_grad_(True)
    y = coll.unshard(w, ("model", "data"), mesh, batch_axes=("data",))
    (g,) = torch.autograd.grad(loss(y, 30), w)
    out["unshard_model_data"] = err(g, (draw(30, 4, 6) + draw(31, 4, 6))[
        2 * m:2 * m + 2, 3 * d:3 * d + 3])
    # a psum whose output feeds replicated work: the cotangent unchanged
    x = draw(40 + 2 * d + m, 5).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(coll.psum(x, mesh, "model"), 50), x)
    out["psum_feeds_replicated"] = err(g, draw(50 + d, 5))
    # the router ahead of the experts' psum over model: its gradient sums
    # every model rank's partial result
    r = draw(60 + d, 5).requires_grad_(True)
    part = coll.pvary(r, mesh, "model") * draw(70 + m, 5)
    (g,) = torch.autograd.grad(loss(coll.psum(part, mesh, "model"), 80), r)
    out["router_ahead_of_psum"] = err(
        g, draw(80 + d, 5) * (draw(70, 5) + draw(71, 5)))
    # pmean of a replicated value: the cotangent over the ranks' count
    x = draw(90, 3).requires_grad_(True)
    (g,) = torch.autograd.grad(
        coll.pmean(x, mesh, ("data", "model")).sum(), x)
    out["pmean"] = err(g, torch.full((3,), 0.25, dtype=torch.float64))
    # psum_scatter: the block of the sum; its gradient the gathered one
    x = draw(100 + d, 4, 2).requires_grad_(True)
    y = coll.psum_scatter(x, mesh, "data", 0)
    out["psum_scatter"] = err(y, (draw(100, 4, 2) + draw(101, 4, 2))[
        2 * d:2 * d + 2])
    (g,) = torch.autograd.grad((y * draw(110 + d, 2, 2)).sum(), x)
    out["psum_scatter_grad"] = err(g, torch.cat([draw(110, 2, 2),
                                                 draw(111, 2, 2)]))
    return out


def _group_train(mesh, out_dir: str) -> dict:
    """Training on the mesh: the parity cases of ``mc.TRAIN_ARCHS``, the
    backward rules, ``compressed_grad_sync`` over data, microbatches, the
    elastic checkpoint and ``TrainLoop``'s resume."""
    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.convert import (lm_params_from_arrays,
                                     opt_state_from_arrays)
    from repro_torch.data import TokenLoader
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch import make_mesh, make_rank_mesh
    from repro_torch.models import LM, params
    from repro_torch.training import (AdamWConfig, TrainLoop, adamw_init,
                                      compressed_grad_sync, loss_and_grads,
                                      make_train_step, sync_grads)
    res = {f"rule/{k}": v for k, v in _rule_cases(mesh).items()}
    opt_cfg = AdamWConfig(lr=mc.TRAIN_LR, warmup_steps=mc.TRAIN_WARMUP)
    rules = params.DEFAULT_RULES
    for arch in mc.TRAIN_ARCHS:
        cfg = mc.train_config(arch, configs)
        lm = LM(cfg)
        metas = lm.abstract_params()
        tree, batch = mc.train_weights(arch), mc.train_batch(arch)
        shard = lm_params_from_arrays(cfg, tree, "cpu", mesh=mesh,
                                      rules=rules)
        lm.check_params(shard, mesh, mode="train")
        res[f"{arch}/serve_layout_refused"] = _raises(
            lambda: lm.check_params(shard, mesh), ValueError)
        mesh.counts.clear()
        loss, met, grads = loss_and_grads(lm, shard, batch, mesh=mesh)
        grads = sync_grads(grads, params.spec_tree(metas, mesh, rules), mesh,
                           ("data",))
        for k in ("psum", "all_gather", "psum_scatter", "moe_shard_map"):
            res[f"{arch}/counts/{k}"] = mesh.counts[k]
        res[f"{arch}/loss"] = loss.numpy()
        for k, v in met.items():
            res[f"{arch}/metric/{k}"] = v.numpy()
        for i, (n, m) in enumerate(zip(
                params.leaves(params.sharding_tree(metas, mesh, rules)),
                params.leaves(metas))):
            res[f"{arch}/box/{i}"] = _box(n, m.shape)
        for i, g in enumerate(params.leaves(grads)):
            res[f"{arch}/grad/{i}"] = g.numpy()
        step = make_train_step(lm, opt_cfg=opt_cfg, mesh=mesh)
        opt = opt_state_from_arrays(cfg, mc.train_opt_state(arch), "cpu",
                                    mesh=mesh, rules=rules)
        p, o, sm = step(shard, opt, batch)
        for k in ("loss", "grad_norm"):
            res[f"{arch}/step/{k}"] = sm[k].numpy()
        for part, t in (("params", p), ("m", o["m"]), ("v", o["v"])):
            for i, leaf in enumerate(params.leaves(t)):
                res[f"{arch}/step/{part}/{i}"] = leaf.numpy()

    # int8 error feedback over data, one gradient a data rank
    g = torch.from_numpy(mc.compressed_input(mesh.coord["data"]))
    r = {"w": torch.zeros_like(g)}
    for i in range(mc.COMPRESSED_STEPS):
        out, r = compressed_grad_sync({"w": g}, "data", r, mesh=mesh)
        res[f"compressed/mean/{i}"] = out["w"].numpy()
        res[f"compressed/residual/{i}"] = r["w"].numpy()

    # microbatches: 2 of the global batch's rows against 1
    arch = "olmo-1b"
    cfg = configs.get_smoke_config(arch)
    lm = LM(cfg)
    tree, batch = mc.train_weights(arch), mc.train_batch(arch)
    for n in (1, 2):
        p = lm_params_from_arrays(cfg, tree, "cpu", mesh=mesh, rules=rules)
        p, o, sm = make_train_step(lm, opt_cfg=opt_cfg, microbatches=n,
                                   mesh=mesh)(p, adamw_init(p), batch)
        res[f"micro{n}/grad_norm"] = sm["grad_norm"].numpy()
        for part, t in (("params", p), ("m", o["m"]), ("v", o["v"])):
            for i, leaf in enumerate(params.leaves(t)):
                res[f"micro{n}/{part}/{i}"] = leaf.numpy()

    # a bfloat16 state after one step, saved from this (2, 2) mesh and
    # restored on (4, 1), on (1, 1) and without a mesh
    lm = LM(cfg.scaled(param_dtype="bfloat16", activ_dtype="bfloat16"))
    metas = lm.abstract_params()
    step = make_train_step(lm, opt_cfg=opt_cfg, mesh=mesh)
    shard = params.init_tree(metas, torch.Generator().manual_seed(5), "cpu",
                             mesh=mesh, rules=rules)
    opt = adamw_init(shard)
    step(shard, opt, batch)
    state = {"params": shard, "opt": opt}
    specs = {"params": step.param_specs, "opt": step.opt_specs}
    whole = params.map_tree(lambda t, sp: coll.unshard(t, sp, mesh), state,
                            specs)
    ck = Checkpointer(os.path.join(out_dir, "elastic"), async_write=False)
    ck.save(1, state, mesh=mesh, specs=specs)
    res["elastic/bf16"] = any(t.dtype == torch.bfloat16
                              for t in params.leaves(shard))
    for name, other in (("4x1", make_rank_mesh((4, 1), mc.MESH_AXES,
                                               device="cpu")),
                        ("2x2", mesh),
                        ("1x1", make_mesh((1, 1), mc.MESH_AXES,
                                          device="cpu"))):
        s2 = params.spec_tree(metas, other, rules)
        s2 = {"params": s2, "opt": {"m": s2, "v": s2, "step": ()}}
        got, at, _ = ck.restore(state, 1, mesh=other, specs=s2)
        want = params.map_tree(
            lambda t, sp: t[NamedSharding(other, sp).index(t.shape)],
            whole, s2)
        res[f"elastic/{name}"] = at == 1 and _leaves_equal(got, want)
    got, _, _ = ck.restore(state, 1)
    res["elastic/no_mesh"] = _leaves_equal(got, whole)

    # TrainLoop on the mesh: 4 steps straight against 2, save, restore, 2
    lm = LM(cfg)
    metas = lm.abstract_params()
    loader = TokenLoader(vocab=cfg.vocab, batch=mc.TRAIN_B,
                         seq_len=mc.TRAIN_S, seed=3)
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2),
                           mesh=mesh)

    def fresh():
        p = params.init_tree(metas, torch.Generator().manual_seed(6), "cpu",
                             mesh=mesh, rules=rules)
        return p, adamw_init(p)

    p4, o4, h4 = TrainLoop(lm, loader, step).run(*fresh(), 0, 4,
                                                  log_every=0)
    ck = Checkpointer(os.path.join(out_dir, "loop"), async_write=False)
    _, _, ha = TrainLoop(lm, loader, step, ck, ckpt_every=2).run(
        *fresh(), 0, 2, log_every=0)
    ex_p, ex_o = fresh()
    st, at, _ = ck.restore({"params": ex_p, "opt": ex_o}, mesh=mesh,
                           specs={"params": step.param_specs,
                                  "opt": step.opt_specs})
    pb, ob, hb = TrainLoop(lm, loader, step, ck, ckpt_every=2).run(
        st["params"], st["opt"], at, 2, log_every=0)
    res["resume/at"] = at
    res["resume/losses"] = h4 == ha + hb
    res["resume/state"] = _leaves_equal({"p": p4, "o": o4},
                                        {"p": pb, "o": ob})
    return res


def _group_retrieval(mesh, out_dir: str) -> dict:
    """``ShardedDeployment`` on a (data 4) mesh of the four ranks, one
    shard a rank, the cases of ``_mesh_reference.retrieval``; the merges
    alone on the same tie-laden lists; ``ppermute``; what each rank
    stages; a rank whose search raises and one whose heartbeat is stale;
    the async server's script (``_mesh_common.async_script``) over the
    ``all_gather`` flat and build deployments, on this rank's skewed clock;
    ``broadcast``; then ``launch.serve.main`` with ``--shards 2``, and
    with ``--async``, on two pairs of ranks, each its own default group of
    two."""
    import json
    import time
    import torch.distributed as dist
    from repro_torch.core import IndexSpec, SearchRequest
    from repro_torch.distributed import (DeploymentSpec, ShardedDeployment,
                                         sharded_flat_topk,
                                         sharded_topk_merge)
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import make_rank_mesh
    from repro_torch.launch import serve
    from repro_torch.serving import AsyncRetrievalServer, SLOPolicy
    from repro_torch.streaming import SegmentedIndex

    mesh = make_rank_mesh(mc.RET_SHAPE, mc.RET_AXES, device="cpu")
    D, r = mc.RET_SHAPE[0], mesh.coord["data"]
    ds = mc.retrieval_data()
    res = {}

    def spec(merge, psk, **kw):
        kw.setdefault("shard_timeout_s", mc.NEVER_S)
        return DeploymentSpec(n_shards=D, merge=merge, per_shard_k=psk,
                              index=IndexSpec(**mc.RET_INDEX), **kw)

    def put(key, dep, request):
        mesh.counts.clear()
        out = dep.execute(request)
        res[f"{key}/ids"] = out.ids
        res[f"{key}/dists"] = out.dists
        res[f"{key}/rows"] = mc.report_rows(out.report)
        res[f"{key}/missing"] = np.asarray(out.report.missing_shards,
                                           np.int64)
        for c in ("all_gather", "ppermute"):
            res[f"{key}/count/{c}"] = mesh.counts[c]

    def ask(mask=15, route=None):
        return mc.retrieval_request(ds, mask, SearchRequest, route)

    seg = mc.retrieval_segmented(SegmentedIndex(IndexSpec(**mc.RET_INDEX),
                                                device="cpu"))
    for merge in mc.RET_MERGES:
        for psk in mc.RET_PER_SHARD_K:
            flat = ShardedDeployment.flat(ds.vectors, ds.lo, ds.hi,
                                          spec=spec(merge, psk), mesh=mesh)
            built = ShardedDeployment.build(ds.vectors, ds.lo, ds.hi,
                                            spec=spec(merge, psk), mesh=mesh)
            segd = ShardedDeployment.from_segmented(
                seg, spec=spec(merge, psk), mesh=mesh)
            for mask in mc.RET_MASKS[:None if psk == 0 else 1]:
                put(f"flat/{merge}/{psk}/{mask}", flat, ask(mask))
            for route in mc.RET_ROUTES[0 if psk == 0 else 1:]:
                put(f"build/{merge}/{psk}/{route}", built, ask(route=route))
                put(f"segmented/{merge}/{psk}/{route}", segd,
                    ask(route=route))
            if psk:
                continue
            for layout, d, route in (("flat", flat, None),
                                     ("build", built, "pruned"),
                                     ("segmented", segd, "pruned")):
                d.fail(D - 1)
                put(f"{layout}/{merge}/failed3", d, ask(route=route))
                d.restore(D - 1)
            if merge == "all_gather":
                for layout, d in (("flat", flat), ("build", built)):
                    mesh.counts.clear()
                    got = mc.async_script(AsyncRetrievalServer, SLOPolicy, d,
                                          mc.ScriptClock(r))
                    got["broadcasts"] = mesh.counts["broadcast"]
                    for key, v in got.items():
                        res[f"async/{layout}/{key}"] = v
        # each rank holds its own shard's rows only
        res["shape/flat"] = np.asarray(flat._flat[0].shape)
        res["shape/flat_ranges"] = np.asarray([t.shape[0]
                                               for t in flat._flat[1:]])
        res["shape/build"] = np.asarray(
            [-1 if s.engine is None else s.engine.index.vectors.shape[0]
             for s in built.shards])
        res["shape/segmented"] = np.asarray(
            [-1 if s.engine is None else len(s.engine.segments)
             for s in segd.shards])
        res["shape/segmented_ids"] = np.asarray(
            [seg.segments.index(x) for x in segd.shards[r].engine.segments])

    # sharded_flat_topk on ranks: this rank's rows only, rebased and merged
    nloc = ds.n // D
    rows = slice(r * nloc, (r + 1) * nloc)
    q = mc.retrieval_request(ds, 15, SearchRequest)
    for merge in mc.RET_MERGES:
        gi, gd = sharded_flat_topk(mesh, ds.vectors[rows], ds.lo[rows],
                                   ds.hi[rows], q.vectors, q.qlo, q.qhi,
                                   mask=15, k=mc.RET_K, merge=merge)
        res[f"sharded_flat_topk/{merge}/ids"] = gi.numpy()
        res[f"sharded_flat_topk/{merge}/dists"] = gd.numpy()

    # a rank whose local search raises (rank 1), then one whose heartbeat
    # is stale on its own clock (rank 2): every rank answers degraded
    built = ShardedDeployment.build(ds.vectors, ds.lo, ds.hi,
                                    spec=spec("all_gather", 0), mesh=mesh)

    def boom(request):
        raise RuntimeError("shard down mid-search")

    if r == 1:
        built.shards[1].engine.execute = boom
    put("build/all_gather/raised1", built, ask(route="pruned"))
    flat = ShardedDeployment.flat(
        ds.vectors, ds.lo, ds.hi, mesh=mesh,
        spec=spec("all_gather", 0, shard_timeout_s=60.0))
    if r == 2:
        flat.heartbeats.ping("shard-2", 0, now=time.time() - 3600.0)
    put("flat/all_gather/stale2", flat, ask())
    flat.restore(2)
    res["flat/all_gather/restored_degraded"] = flat.execute(ask()).degraded

    # the merges alone: this rank's list of the shared tie-laden ones
    for seed in (0, 1):
        ids, dists = mc.retrieval_lists(seed)
        for name, alive in mc.RET_LIST_ALIVE.items():
            for merge in mc.RET_MERGES:
                gi, gd = sharded_topk_merge(mesh, ids[r], dists[r],
                                            mc.RET_LIST_K, merge=merge,
                                            alive=alive)
                res[f"lists/{seed}/{name}/{merge}/ids"] = gi
                res[f"lists/{seed}/{name}/{merge}/dists"] = gd

    # ppermute: a ring, and a pair that leaves two ranks receiving nothing
    mesh.counts.clear()
    mesh.records.clear()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    res["ppermute/ring"] = coll.ppermute(
        x, mesh, "data", [(i, (i + 1) % D) for i in range(D)]).numpy()
    res["ppermute/pair"] = coll.ppermute(x, mesh, "data",
                                         [(0, 2), (2, 0)]).numpy()
    res["ppermute/count"] = mesh.counts["ppermute"]
    res["ppermute/records"] = np.asarray(
        [[n, P, c] for (op, n, P), c in mesh.records.items()
         if op == "collective-permute"])
    res["ppermute/tuple_refused"] = _raises(
        lambda: coll.ppermute(x, mesh, ("data",), [(0, 1)]), ValueError)
    res["ppermute/twice_refused"] = _raises(
        lambda: coll.ppermute(x, mesh, "data", [(0, 1), (0, 2)]),
        ValueError)

    # broadcast from rank 0 and from rank 2 of the axis; no backward
    mesh.counts.clear()
    res["broadcast/from0"] = coll.broadcast(x, mesh, "data").numpy()
    res["broadcast/from2"] = coll.broadcast(x, mesh, "data", src=2).numpy()
    res["broadcast/count"] = mesh.counts["broadcast"]
    res["broadcast/records"] = np.asarray(
        [[n, P, c] for (op, n, P), c in mesh.records.items()
         if op == "broadcast"])
    res["broadcast/backward_raises"] = _raises(
        lambda: coll.broadcast(x.clone().requires_grad_(), mesh,
                               "data").sum().backward(), RuntimeError)

    # launch.serve on two pairs of ranks, each pair its own group of two
    dist.barrier()
    dist.destroy_process_group()
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, f'pair{r // 2}')}",
        rank=r % 2, world_size=2,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    res["serve/summary"] = json.dumps(serve.main(mc.RET_SERVE_ARGS))
    res["serve/async_summary"] = json.dumps(serve.main(mc.RET_SERVE_ARGS
                                                       + ["--async"]))
    return res


GROUPS = {"moe": _group_moe, "serve": _group_serve, "train": _group_train,
          "retrieval": _group_retrieval}
