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
import datetime
import os
import subprocess
import sys
import traceback

import numpy as np
import torch

import _mesh_common as mc

RANK_LIMIT_S = 300
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
        res = GROUPS[what](mesh)
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


def _group_moe(mesh) -> dict:
    """Sharded init and carry, the MoE's paths, and what must raise."""
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import make_host_mesh, make_production_mesh
    from repro_torch.launch import make_rank_mesh
    from repro_torch.models import LM, moe, params
    from repro_torch.training import make_train_step
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
        gather leaves it: the experts this rank's shards, the rest whole."""
        mesh.counts.clear()
        with torch.no_grad():
            y, aux = moe.moe_apply(layer, torch.from_numpy(x), cfg=cfg,
                                   mesh=mesh, batch_axes=("data",),
                                   capacity_factor=cf, mode=mode)
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
    res["raises/train_loss"] = _raises(
        lambda: lm.train_loss(shard, batch, mesh=mesh), NotImplementedError)
    res["raises/train_step"] = _raises(
        lambda: make_train_step(lm, mesh=mesh), NotImplementedError)
    res["host_mesh"] = make_host_mesh(2, 8, device="cpu").shape == {
        "data": 2, "model": 2}
    return res


def _group_serve(mesh) -> dict:
    """``ServeEngine`` on the mesh and without one, each config."""
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models import LM, params
    from repro_torch.serving import ServeEngine
    res = {}
    for arch in mc.SERVE_ARCHS:
        cfg = configs.get_smoke_config(arch)
        lm = LM(cfg)
        tree = mc.weights(arch)
        batch = mc.serve_inputs(arch)
        mesh.counts.clear()
        g = ServeEngine(lm, lm_params_from_arrays(
            cfg, tree, "cpu", mesh=mesh, rules=params.SERVE_RULES),
                        mesh=mesh).generate(batch, n_new=mc.SERVE_NEW,
                                            max_len=mc.SERVE_MAX_LEN)
        res[f"{arch}/tokens"] = g.tokens
        res[f"{arch}/logits"] = g.logits_last
        res[f"{arch}/moe_full_ep"] = mesh.counts["moe_full_ep"]
        res[f"{arch}/all_gather"] = mesh.counts["all_gather"]
        g = ServeEngine(lm, lm_params_from_arrays(cfg, tree, "cpu"),
                        device="cpu").generate(batch, n_new=mc.SERVE_NEW,
                                               max_len=mc.SERVE_MAX_LEN)
        res[f"{arch}/tokens_meshless"] = g.tokens
        res[f"{arch}/logits_meshless"] = g.logits_last
    return res


GROUPS = {"moe": _group_moe, "serve": _group_serve}
