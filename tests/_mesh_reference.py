"""The reference's side of the mesh tests, run as its own process:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_mesh_reference.py OUT.npz moe|serve|train|retrieval

on a (data 2, model 2) mesh of four forced host devices (``retrieval``:
a (data 4) mesh). ``moe``: the MoE
cases of ``_mesh_common.MOE_CASES`` through ``repro.models.moe.moe_apply``
in the full-EP branch (``mode="decode"``, experts placed by
``SERVE_RULES``), the ``shard_map`` branch (``mode="train"``, placed by
``DEFAULT_RULES``; and ``mode="prefill"`` past 16,384 tokens, placed by
``SERVE_RULES``) and without a mesh, and the local branch on the mesh
(``_mesh_common.local_layer``, whose E the model axis does not divide),
each under ``jax.jit`` (eager
``shard_map`` takes ~10x longer here). ``serve``: ``ServeEngine(lm,
params, mesh=mesh).generate`` for each of ``_mesh_common.SERVE_ARCHS``,
the parameters placed by ``SERVE_RULES``, and for
``_mesh_common.SERVE_EDGE_ARCHS`` each of ``SERVE_EDGE_CASES``.
``train``: for each of
``_mesh_common.TRAIN_ARCHS``, ``jax.value_and_grad(lm.train_loss)`` on the
mesh and one step of ``make_train_step(lm, mesh=mesh)`` (its ``jit`` with
the parameter, optimizer and batch shardings) from
``_mesh_common.train_opt_state``, the parameters placed by
``DEFAULT_RULES`` and the batch by ``batch_spec``; and
``compressed_grad_sync`` over ``data`` inside ``shard_map``, one
gradient a data rank. ``retrieval``: the reference's
``ShardedDeployment`` in its three layouts on the (data 4) mesh, under
``all_gather`` and ``tournament`` with ``per_shard_k`` 0 and 2, with
shards lost, and its merges on tie-laden lists (:func:`retrieval`).
``retrieval_async``: the async server's script
(``_mesh_common.async_script``) over the flat and build layouts on rank
0's clock (:func:`retrieval_async`; a process of its own, which runs
beside ``retrieval``'s). The
outputs go to ``OUT.npz``.
The flag must be set before jax is imported; jax's ``shard_map``
deprecation warning is ignored in this process.
"""
import functools
import os
import sys
import warnings

warnings.simplefilter("ignore", DeprecationWarning)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _mesh_common as mc  # noqa: E402


def main(out: str, what: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.launch.mesh import make_mesh
    from repro.models import moe as rmoe
    from repro.models.params import (DEFAULT_RULES, SERVE_RULES,
                                     sharding_tree)
    from repro.models.transformer import LM
    from repro.serving import ServeEngine

    assert len(jax.devices()) == mc.WORLD, jax.devices()
    mesh = make_mesh(mc.MESH_SHAPE, mc.MESH_AXES)
    res = {}
    if what == "moe":
        for name, arch, cf in mc.MOE_CASES:
            rcfg = configs.get_smoke_config(arch)
            layer = jax.tree.map(jnp.asarray, mc.moe_layer(mc.weights(arch)))
            metas = rmoe.moe_meta(rcfg, jnp.float32)
            x = jnp.asarray(mc.moe_input(arch))
            for mode, rules in (("decode", SERVE_RULES),
                                ("train", DEFAULT_RULES)):
                p = jax.device_put(layer, sharding_tree(metas, mesh, rules))
                y, aux = jax.jit(functools.partial(
                    rmoe.moe_apply, cfg=rcfg, mesh=mesh,
                    batch_axes=("data",), capacity_factor=cf,
                    mode=mode))(p, x)
                res[f"{name}/{mode}/y"] = np.asarray(y)
                res[f"{name}/{mode}/aux"] = np.asarray(aux)
            y, aux = jax.jit(functools.partial(
                rmoe.moe_apply, cfg=rcfg, mesh=None, batch_axes=None,
                capacity_factor=cf, mode="train"))(layer, x)
            res[f"{name}/local/y"] = np.asarray(y)
            res[f"{name}/local/aux"] = np.asarray(aux)
            p = jax.device_put(layer, sharding_tree(metas, mesh,
                                                    SERVE_RULES))
            y, aux = jax.jit(functools.partial(
                rmoe.moe_apply, cfg=rcfg, mesh=mesh, batch_axes=("data",),
                capacity_factor=cf, mode="prefill"))(
                    p, jnp.asarray(mc.moe_input(arch, B=mc.PREFILL_B,
                                                S=mc.PREFILL_S)))
            res[f"{name}/prefill/y"] = np.asarray(y)
            res[f"{name}/prefill/aux"] = np.asarray(aux)
        rcfg = configs.get_smoke_config(mc.LOCAL_ARCH).scaled(
            n_experts=mc.LOCAL_E)
        layer = jax.tree.map(jnp.asarray, mc.local_layer())
        p = jax.device_put(layer, sharding_tree(
            rmoe.moe_meta(rcfg, jnp.float32), mesh, DEFAULT_RULES))
        y, aux = jax.jit(functools.partial(
            rmoe.moe_apply, cfg=rcfg, mesh=mesh, batch_axes=("data",),
            capacity_factor=1.0, mode="train"))(
                p, jnp.asarray(mc.moe_input(mc.LOCAL_ARCH)))
        res["local_e5/train/y"] = np.asarray(y)
        res["local_e5/train/aux"] = np.asarray(aux)
    elif what == "serve":
        for arch in mc.SERVE_ARCHS:
            lm = LM(configs.get_smoke_config(arch))
            params = jax.device_put(
                jax.tree.map(jnp.asarray, mc.weights(arch)),
                sharding_tree(lm.abstract_params(), mesh, SERVE_RULES))
            batch = {k: jnp.asarray(v)
                     for k, v in mc.serve_inputs(arch).items()}
            eng = ServeEngine(lm, params, mesh=mesh)
            g = eng.generate(batch, n_new=mc.SERVE_NEW,
                             max_len=mc.SERVE_MAX_LEN)
            res[f"{arch}/tokens"] = np.asarray(g.tokens)
            res[f"{arch}/logits"] = np.asarray(g.logits_last)
            if arch not in mc.SERVE_EDGE_ARCHS:
                continue
            for case, (B, max_len) in mc.SERVE_EDGE_CASES.items():
                g = eng.generate({k: jnp.asarray(v) for k, v in
                                  mc.serve_inputs(arch, B=B).items()},
                                 n_new=mc.SERVE_NEW, max_len=max_len)
                res[f"{arch}/{case}/tokens"] = np.asarray(g.tokens)
                res[f"{arch}/{case}/logits"] = np.asarray(g.logits_last)
    elif what == "train":
        train(mesh, res)
    elif what == "retrieval":
        retrieval(res)
    elif what == "retrieval_async":
        retrieval_async(res)
    else:
        raise SystemExit(f"unknown case group {what!r}")
    np.savez(out, **res)


def train(mesh, res: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.distributed.sharding import batch_spec
    from repro.models.params import DEFAULT_RULES, sharding_tree
    from repro.models.transformer import LM
    from repro.training import AdamWConfig, make_train_step
    from repro.training.grad_compression import compressed_grad_sync
    from jax.experimental.shard_map import shard_map

    bspec = batch_spec(mesh, 1 << 30, axes=("data",))
    for arch in mc.TRAIN_ARCHS:
        lm = LM(mc.train_config(arch, configs))
        params = jax.device_put(
            jax.tree.map(jnp.asarray, mc.train_weights(arch)),
            sharding_tree(lm.abstract_params(), mesh, DEFAULT_RULES))
        batch = {k: jax.device_put(v, NamedSharding(
            mesh, P(*(bspec + (None,) * (v.ndim - 1)))))
            for k, v in mc.train_batch(arch).items()}
        (loss, met), grads = jax.jit(jax.value_and_grad(functools.partial(
            lm.train_loss, mesh=mesh, batch_axes=("data",)),
            has_aux=True))(params, batch)
        res[f"{arch}/loss"] = np.asarray(loss)
        for k, v in met.items():
            res[f"{arch}/metric/{k}"] = np.asarray(v)
        for i, g in enumerate(jax.tree.leaves(grads)):
            res[f"{arch}/grad/{i}"] = np.asarray(g)
        step = make_train_step(lm, mesh=mesh, batch_axes=("data",),
                               opt_cfg=AdamWConfig(
                                   lr=mc.TRAIN_LR,
                                   warmup_steps=mc.TRAIN_WARMUP))
        opt = jax.device_put(jax.tree.map(jnp.asarray,
                                          mc.train_opt_state(arch)),
                             step.opt_shardings)
        new_p, new_o, sm = step(batch)(params, opt, batch)
        for k in ("loss", "grad_norm"):
            res[f"{arch}/step/{k}"] = np.asarray(sm[k])
        for part, tree in (("params", new_p), ("m", new_o["m"]),
                           ("v", new_o["v"])):
            for i, t in enumerate(jax.tree.leaves(tree)):
                res[f"{arch}/step/{part}/{i}"] = np.asarray(t)

    def sync(g, r):
        out, nr = compressed_grad_sync({"w": g[0]}, "data", {"w": r[0]})
        return out["w"][None], nr["w"][None]

    f = jax.jit(shard_map(sync, mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data")),
                          check_rep=False))
    g = jnp.asarray(np.stack([mc.compressed_input(d) for d in range(2)]))
    r = jnp.zeros_like(g)
    for i in range(mc.COMPRESSED_STEPS):
        out, r = f(g, r)
        res[f"compressed/mean/{i}"] = np.asarray(out)
        res[f"compressed/residual/{i}"] = np.asarray(r)


def retrieval(res: dict) -> None:
    """``ShardedDeployment`` (``flat``, ``build``, ``from_segmented``) on a
    (data 4) mesh under each merge and fan-in width, with shards lost; the
    merges alone on tie-laden lists, each vmapped lane and the mesh's."""
    import jax
    import jax.numpy as jnp
    from repro.core import IndexSpec, SearchRequest
    from repro.distributed import deployment as dep
    from repro.distributed import topk
    from repro.launch.mesh import make_mesh
    from repro.streaming import SegmentedIndex

    mesh = make_mesh(mc.RET_SHAPE, mc.RET_AXES)
    D = mc.RET_SHAPE[0]
    ds = mc.retrieval_data()

    def spec(merge, psk):
        return dep.DeploymentSpec(
            n_shards=D, merge=merge, per_shard_k=psk,
            index=IndexSpec(**mc.RET_INDEX), shard_timeout_s=mc.NEVER_S)

    def put(key, r):
        res[f"{key}/ids"] = np.asarray(r.ids, np.int64)
        res[f"{key}/dists"] = np.asarray(r.dists, np.float32)
        res[f"{key}/rows"] = mc.report_rows(r.report)
        res[f"{key}/missing"] = np.asarray(r.report.missing_shards, np.int64)

    def ask(mask=15, route=None):
        return mc.retrieval_request(ds, mask, SearchRequest, route)

    seg = mc.retrieval_segmented(SegmentedIndex(IndexSpec(**mc.RET_INDEX)))
    for merge in mc.RET_MERGES:
        for psk in mc.RET_PER_SHARD_K:
            flat = dep.ShardedDeployment.flat(
                ds.vectors, ds.lo, ds.hi, spec=spec(merge, psk), mesh=mesh)
            built = dep.ShardedDeployment.build(
                ds.vectors, ds.lo, ds.hi, spec=spec(merge, psk), mesh=mesh)
            segd = dep.ShardedDeployment.from_segmented(
                seg, spec=spec(merge, psk), mesh=mesh)
            for mask in mc.RET_MASKS[:None if psk == 0 else 1]:
                put(f"flat/{merge}/{psk}/{mask}", flat.execute(ask(mask)))
            for route in mc.RET_ROUTES[0 if psk == 0 else 1:]:
                put(f"build/{merge}/{psk}/{route}",
                    built.execute(ask(route=route)))
                put(f"segmented/{merge}/{psk}/{route}",
                    segd.execute(ask(route=route)))
            if psk:
                continue
            for layout, d, route in (("flat", flat, None),
                                     ("build", built, "pruned"),
                                     ("segmented", segd, "pruned")):
                d.fail(D - 1)
                put(f"{layout}/{merge}/failed3", d.execute(ask(route=route)))
                d.restore(D - 1)
            if merge == "all_gather":
                # what a rank whose search raises (shard 1) and one whose
                # heartbeat is stale (shard 2) leave
                built.fail(1)
                put("build/all_gather/failed1",
                    built.execute(ask(route="pruned")))
                flat.fail(2)
                put("flat/all_gather/failed2", flat.execute(ask()))

    for seed in (0, 1):
        ids, dists = mc.retrieval_lists(seed)
        for name, alive in mc.RET_LIST_ALIVE.items():
            live = np.ones(D, bool) if alive is None else alive
            for merge in mc.RET_MERGES:
                fn = topk.MERGE_SCHEDULES[merge]

                def lane(i, d):
                    ok = jnp.asarray(live)[jax.lax.axis_index("data")]
                    return fn(jnp.where(ok, i, -1), jnp.where(ok, d, jnp.inf),
                              mc.RET_LIST_K, "data")

                gi, gd = jax.vmap(lane, axis_name="data")(ids, dists)
                key = f"lists/{seed}/{name}/{merge}"
                res[f"{key}/lanes/ids"] = np.asarray(gi, np.int64)
                res[f"{key}/lanes/dists"] = np.asarray(gd, np.float32)
                gi, gd = topk.sharded_topk_merge(
                    mesh, ids, dists, mc.RET_LIST_K, merge=merge,
                    alive=alive)
                res[f"{key}/mesh/ids"] = gi
                res[f"{key}/mesh/dists"] = gd


def retrieval_async(res: dict) -> None:
    """The ``AsyncRetrievalServer`` script over the ``all_gather`` flat and
    build deployments on a (data 4) mesh, one process on rank 0's
    clock."""
    from repro.core import IndexSpec
    from repro.distributed import deployment as dep
    from repro.launch.mesh import make_mesh
    from repro.serving import AsyncRetrievalServer, SLOPolicy

    mesh = make_mesh(mc.RET_SHAPE, mc.RET_AXES)
    ds = mc.retrieval_data()
    spec = dep.DeploymentSpec(
        n_shards=mc.RET_SHAPE[0], merge="all_gather",
        index=IndexSpec(**mc.RET_INDEX), shard_timeout_s=mc.NEVER_S)
    for layout in mc.ASYNC_LAYOUTS:
        d = getattr(dep.ShardedDeployment, layout)(
            ds.vectors, ds.lo, ds.hi, spec=spec, mesh=mesh)
        got = mc.async_script(AsyncRetrievalServer, SLOPolicy, d,
                              mc.ScriptClock(0))
        for key, v in got.items():
            res[f"async/{layout}/{key}"] = v


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
