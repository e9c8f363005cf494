"""The fake-rank side of ``tests/test_torch_dryrun.py``, run as its own
process (the fake process group is a process-wide default group):

    python tests/_dryrun_ranks.py OUT.json

On a fake (pod 2, data 2, model 2) group of 8 ranks
(``repro_torch.launch.dryrun.fake_group``): olmo-1b smoke's train and
decode bundles counted on fake tensors (``count_step``), with their
argument bytes beside the metas' reckoning and, in decode, the caches'
reckoning in the reference's layout; each segment's repeat count
bumped in turn for recurrentgemma-2b and deepseek-v3-671b smoke; the MSTG
serving step's three layouts at a small size; and a second
``fake_group`` inside the first. Then, on a fake group of 256 ranks,
``run_cell`` of olmo-1b at decode_32k on the single-pod mesh. Writes
every number as JSON.
"""
import json
import os
import sys
import tempfile
import traceback


def _counted(runner, shape, mesh):
    from repro_torch.launch.dryrun import collective_bytes, count_step
    mesh.records.clear()
    b = runner.bundle_for(shape)
    c = count_step(b.fn, b.args)
    _, _, counts = collective_bytes(mesh.records, mesh.size)
    return b, c, counts


def main(out: str) -> None:
    import torch
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.launch import dryrun, dryrun_mstg as dm
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.steps import ArchRunner
    from repro_torch.models import params as pr

    torch.set_num_threads(1)
    res = {}
    with dryrun.fake_group(8):
        mesh = make_rank_mesh((2, 2, 2), ("pod", "data", "model"),
                              device="cpu")
        runner = ArchRunner(get_smoke_config("olmo-1b"), mesh)
        for kind in ("train", "decode"):
            shape = ShapeConfig(kind, 64, 8, kind)
            try:
                b, c, counts = _counted(runner, shape, mesh)
                rules = pr.DEFAULT_RULES if kind == "train" \
                    else pr.SERVE_RULES
                res[kind] = dict(
                    status="ok", flops=c["flops"], bytes=c["bytes"],
                    counts=counts, temp=c["peak_bytes"] - c["output_bytes"],
                    arg_bytes=[0 if isinstance(a, int) else pr.tree_bytes(a)
                               for a in b.args],
                    shard_bytes=pr.tree_bytes(pr.shard_metas(
                        runner.metas, mesh, rules)),
                    whole_bytes=pr.tree_bytes(runner.metas))
                if kind == "decode":
                    res[kind]["cache_reckoned"] = dryrun.laid_out_bytes(
                        *runner.decode_cache_layout(shape), mesh)
            except Exception:  # noqa: BLE001 — the test reads the status
                res[kind] = dict(status="error",
                                 traceback=traceback.format_exc())
        # count(full depth) against one repeat each plus (R_k - 1) units
        ident = {}
        for arch in ("recurrentgemma-2b", "deepseek-v3-671b"):
            cfg = get_smoke_config(arch)
            R = [s.repeats for s in ArchRunner(cfg, mesh).lm.layout]
            for kind in ("train", "decode"):
                shape = ShapeConfig(kind, 32, 8, kind)

                def flops(reps):
                    r = ArchRunner(cfg, mesh, segment_repeats=reps)
                    return _counted(r, shape, mesh)[1]["flops"]

                base = flops([1] * len(R))
                bumps = []
                for k in range(len(R)):
                    reps = [1] * len(R)
                    reps[k] = 2
                    bumps.append(flops(reps))
                ident[f"{arch}|{kind}"] = dict(
                    repeats=R, full=flops(None), base=base, bumps=bumps)
        res["identity"] = ident
        # the MSTG serving step on the same mesh at a small size
        size = dict(n_corpus=1 << 16, n_queries=8, dim=16)
        mstg = {}
        for merge in dm.MERGES:
            mesh.records.clear()
            fn, args = (dm.build_step_v2(mesh, **size)
                        if merge == "fullmesh_v2"
                        else dm.build_step(mesh, merge, **size))
            from torch._subclasses.fake_tensor import FakeTensorMode
            from repro_torch.launch.steps import materialize
            with FakeTensorMode(allow_non_fake_inputs=True):
                ids, d = fn(*materialize(args))
                shapes = [list(ids.shape), str(ids.dtype), list(d.shape)]
            mesh.records.clear()
            c = dryrun.count_step(fn, args)
            mstg[merge] = dict(
                out=shapes, flops=c["flops"],
                model=dm.model_flops_per_device(mesh, merge, **size),
                n_loc=args[0].shape[0], q_loc=args[3].shape[0],
                counts=dryrun.collective_bytes(mesh.records, 8)[2])
        res["mstg"] = mstg
        try:
            with dryrun.fake_group(8):
                pass
            res["nested_group_refused"] = False
        except RuntimeError:
            res["nested_group_refused"] = True
    with dryrun.fake_group(256), tempfile.TemporaryDirectory() as tmp:
        res["cell"] = dryrun.run_cell("olmo-1b", "decode_32k", "single_pod",
                                      tmp)
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    main(sys.argv[1])
