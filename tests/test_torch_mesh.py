"""The port's mesh bookkeeping against the reference's, in this process:
the parameter specs (``repro_torch.models.params.spec_tree``) of all ten
configs, full and smoke, under both rule sets on four meshes; the helpers
of ``repro_torch.distributed.sharding``; a shard's index by hand; what the
mesh refuses; and the imports of the port and of ``chip_smoke.py``.

The reference's ``spec_for`` reads only ``mesh.shape``, so a namespace
with a ``shape`` stands in for its mesh and a logical
``repro_torch.launch.make_mesh`` for the port's; no devices are needed.
The reference is imported inside :func:`_ref` with ``DeprecationWarning``
ignored there only (its model package imports ``jax.experimental.
shard_map``). The multi-rank cases are in ``tests/test_torch_mesh_moe.py``
and ``tests/test_torch_mesh_serve.py``.
"""
import ast
import functools
import os
import subprocess
import sys
import types
import warnings

import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.launch import make_mesh, make_rank_mesh
from repro_torch.launch.mesh import Mesh, transport
from repro_torch.models import LM, params
from repro_torch.serving import ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        from jax.sharding import PartitionSpec
        from repro import configs
        from repro.distributed import sharding as rsharding
        from repro.models import params as rparams
        from repro.models.transformer import LM as RLM
    return dict(jax=jax, P=PartitionSpec, configs=configs, LM=RLM,
                params=rparams, sharding=rsharding)


def _by_path(tree, is_leaf, path=()):
    """{path: leaf} of nested dicts and lists."""
    if is_leaf(tree):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_by_path(v, is_leaf, path + (k,)))
    return out


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", tcfg.ARCH_NAMES)
def test_spec_tree_equals_reference(arch, size):
    r = _ref()
    get = "get_config" if size == "full" else "get_smoke_config"
    rmetas = r["LM"](getattr(r["configs"], get)(arch)).abstract_params()
    metas = LM(getattr(tcfg, get)(arch)).abstract_params()
    for shape, axes in MESHES.values():
        rmesh = types.SimpleNamespace(shape=dict(zip(axes, shape)))
        mesh = make_mesh(shape, axes, device="cpu")
        for rules, rrules in (
                (params.DEFAULT_RULES, r["params"].DEFAULT_RULES),
                (params.SERVE_RULES, r["params"].SERVE_RULES)):
            want = {k: tuple(v) for k, v in _by_path(
                r["params"].spec_tree(rmetas, rmesh, rrules),
                lambda x: isinstance(x, r["P"])).items()}
            got = _by_path(params.spec_tree(metas, mesh, rules),
                           lambda x: isinstance(x, tuple))
            assert got == want, (shape, rules is params.SERVE_RULES)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharding_helpers_equal_reference(mesh_name):
    rs = _ref()["sharding"]
    shape, axes = MESHES[mesh_name]
    rmesh = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    mesh = make_mesh(shape, axes, device="cpu")
    for ax in (None, "data", "model", ("data", "model"), axes):
        assert sharding.mesh_axis_size(mesh, ax) == rs.mesh_axis_size(
            rmesh, ax)
        for n in (1, 3, 4, 16, 32, 48, 512):
            assert sharding.shard_or_replicate(mesh, n, ax) == \
                rs.shard_or_replicate(rmesh, n, ax)
    for batch in (1, 2, 3, 4, 16, 32, 256):
        for ba in (("pod", "data"), ("data",), ("model",)):
            assert sharding.batch_spec(mesh, batch, ba) == tuple(
                rs.batch_spec(rmesh, batch, ba))
    assert sharding.replicated(mesh).spec == ()
    assert sharding.named(mesh, "data", None).spec == ("data", None)


def test_a_shard_is_its_block_with_the_last_axis_fastest():
    """Experts over (data, model) on a 2 x 2 mesh: rank (d, m) holds block
    2 d + m; D over data alone; a dim past the spec is whole."""
    sh = sharding.NamedSharding(
        Mesh({"data": 2, "model": 2}, torch.device("cpu"),
             coord={"data": 1, "model": 0}),
        (("data", "model"), "data"))
    assert sh.shard_shape((8, 6, 5)) == (2, 3, 5)
    assert sh.index((8, 6, 5)) == (slice(4, 6), slice(3, 6), slice(0, 5))
    with pytest.raises(ValueError, match="does not split"):
        sh.shard_shape((6, 6, 5))


def test_shard_metas_count_this_rank_s_bytes():
    cfg = tcfg.get_config("qwen3-moe-30b-a3b")
    metas = LM(cfg).abstract_params()
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    half = params.tree_bytes(params.shard_metas(metas, mesh,
                                                params.SERVE_RULES))
    whole = params.tree_bytes(metas)
    # everything but the norms and the router splits in two
    assert 0.5 * whole < half < 0.505 * whole


def test_shape_dtype_tree_is_meta_tensors():
    metas = LM(tcfg.get_smoke_config("olmo-1b")).abstract_params()
    sds = params.shape_dtype_tree(metas)
    t = sds["embed"]["table"]
    assert t.device.type == "meta"
    assert tuple(t.shape) == metas["embed"]["table"].shape
    assert t.dtype == metas["embed"]["table"].dtype


def test_the_mesh_refuses_what_it_cannot_carry():
    assert transport("nccl", "cuda") == "direct"
    assert transport("gloo", "cpu") == "direct"
    assert transport("gloo", "cuda") == "host"
    for backend, dev in (("nccl", "cpu"), ("gloo", "meta"),
                         ("mpi", "cpu")):
        with pytest.raises(RuntimeError, match="no collectives"):
            transport(backend, dev)
    logical = make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="logical mesh"):
        coll.psum(torch.ones(3), logical, "data")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_rank_mesh((1, 1), ("data", "model"), device="cpu")
    lm = LM(tcfg.get_smoke_config("olmo-1b"))
    lm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="mesh of ranks"):
        ServeEngine(lm, mesh=logical)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
    # and at run time, every module of the port
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
