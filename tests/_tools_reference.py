"""The reference's side of the launch-tool parity tests, run as its own
process (its ``dryrun`` and ``roofline`` modules force 512 host devices
through ``XLA_FLAGS`` when they are imported, which a pytest worker that
other files share must not see):

    python tests/_tools_reference.py OUT.json

Writes, for every config x shape x production mesh shape, the reference's
``batch_axes_for`` and ``cache_specs`` (on a stub mesh: both read only
``mesh.shape``; specs as nested lists), ``model_flops``,
``analytic_memory_bytes`` and ``_cache_bytes``; its ``supports_shape``
verdicts; and its ``collective_bytes`` of synthetic HLO lines (``HLO_CASES``).
jax's deprecation warnings are ignored in this process.
"""
import json
import os
import sys
import warnings

warnings.simplefilter("ignore", DeprecationWarning)

MESH_SHAPES = {"single_pod": {"data": 16, "model": 16},
               "multi_pod": {"pod": 2, "data": 16, "model": 16}}
DTYPES = {"f32": 4, "bf16": 2, "s32": 4, "s8": 1}
# (op, dtype, result dims, group size, -start form)
HLO_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
           "collective-permute", "collective-broadcast")
HLO_CASES = [(op, dt, dims, P, start)
             for op in HLO_OPS for P in (2, 4, 16) for start in (False, True)
             for dt, dims in (("f32", (16, 128)), ("bf16", (4, 32, 64)))]


def result_bytes(dt, dims) -> int:
    n = DTYPES[dt]
    for d in dims:
        n *= d
    return n


def hlo_line(i, op, dt, dims, P, start) -> str:
    """One HLO instruction of ``op``'s result type ``dt[dims]`` over
    replica groups of ``P``; a ``-start`` form carries (operand, result)."""
    ty = f"{dt}[{','.join(map(str, dims))}]{{0}}"
    small = f"{dt}[{','.join(map(str, (1,) + tuple(dims[1:])))}]{{0}}"
    res = f"({small}, {ty})" if start else ty
    name = op + ("-start" if start else "")
    return (f"  %{name}.{i} = {res} {name}({small} %p.{i}), "
            f"replica_groups=[{16 // P if P <= 16 else 1},{P}]<=[16]")


class StubMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _plain(spec_tree):
    """A spec tree as nested lists (a PartitionSpec as the list of its
    entries, an entry tuple as a list)."""
    from jax.sharding import PartitionSpec
    if isinstance(spec_tree, PartitionSpec):
        return [list(e) if isinstance(e, tuple) else e for e in spec_tree]
    if isinstance(spec_tree, dict):
        return {k: _plain(v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return [_plain(v) for v in spec_tree]
    return spec_tree


def main(out: str) -> None:
    from repro.configs import ALL_SHAPES, ARCH_NAMES, get_config, \
        supports_shape
    from repro.launch import roofline as rl
    from repro.launch.dryrun import collective_bytes
    from repro.launch.steps import batch_axes_for, cache_specs
    from repro.models.transformer import LM

    grid = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        lm = LM(cfg)
        for shape in ALL_SHAPES:
            n_front = (cfg.n_frontend_tokens
                       if cfg.frontend == "vision_stub" else 0)
            enc_len = shape.seq_len if cfg.n_enc_layers else 0
            for mk, ms in MESH_SHAPES.items():
                mesh = StubMesh(ms)
                devices = 1
                for v in ms.values():
                    devices *= v
                ba = batch_axes_for(mesh, shape.global_batch)
                grid[f"{arch}|{shape.name}|{mk}"] = {
                    "batch_axes": list(ba),
                    "cache_specs": _plain(cache_specs(
                        lm, mesh, ba, shape.global_batch,
                        shape.seq_len + n_front, enc_len)),
                    "model_flops": rl.model_flops(cfg, lm, shape, devices),
                    "analytic_memory_bytes": rl.analytic_memory_bytes(
                        cfg, lm, shape, ms),
                    "cache_bytes": rl._cache_bytes(lm, shape, devices),
                }
    supports = {f"{a}|{s.name}": bool(supports_shape(get_config(a), s)[0])
                for a in ARCH_NAMES for s in ALL_SHAPES}
    hlo = []
    for i, case in enumerate(HLO_CASES):
        hlo.append(list(collective_bytes(hlo_line(i, *case), 16)))
    text = "\n".join(hlo_line(i, *c) for i, c in enumerate(HLO_CASES))
    with open(out, "w") as f:
        json.dump({"grid": grid, "supports": supports, "hlo_cases": hlo,
                   "hlo_all": list(collective_bytes(text, 16))}, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    main(sys.argv[1])
