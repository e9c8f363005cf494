"""The port covers the reference: every public top-level function and
class of ``src/repro/`` has a counterpart of the same name in the same
module of ``src/repro_torch/`` (a ``def``, a ``class``, an assignment or
an import binding that name), or is listed in :data:`ACCOUNTED` with the
ROADMAP §3 entry that explains it. Read from the source with ``ast``;
neither package is imported.
"""
import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")

# (reference module, name) -> (port module, its name there, or None where
# it is not ported; the ROADMAP §3 entry that says why)
ACCOUNTED = {
    ("core/segment_tree.py", "node_ranges_jax"):
        ("core/segment_tree.py", "node_ranges", "(as)"),
    ("core/segment_tree.py", "decompose_jax"):
        ("core/segment_tree.py", "decompose_batched", "(as)"),
    ("core/search.py", "DeviceVariant"):
        ("core/search.py", "device_variant", "(as)"),
    ("kernels/gathered_topk.py", "gathered_topk"):
        ("kernels/ops.py", "gathered_topk", "(at)"),
    ("kernels/gathered_topk.py", "gathered_topk_quant"):
        ("kernels/ops.py", "gathered_topk_quant", "(at)"),
    ("kernels/gathered_l2.py", "gathered_l2"):
        ("kernels/ops.py", "gathered_l2", "(at)"),
    ("kernels/gathered_l2.py", "gathered_l2_dot"):
        ("kernels/ops.py", "gathered_l2_dot", "(at)"),
    ("kernels/pairwise_l2.py", "pairwise_l2_masked"):
        ("kernels/ops.py", "pairwise_l2_masked", "(at)"),
    ("kernels/pairwise_l2_int8.py", "pairwise_l2_int8"):
        ("kernels/ops.py", "pairwise_l2_int8", "(at)"),
    ("kernels/fused_topk.py", "fused_topk_l2"):
        ("kernels/ops.py", "fused_topk_l2", "(at)"),
    ("core/compressed.py", "compressed_flat_topr"): (None, None, "(l)"),
    ("serving/ops.py", "embeddable_item"): (None, None, "(r)"),
    ("core/engine.py", "reset_deprecation_warnings"): (None, None, "(s)"),
    ("launch/compat.py", "cost_analysis_dict"): (None, None, "(s)"),
}


def _public_defs(path):
    tree = ast.parse(open(path).read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def _bound_names(path):
    """Every name a module binds at its top level."""
    out = set()
    for n in ast.parse(open(path).read()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


def _reference_names():
    out = []
    for root, _, files in os.walk(REF):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                mod = os.path.relpath(path, REF).replace(os.sep, "/")
                out.extend((mod, name) for name in _public_defs(path))
    return sorted(out)


def _port_names(mod):
    path = os.path.join(PORT, mod)
    return _bound_names(path) if os.path.exists(path) else set()


def test_every_reference_name_has_a_counterpart():
    names = _reference_names()
    assert len(names) > 250          # the walk found the tree
    missing = []
    for mod, name in names:
        if (mod, name) in ACCOUNTED:
            continue
        if name not in _port_names(mod):
            missing.append(f"{mod}::{name}")
    assert not missing, "not in the port and not accounted for: " + \
        ", ".join(missing)


@pytest.mark.parametrize("key", sorted(ACCOUNTED), ids="::".join)
def test_accounted_names_are_as_listed(key):
    """Each listed name is really absent from the port's same module, its
    counterpart (where one is named) exists, and ROADMAP §3 has the
    entry."""
    mod, name = key
    port_mod, port_name, letter = ACCOUNTED[key]
    assert name in _public_defs(os.path.join(REF, mod))
    assert name not in _port_names(mod)
    if port_mod is not None:
        assert port_name in _port_names(port_mod)
    roadmap = open(os.path.join(ROOT, "ROADMAP.md")).read()
    section = roadmap[roadmap.index("### 3."):]
    assert re.search(r"\*\*" + re.escape(letter) + r"\*\*", section), letter
