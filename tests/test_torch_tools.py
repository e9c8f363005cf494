"""The last pieces of the port against the reference, on the CPU:
``kernels.ref.topk_mask_ref``, ``core.segment_tree.vertex_levels_for_cover``,
``core.flat.flat_search_blocked``, and the launch tools' arithmetic
(``launch.steps.batch_axes_for`` / ``cache_specs``, ``launch.roofline``'s
``model_flops`` / ``analytic_memory_bytes`` / ``_cache_bytes``,
``launch.dryrun.collective_bytes``, ``configs.supports_shape``).

The reference's core and kernel modules are imported inside :func:`_ref`
with ``DeprecationWarning`` ignored. Its launch modules force 512 host
devices through ``XLA_FLAGS`` when imported, so their side runs once in a
subprocess (``tests/_tools_reference.py``) that writes every number as
JSON; their ``batch_axes_for`` and ``cache_specs`` read only
``mesh.shape``, so a stub mesh serves and no devices are needed.
Bars: masks, levels, specs, FLOP and byte formulas and collective
accounts equal; the blocked scan's ids equal wherever distances are
distinct, its distances within 1e-4 (ROADMAP's bar for the pairwise
scans).
"""
import functools
import json
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.core import intervals as iv
from repro_torch.core import segment_tree as st
from repro_torch.core.flat import flat_search, flat_search_blocked
from repro_torch.kernels import ref as kref
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.launch.dryrun import collective_bytes
from repro_torch.models import LM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _tools_reference as tref  # noqa: E402

MASKS = [
    iv.ANY_OVERLAP,
    iv.QUERY_CONTAINED,
    iv.QUERY_CONTAINING,
    iv.LEFT_OVERLAP,
    iv.RIGHT_OVERLAP,
    iv.LEFT_OVERLAP | iv.RIGHT_OVERLAP,
    iv.QUERY_CONTAINED | iv.QUERY_CONTAINING,
    iv.LEFT_OVERLAP | iv.QUERY_CONTAINED | iv.RIGHT_OVERLAP,
]


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax.numpy as jnp
        from repro.core import flat as rflat
        from repro.core import segment_tree as rst
        from repro.kernels import ref as rref
    return types.SimpleNamespace(jnp=jnp, flat=rflat, st=rst, kref=rref)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference launch tools' numbers, from their own process."""
    out = tmp_path_factory.mktemp("tools") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "_tools_reference.py"),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        return json.load(f)


# ---- topk_mask_ref ---------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 17, 40])
def test_topk_mask_equals_reference_with_ties(k):
    r = _ref()
    rng = np.random.default_rng(k)
    d = rng.integers(0, 6, size=(7, 40)).astype(np.float32)  # many ties
    d[3] = 2.0                                                # a row all tied
    got = kref.topk_mask_ref(torch.from_numpy(d), k).numpy()
    want = np.asarray(r.kref.topk_mask_ref(r.jnp.asarray(d), k))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.bool_ and (got.sum(1) == k).all()


# ---- vertex_levels_for_cover ---------------------------------------------

def _random_cover(rng, Kpad: int):
    """A cover from the decomposition of a random range, with junk in the
    invalid slots."""
    r = _ref()
    lo, hi = sorted(rng.integers(0, Kpad, size=2).tolist())
    nodes = r.st.decompose(lo, hi, Kpad)
    P = r.st.max_cover_nodes(Kpad)
    levels = rng.integers(0, r.st.num_levels(Kpad), size=P).astype(np.int32)
    idxs = rng.integers(0, 4, size=P).astype(np.int32)
    valid = np.zeros(P, bool)
    for i, (lvl, j) in enumerate(nodes):
        levels[i], idxs[i], valid[i] = lvl, j, True
    return levels, idxs, valid


@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
@pytest.mark.parametrize("Kpad", [16, 64, 1024])
def test_vertex_levels_for_cover_equals_reference(Kpad, lead):
    r = _ref()
    rng = np.random.default_rng(Kpad + len(lead))
    for _ in range(8):
        levels, idxs, valid = _random_cover(rng, Kpad)
        tkeys = rng.integers(0, Kpad, size=lead + (Kpad,)).astype(np.int32)
        got = st.vertex_levels_for_cover(
            torch.from_numpy(tkeys), torch.from_numpy(levels),
            torch.from_numpy(idxs), torch.from_numpy(valid), Kpad)
        want = r.st.vertex_levels_for_cover(
            r.jnp.asarray(tkeys), r.jnp.asarray(levels),
            r.jnp.asarray(idxs), r.jnp.asarray(valid), Kpad)
        assert got.dtype == torch.int32 and got.shape == tkeys.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- flat_search_blocked ---------------------------------------------------

def _scan_inputs(seed: int, N: int = 300, Q: int = 12, d: int = 16,
                 dup: bool = False):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(N, d)).astype(np.float32)
    lo = rng.integers(0, 100, size=N).astype(np.float32)
    hi = lo + rng.integers(0, 30, size=N).astype(np.float32)
    if dup:                       # exact ties: rows repeated, ranges too
        src = rng.integers(0, N, size=N // 3)
        dst = rng.integers(0, N, size=N // 3)
        corpus[dst], lo[dst], hi[dst] = corpus[src], lo[src], hi[src]
    queries = rng.normal(size=(Q, d)).astype(np.float32)
    ql = rng.integers(0, 100, size=Q).astype(np.float32)
    qh = ql + rng.integers(0, 40, size=Q).astype(np.float32)
    return corpus, lo, hi, queries, ql, qh


def _f64_sorted(args, mask):
    """Each row's qualifying float64 distances, ascending."""
    corpus, lo, hi, queries, ql, qh = (a.astype(np.float64) for a in args)
    d = ((queries[:, None, :] - corpus[None]) ** 2).sum(-1)
    sel = iv.eval_predicate(mask, torch.from_numpy(lo)[None],
                            torch.from_numpy(hi)[None],
                            torch.from_numpy(ql)[:, None],
                            torch.from_numpy(qh)[:, None]).numpy()
    return np.sort(np.where(sel, d, np.inf), axis=1)


def _assert_same_lists(ids, d, want_ids, want_d, full, rtol=1e-4):
    """NO_EDGE and +inf where ``want`` has them; distances within ``rtol``;
    ids equal at every position whose distance is distinct (no other
    qualifying row within ``rtol`` in the float64 row ``full``)."""
    ids, d = np.asarray(ids), np.asarray(d)
    want_ids, want_d = np.asarray(want_ids), np.asarray(want_d)
    np.testing.assert_array_equal(ids < 0, want_ids < 0)
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(want_d))
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(d[fin], want_d[fin], rtol=rtol, atol=rtol)
    k = ids.shape[1]
    full = np.pad(full, ((0, 0), (0, max(0, k + 1 - full.shape[1]))),
                  constant_values=np.inf)
    tol = rtol * (np.abs(full) + 1.0)
    with np.errstate(invalid="ignore"):            # inf - inf past the end
        gap_lo = np.diff(full, axis=1, prepend=-np.inf)[:, :k]
        gap_hi = np.diff(full, axis=1, append=np.inf)[:, :k]
    distinct = fin & (gap_lo > tol[:, :k]) & (gap_hi > tol[:, :k])
    np.testing.assert_array_equal(ids[distinct], want_ids[distinct])
    return int(distinct.sum())


@pytest.mark.parametrize("case", ["divides", "ragged", "beyond_n",
                                  "k_above_qualifying", "duplicates"])
@pytest.mark.parametrize("mask", MASKS, ids=iv.mask_name)
def test_flat_search_blocked_equals_reference(mask, case):
    r = _ref()
    block, k = {"divides": (60, 10), "ragged": (64, 10),
                "beyond_n": (512, 10), "k_above_qualifying": (37, 120),
                "duplicates": (50, 10)}[case]
    args = _scan_inputs(mask, dup=case == "duplicates")
    if case == "k_above_qualifying":
        k = int((_f64_sorted(args, mask) < np.inf).sum(1).max()) + 5
    ids, d = flat_search_blocked(*map(torch.from_numpy, args), mask=mask,
                                 k=k, block=block)
    assert ids.dtype == torch.int32 and d.dtype == torch.float32
    assert ids.shape == d.shape == (args[3].shape[0], k)
    rids, rd = r.flat.flat_search_blocked(*map(r.jnp.asarray, args),
                                          mask=mask, k=k, block=block)
    full = _f64_sorted(args, mask)
    n = _assert_same_lists(ids, d, rids, rd, full)
    assert n > 0
    # and the port's own exact scan
    fids, fd = flat_search(*map(torch.from_numpy, args), mask=mask, k=k)
    _assert_same_lists(ids, d, fids, fd, full)
    if case == "k_above_qualifying":
        assert (ids == -1).any(1).all()


def test_flat_search_blocked_keeps_the_earlier_winner_among_exact_ties():
    """Every row the same vector and range: each block's distances are
    exactly equal, and the winners stay the k lowest ids, as
    ``lax.top_k`` keeps the lower position."""
    r = _ref()
    args = list(_scan_inputs(5, N=100))
    args[0][:] = args[0][0]
    args[1][:], args[2][:] = 0.0, 200.0
    ids, _ = flat_search_blocked(*map(torch.from_numpy, args),
                                 mask=iv.ANY_OVERLAP, k=7, block=16)
    rids, _ = r.flat.flat_search_blocked(*map(r.jnp.asarray, args),
                                         mask=iv.ANY_OVERLAP, k=7, block=16)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(ids.numpy()[0], np.arange(7))


# ---- the launch tools' arithmetic ------------------------------------------

def _plain(tree):
    """Spec tuples as nested lists, for comparison with the JSON."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _grid(arch):
    cfg = tcfg.get_config(arch)
    lm = LM(cfg)
    for shape in tcfg.ALL_SHAPES:
        for mk, ms in tref.MESH_SHAPES.items():
            yield cfg, lm, shape, mk, ms


@pytest.mark.parametrize("arch", tcfg.ARCH_NAMES)
def test_batch_axes_and_cache_specs_equal_reference(reference, arch):
    for cfg, lm, shape, mk, ms in _grid(arch):
        want = reference["grid"][f"{arch}|{shape.name}|{mk}"]
        mesh = types.SimpleNamespace(shape=dict(ms))
        ba = steps.batch_axes_for(mesh, shape.global_batch)
        assert list(ba) == want["batch_axes"], (shape.name, mk)
        n_front = (cfg.n_frontend_tokens if cfg.frontend == "vision_stub"
                   else 0)
        enc_len = shape.seq_len if cfg.n_enc_layers else 0
        got = steps.cache_specs(lm, mesh, ba, shape.global_batch,
                                shape.seq_len + n_front, enc_len)
        assert _plain(got) == want["cache_specs"], (shape.name, mk)


@pytest.mark.parametrize("arch", tcfg.ARCH_NAMES)
def test_roofline_formulas_equal_reference(reference, arch):
    for cfg, lm, shape, mk, ms in _grid(arch):
        want = reference["grid"][f"{arch}|{shape.name}|{mk}"]
        devices = int(np.prod(list(ms.values())))
        assert rl.model_flops(cfg, lm, shape, devices) == \
            want["model_flops"], (shape.name, mk)
        assert rl.analytic_memory_bytes(cfg, lm, shape, ms) == \
            want["analytic_memory_bytes"], (shape.name, mk)
        assert rl._cache_bytes(lm, shape, devices) == \
            want["cache_bytes"], (shape.name, mk)


@pytest.mark.parametrize("op", tref.HLO_OPS)
def test_collective_bytes_equals_reference_hlo_parse(reference, op):
    n = 0
    for i, (o, dt, dims, P, start) in enumerate(tref.HLO_CASES):
        if o != op:
            continue
        rec = [(o, tref.result_bytes(dt, dims), P)]
        assert [collective_bytes(rec, 16)[j] for j in range(3)] == \
            reference["hlo_cases"][i], (o, dt, dims, P, start)
        n += 1
    assert n == 12


def test_collective_bytes_of_all_records_equals_reference(reference):
    from collections import Counter
    recs = Counter((o, tref.result_bytes(dt, dims), P)
                   for o, dt, dims, P, _ in tref.HLO_CASES)
    assert [list(x) for x in [collective_bytes(recs, 16)]][0] == \
        reference["hlo_all"]
    with pytest.raises(ValueError):
        collective_bytes([("send", 4, 2)])


def test_supports_shape_equals_reference(reference):
    got = {f"{a}|{s.name}": bool(tcfg.supports_shape(tcfg.get_config(a),
                                                     s)[0])
           for a in tcfg.ARCH_NAMES for s in tcfg.ALL_SHAPES}
    assert got == reference["supports"]
    assert sum(got.values()) == 33 and len(got) - sum(got.values()) == 7


def test_roofline_reads_the_dryrun_record_against_a_named_card(tmp_path):
    """``analyze_cell`` prices a record's counts with the named card's
    peaks, ``corrected`` equal to what was counted; an unknown card is
    refused."""
    from repro_torch.obs.profile import PEAKS
    cell = {"status": "ok", "kind": "decode", "flops_per_device": 2.0e12,
            "devices": 256, "mesh_shape": {"data": 16, "model": 16},
            "bytes_per_device": 6.7e12,
            "collective_bytes": {"all-gather": 9.0e8, "all-reduce": 0},
            "collective_wire_bytes": {"all-gather": 1.8e9,
                                      "all-reduce": 0}}
    adir, out = tmp_path / "dry", tmp_path / "roof"
    adir.mkdir()
    (adir / "olmo-1b__decode_32k__single_pod.json").write_text(
        json.dumps(cell))
    rec = rl.analyze_cell("olmo-1b", "decode_32k", str(adir), str(out))
    pk = PEAKS[rl.DEFAULT_CARD]
    assert rec["corrected"] == rec["hlo"]
    assert rec["terms"]["compute_s"] == 2.0e12 / pk.bf16_flop_per_s
    assert rec["terms"]["memory_hlo_s"] == 6.7e12 / pk.hbm_bytes_per_s
    assert rec["terms"]["collective_s"] == 9.0e8 / 450e9
    assert rec["segment_repeats"] == [16]
    assert rl.analyze_cell("olmo-1b", "train_4k", str(adir),
                           str(out)) is None
    assert "| olmo-1b | decode_32k |" in rl.emit_markdown(str(out))
    with pytest.raises(KeyError):
        rl.analyze_cell("olmo-1b", "decode_32k", str(adir), str(out),
                        force=True, card="NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError):
        rl.main(["--card", "TPU v5e", "--out", str(out)])
