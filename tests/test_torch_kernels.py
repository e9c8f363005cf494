"""The port's kernels against the JAX reference.

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs its plain
PyTorch version; these tests hold that version to the reference's Pallas
kernel (interpret mode) and to ``repro.kernels.ref`` on the same inputs,
made with numpy from a seed, at the tolerances of ``tests/test_kernels.py``:
ids exact, distances within 1e-5 (gathered) or 1e-4 (pairwise). The CUDA
kernels themselves are held to the plain versions in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import intervals as riv
from repro.kernels.gathered_l2 import gathered_l2 as pallas_gathered_l2
from repro.kernels.gathered_topk import gathered_topk as pallas_gathered_topk
from repro.kernels.pairwise_l2 import pairwise_l2_masked as pallas_pairwise
from repro.kernels import ref as jref

from repro_torch.kernels import ops

MASKS = [riv.ANY_OVERLAP, riv.QUERY_CONTAINED, riv.QUERY_CONTAINING,
         riv.LEFT_OVERLAP | riv.RIGHT_OVERLAP, riv.BEFORE | riv.AFTER]


def _mk_pairwise(Q, N, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    c = rng.normal(0, 1, (N, d)).astype(np.float32)
    lo = rng.uniform(0, 100, N).astype(np.float32)
    hi = lo + rng.uniform(0, 30, N).astype(np.float32)
    ql = rng.uniform(0, 100, Q).astype(np.float32)
    qh = ql + rng.uniform(0, 30, Q).astype(np.float32)
    return q, c, lo, hi, ql, qh


def _mk_wavefront_step(Q, n, d, M, L, seed=0):
    """Random inputs shaped like one wavefront beam step (the generator of
    tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    ids = rng.integers(-1, n, (Q, M)).astype(np.int32)
    avail = (rng.random((Q, M)) < 0.7) & (ids >= 0)
    b = rng.integers(0, 40, (Q, M)).astype(np.int32)
    e = b + rng.integers(0, 40, (Q, M)).astype(np.int32)
    ver = rng.integers(0, 70, Q).astype(np.int32)
    pool_d = np.sort(rng.random((Q, L)).astype(np.float32), axis=1)
    pool_ids = rng.integers(0, n, (Q, L)).astype(np.int32)
    tail = rng.integers(0, L + 1, Q)
    for qi in range(Q):
        pool_d[qi, tail[qi]:] = np.inf
        pool_ids[qi, tail[qi]:] = -1
    pool_exp = (rng.random((Q, L)) < 0.5) & np.isfinite(pool_d)
    return q, table, ids, avail, b, e, ver, pool_ids, pool_d, pool_exp


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


@pytest.mark.parametrize("mask", MASKS, ids=riv.mask_name)
@pytest.mark.parametrize("shape", [(3, 5, 8), (16, 130, 32), (9, 257, 17)])
def test_pairwise_plain_matches_pallas_and_ref(mask, shape):
    args = _mk_pairwise(*shape, seed=sum(shape))
    got = ops.pairwise_l2_masked(*_t(args), mask).numpy()
    pallas = np.asarray(pallas_pairwise(*args, mask, bq=8, bn=128,
                                        interpret=True))
    want = np.asarray(jref.pairwise_l2_masked_ref(*map(jnp.asarray, args),
                                                  mask))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)


def test_pairwise_nan_rows_never_qualify():
    q, c, lo, hi, ql, qh = _mk_pairwise(4, 12, 8, seed=5)
    lo[3] = hi[3] = np.nan
    for mask in range(64):
        got = ops.pairwise_l2_masked(*_t((q, c, lo, hi, ql, qh)), mask)
        assert torch.isinf(got[:, 3]).all()


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 37, 17), (12, 40, 64)])
def test_gathered_l2_plain_matches_pallas_and_ref(shape):
    Q, S, d = shape
    rng = np.random.default_rng(Q * S + d)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    cv = rng.normal(0, 1, (Q, S, d)).astype(np.float32)
    got = ops.gathered_l2(*_t((q, cv))).numpy()
    pallas = np.asarray(pallas_gathered_l2(q, cv, bq=4, interpret=True))
    want = np.asarray(jref.gathered_l2_ref(jnp.asarray(q), jnp.asarray(cv)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 50, 8, 12, 6), (9, 200, 16, 40, 16),
                                   (4, 30, 4, 24, 12), (2, 80, 8, 3, 10)])
def test_gathered_topk_plain_matches_pallas_and_ref(shape):
    """The fused wavefront step: ids and expanded flags bit-equal to the
    Pallas kernel and its oracle, distances within 1e-5."""
    args = _mk_wavefront_step(*shape, seed=sum(shape))
    ki, kd, ke = (a.numpy() for a in ops.gathered_topk(*_t(args)))
    pi, pd, pe = (np.asarray(a) for a in pallas_gathered_topk(
        *map(jnp.asarray, args), bq=4, interpret=True))
    ri, rd, re = (np.asarray(a) for a in jref.gathered_topk_ref(
        *map(jnp.asarray, args)))
    for ids, d, ex in ((pi, pd, pe), (ri, rd, re)):
        np.testing.assert_array_equal(ki, ids)
        np.testing.assert_allclose(kd, d, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ke, ex.astype(bool))


@pytest.mark.parametrize("case", ["unsorted_beam", "all_live"])
def test_gathered_topk_plain_matches_pallas_on_hard_steps(case):
    """The semantics the CUDA step kernel is held to, where its selection
    differs most from a sorted-beam merge: a beam in no order (the kernel
    may not assume it sorted), and a step whose candidates all pass the
    mask (every entry of [beam | candidates] is finite)."""
    Q, n, d, M, L = 6, 120, 16, 48, 16
    args = list(_mk_wavefront_step(Q, n, d, M, L, seed=11))
    rng = np.random.default_rng(12)
    if case == "unsorted_beam":
        for qi in range(Q):
            perm = rng.permutation(L)
            for j in (7, 8, 9):                 # pool_ids, pool_d, pool_exp
                args[j][qi] = args[j][qi][perm]
        assert not all(np.all(np.diff(r[np.isfinite(r)]) >= 0)
                       for r in args[8])
    else:
        args[2] = rng.integers(0, n, (Q, M)).astype(np.int32)
        args[3] = np.ones((Q, M), bool)
        args[4] = np.zeros((Q, M), np.int32)
        args[5] = np.full((Q, M), 100, np.int32)
    ki, kd, ke = (a.numpy() for a in ops.gathered_topk(*_t(args)))
    pi, pd, pe = (np.asarray(a) for a in pallas_gathered_topk(
        *map(jnp.asarray, args), bq=2, interpret=True))
    ri, rd, re = (np.asarray(a) for a in jref.gathered_topk_ref(
        *map(jnp.asarray, args)))
    if case == "all_live":
        assert np.isfinite(kd).all()
    for ids, dist, ex in ((pi, pd, pe), (ri, rd, re)):
        np.testing.assert_array_equal(ki, ids)
        np.testing.assert_allclose(kd, dist, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ke, ex.astype(bool))


@pytest.mark.parametrize("smem", [ops.gathered_topk_smem_bytes,
                                  ops.gathered_topk_quant_smem_bytes])
def test_step_shared_memory_admits_the_widest_route_step(smem):
    """The step kernel's shared memory fits a block at the widest step the
    graph route makes (fanout 8 at S = 767, L = 64), and is never more than
    the first design's 12 bytes per entry of L + M (so every step that
    design took is still admitted)."""
    assert smem(128, 8 * 767, 64) <= ops.MAX_SHARED_BYTES
    planes = 1 if smem is ops.gathered_topk_smem_bytes else 3
    for d, M, L in ((1, 0, 1), (17, 1, 1), (128, 8 * 767, 64),
                    (128, 19000, 64), (129, 3, 4000), (4096, 50, 10)):
        assert smem(d, M, L) <= 4 * (planes * d + 3 * (L + M))


def test_gathered_topk_ties_go_to_the_lower_position():
    """Exact ties (a duplicated table row, equal beam distances) resolve to
    the lower position of [beam | candidates], as lax.top_k does."""
    table = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 2.0]],
                     np.float32)
    q = np.zeros((1, 2), np.float32)
    ids = np.array([[2, 1, 3]], np.int32)
    avail = np.ones((1, 3), bool)
    b = np.zeros((1, 3), np.int32)
    e = np.full((1, 3), 9, np.int32)
    ver = np.array([1], np.int32)
    pool_ids = np.array([[0, 3, -1, -1]], np.int32)
    pool_d = np.array([[1.0, 4.0, np.inf, np.inf]], np.float32)
    pool_exp = np.array([[True, False, False, False]])
    args = (q, table, ids, avail, b, e, ver, pool_ids, pool_d, pool_exp)
    ki, kd, ke = (a.numpy() for a in ops.gathered_topk(*_t(args)))
    pi, pd, pe = (np.asarray(a) for a in pallas_gathered_topk(
        *map(jnp.asarray, args), bq=1, interpret=True))
    assert ki.tolist() == [[0, 2, 1, 3]] == pi.tolist()
    assert ke.tolist() == [[True, False, False, False]]
    np.testing.assert_array_equal(kd, pd)


def test_cpu_runs_leave_launch_counters_at_zero():
    ops.reset_launches()
    args = _t(_mk_wavefront_step(3, 50, 8, 12, 6))
    ops.gathered_topk(*args)
    ops.gathered_l2(args[0], args[1][:3][None].expand(3, 3, 8).contiguous())
    pw = _t(_mk_pairwise(3, 5, 8))
    ops.pairwise_l2_masked(*pw, riv.ANY_OVERLAP)
    ops.pairwise_l2_masked(pw[0], pw[1].half(), *pw[2:], riv.ANY_OVERLAP)
    codes = torch.zeros((5, 8), dtype=torch.int8)
    ones, zeros = torch.ones(8), torch.zeros(8)
    ops.pairwise_l2_int8(pw[0], codes, ones, zeros, torch.zeros(5), *pw[2:],
                         riv.ANY_OVERLAP)
    ops.gathered_topk_quant(args[0], args[1].to(torch.int8), ones, zeros,
                            *args[2:])
    ops.gathered_l2_dot(args[0], args[1][:3][None].expand(3, 3, 8)
                        .contiguous())
    ops.fused_topk_l2(*pw, riv.ANY_OVERLAP, 2)
    ops.fused_topk_l2(pw[0], pw[1].half(), *pw[2:], riv.ANY_OVERLAP, 2)
    assert ops.LAUNCHES == {
        "gathered_topk": 0, "gathered_topk_quant_int8": 0,
        "gathered_topk_quant_f16": 0, "gathered_l2": 0,
        "gathered_l2_dot": 0, "pairwise_l2_masked": 0,
        "pairwise_l2_masked_f16": 0, "pairwise_l2_int8": 0,
        "fused_topk_l2": 0, "fused_topk_l2_f16": 0}


def test_wrappers_refuse_other_devices():
    q = torch.zeros((2, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.gathered_l2(q, torch.zeros((2, 3, 4), device="meta"))
