"""The port's gathered_l2_dot and fused_topk_l2 against the JAX reference.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run their plain
PyTorch versions; these tests hold them to the reference's Pallas kernels
(interpret mode) and to ``repro.kernels.ref`` on the same inputs, made
with numpy from a seed: distances within 1e-4 relative to (|d| + 1), the
tolerance of the reference's pairwise tests; ids equal wherever the
distances are distinct. The CUDA kernels are held to the plain versions in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import intervals as riv
from repro.kernels import ref as jref
from repro.kernels.fused_topk import fused_topk_l2 as pallas_fused_topk
from repro.kernels.gathered_l2 import gathered_l2 as pallas_l2
from repro.kernels.gathered_l2 import gathered_l2_dot as pallas_l2_dot

from repro_torch.kernels import ops, ref

MASKS = [
    riv.ANY_OVERLAP,
    riv.QUERY_CONTAINED,
    riv.QUERY_CONTAINING,
    riv.LEFT_OVERLAP,
    riv.RIGHT_OVERLAP,
    riv.LEFT_OVERLAP | riv.RIGHT_OVERLAP,
    riv.QUERY_CONTAINED | riv.QUERY_CONTAINING,
    riv.LEFT_OVERLAP | riv.QUERY_CONTAINED | riv.RIGHT_OVERLAP,
]
RTOL = 1e-4


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _mk(Q, N, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    c = rng.normal(0, 1, (N, d)).astype(np.float32)
    lo = rng.uniform(0, 100, N).astype(np.float32)
    hi = lo + rng.uniform(0, 30, N).astype(np.float32)
    ql = rng.uniform(0, 100, Q).astype(np.float32)
    qh = ql + rng.uniform(0, 30, Q).astype(np.float32)
    return q, c, lo, hi, ql, qh


def _pallas(args, mask, k, bn=256):
    ids, d = pallas_fused_topk(*map(jnp.asarray, args), mask, k=k, bn=bn,
                               interpret=True)
    return np.asarray(ids), np.asarray(d)


def _assert_topk(got, want):
    """Same +inf pattern (NO_EDGE there), dists within RTOL, ids equal
    wherever the distances are distinct."""
    (gi, gd), (wi, wd) = got, want
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    assert (gi[~np.isfinite(gd)] == ops.NO_EDGE).all()
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=RTOL)
    fin = np.isfinite(wd)
    with np.errstate(invalid="ignore"):
        tie = np.abs(gd - wd) <= RTOL * (np.abs(wd) + 1)
    assert ((gi == wi) | (tie & fin) | ~fin).all()


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 37, 17), (12, 40, 64),
                                   (13, 9, 16)])
def test_gathered_l2_dot_plain_matches_pallas_and_ref(shape):
    """Q = 13 is not a multiple of the Pallas block (bq = 8)."""
    Q, S, d = shape
    rng = np.random.default_rng(Q * S + d)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    cv = rng.normal(0, 1, (Q, S, d)).astype(np.float32)
    got = ops.gathered_l2_dot(*_t((q, cv))).numpy()
    pallas = np.asarray(pallas_l2_dot(q, cv, bq=8, interpret=True))
    want = np.asarray(jref.gathered_l2_ref(jnp.asarray(q), jnp.asarray(cv)))
    for other in (pallas, want):
        np.testing.assert_allclose(got, other, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("name", ["gathered_l2", "gathered_l2_dot"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 37, 17), (13, 9, 64)])
def test_gathered_l2_half_inputs_match_pallas(shape, name, dtype):
    """Kernels 3 and 4 with float16 or bfloat16 queries and candidates (the
    card widens both to float32, as the reference's kernels upcast): the
    port's plain version against the Pallas kernels in interpret mode on
    the same half-precision values, 1e-5 (diff form) and RTOL (contraction
    form) as for float32 inputs."""
    Q, S, d = shape
    rng = np.random.default_rng(Q * S + d)
    tdt = getattr(torch, dtype)
    q = torch.from_numpy(rng.normal(0, 1, (Q, d)).astype(np.float32)).to(tdt)
    cv = torch.from_numpy(rng.normal(0, 1, (Q, S, d)).astype(np.float32)
                          ).to(tdt)
    got = getattr(ops, name)(q, cv).numpy()
    jq, jcv = (jnp.asarray(t.float().numpy(), dtype=getattr(jnp, dtype))
               for t in (q, cv))
    pallas = pallas_l2 if name == "gathered_l2" else pallas_l2_dot
    want = np.asarray(pallas(jq, jcv, bq=8, interpret=True))
    tol = 1e-5 if name == "gathered_l2" else RTOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mask", MASKS, ids=riv.mask_name)
@pytest.mark.parametrize("shape", [(4, 300, 16, 5), (8, 1030, 32, 10)])
def test_fused_topk_plain_matches_pallas(mask, shape):
    Q, N, d, k = shape
    args = _mk(Q, N, d, seed=N + d)
    got = [a.numpy() for a in ops.fused_topk_l2(*_t(args), mask, k)]
    _assert_topk(got, _pallas(args, mask, k))


def test_fused_topk_plain_block_size_changes_nothing():
    """The running top-k gives the same ids at any block size."""
    args = _t(_mk(8, 1030, 32, seed=3))
    want = ref.fused_topk_l2_ref(*args, riv.ANY_OVERLAP, 10)
    for block in (1, 64, 1000, 4096):
        got = ref.fused_topk_l2_ref(*args, riv.ANY_OVERLAP, 10, block=block)
        assert torch.equal(got[0], want[0])
        # the product of a slice rounds as the whole product may not
        torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=RTOL)


def test_fused_topk_k_beyond_n_pads_with_no_edge():
    args = _mk(3, 7, 4, seed=11)
    args[2][:] = 0.0
    args[3][:] = 200.0                       # every row qualifies
    got = [a.numpy() for a in ops.fused_topk_l2(*_t(args), riv.ANY_OVERLAP,
                                                10)]
    want = _pallas(args, riv.ANY_OVERLAP, 10, bn=128)
    _assert_topk(got, want)
    assert (got[0][:, 7:] == ops.NO_EDGE).all()
    assert np.isinf(got[1][:, 7:]).all()
    assert np.isfinite(got[1][:, :7]).all()


def test_fused_topk_all_masked_query():
    args = _mk(4, 300, 16, seed=5)
    args[4][2] = args[5][2] = np.nan         # query 2 matches no row
    got = [a.numpy() for a in ops.fused_topk_l2(*_t(args), riv.ANY_OVERLAP,
                                                5)]
    _assert_topk(got, _pallas(args, riv.ANY_OVERLAP, 5))
    assert (got[0][2] == ops.NO_EDGE).all() and np.isinf(got[1][2]).all()
    assert np.isfinite(got[1][0]).any()


def test_fused_topk_duplicate_rows_across_blocks_go_to_the_lowest_id():
    """Rows 3 and 5 share a Pallas block; 600 lies two blocks later."""
    q, c, lo, hi, ql, qh = _mk(2, 1030, 32, seed=9)
    c[[5, 600]] = c[3]
    q[0] = c[3]
    lo[:] = 0.0
    hi[:] = 200.0
    args = (q, c, lo, hi, ql, qh)
    ids, dists = (a.numpy() for a in ops.fused_topk_l2(*_t(args),
                                                       riv.ANY_OVERLAP, 6))
    p_ids, p_d = _pallas(args, riv.ANY_OVERLAP, 6)
    assert ids[0, :3].tolist() == [3, 5, 600] == p_ids[0, :3].tolist()
    assert dists[0, 0] == dists[0, 1] == dists[0, 2]
    _assert_topk((ids, dists), (p_ids, p_d))


def test_fused_topk_plain_matches_the_sorted_masked_scan():
    """Dists equal to the masked scan's, ids to its stable order."""
    args = _t(_mk(6, 500, 8, seed=2))
    for mask in (riv.ANY_OVERLAP, riv.BEFORE | riv.AFTER):
        ids, dists = ops.fused_topk_l2(*args, mask, 12)
        full = ops.pairwise_l2_masked(*args, mask)
        want = torch.sort(full, dim=1, stable=True)
        torch.testing.assert_close(dists, want.values[:, :12], rtol=RTOL,
                                   atol=RTOL)
        fin = torch.isfinite(dists)
        assert torch.equal(ids[fin].long(), want.indices[:, :12][fin])
