"""The port's CUDA kernels and engine on a card, against their plain PyTorch
versions. Every test here is marked ``cuda`` and skips without a card. The
file imports neither ``jax`` nor ``repro``, so it runs on a machine that has
only PyTorch; from the root of a checkout:

    python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (ANY_OVERLAP, QUERY_CONTAINED, MSTGIndex,
                              QueryEngine, SearchRequest)
from repro_torch.data import make_queries, make_range_dataset
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _wavefront_step(Q, n, d, M, L, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    table[1::2] = table[0::2][: len(table[1::2])]          # exact ties
    ids = rng.integers(-1, n + 3, (Q, M)).astype(np.int32)  # some past n
    pool_d = np.sort(rng.random((Q, L)).astype(np.float32), axis=1)
    pool_ids = rng.integers(0, n, (Q, L)).astype(np.int32)
    tail = rng.integers(0, L + 1, Q)
    for qi in range(Q):
        pool_d[qi, tail[qi]:] = np.inf
        pool_ids[qi, tail[qi]:] = -1
    b = rng.integers(0, 40, (Q, M)).astype(np.int32)
    return [torch.from_numpy(a) for a in (
        rng.normal(size=(Q, d)).astype(np.float32), table, ids,
        rng.random((Q, M)) < 0.7, b,
        b + rng.integers(0, 40, (Q, M)).astype(np.int32),
        rng.integers(0, 70, Q).astype(np.int32), pool_ids, pool_d,
        (rng.random((Q, L)) < 0.5) & np.isfinite(pool_d))]


@pytest.mark.parametrize("mask", [ANY_OVERLAP, QUERY_CONTAINED, 16 | 32, 63])
def test_pairwise_kernel_matches_plain(dev, mask):
    rng = np.random.default_rng(mask)
    Q, N, d = 67, 1000, 17
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.normal(size=(Q, d)).astype(np.float32),
        rng.normal(size=(N, d)).astype(np.float32),
        rng.uniform(0, 100, N).astype(np.float32),
        rng.uniform(100, 130, N).astype(np.float32),
        rng.uniform(0, 100, Q).astype(np.float32),
        rng.uniform(100, 130, Q).astype(np.float32))]
    got = ops.pairwise_l2_masked(*args, mask)
    want = ref.pairwise_l2_masked_ref(*args, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_gathered_l2_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(33, 128)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(33, 45, 128)).astype(np.float32))
    got = ops.gathered_l2(q.to(dev), cv.to(dev))
    torch.testing.assert_close(got.cpu(), ref.gathered_l2_ref(q, cv),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(5, 50, 17, 12, 6),
                                   (64, 2000, 128, 767, 64),
                                   (8, 3000, 128, 6136, 64)])
def test_gathered_topk_kernel_matches_plain(dev, shape):
    args = [a.to(dev) for a in _wavefront_step(*shape)]
    gi, gd, ge = ops.gathered_topk(*args)
    wi, wd, we = ref.gathered_topk_ref(*args)
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
    tie = (gd - wd).abs() <= 1e-5 * (wd.abs() + 1)
    assert bool(((gi == wi) | tie).all())
    assert bool(((ge == we) | (gi != wi)).all())


def test_wrappers_count_launches_and_refuse_bad_input(dev):
    ops.reset_launches()
    q = torch.zeros((4, 8), device=dev)
    ops.gathered_l2(q, torch.zeros((4, 3, 8), device=dev))
    assert ops.LAUNCHES["gathered_l2"] == 1
    with pytest.raises(TypeError):
        ops.gathered_l2(q.double(), torch.zeros((4, 3, 8), device=dev))
    with pytest.raises(ValueError):
        ops.gathered_l2(q, torch.zeros((4, 3, 8), device=dev).transpose(0, 1))
    assert ops.LAUNCHES["gathered_l2"] == 1


def test_engine_on_cuda_agrees_with_cpu(dev):
    ds = make_range_dataset(n=600, d=16, n_queries=12, quantize=32, seed=0)
    idx = MSTGIndex(ds.vectors, ds.lo, ds.hi, variants=("T", "Tp"), m=8,
                    ef_con=40)
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.15, seed=3)
    gpu, cpu = QueryEngine(idx, device=dev), QueryEngine(idx, device="cpu")
    for route in ("graph", "pruned", "flat"):
        req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=10, ef=32,
                            route=route, fanout=2)
        ops.reset_launches()
        a, b = gpu.execute(req), cpu.execute(req)
        if route != "pruned":     # the pruned scan is plain torch code
            assert sum(ops.LAUNCHES.values()) > 0
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-4)
