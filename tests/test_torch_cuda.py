"""The port's CUDA kernels and engine on a card, against their plain PyTorch
versions. Every test here is marked ``cuda`` and skips without a card. The
file imports neither ``jax`` nor ``repro``, so it runs on a machine that has
only PyTorch; from the root of a checkout:

    python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the edge inputs the card check also runs)
from repro_torch.core import (ANY_OVERLAP, QUERY_CONTAINED, EngineConfig,
                              MSTGIndex, QueryEngine, SearchRequest)
from repro_torch.core.quant import QuantizedStore
from repro_torch.data import make_queries, make_range_dataset
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _wavefront_step(Q, n, d, M, L, case="", seed=0):
    """One step's inputs. ``case``: "unsorted" shuffles each beam row;
    "all_live" makes every candidate pass the mask; "tie" takes small
    integer vectors, so distances are exact in any order and beam entries
    tie exactly with candidates of the same id; "view" passes ``table[1:]``
    and "misaligned" a table whose data does not start on 16 bytes (both
    are contiguous)."""
    rng = np.random.default_rng(seed)
    if case == "tie":
        table = rng.integers(-2, 3, (n, d)).astype(np.float32)
        q = rng.integers(-2, 3, (Q, d)).astype(np.float32)
    else:
        table = rng.normal(size=(n, d)).astype(np.float32)
        table[1::2] = table[0::2][: len(table[1::2])]      # exact ties
        q = rng.normal(size=(Q, d)).astype(np.float32)
    ids = rng.integers(-1, n + 3, (Q, M)).astype(np.int32)  # some past n
    avail = rng.random((Q, M)) < 0.7
    pool_d = np.sort(rng.random((Q, L)).astype(np.float32), axis=1)
    pool_ids = rng.integers(0, n, (Q, L)).astype(np.int32)
    b = rng.integers(0, 40, (Q, M)).astype(np.int32)
    e = b + rng.integers(0, 40, (Q, M)).astype(np.int32)
    ver = rng.integers(0, 70, Q).astype(np.int32)
    if case in ("all_live", "tie"):
        ids = rng.integers(0, n, (Q, M)).astype(np.int32)
        avail[:] = True
        b[:] = 0
        e[:] = 100
    if case == "tie":
        diff = table[pool_ids].astype(np.float64) - q[:, None, :]
        pool_d = (diff * diff).sum(-1).astype(np.float32)
    tail = rng.integers(0, L + 1, Q)
    for qi in range(Q):
        pool_d[qi, tail[qi]:] = np.inf
        pool_ids[qi, tail[qi]:] = -1
        if case in ("unsorted", "tie"):
            perm = rng.permutation(L)
            pool_d[qi], pool_ids[qi] = pool_d[qi, perm], pool_ids[qi, perm]
    if case == "view":
        table = np.concatenate([rng.normal(size=(1, d)).astype(np.float32),
                                table])
    return [torch.from_numpy(a) for a in (
        q, table, ids, avail, b, e, ver, pool_ids, pool_d,
        (rng.random((Q, L)) < 0.5) & np.isfinite(pool_d))]


def _step_table(table, case):
    """The table as the case hands it to the kernel (see _wavefront_step)."""
    if case == "view":
        return table[1:]
    if case == "misaligned":
        buf = torch.empty(table.numel() + 1, dtype=table.dtype,
                          device=table.device)
        buf[1:] = table.flatten()
        table = buf[1:].view(table.shape)
        assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    return table


# (Q, n, d, M, L[, case]): ragged shapes, the widest route step (M = 8 *
# 767), d = 1, 17 and 129 (no whole number of 16-byte loads), an unsorted
# beam, every candidate live, exact beam/candidate ties, table views
STEP_CASES = [(5, 50, 17, 12, 6), (64, 2000, 128, 767, 64),
              (8, 3000, 128, 6136, 64), (64, 2000, 128, 767, 64, "unsorted"),
              (8, 3000, 128, 6136, 64, "all_live"),
              (16, 40, 8, 200, 64, "tie"), (37, 500, 1, 300, 16),
              (37, 500, 129, 300, 64), (37, 500, 17, 300, 16, "view"),
              (37, 500, 128, 300, 16, "misaligned")]


def _assert_step_matches(got, want, exact: bool):
    """ids equal where dists differ by more than 1e-5 relative, expanded
    flags equal where ids are equal; everything equal where the case's
    distances are exact."""
    (gi, gd, ge), (wi, wd, we) = got, want
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
    tie = (gd - wd).abs() <= 1e-5 * (wd.abs() + 1)
    assert bool(((gi == wi) | tie).all())
    assert bool(((ge == we) | (gi != wi)).all())
    if exact:
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
        assert torch.equal(ge, we)


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


def _scan_inputs(Q, N, d, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 100, N).astype(np.float32)
    hi = lo + rng.uniform(0, 30, N).astype(np.float32)
    if N > 3:                                     # NaN-padded rows
        lo[-2:] = np.nan
        hi[-2:] = np.nan
    ql = rng.uniform(0, 100, Q).astype(np.float32)
    qh = ql + rng.uniform(0, 30, Q).astype(np.float32)
    store = QuantizedStore.from_vectors(
        rng.normal(0, 2, (N, d)).astype(np.float32), "int8")
    return (rng.normal(size=(Q, d)).astype(np.float32), store, lo, hi, ql,
            qh)


@pytest.mark.parametrize("mask", [ANY_OVERLAP, 16 | 32, 63])
@pytest.mark.parametrize("shape", [(1, 1, 1), (67, 1000, 17), (130, 4099, 128)])
def test_int8_and_f16_scans_match_plain(dev, mask, shape):
    """pairwise_l2_int8 (its output bit-equal to the plain version's) and
    pairwise_l2_masked over a float16 corpus, at ragged Q, N and d."""
    q, st, lo, hi, ql, qh = _scan_inputs(*shape, seed=mask + shape[2])
    qt, lo, hi, ql, qh = (torch.from_numpy(a).to(dev)
                          for a in (q, lo, hi, ql, qh))
    i8 = [torch.from_numpy(a).to(dev) for a in (st.codes, st.scale,
                                                st.offset, st.sq_norm)]
    got = ops.pairwise_l2_int8(qt, *i8, lo, hi, ql, qh, mask)
    want = ref.pairwise_l2_int8_ref(qt, *i8, lo, hi, ql, qh, mask)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert torch.equal(got[fin], want[fin])
    f16 = torch.from_numpy(st.dequantize()).to(dev).half()
    got = ops.pairwise_l2_masked(qt, f16, lo, hi, ql, qh, mask)
    want = ref.pairwise_l2_masked_ref(qt, f16, lo, hi, ql, qh, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["int8", "float16"])
@pytest.mark.parametrize("shape", STEP_CASES)
def test_gathered_topk_quant_kernel_matches_plain(dev, dtype, shape):
    case = shape[5] if len(shape) > 5 else ""
    args = [a.to(dev) for a in _wavefront_step(*shape, seed=7)]
    st = QuantizedStore.from_vectors(args[1].cpu().numpy(), dtype)
    if dtype == "int8":
        assert st.codes.min() == -127 and st.codes.max() == 127
    quant = [torch.from_numpy(a).to(dev) for a in (st.codes, st.scale,
                                                   st.offset)]
    quant[0] = _step_table(quant[0], case)
    args = [args[0], *quant, *args[2:]]
    ops.reset_launches()
    got = ops.gathered_topk_quant(*args)
    assert ops.LAUNCHES["gathered_topk_quant_" + (
        "int8" if dtype == "int8" else "f16")] == 1
    # float16 codes of small integers dequantize exactly
    _assert_step_matches(got, ref.gathered_topk_quant_ref(*args),
                         exact=case == "tie" and dtype == "float16")


def test_gathered_l2_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(33, 128)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(33, 45, 128)).astype(np.float32))
    got = ops.gathered_l2(q.to(dev), cv.to(dev))
    torch.testing.assert_close(got.cpu(), ref.gathered_l2_ref(q, cv),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", STEP_CASES)
def test_gathered_topk_kernel_matches_plain(dev, shape):
    case = shape[5] if len(shape) > 5 else ""
    args = [a.to(dev) for a in _wavefront_step(*shape)]
    args[1] = _step_table(args[1], case)
    ops.reset_launches()
    got = ops.gathered_topk(*args)
    assert ops.LAUNCHES["gathered_topk"] == 1
    _assert_step_matches(got, ref.gathered_topk_ref(*args),
                         exact=case == "tie")


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


@pytest.mark.parametrize("tier", ["int8", "float16"])
def test_quantized_engine_on_cuda_agrees_with_cpu(dev, tier):
    ds = make_range_dataset(n=600, d=16, n_queries=12, quantize=32, seed=0)
    idx = MSTGIndex(ds.vectors, ds.lo, ds.hi, variants=("T", "Tp"), m=8,
                    ef_con=40)
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.15, seed=3)
    cfg = EngineConfig(storage_dtype=tier)
    gpu = QueryEngine(idx, cfg, device=dev)
    cpu = QueryEngine(idx, cfg, device="cpu")
    scan = "pairwise_l2_int8" if tier == "int8" else "pairwise_l2_masked_f16"
    step = "gathered_topk_quant_" + ("int8" if tier == "int8" else "f16")
    for route, kernel in (("graph", step), ("pruned", None), ("flat", scan)):
        req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=10, ef=32,
                            route=route, fanout=2)
        ops.reset_launches()
        a, b = gpu.execute(req), cpu.execute(req)
        if kernel is not None:
            assert ops.LAUNCHES[kernel] > 0
        assert ops.LAUNCHES["gathered_topk"] == 0
        assert ops.LAUNCHES["pairwise_l2_masked"] == 0
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-5, atol=1e-5)
    assert gpu._corpus_dev is None


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 37, 17), (13, 9, 1),
                                   (256, 88, 128)])
def test_gathered_l2_dot_kernel_matches_plain(dev, shape):
    Q, S, d = shape
    rng = np.random.default_rng(Q + S + d)
    q = torch.from_numpy(rng.normal(size=(Q, d)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(Q, S, d)).astype(np.float32))
    ops.reset_launches()
    got = ops.gathered_l2_dot(q.to(dev), cv.to(dev)).cpu()
    assert ops.LAUNCHES["gathered_l2_dot"] == 1
    for want in (ref.gathered_l2_dot_ref(q, cv), ref.gathered_l2_ref(q, cv)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _fused_inputs(Q, N, d, seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 50, N).astype(np.float32)
    hi = lo + rng.integers(0, 20, N).astype(np.float32)
    if N > 3:                                     # NaN-padded rows
        lo[-2:] = hi[-2:] = np.nan
    ql = rng.integers(0, 50, Q).astype(np.float32)
    qh = ql + rng.integers(0, 20, Q).astype(np.float32)
    if Q > 1:                                     # an all-masked query
        ql[Q // 2] = qh[Q // 2] = np.nan
    return [torch.from_numpy(a) for a in (
        rng.normal(size=(Q, d)).astype(np.float32),
        rng.normal(size=(N, d)).astype(np.float32), lo, hi, ql, qh)]


def _assert_topk_close(got, want, rtol=1e-4):
    (gi, gd), (wi, wd) = [(i.cpu(), d.cpu()) for i, d in (got, want)]
    assert torch.equal(torch.isfinite(gd), torch.isfinite(wd))
    torch.testing.assert_close(gd, wd, rtol=rtol, atol=rtol)
    tie = (gd - wd).abs() <= rtol * (wd.abs() + 1)
    assert bool(((gi == wi) | (tie & torch.isfinite(wd))).all())
    assert bool((gi[~torch.isfinite(gd)] == ops.NO_EDGE).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("mask", [ANY_OVERLAP, QUERY_CONTAINED, 16 | 32, 63])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 5, 8, 10),
                                   (67, 1000, 17, 32), (130, 4099, 128, 7)])
def test_fused_topk_kernel_matches_plain(dev, shape, mask, dtype):
    """Ragged Q and N, d = 1 and 17, k = 1, 32 and k > N, NaN-padded rows
    and an all-masked query, float32 and float16 corpus."""
    Q, N, d, k = shape
    args = [a.to(dev) for a in _fused_inputs(Q, N, d, seed=sum(shape))]
    args[1] = args[1].to(dtype)
    name = "fused_topk_l2" + ("_f16" if dtype == torch.float16 else "")
    ops.reset_launches()
    got = ops.fused_topk_l2(*args, mask, k)
    assert ops.LAUNCHES[name] == 1
    _assert_topk_close(got, ref.fused_topk_l2_ref(*args, mask, k))


def test_fused_topk_duplicates_go_to_the_lowest_id(dev):
    rng = np.random.default_rng(3)
    N, d = 5000, 64
    c = rng.normal(size=(N, d)).astype(np.float32)
    c[[5, 600, 4100]] = c[3]
    q = np.stack([c[3], rng.normal(size=d).astype(np.float32)])
    rest = [np.zeros(N, np.float32), np.full(N, 100, np.float32),
            np.full(2, 10, np.float32), np.full(2, 20, np.float32)]
    args = [torch.from_numpy(a).to(dev) for a in (q, c, *rest)]
    ids, _ = ops.fused_topk_l2(*args, ANY_OVERLAP, 5)
    assert ids[0, :4].tolist() == [3, 5, 600, 4100]


def test_fused_topk_matches_the_flat_scan(dev):
    """Its distances are the masked scan's, bit for bit."""
    args = [a.to(dev) for a in _fused_inputs(256, 30000, 128, seed=5)]
    ids, dists = ops.fused_topk_l2(*args, ANY_OVERLAP, 10)
    full = ops.pairwise_l2_masked(*args, ANY_OVERLAP)
    want = torch.sort(full, dim=1, stable=True)
    assert torch.equal(dists, want.values[:, :10])
    fin = torch.isfinite(dists)
    assert torch.equal(ids[fin].long(), want.indices[:, :10][fin])


def _fused_edge_inputs(case, Q, N, d, seed):
    """chip_smoke.py's inputs of the filtered epilogue's edge cases, as
    tensors."""
    return [torch.from_numpy(a)
            for a in chip_smoke.fused_edge_inputs(case, Q, N, d, seed)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("case", ["falling", "ties", "sel0", "sel1", "nan"])
def test_fused_topk_filter_edges(dev, case, k, dtype):
    """The filtered epilogue at Q = 256 (four query blocks, a split per
    few tiles) and N = 20077 (no multiple of the 128-row tile)."""
    Q, N, d = 256, 20077, 64
    args = [a.to(dev) for a in _fused_edge_inputs(case, Q, N, d, seed=k)]
    args[1] = args[1].to(dtype)
    got = ops.fused_topk_l2(*args, ANY_OVERLAP, k)
    want = ref.fused_topk_l2_ref(*args, ANY_OVERLAP, k)
    _assert_topk_close(got, want)
    ids = got[0].cpu()
    if case in ("falling", "ties", "sel0"):      # exact distances
        assert torch.equal(ids, want[0].cpu())
        assert torch.equal(got[1].cpu(), want[1].cpu())
    if case == "falling":
        assert ids.tolist() == [list(range(N - 1, N - 1 - k, -1))] * Q
    if case == "sel0":
        assert bool((ids == ops.NO_EDGE).all())


def test_new_wrappers_refuse_bad_input(dev):
    args = [a.to(dev) for a in _fused_inputs(4, 50, 8, seed=0)]
    ops.reset_launches()
    with pytest.raises(ValueError, match=str(ops.FUSED_TOPK_MAX_K)):
        ops.fused_topk_l2(*args, ANY_OVERLAP, ops.FUSED_TOPK_MAX_K + 1)
    with pytest.raises(TypeError):
        ops.fused_topk_l2(args[0], args[1].double(), *args[2:], ANY_OVERLAP,
                          5)
    with pytest.raises(TypeError):
        ops.gathered_l2_dot(args[0],
                            torch.zeros((4, 3, 8), device=dev).double())
    assert sum(ops.LAUNCHES.values()) == 0


def test_traced_kernel_spans_on_the_card(dev):
    from repro_torch import obs
    args = [a.to(dev) for a in _fused_inputs(64, 20000, 128, seed=2)]
    cand = args[1][:64 * 40].reshape(64, 40, 128).contiguous()
    plain = (ops.fused_topk_l2(*args, ANY_OVERLAP, 10),
             ops.gathered_l2_dot(args[0], cand))
    with obs.capture() as tracer:
        traced = (ops.fused_topk_l2(*args, ANY_OVERLAP, 10),
                  ops.gathered_l2_dot(args[0], cand))
    roots = tracer.trace().roots
    assert [sp.name for sp in roots] == ["kernel:fused_topk_l2",
                                         "kernel:gathered_l2_dot"]
    for sp in roots:
        assert sp.args["impl"] == "cuda"
        if obs.device_peaks(dev) is not None:
            assert 0.0 < sp.args["frac_of_peak"] <= 1.05
    assert all(torch.equal(a, b) for a, b in zip(traced[0], plain[0]))
    assert torch.equal(traced[1], plain[1])


# (Q, N, d, case) for the scans on both copy paths: d = 1, 17 and 129 take
# the element path; N past a multiple of the 128-row tile, Q past a
# multiple of the 64-row block; "misaligned" hands every operand over one
# element past a 16-byte boundary
SCAN_EDGES = [(1, 1, 1, ""), (67, 1000, 17, ""), (256, 3001, 64, ""),
              (130, 4099, 128, ""), (300, 2055, 129, ""), (1, 777, 256, ""),
              (67, 1000, 128, "misaligned"), (300, 333, 17, "misaligned")]


@pytest.mark.parametrize("shape", SCAN_EDGES)
def test_tensor_core_scans_match_plain_at_edge_shapes(dev, shape):
    """Kernel 5 (float32 and float16 corpus) within 1e-4 of its plain
    version, kernel 6 bit-equal, kernel 7 on the same inputs."""
    Q, N, d, case = shape
    q, st, lo, hi, ql, qh = _scan_inputs(Q, N, d, seed=Q + N + d)
    qt, c, lo, hi, ql, qh = (torch.from_numpy(a).to(dev) for a in (
        q, st.dequantize(), lo, hi, ql, qh))
    i8 = [torch.from_numpy(a).to(dev) for a in (st.codes, st.scale,
                                                st.offset, st.sq_norm)]
    c16 = c.half()
    qt, c, c16, i8[0] = (_step_table(x, case) for x in (qt, c, c16, i8[0]))
    for mask in (ANY_OVERLAP, 16 | 32):
        for corpus in (c, c16):
            got = ops.pairwise_l2_masked(qt, corpus, lo, hi, ql, qh, mask)
            want = ref.pairwise_l2_masked_ref(qt, corpus, lo, hi, ql, qh,
                                              mask)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            k = min(10, N)
            _assert_topk_close(
                ops.fused_topk_l2(qt, corpus, lo, hi, ql, qh, mask, k),
                ref.fused_topk_l2_ref(qt, corpus, lo, hi, ql, qh, mask, k))
        got = ops.pairwise_l2_int8(qt, *i8, lo, hi, ql, qh, mask)
        want = ref.pairwise_l2_int8_ref(qt, *i8, lo, hi, ql, qh, mask)
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        fin = torch.isfinite(want)
        assert torch.equal(got[fin], want[fin])


@pytest.mark.parametrize("d", [17, 64, 128])
def test_scans_hold_rtol_at_distance_zero(dev, d):
    """Every query is a corpus row (|q|^2 ~ d), so its distance to that row
    is exactly 0: where a truncating tensor-core accumulation carried
    across d would show (it drifted 2e-4 at d = 128). Kernels 5 and 7,
    float32 and float16 corpus: those distances within RTOL of the exact 0
    (the plain version's own float32 rounding is of the same size, so the
    two are not held to each other there), every other one within RTOL of
    the plain version."""
    rng = np.random.default_rng(d)
    N = 3000
    rows = torch.arange(5, N, 97)
    Q = len(rows)
    lo, hi = torch.zeros(N), torch.full((N,), 100.0)
    ql, qh = torch.full((Q,), 10.0), torch.full((Q,), 20.0)
    c = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
    own = torch.zeros((Q, N), dtype=torch.bool)
    own[torch.arange(Q), rows] = True
    for corpus in (c, c.half()):
        q = corpus[rows].float()
        args = [a.to(dev) for a in (q, corpus, lo, hi, ql, qh)]
        got = ops.pairwise_l2_masked(*args, ANY_OVERLAP).cpu()
        want = ref.pairwise_l2_masked_ref(*args, ANY_OVERLAP).cpu()
        assert float(got[own].abs().max()) <= 1e-4
        torch.testing.assert_close(got[~own], want[~own], rtol=1e-4,
                                   atol=1e-4)
        ids, dists = (a.cpu() for a in ops.fused_topk_l2(*args, ANY_OVERLAP,
                                                         3))
        assert torch.equal(ids[:, 0].long(), rows)
        assert torch.equal(dists[:, 0], got[own])      # the scan's, bit-equal
        w_ids, w_d = ref.fused_topk_l2_ref(*args, ANY_OVERLAP, 3)
        _assert_topk_close((ids[:, 1:], dists[:, 1:]),
                           (w_ids[:, 1:], w_d[:, 1:]))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1, ""), (5, 37, 17, ""),
                                   (67, 30, 64, ""), (256, 44, 128, ""),
                                   (300, 12, 129, ""), (1, 20, 256, ""),
                                   (67, 30, 128, "misaligned")])
def test_gathered_kernels_take_half_candidates(dev, dtype, shape):
    """Kernels 3 and 4 over float16 and bfloat16 candidates (and a query
    of the same type) against their plain versions."""
    Q, S, d, case = shape
    rng = np.random.default_rng(Q + S + d)
    q = torch.from_numpy(rng.normal(size=(Q, d)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(Q, S, d)).astype(np.float32))
    q, cv = q.to(dev).to(dtype), _step_table(cv.to(dev).to(dtype), case)
    ops.reset_launches()
    for name in ("gathered_l2", "gathered_l2_dot"):
        got = getattr(ops, name)(q, cv)
        want = getattr(ref, name + "_ref")(q, cv)
        rtol = 1e-5 if name == "gathered_l2" else 1e-4
        torch.testing.assert_close(got, want, rtol=rtol, atol=rtol)
        assert ops.LAUNCHES[name] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", chip_smoke.GATHERED_EDGES,
                         ids=lambda s: "-".join(map(str, s)).rstrip("-"))
def test_gathered_kernels_at_the_card_checks_edges(dev, dtype, shape):
    """chip_smoke.py's GATHERED_EDGES through kernels 3 and 4: both load
    paths, S no multiple of the unroll, a misaligned query or candidate
    view, Q past a grid dimension's 65,535, non-finite candidates (non-
    finite exactly where the plain version is)."""
    Q, S, d, case = shape
    q_np, cv_np = chip_smoke.gathered_edge_inputs(
        np.random.default_rng(Q + S + d), Q, S, d, case)
    q, cv = chip_smoke.gathered_edge_tensors(q_np, cv_np, dtype, case, dev)
    ops.reset_launches()
    for name in ("gathered_l2", "gathered_l2_dot"):
        got = getattr(ops, name)(q, cv)
        want = getattr(ref, name + "_ref")(q, cv)
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        fin = torch.isfinite(want)
        rtol = 1e-5 if name == "gathered_l2" else 1e-4
        torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=rtol)
        assert ops.LAUNCHES[name] == 1


def test_delta_scan_with_dead_rows_on_cuda_agrees_with_cpu(dev):
    """The streaming delta's scan (one ``pairwise_l2_masked`` launch) over
    an arena with NaN-dead rows (upserts and kills) and NaN unused rows,
    k past the live rows and past the capacity, against the same scan's
    plain version on the CPU."""
    from repro_torch.streaming import DeltaBuffer
    ds = make_range_dataset(n=300, d=24, n_queries=9, quantize=32, seed=2)
    delta = DeltaBuffer()
    delta.add(np.arange(200), ds.vectors[:200], ds.lo[:200], ds.hi[:200])
    delta.add(np.arange(10), ds.vectors[200:210], ds.lo[200:210],
              ds.hi[200:210])
    dead = list(range(50, 90, 3))
    for e in dead:
        assert delta.kill(e)
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.3, seed=1)
    for k in (10, 250, 300):
        ops.reset_launches()
        a = delta.search(ds.queries, qlo, qhi, ANY_OVERLAP, k, device=dev)
        assert ops.LAUNCHES["pairwise_l2_masked"] == 1
        assert sum(ops.LAUNCHES.values()) == 1
        b = delta.search(ds.queries, qlo, qhi, ANY_OVERLAP, k, device="cpu")
        assert a[0].shape == b[0].shape == (9, min(k, 256))
        assert not np.isin(a[0], dead).any()
        np.testing.assert_array_equal(np.isfinite(a[1]), np.isfinite(b[1]))
        np.testing.assert_array_equal(a[0][~np.isfinite(a[1])], -1)
        fin = np.isfinite(b[1])
        np.testing.assert_allclose(a[1][fin], b[1][fin], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("merge", ["all_gather", "tournament"])
def test_merge_with_ties_on_cuda_equals_cpu(dev, merge):
    """Both schedules on the card, integer distances (ties everywhere) and
    a dead shard, against the same code on the CPU: the stable sort keeps
    the lowest position among ties on both."""
    from repro_torch.distributed import sharded_topk_merge
    from repro_torch.launch import make_mesh
    rng = np.random.default_rng(5)
    D, Q, w, k = 8, 33, 4, 11
    dists = np.sort(rng.integers(0, 5, (D, Q, w)).astype(np.float32), axis=2)
    ids = rng.integers(0, 10_000, (D, Q, w)).astype(np.int64)
    alive = np.arange(D) != 5
    got = sharded_topk_merge(make_mesh((D,), ("data",), device=dev), ids,
                             dists, k, merge=merge, alive=alive)
    want = sharded_topk_merge(make_mesh((D,), ("data",), device="cpu"), ids,
                              dists, k, merge=merge, alive=alive)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert np.isin(got[0][got[0] >= 0], ids[alive]).all()


def test_sharded_flat_on_cuda_launches_once_per_live_shard(dev):
    from repro_torch.distributed import DeploymentSpec, ShardedDeployment
    from repro_torch.launch import make_mesh
    ds = make_range_dataset(n=800, d=32, n_queries=16, quantize=64, seed=4)
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=2)
    req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=10)
    spec = DeploymentSpec(n_shards=4, merge="tournament")
    gpu = ShardedDeployment.flat(ds.vectors, ds.lo, ds.hi, spec=spec,
                                 mesh=make_mesh((4,), ("data",), device=dev))
    cpu = ShardedDeployment.flat(ds.vectors, ds.lo, ds.hi, spec=spec,
                                 mesh=make_mesh((4,), ("data",),
                                                device="cpu"))
    for failed in (None, 2):
        if failed is not None:
            gpu.fail(failed)
            cpu.fail(failed)
        ops.reset_launches()
        a = gpu.execute(req)
        assert ops.LAUNCHES["pairwise_l2_masked"] == (4 if failed is None
                                                      else 3)
        b = cpu.execute(req)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-4)


def test_async_graph_server_on_cuda_equals_solo_execute(dev):
    """The continuous path on the card: queries admitted in waves into a
    running wavefront give solo ``execute``'s ids and dists bit for bit,
    with a refill and the step kernels launched."""
    from repro_torch.serving import AsyncRetrievalServer, SLOPolicy
    ds = make_range_dataset(n=600, d=16, n_queries=12, quantize=32, seed=0)
    idx = MSTGIndex(ds.vectors, ds.lo, ds.hi, variants=("T", "Tp"), m=8,
                    ef_con=40)
    eng = QueryEngine(idx, device=dev)
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.15, seed=3)
    want = [eng.execute(SearchRequest(ds.queries[i:i + 1],
                                      (qlo[i:i + 1], qhi[i:i + 1]),
                                      ANY_OVERLAP, k=8, ef=32,
                                      route="graph"))
            for i in range(len(qlo))]
    srv = AsyncRetrievalServer(
        eng, lambda items: ds.queries[np.asarray(items)], k=8, ef=32,
        route="graph", max_inflight=16, chunk=2,
        policy=SLOPolicy(max_wait_ms=0.0, max_batch=4))
    ops.reset_launches()
    tickets = {}
    for wave in (range(0, 5), range(5, 9), range(9, 12)):
        for i in wave:
            tickets[srv.submit(i, qlo[i], qhi[i], ANY_OVERLAP)] = i
        srv.step()
    got = srv.run_until_idle()
    assert ops.LAUNCHES["gathered_topk"] > 0 and ops.LAUNCHES["gathered_l2"] > 0
    assert srv.snapshot()["refills"] > 0
    for t, i in tickets.items():
        np.testing.assert_array_equal(got[t].hit.ids, want[i].ids[0])
        np.testing.assert_array_equal(got[t].hit.dists, want[i].dists[0])


def test_irangegraph_on_cuda_agrees_with_its_cpu_run(dev):
    """``IRangeGraphLike`` built once on the host, searched on the card
    (kernels 1 and 3 launched) and on the CPU."""
    from repro_torch.core import intervals as iv
    from repro_torch.core.baselines import IRangeGraphLike
    ds = make_range_dataset(n=800, d=16, n_queries=16, quantize=32, seed=9)
    attr = (ds.lo + ds.hi) / 2
    qlo = np.full(16, np.quantile(attr, 0.2))
    qhi = np.full(16, np.quantile(attr, 0.6))
    gpu = IRangeGraphLike(ds.vectors, attr, m=8, ef_con=40, device=dev)
    cpu = gpu.to("cpu")
    ops.reset_launches()
    gi, gd = gpu.search(ds.queries, qlo, qhi, k=10, ef=64)
    assert ops.LAUNCHES["gathered_topk"] > 0 and ops.LAUNCHES["gathered_l2"] > 0
    ci, cd = cpu.search(ds.queries, qlo, qhi, iv.RFANN_MASK, k=10, ef=64)
    agree = chip_smoke.agreement(gi, gd, ci, cd, 1e-5)
    assert agree >= 0.99, agree
    np.testing.assert_allclose(gd, cd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-1b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-2b", "rwkv6-7b",
                                  "deepseek-v3-671b"])
def test_serve_engine_on_cuda_equals_cpu(dev, arch):
    """One CPU init of a smoke config, generated on the CPU and, with the
    parameters copied over, on the card: equal tokens."""
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.serving import ServeEngine
    lm = LM(configs.get_smoke_config(arch))
    lm.init(torch.Generator().manual_seed(3), device="cpu")
    # RWKV's chunk scan takes a multiple of its 16-token chunk
    P = 32 if arch == "rwkv6-7b" else 20
    toks = np.random.default_rng(3).integers(0, lm.cfg.vocab, (2, P))
    want = ServeEngine(lm, device="cpu").generate({"tokens": toks}, n_new=6,
                                                  max_len=40)
    got = ServeEngine(lm, device=dev).generate({"tokens": toks}, n_new=6,
                                               max_len=40)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    scale = max(1.0, float(np.abs(want.logits_last).max()))
    np.testing.assert_allclose(got.logits_last, want.logits_last, rtol=1e-4,
                               atol=1e-5 * scale)


def test_moe_router_on_cuda_is_deterministic_and_equals_cpu(dev):
    """qwen3-moe's MoE block on the card, twice on one input at a capacity
    that drops assignments: the same experts, kept set and output bit for
    bit; the experts and kept set equal the CPU's, the output within
    1e-4."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.params import init_tree
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    p = init_tree(moe.moe_meta(cfg, torch.float32),
                  torch.Generator().manual_seed(4), "cpu")
    p["router"] = p["router"] * 50
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 32, cfg.d_model)).astype(np.float32))
    pd = {k: v.to(dev) for k, v in p.items()}
    y1, _ = moe.moe_apply(pd, x.to(dev), cfg=cfg, capacity_factor=1.0)
    y2, _ = moe.moe_apply(pd, x.to(dev), cfg=cfg, capacity_factor=1.0)
    yc, _ = moe.moe_apply(p, x, cfg=cfg, capacity_factor=1.0)
    st = [moe.routing(q, xx, cfg=cfg, capacity_factor=1.0)
          for q, xx in ((pd, x.to(dev)), (pd, x.to(dev)), (p, x))]
    assert torch.equal(y1, y2)
    for key in ("experts", "kept"):
        assert torch.equal(st[0][key], st[1][key])
        assert torch.equal(st[0][key].cpu(), st[2][key])
    assert int(st[0]["dropped"]) > 0
    np.testing.assert_allclose(y1.cpu().numpy(), yc.numpy(), rtol=1e-4,
                               atol=1e-5 * max(1.0, float(yc.abs().max())))


def test_serve_driver_on_cuda(dev):
    from repro_torch.launch import serve
    out = serve.main(["--requests", "8", "--n", "600"])
    assert out["device"] == "cuda" and out["served"] == 8
    assert out["non_empty"] == 8
