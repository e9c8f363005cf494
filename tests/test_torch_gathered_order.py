"""Why gathered_l2.cu may sum in its own order.

The card's ``gathered_l2`` and ``gathered_l2_dot`` do not sum a row the way
the plain version does. G lanes share a candidate row (G, a power of two,
the largest that is at most the row's 16-byte unit count and 32; G = 32 on
the element path taken when a row is no whole number of 16-byte units or
the query or the candidates do not start on 16 bytes). Lane column c takes units c,
c + G, c + 2G, ... of the row and sums their elements into one float32
partial with ``fmaf``; each lane holds 4 rows at once. A transpose-reduce
across the G lanes then halves the rows a lane carries each round, and
butterflies finish; kernel 4 sums q.c and |c|^2 that way, |q|^2 once per
lane group, and rounds ``(qq - 2 qc) + cc``.

These tests emulate that order in float32 torch on the CPU (``fmaf`` as a
float64 product and sum rounded once to float32, which can differ from a
single rounding only on rare double-rounding ties) and hold it to the plain
version and to the Pallas kernels in interpret mode, on numpy inputs from a
seed, at the card check's tolerances: 1e-5 (kernel 3) and 1e-4 (kernel 4).
A warp-level emulation of the shuffle rounds checks that every row of a
warp's set is stored once, by the lane the kernel picks, with the sum the
order emulation takes. The kernel itself is held to the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.gathered_l2 import gathered_l2 as pallas_l2
from repro.kernels.gathered_l2 import gathered_l2_dot as pallas_l2_dot

from repro_torch.kernels import ref

UNROLL = 4                         # gathered_l2.cu's kUnroll
RTOL = {"gathered_l2": 1e-5, "gathered_l2_dot": 1e-4}
DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}


def layout(d: int, itemsize: int, aligned: bool = True):
    """(elements per unit, lanes per row) as gathered_l2.cu's launcher
    picks them."""
    if (d * itemsize) % 16 or not aligned:
        return 1, 32
    epv = 16 // itemsize
    units = d // epv
    g = 32
    while g > 1 and g > units:
        g //= 2
    return epv, g


def fma(a, b, c):
    """fmaf in float32: the exact product, one sum in float64, rounded."""
    return (a.double() * b.double() + c.double()).float()


def lane_order(d: int, epv: int, g: int):
    """(G, T) element indices each lane column sums, in its order (unit c,
    then c + G, ...; each unit's elements in turn); -1 pads short columns."""
    units = d // epv
    cols = []
    for col in range(g):
        cols.append([u * epv + e for u in range(col, units, g)
                     for e in range(epv)])
    width = max(1, max(len(c) for c in cols))
    return torch.tensor([c + [-1] * (width - len(c)) for c in cols])


def fold(p):
    """The shuffle rounds' sum over the last dim: halves, then quarters."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def emulated(name: str, queries, cand, aligned: bool = True):
    """gathered_l2.cu's order of work on (Q, d) float32 queries and (Q, S,
    d) candidates of any of the three types. Returns (Q, S) float32."""
    Q, S, d = cand.shape
    epv, g = layout(d, cand.element_size(), aligned)
    order = lane_order(d, epv, g)
    q = queries.to(torch.float32)
    c = cand.to(torch.float32)                    # the widening is exact
    acc = torch.zeros((Q, S, g))
    cc = torch.zeros((Q, S, g))
    qq = torch.zeros((Q, g))
    for t in range(order.shape[1]):
        idx = order[:, t]
        live = idx >= 0
        k = idx.clamp(min=0)
        qv = q[:, k]                              # (Q, G)
        cv = c[:, :, k]                           # (Q, S, G)
        if name == "gathered_l2_dot":
            acc = torch.where(live, fma(qv[:, None, :], cv, acc), acc)
            cc = torch.where(live, fma(cv, cv, cc), cc)
            qq = torch.where(live, fma(qv, qv, qq), qq)
        else:
            diff = cv - qv[:, None, :]
            acc = torch.where(live, fma(diff, diff, acc), acc)
    if name == "gathered_l2_dot":
        return (fold(qq)[:, None] - 2.0 * fold(acc)) + fold(cc)
    return fold(acc)


def inputs(Q, S, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    cv = rng.normal(0, 1, (Q, S, d)).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(cv).to(DTYPES[dtype])


def pallas(name, q, cv):
    """The Pallas kernel in interpret mode on the same values (a float32
    query, candidates in their own type)."""
    jcv = jnp.asarray(cv.float().numpy(), dtype=getattr(jnp, str(
        cv.dtype).split(".")[1]))
    fn = pallas_l2 if name == "gathered_l2" else pallas_l2_dot
    return np.asarray(fn(jnp.asarray(q.numpy()), jcv, bq=8, interpret=True))


# (dtype, d, aligned): d with whole 16-byte units (the vector path: one,
# two, 16 or 32 units, 34 / 17 units with a short last round, 275 units)
# and without them or misaligned (the element path)
ORDER_CASES = [("float32", d, True) for d in (4, 8, 128, 136, 1, 17, 129)] \
    + [("float16", d, True) for d in (8, 128, 136, 4, 17)] \
    + [("bfloat16", d, True) for d in (8, 136, 17)] \
    + [("float32", 128, False), ("float16", 128, False), ("float32", 1100,
                                                          True)]


@pytest.mark.parametrize("name", ["gathered_l2", "gathered_l2_dot"])
@pytest.mark.parametrize("dtype,d,aligned", ORDER_CASES)
def test_kernel_order_matches_plain_and_pallas(name, dtype, d, aligned):
    """S = 11 is no multiple of the unroll; Q = 3 no multiple of the Pallas
    block."""
    q, cv = inputs(3, 11, d, dtype, seed=d)
    got = emulated(name, q, cv, aligned)
    tol = RTOL[name]
    want = getattr(ref, name + "_ref")(q, cv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), pallas(name, q, cv), rtol=tol,
                               atol=tol)


def test_layout_follows_the_row_width():
    assert layout(128, 4) == (4, 32)
    assert layout(128, 2) == (8, 16)          # a warp load covers two rows
    assert layout(136, 4) == (4, 32)
    assert layout(136, 2) == (8, 16)
    assert layout(4, 4) == (4, 1)
    assert layout(8, 4) == (4, 2)
    assert layout(17, 4) == (1, 32)
    assert layout(4, 2) == (1, 32)
    assert layout(128, 4, aligned=False) == (1, 32)


@pytest.mark.parametrize("name", ["gathered_l2", "gathered_l2_dot"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_non_finite_candidates_land_where_the_plain_version_puts_them(
        name, dtype):
    q, cv = inputs(4, 9, 128, dtype, seed=5)
    cv[0, 2, 7] = float("inf")
    cv[1, 0] = float("inf")                   # a whole row
    cv[2, 4, 100] = float("nan")
    cv[3, 8, 0] = -float("inf")
    got = emulated(name, q, cv)
    want = getattr(ref, name + "_ref")(q, cv)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert int((~torch.isfinite(want)).sum()) == 4
    fin = torch.isfinite(want)
    tol = RTOL[name]
    torch.testing.assert_close(got[fin], want[fin], rtol=tol, atol=tol)


def transpose_reduce(v, g: int):
    """gathered_l2.cu's reduce_rows on a warp's (32, U) partials, round by
    round as the lanes do it. Returns the lanes' values and each lane's
    ``base`` (the first of the rows it holds)."""
    v = v.clone()
    lanes = torch.arange(32)
    base = torch.zeros(32, dtype=torch.long)
    n = v.shape[1]
    o = g // 2
    while o > 0:
        partner = lanes ^ o
        upper = (lanes & o) != 0
        if n > 1:
            h = n // 2
            lo, hi = v[:, :h], v[:, h:n]
            keep = torch.where(upper[:, None], hi, lo)
            send = torch.where(upper[:, None], lo, hi)
            v = keep + send[partner]
            base += torch.where(upper, h, 0)
            n = h
        else:
            v = v + v[partner]
        o //= 2
    return v[:, :n], base


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_transpose_reduce_stores_every_row_once(g):
    """Each of the warp's UNROLL * 32/G rows is stored by exactly one lane
    (those whose butterfly bits are clear), with the halves-fold of the
    row's G partials, bit for bit."""
    gen = torch.Generator().manual_seed(g)
    v = torch.randn((32, UNROLL), generator=gen)
    slots, copies = 32 // g, max(1, g // UNROLL)
    out, base = transpose_reduce(v, g)
    stored = {}
    for lane in range(32):
        if lane % copies:
            continue
        for k in range(out.shape[1]):
            row = (int(base[lane]) + k) * slots + lane // g
            assert row not in stored
            stored[row] = out[lane, k]
    assert sorted(stored) == list(range(UNROLL * slots))
    for row, val in stored.items():
        slot, u = row % slots, row // slots
        partials = v[slot * g:(slot + 1) * g, u]
        assert torch.equal(val, fold(partials))
