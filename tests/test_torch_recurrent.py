"""The port's recurrent mixers (``repro_torch.models.recurrent``: RG-LRU
and RWKV-6) against the reference's ``repro.models.recurrent`` on the CPU.

Both sides run the same numpy weights (the reference's ``init_tree``, with
the parameters it initialises to zeros or ones drawn at random here so
every term is exercised) on the same numpy input. Prefill outputs and
states agree at rtol 1e-4 / atol 1e-5 of the tensor's scale at sequence
lengths that are not powers of 2 (RG-LRU's doubling scan) and at multiples
of the 16-token chunk (RWKV's chunk scan); so do decode steps from a
prefill's states, and a prefill of P tokens followed by n decode steps
equals a prefill of P + n. The reference is imported inside :func:`_ref`
with ``DeprecationWarning`` ignored there only.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.models import recurrent as rec

RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        import jax.numpy as jnp
        from repro import configs
        from repro.models import params
        from repro.models import recurrent as rrec
    return dict(jax=jax, jnp=jnp, configs=configs, rec=rrec, params=params)


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def _setup(kind: str, seed: int = 0):
    """(reference cfg, port cfg, reference apply, port apply, numpy
    params, torch params) of one mixer at its smoke size."""
    r = _ref()
    arch = "recurrentgemma-2b" if kind == "rg" else "rwkv6-7b"
    rcfg = r["configs"].get_smoke_config(arch)
    cfg = tcfg.get_smoke_config(arch)
    meta_fn = r["rec"].rglru_meta if kind == "rg" else r["rec"].rwkv6_meta
    metas = meta_fn(rcfg, r["jnp"].float32)
    np_p = r["jax"].tree.map(np.asarray, r["params"].init_tree(
        metas, r["jax"].random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    # draw what the init sets to constants, so every term is live
    for name in ("conv_b", "lru_in_gate", "lru_in_gate_b", "lru_rec_gate",
                 "lru_rec_gate_b", "lru_a", "w0", "bonus", "ln_scale"):
        if name in np_p:
            np_p[name] = (np_p[name] + 0.5 * rng.normal(
                size=np_p[name].shape)).astype(np.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in np_p.items()}
    if kind == "rg":
        ref_fn = functools.partial(r["rec"].rglru_apply, cfg=rcfg)
        fn = functools.partial(rec.rglru_apply, cfg=cfg)
    else:
        ref_fn = functools.partial(r["rec"].rwkv6_apply, cfg=rcfg,
                                   chunk=rcfg.rwkv_chunk)
        fn = functools.partial(rec.rwkv6_apply, cfg=cfg, chunk=cfg.rwkv_chunk)
    return rcfg, cfg, ref_fn, fn, np_p, p


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)
                                              ).astype(np.float32)


def _ref_call(ref_fn, np_p, x, mode, cache=None):
    r = _ref()
    jp = r["jax"].tree.map(r["jnp"].asarray, np_p)
    if cache is not None:
        cache = tuple(r["jnp"].asarray(np.asarray(c)) for c in cache)
    y, c = ref_fn(jp, r["jnp"].asarray(x), mode=mode, cache=cache)
    return np.asarray(y), tuple(np.asarray(t) for t in c)


@pytest.mark.parametrize("kind,S", [("rg", 1), ("rg", 7), ("rg", 37),
                                    ("rg", 100), ("rwkv", 5), ("rwkv", 16),
                                    ("rwkv", 48)])
def test_prefill_equals_reference(kind, S):
    _, cfg, ref_fn, fn, np_p, p = _setup(kind)
    x = _x(cfg, 2, S, seed=S)
    wy, wc = _ref_call(ref_fn, np_p, x, "prefill")
    gy, gc = fn(p, torch.from_numpy(x), mode="prefill")
    _close(gy, wy, f"{kind} S={S}: y")
    assert len(gc) == len(wc) == 2
    for i, (g, w) in enumerate(zip(gc, wc)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w, f"{kind} S={S}: state {i}")


@pytest.mark.parametrize("kind,P", [("rg", 13), ("rwkv", 16)])
def test_decode_steps_equal_reference_and_update_in_place(kind, P):
    _, cfg, ref_fn, fn, np_p, p = _setup(kind, seed=1)
    x = _x(cfg, 3, P + 4, seed=7)
    _, wc = _ref_call(ref_fn, np_p, x[:, :P], "prefill")
    _, gc = fn(p, torch.from_numpy(x[:, :P]), mode="prefill")
    cache = tuple(t.clone() for t in gc)
    for t in range(P, P + 4):
        wy, wc = _ref_call(ref_fn, np_p, x[:, t:t + 1], "decode", wc)
        gy, new = fn(p, torch.from_numpy(x[:, t:t + 1]), mode="decode",
                     cache=cache)
        assert all(a is b for a, b in zip(new, cache))
        _close(gy, wy, f"{kind} decode t={t}: y")
        for i, (g, w) in enumerate(zip(cache, wc)):
            _close(g, w, f"{kind} decode t={t}: state {i}")


@pytest.mark.parametrize("kind,P,n", [("rg", 13, 6), ("rg", 1, 9),
                                      ("rwkv", 16, 16), ("rwkv", 32, 16)])
def test_prefill_then_decode_equals_longer_prefill(kind, P, n):
    _, cfg, _, fn, _, p = _setup(kind, seed=2)
    x = torch.from_numpy(_x(cfg, 2, P + n, seed=11))
    want_y, want_c = fn(p, x, mode="prefill")
    _, cache = fn(p, x[:, :P], mode="prefill")
    ys = []
    for t in range(P, P + n):
        y, cache = fn(p, x[:, t:t + 1], mode="decode", cache=cache)
        ys.append(y)
    _close(torch.cat(ys, 1), want_y[:, P:], f"{kind}: decoded y")
    for i, (g, w) in enumerate(zip(cache, want_c)):
        _close(g, w, f"{kind}: state {i}")


def test_rglru_scan_matches_a_float64_loop_over_long_sequences():
    """The doubling scan against the plain recurrence in float64 at S =
    1000, with decays near 0 and near 1: float32 rounding only."""
    rng = np.random.default_rng(3)
    B, S, W = 2, 1000, 8
    x = torch.from_numpy(rng.normal(size=(B, S, W)).astype(np.float32))
    r = torch.from_numpy(rng.random((B, S, W)).astype(np.float32))
    i = torch.from_numpy(rng.random((B, S, W)).astype(np.float32))
    a_param = torch.from_numpy(rng.normal(size=W).astype(np.float32) * 3)
    h0 = torch.from_numpy(rng.normal(size=(B, W)).astype(np.float32))
    y, h = rec._rglru_scan(x, r, i, a_param, h0)
    a, b = rec._lru_coeffs(r.double(), i.double(), x.double(),
                           a_param.double())
    hh, want = h0.double(), []
    for t in range(S):
        hh = a[:, t] * hh + b[:, t]
        want.append(hh)
    want = torch.stack(want, 1)
    np.testing.assert_allclose(y.double().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.double().numpy(), want[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_rwkv_chunk_scan_shares_the_reference_overflow():
    """Reference caveat, kept: with every decay at the -8 clip, a chunk's
    cumulative log decay reaches -128 and ``exp(-c_incl)`` overflows
    float32 in both the reference and the port; their finite patterns
    agree. A prefill whose length is no multiple of the chunk raises."""
    _, cfg, ref_fn, fn, np_p, p = _setup("rwkv", seed=4)
    np_p["w0"] = np.full_like(np_p["w0"], 10.0)
    p["w0"] = torch.from_numpy(np_p["w0"].copy())
    x = _x(cfg, 1, 16, seed=5)
    wy, _ = _ref_call(ref_fn, np_p, x, "prefill")
    gy, _ = fn(p, torch.from_numpy(x), mode="prefill")
    assert not np.isfinite(wy).all()
    np.testing.assert_array_equal(np.isfinite(gy.numpy()), np.isfinite(wy))
    with pytest.raises(ValueError, match="multiple of 16"):
        fn(p, torch.from_numpy(_x(cfg, 1, 20, seed=5)), mode="prefill")
