"""The port's mixture-of-experts block (``repro_torch.models.moe``, the
local path) against the reference's ``repro.models.moe`` on the CPU.

Both sides run the same numpy weights (drawn by the reference's
``init_tree``) on the same numpy input: ``moe_apply``'s output and
load-balance aux agree at rtol 1e-4 / atol 1e-5 of the output's scale, for
softmax and sigmoid routers, with and without top-k renormalization and
shared experts, at a capacity that drops assignments (where the kept set
must equal the reference router's exactly) and with tied router scores
(where the lower expert must win, as in ``lax.top_k``). The reference is
imported inside :func:`_ref` with ``DeprecationWarning`` ignored there only
(it imports ``jax.experimental.shard_map``, which the repository's pytest
settings turn into an error).
"""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.models import moe

RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        import jax.numpy as jnp
        from repro import configs
        from repro.models import moe as rmoe
        from repro.models import params
    return dict(jax=jax, jnp=jnp, configs=configs, moe=rmoe, params=params)


def _cfgs(arch: str, **kw):
    """(reference config, port config) of ``arch``'s smoke size, with
    ``kw`` replaced on both."""
    r = _ref()
    return (r["configs"].get_smoke_config(arch).scaled(**kw),
            tcfg.get_smoke_config(arch).scaled(**kw))


def _weights(rcfg, seed: int):
    """The reference's MoE parameters as numpy, and as torch tensors."""
    r = _ref()
    metas = r["moe"].moe_meta(rcfg, r["jnp"].float32)
    np_tree = r["jax"].tree.map(
        np.asarray, r["params"].init_tree(metas, r["jax"].random.key(seed)))
    # the reference's router scale (0.02) keeps the scores near uniform;
    # widen it so routing is decisive and drops follow the router
    np_tree["router"] = np_tree["router"] * 50
    return np_tree, _torch_tree(np_tree)


def _torch_tree(np_tree):
    if isinstance(np_tree, dict):
        return {k: _torch_tree(v) for k, v in np_tree.items()}
    return torch.from_numpy(np.array(np_tree))


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def _run_both(rcfg, cfg, np_p, p, x, cf):
    r = _ref()
    want_y, want_aux = r["moe"].moe_apply(
        r["jax"].tree.map(r["jnp"].asarray, np_p), r["jnp"].asarray(x),
        cfg=rcfg, mesh=None, batch_axes=None, capacity_factor=cf,
        mode="prefill")
    got_y, got_aux = moe.moe_apply(p, torch.from_numpy(x), cfg=cfg,
                                   capacity_factor=cf)
    st = moe.routing(p, torch.from_numpy(x), cfg=cfg, capacity_factor=cf)
    return (want_y, want_aux), (got_y, got_aux), st


def _ref_kept(rcfg, np_p, x, capacity):
    """The reference router's experts and kept set, by the reference's own
    ops (``lax.top_k`` and the exclusive one-hot cumsum of
    ``repro.models.moe._local_moe``)."""
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = (xf @ jnp.asarray(np_p["router"])).astype(jnp.float32)
    scores = (jax.nn.sigmoid(logits) if rcfg.router_fn == "sigmoid"
              else jax.nn.softmax(logits, axis=-1))
    _, eidx = jax.lax.top_k(scores + jnp.asarray(np_p["bias"])[None], rcfg.top_k)
    onehot = jax.nn.one_hot(eidx.reshape(-1), rcfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1)
    return np.asarray(eidx), np.asarray(pos < capacity).reshape(eidx.shape)


ROUTERS = {
    "softmax_norm": dict(arch="qwen3-moe-30b-a3b"),
    "softmax_raw": dict(arch="qwen3-moe-30b-a3b", router_norm_topk=False),
    "sigmoid_norm_shared": dict(arch="deepseek-v3-671b"),
    "sigmoid_raw_shared": dict(arch="deepseek-v3-671b",
                               router_norm_topk=False),
    "softmax_shared": dict(arch="qwen3-moe-30b-a3b", n_shared_experts=2),
}


@pytest.mark.parametrize("case", sorted(ROUTERS))
def test_moe_apply_equals_reference(case):
    kw = dict(ROUTERS[case])
    rcfg, cfg = _cfgs(kw.pop("arch"), **kw)
    np_p, p = _weights(rcfg, seed=1)
    if "shared" in np_p:
        assert rcfg.n_shared_experts >= 1
    x = np.random.default_rng(2).normal(size=(2, 13, cfg.d_model)
                                        ).astype(np.float32)
    (wy, waux), (gy, gaux), st = _run_both(rcfg, cfg, np_p, p, x,
                                           cfg.capacity_factor)
    assert gy.shape == (2, 13, cfg.d_model) and gy.dtype == torch.float32
    assert int(st["dropped"]) == 0          # the smoke factor drops nothing
    _close(gy, wy, f"{case}: y")
    _close(gaux, waux, f"{case}: aux")


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25])
def test_capacity_drops_equal_the_reference_router(cf):
    """At these factors experts overflow: the kept set equals the
    reference router's exactly, and so does y (a dropped assignment adds
    nothing to its token)."""
    rcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    np_p, p = _weights(rcfg, seed=3)
    x = np.random.default_rng(4).normal(size=(3, 16, cfg.d_model)
                                        ).astype(np.float32)
    (wy, waux), (gy, gaux), st = _run_both(rcfg, cfg, np_p, p, x, cf)
    T = 3 * 16
    cap = moe.capacity_for(T, cfg, cf)
    assert st["capacity"] == cap == max(int(np.ceil(T * 2 / 8 * cf)), 4)
    want_e, want_kept = _ref_kept(rcfg, np_p, x, cap)
    np.testing.assert_array_equal(st["experts"].numpy(), want_e)
    np.testing.assert_array_equal(st["kept"].numpy(), want_kept)
    assert int(st["dropped"]) == int((~want_kept).sum()) > 0
    # every kept slot is unique and within capacity
    per_expert = np.bincount(want_e[want_kept], minlength=cfg.n_experts)
    assert per_expert.max() <= cap
    _close(gy, wy, f"cf={cf}: y")
    _close(gaux, waux, f"cf={cf}: aux")


@pytest.mark.parametrize("router_fn", ["softmax", "sigmoid"])
def test_tied_router_scores_pick_the_lower_expert(router_fn):
    """Experts 4-7 route exactly like experts 0-3 (duplicated router
    columns), so every score ties with another: the lower expert must be
    picked, as ``lax.top_k`` does, and y must equal the reference's."""
    rcfg, cfg = _cfgs("qwen3-moe-30b-a3b", router_fn=router_fn, top_k=3)
    np_p, p = _weights(rcfg, seed=5)
    np_p["router"][:, 4:] = np_p["router"][:, :4]
    p["router"] = torch.from_numpy(np_p["router"].copy())
    x = np.random.default_rng(6).normal(size=(2, 9, cfg.d_model)
                                        ).astype(np.float32)
    (wy, _), (gy, _), st = _run_both(rcfg, cfg, np_p, p, x,
                                     cfg.capacity_factor)
    want_e, _ = _ref_kept(rcfg, np_p, x, 10 ** 6)
    got_e = st["experts"].numpy()
    np.testing.assert_array_equal(got_e, want_e)
    # of each tied pair (e, e + 4) that both made the top-k, e comes first
    for row in got_e:
        for j, e in enumerate(row):
            if e >= 4 and e - 4 in row:
                assert list(row).index(e - 4) < j
    # with 3 of 8 picked from 4 tied pairs, the first two picks are a pair
    assert (got_e[:, 1] == got_e[:, 0] + 4).all()
    _close(gy, wy, "tied: y")


def test_bfloat16_ties_resolve_to_the_lower_expert():
    """bfloat16 router logits tie often; ``_route`` orders equal scores by
    expert, as ``lax.top_k`` does on the same scores."""
    r = _ref()
    cfg = tcfg.get_smoke_config("qwen3-moe-30b-a3b").scaled(
        n_experts=32, top_k=8)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(64, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(cfg.d_model, 32)).astype(
        np.float32) * 0.02).to(torch.bfloat16)
    bias = torch.zeros(32)
    logits, gates, eidx = moe._route(x, w, bias, cfg)
    scores = torch.softmax(logits, -1).numpy()
    n_ties = sum(len(row) - len(np.unique(row)) for row in scores)
    assert n_ties > 0                        # the case is exercised
    _, want = r["jax"].lax.top_k(r["jnp"].asarray(scores), 8)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(want))
    assert gates.dtype == torch.float32
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_combine_is_a_fixed_order_sum():
    """The combine adds a token's k rows in one order, so two runs agree
    bit for bit, and a dropped assignment never overwrites a kept one (the
    dump row): a token whose every assignment is dropped gets exactly 0
    from the experts."""
    rcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    _, p = _weights(rcfg, seed=8)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32))
    a, _ = moe.moe_apply(p, x, cfg=cfg, capacity_factor=0.25)
    b, _ = moe.moe_apply(p, x, cfg=cfg, capacity_factor=0.25)
    st = moe.routing(p, x, cfg=cfg, capacity_factor=0.25)
    assert torch.equal(a, b)
    kept = st["kept"]
    gone = ~kept.any(1)
    assert gone.any()
    assert torch.equal(a.reshape(-1, cfg.d_model)[gone],
                       torch.zeros(int(gone.sum()), cfg.d_model))
    assert int(st["dropped"]) == int((~kept).sum())
    assert bool(st["experts_used"].any())


def test_routing_names_the_experts_moe_apply_reads():
    """``routing`` reports what ``moe_apply`` does: an expert outside
    ``experts_used`` can take any weights without changing y, and one
    inside it cannot; ``experts_used`` is the set of experts with a kept
    assignment."""
    rcfg, cfg = _cfgs("qwen3-moe-30b-a3b", n_experts=16)
    _, p = _weights(rcfg, seed=10)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(1, 3, cfg.d_model)).astype(np.float32))
    st = moe.routing(p, x, cfg=cfg, capacity_factor=1.0)
    used = st["experts_used"]
    want = torch.zeros(cfg.n_experts, dtype=torch.bool)
    want[st["experts"][st["kept"]]] = True
    assert torch.equal(used, want)
    assert 0 < int(used.sum()) < cfg.n_experts
    y, _ = moe.moe_apply(p, x, cfg=cfg, capacity_factor=1.0)
    for name in ("w_gate", "w_up", "w_down"):
        q = dict(p)
        q[name] = p[name].clone()
        q[name][~used] = 1e3
        assert torch.equal(moe.moe_apply(q, x, cfg=cfg,
                                         capacity_factor=1.0)[0], y)
        q[name][used] = 1e3
        assert not torch.equal(moe.moe_apply(q, x, cfg=cfg,
                                             capacity_factor=1.0)[0], y)
