"""The port's configs and LM (``repro_torch.configs``,
``repro_torch.models``: dense, MoE, MLA, RG-LRU and RWKV-6 layers) against
the reference's ``repro.configs`` / ``repro.models`` on the CPU.

The reference's weights are carried into the port with
``repro_torch.convert.lm_params_from_arrays`` (its init draws from jax's
PRNG, which torch cannot reproduce), so both sides run the same float32
weights: prefill logits and every seeded decode-cache leaf must agree at
rtol 1e-4 / atol 1e-5 (the atol scaled by the tensor's largest magnitude
where that is above 1, see :func:`_close`). The reference is imported inside :func:`_ref` with
``DeprecationWarning`` ignored there only (its models package imports
``jax.experimental.shard_map``, which the repository's pytest settings
would turn into an error).
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import LM, layer_descs, make_segments
from repro_torch.models import attention as tattn
from repro_torch.models import params as tparams
from repro_torch.serving import seed_caches

RTOL, ATOL = 1e-4, 1e-5
DENSE = ("olmo-1b", "gemma3-1b", "qwen3-32b", "qwen1.5-110b")
# MoE, RG-LRU + local attention, RWKV-6, MLA + MoE (+ mtp parameters)
MIXED = ("qwen3-moe-30b-a3b", "recurrentgemma-2b", "rwkv6-7b",
         "deepseek-v3-671b")


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        import jax.numpy as jnp
        from repro import configs
        from repro.models import attention, params, transformer
        from repro.serving import engine
    return dict(jax=jax, jnp=jnp, configs=configs, attention=attention,
                params=params, transformer=transformer, engine=engine)


@functools.lru_cache(maxsize=None)
def _carried(arch: str, seed: int = 0):
    """(reference LM, its params, port LM holding the same weights)."""
    r = _ref()
    rlm = r["transformer"].LM(r["configs"].get_smoke_config(arch))
    params = rlm.init(r["jax"].random.key(seed))
    np_tree = r["jax"].tree.map(np.asarray, params)
    lm = LM(tcfg.get_smoke_config(arch))
    lm.set_params(lm_params_from_arrays(lm.cfg, np_tree, device="cpu"))
    return rlm, params, lm


def _close(got, want, what):
    """rtol 1e-4, and atol 1e-5 of the tensor's own scale: the smoke
    configs' caches reach |x| ~ 20 (the reference's init draws wk at
    1/sqrt(fan_in) with fan_in = heads), where float32 rounding in another
    summation order alone is ~1e-6 a layer."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


@pytest.mark.parametrize("arch", tcfg.ARCH_NAMES)
def test_configs_and_segments_equal_reference(arch):
    r = _ref()
    for get in ("get_config", "get_smoke_config"):
        want = getattr(r["configs"], get)(arch)
        got = getattr(tcfg, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.layer_kinds() == want.layer_kinds()
        assert str(got.pdtype).split(".")[-1] == str(want.pdtype)
        for cross in (False, True):
            wd = r["transformer"].layer_descs(want, cross=cross)
            gd = layer_descs(got, cross=cross)
            assert [dataclasses.astuple(d) for d in gd] == \
                [dataclasses.astuple(d) for d in wd]
            ws = r["transformer"].make_segments(wd)
            gs = make_segments(gd)
            assert [(tuple(map(dataclasses.astuple, s.pattern)), s.repeats)
                    for s in gs] == \
                [(tuple(map(dataclasses.astuple, s.pattern)), s.repeats)
                 for s in ws]
    for shape in tcfg.ALL_SHAPES:
        assert tcfg.supports_shape(tcfg.get_config(arch), shape) == \
            r["configs"].supports_shape(r["configs"].get_config(arch), shape)


@pytest.mark.parametrize("arch", DENSE + MIXED)
def test_param_counts_equal_reference_from_metadata(arch):
    r = _ref()
    want = r["transformer"].LM(r["configs"].get_config(arch))
    lm = LM(tcfg.get_config(arch))
    assert lm.param_count() == want.param_count()
    assert lm.active_param_count() == want.active_param_count()
    assert tparams.tree_bytes(lm.abstract_params()) == \
        r["params"].tree_bytes(want.abstract_params())
    assert list(lm.parameters()) == []          # nothing was allocated


@pytest.mark.parametrize("arch,P", [
    ("olmo-1b", 37), ("gemma3-1b", 12), ("qwen3-moe-30b-a3b", 21),
    ("recurrentgemma-2b", 12), ("recurrentgemma-2b", 24), ("rwkv6-7b", 32),
    ("rwkv6-7b", 11), ("deepseek-v3-671b", 19)])
def test_prefill_and_seeded_caches_equal_reference(arch, P):
    r = _ref()
    jnp = r["jnp"]
    rlm, params, lm = _carried(arch)
    toks = np.random.default_rng(3).integers(0, lm.cfg.vocab, (2, P))
    wl, wc = rlm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    gl, gc = lm.prefill(None, {"tokens": toks})
    _close(gl, wl, "prefill logits")
    max_len = 64
    want = r["engine"].seed_caches(rlm, wc, 2, max_len, P)
    got = seed_caches(lm, gc, 2, max_len, P)
    wleaves = r["jax"].tree.leaves(want)
    gleaves = tparams.leaves(got)
    assert len(gleaves) == len(wleaves) > 0
    for i, (g, w) in enumerate(zip(gleaves, wleaves)):
        assert tuple(g.shape) == w.shape
        _close(g, w, f"seeded cache leaf {i}")
    # one decode step on the seeded caches (updated in place here)
    nxt = np.argmax(np.asarray(wl)[:, -1], -1)[:, None]
    wl2, wc2 = rlm.decode_step(params, want, jnp.asarray(nxt, jnp.int32),
                               jnp.asarray(P, jnp.int32))
    gl2, gc2 = lm.decode_step(None, got, nxt, P)
    _close(gl2, wl2, "decode logits")
    for i, (g, w) in enumerate(zip(tparams.leaves(gc2),
                                   r["jax"].tree.leaves(wc2))):
        _close(g, w, f"decoded cache leaf {i}")
    assert all(a is b for a, b in zip(tparams.leaves(gc2), gleaves))


FLASH_CASES = {
    "causal": dict(Sq=48, Skv=48, causal=True),
    "windowed": dict(Sq=48, Skv=48, causal=True, window=20),
    "padded": dict(Sq=37, Skv=37, causal=True),
    "kv_len": dict(Sq=32, Skv=45, causal=False, kv_len=29),
    "gqa_softcap": dict(Sq=40, Skv=40, causal=True, softcap=5.0),
    # MLA's prefill widths: Dk = qk_nope + qk_rope = 192 against Dv = 128
    "mla_dk192_dv128": dict(Sq=40, Skv=40, causal=True, Dk=192, Dv=128),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_equals_reference(case):
    r = _ref()
    jnp = r["jnp"]
    kw = dict(FLASH_CASES[case])
    Sq, Skv = kw.pop("Sq"), kw.pop("Skv")
    Dk, Dv = kw.pop("Dk", 16), kw.pop("Dv", 16)
    B, H, Hkv = 2, 4, (1 if case == "gqa_softcap" else 2)
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, Sq, H, Dk)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, Dk)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, Dv)).astype(np.float32)
    want = r["attention"].flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=16,
        kv_chunk=16, block_skip=True, **kw)
    for skip in (True, False):
        got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), q_chunk=16,
                                    kv_chunk=16, block_skip=skip, **kw)
        assert tuple(got.shape) == (B, Sq, H, Dv)
        _close(got, want, f"{case}, block_skip={skip}")


@pytest.mark.parametrize("M,window", [(32, None), (32, 8), (8, 8), (6, 8)])
def test_cache_slot_and_mask_equal_reference(M, window):
    r = _ref()
    for cur in range(0, 40, 3):
        ws, wv = r["attention"].cache_slot_and_mask(cur, M, window)
        gs, gv = tattn.cache_slot_and_mask(cur, M, window)
        assert int(gs) == int(ws)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("arch", sorted(set(tcfg.ARCH_NAMES) - set(DENSE)
                                         - set(MIXED)))
def test_unported_configs_raise(arch):
    for cfg in (tcfg.get_config(arch), tcfg.get_smoke_config(arch)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LM(cfg)


def test_attention_raises_on_cross_and_training_modes():
    cfg = tcfg.get_smoke_config("olmo-1b")
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.attn_apply({}, x, cfg=cfg, rope_theta=1e4, window=None,
                         positions=torch.arange(4), mode="prefill",
                         cross_memory=x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.attn_apply({}, x, cfg=cfg, rope_theta=1e4, window=None,
                         positions=torch.arange(4), mode="train")


def test_init_registers_reference_paths_and_is_seeded():
    r = _ref()
    rlm, params, _ = _carried("gemma3-1b")
    want_paths = sorted(
        ".".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in p)
        for p, _ in r["jax"].tree_util.tree_flatten_with_path(params)[0])
    cfg = tcfg.get_smoke_config("gemma3-1b")
    a, b = LM(cfg), LM(cfg)
    a.init(torch.Generator().manual_seed(5), device="cpu")
    b.init(torch.Generator().manual_seed(5), device="cpu")
    assert sorted(a.state_dict()) == want_paths
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
        assert va.dtype == cfg.pdtype and not va.requires_grad
    c = LM(cfg)
    c.init(torch.Generator().manual_seed(6), device="cpu")
    assert not torch.equal(a.state_dict()["embed.table"],
                           c.state_dict()["embed.table"])
    # the reference's init scales: embed at d**-0.5, ones for norms
    table = a.state_dict()["embed.table"]
    assert abs(float(table.std()) - cfg.d_model ** -0.5) < 0.02
    assert torch.equal(a.state_dict()["final_norm.scale"],
                       torch.ones(cfg.d_model))


def test_lm_params_from_arrays_takes_key_paths_and_rejects_bad_trees():
    r = _ref()
    jax = r["jax"]
    rlm, params, lm = _carried("olmo-1b")
    pairs = [(p, np.asarray(a)) for p, a in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    tree = lm_params_from_arrays(lm.cfg, pairs, device="cpu")
    for g, w in zip(tparams.leaves(tree), tparams.leaves(lm.params)):
        assert torch.equal(g, w)
    np_tree = jax.tree.map(np.asarray, params)
    bad = jax.tree.map(lambda a: a, np_tree)
    del bad["embed"]["table"]
    with pytest.raises(KeyError, match="embed.table"):
        lm_params_from_arrays(lm.cfg, bad, device="cpu")
    bad = jax.tree.map(lambda a: a, np_tree)
    bad["embed"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="embed.extra"):
        lm_params_from_arrays(lm.cfg, bad, device="cpu")
    bad = jax.tree.map(lambda a: a, np_tree)
    bad["embed"]["table"] = bad["embed"]["table"][:, :-1]
    with pytest.raises(ValueError, match="embed.table"):
        lm_params_from_arrays(lm.cfg, bad, device="cpu")
    with pytest.raises(KeyError):
        LM(lm.cfg).set_params({"embed": {}})


def test_lm_params_from_arrays_carries_bfloat16_bit_exact():
    r = _ref()
    jax = r["jax"]
    rcfg = r["configs"].get_smoke_config("olmo-1b").scaled(
        param_dtype="bfloat16", activ_dtype="bfloat16")
    params = r["transformer"].LM(rcfg).init(jax.random.key(2))
    cfg = tcfg.get_smoke_config("olmo-1b").scaled(
        param_dtype="bfloat16", activ_dtype="bfloat16")
    tree = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    for g, w in zip(tparams.leaves(tree), jax.tree.leaves(params)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_seed_leaf_places_stacked_mla_latents_along_their_sequence_axis():
    """A stacked segment's MLA leaf is (R, B, P, r): its sequence axis is
    second from the end. Counting it third from the end (the kv rule)
    would pick the batch axis; the seeded leaf must equal the reference's
    (which writes the prompt at offset 0) and keep every prompt entry at
    its position."""
    r = _ref()
    from repro_torch.models.transformer import LayerDesc, Segment, cache_meta
    from repro_torch.serving.engine import _seed_leaf
    cfg = tcfg.get_smoke_config("deepseek-v3-671b")
    R, B, P, M = 2, 3, 5, 16
    metas = cache_meta(cfg, [Segment((LayerDesc("mla", "moe"),), R)], B, M)
    lat_meta, rope_meta = metas[0]["L0"]
    assert lat_meta.shape == (R, B, M, cfg.kv_lora_rank)
    assert lat_meta.seq_axis == rope_meta.seq_axis == -2
    rng = np.random.default_rng(5)
    for m in (lat_meta, rope_meta):
        x = rng.normal(size=(R, B, P, m.shape[-1])).astype(np.float32)
        got = _seed_leaf(torch.from_numpy(x), m, P).numpy()
        sds = r["jax"].ShapeDtypeStruct(m.shape, r["jnp"].float32)
        want = np.asarray(r["engine"]._seed_leaf(r["jnp"].asarray(x), sds, P))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, :, :P], x)
        assert not got[:, :, P:].any()


def test_seeded_recurrent_states_are_taken_as_they_are():
    from repro_torch.models.transformer import LayerDesc, cache_meta_for_desc
    from repro_torch.serving.engine import _seed_leaf
    for arch, kind in (("recurrentgemma-2b", "rg"), ("rwkv6-7b", "rwkv")):
        cfg = tcfg.get_smoke_config(arch)
        for m in cache_meta_for_desc(cfg, LayerDesc(kind, "dense"), 2, 64):
            assert m.seq_axis is None
            x = torch.randn(m.shape).to(m.dtype)
            assert _seed_leaf(x, m, 7) is x
            with pytest.raises(ValueError, match="no sequence axis"):
                _seed_leaf(x[:1], m, 7)


def test_init_tree_draws_large_leaves_in_slabs(monkeypatch):
    """A leaf above ``SLAB_ELEMS`` is filled slab by slab: no float32 draw
    is larger than a slab (the whole-leaf float32 transient is what kept
    qwen3-moe-30b-a3b from initialising on one 80 GB card), one seed gives
    one leaf, and the init's scale holds."""
    slab = 1000
    monkeypatch.setattr(tparams, "SLAB_ELEMS", slab)
    metas = {"big": tparams.meta((7, 30, 40), (None, None, None),
                                 torch.bfloat16),
             "small": tparams.meta((20, 40), (None, None))}
    draws = []
    randn = torch.randn

    def spy(*a, **kw):
        out = randn(*a, **kw)
        draws.append(out.numel() * out.element_size())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    a = tparams.init_tree(metas, torch.Generator().manual_seed(9), "cpu")
    big_draws = draws[:]
    b = tparams.init_tree(metas, torch.Generator().manual_seed(9), "cpu")
    leaf_f32_bytes = 7 * 30 * 40 * 4
    # the peak float32 transient is one slab, not the leaf
    assert max(big_draws[:-1]) == slab * 4 < leaf_f32_bytes
    assert len(big_draws) == -(-7 * 30 * 40 // slab) + 1
    assert a["big"].dtype == torch.bfloat16 and a["big"].shape == (7, 30, 40)
    assert torch.equal(a["big"], b["big"]) and torch.equal(a["small"],
                                                           b["small"])
    assert abs(float(a["big"].float().std()) - 30 ** -0.5) < 0.01  # fan_in
    c = tparams.init_tree(metas, torch.Generator().manual_seed(10), "cpu")
    assert not torch.equal(a["big"], c["big"])
