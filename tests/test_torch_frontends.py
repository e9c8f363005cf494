"""The port's encoder, cross-attention and front ends
(``repro_torch.models``: ``attn_apply``'s cross branch, ``LM._encode`` /
``LM._frontend``; ``ServeEngine`` and the serving driver with ``frames`` /
``patches``) against the reference's on the CPU, for seamless-m4t-large-v2
(encoder-decoder over audio frames) and llava-next-mistral-7b (patch
embeddings prepended to the tokens).

The reference's weights are carried into the port with
``repro_torch.convert.lm_params_from_arrays``; tensors are held at rtol
1e-4 and atol 1e-5 of the tensor's scale (``test_torch_models._close``).
The reference's init draws every ``wq`` at 1/sqrt(n_heads), so at the
smoke widths the attention scores have a std of ~16 and the softmax sits
near its corners: there a 1e-7 relative change of the weights can move the
logits by more than that tolerance, in either implementation (seamless's
do on the control's batches,
:func:`test_parity_weights_keep_rounding_inside_the_tolerance`). So the
end-to-end parity tests scale the reference's ``wq`` leaves by
``WQ_SCALE`` before carrying them (scores of std ~4), and the same
weights go to both sides. The reference is imported inside a cached
function with ``DeprecationWarning`` ignored there only.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.models import params as tparams
from repro_torch.serving import ServeEngine, seed_caches

from test_torch_models import _close

ARCHS = ("seamless-m4t-large-v2", "llava-next-mistral-7b")
ENC_LEN = 21          # no multiple of the smoke configs' 16-entry kv chunk
WQ_SCALE = 0.25


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        import jax.numpy as jnp
        from repro import configs
        from repro.models import attention
        from repro.models.transformer import LM as RLM
        from repro.serving import ServeEngine as RServeEngine
        from repro.serving import engine
    return dict(jax=jax, jnp=jnp, configs=configs, attention=attention,
                LM=RLM, ServeEngine=RServeEngine, engine=engine)


@functools.lru_cache(maxsize=None)
def _carried(arch: str, seed: int = 0, wq_scale: float = WQ_SCALE):
    """(reference LM, its params with every ``wq`` leaf times
    ``wq_scale``, port LM holding the same weights)."""
    r = _ref()
    jax = r["jax"]
    rlm = r["LM"](r["configs"].get_smoke_config(arch))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * wq_scale if path[-1].key == "wq" else a,
        rlm.init(jax.random.key(seed)))
    lm = LM(tcfg.get_smoke_config(arch))
    lm.set_params(lm_params_from_arrays(
        lm.cfg, r["jax"].tree.map(np.asarray, params), device="cpu"))
    return rlm, params, lm


def _batch(cfg, B: int, P: int, seed: int):
    """Tokens and the config's frames (ENC_LEN of them) or patches, as
    float32 numpy like the serving driver's."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, P))}
    if cfg.frontend == "vision_stub":
        b["patches"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    if cfg.n_enc_layers:
        b["frames"] = rng.normal(
            size=(B, ENC_LEN, cfg.frontend_dim)).astype(np.float32)
    return b


def _jax_batch(b):
    jnp = _ref()["jnp"]
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in b.items()}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("variant", ["plain", "bias_qknorm"])
def test_cross_attention_equals_reference(variant, mode):
    """``attn_apply(is_cross=True)``: keys and values from the memory at
    prefill (enc_len 21, no chunk multiple) and from the cache at decode;
    biases and a q-only norm where the config asks for them (drawn away
    from their zeros / ones init, so they count)."""
    r = _ref()
    jnp = r["jnp"]
    cfg = tcfg.get_smoke_config("seamless-m4t-large-v2")
    if variant == "bias_qknorm":
        cfg = cfg.scaled(attn_bias=True, qk_norm=True)
    rng = np.random.default_rng(7)
    p = {k: (rng.normal(size=m.shape) / np.sqrt(m.shape[0])
             ).astype(np.float32)
         for k, m in tattn.attn_meta(cfg, torch.float32).items()}
    for k in ("q_norm", "k_norm"):
        if k in p:
            p[k] = (1 + 0.5 * rng.normal(size=p[k].shape)).astype(np.float32)
    B, Sq = 2, (1 if mode == "decode" else 13)
    x = rng.normal(size=(B, Sq, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, ENC_LEN, cfg.d_model)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    kw = dict(cfg=cfg, rope_theta=cfg.rope_theta, window=None,
              positions=np.arange(Sq), is_cross=True)
    _, wcache = r["attention"].attn_apply(
        rp, jnp.asarray(x), mode="prefill", cross_memory=jnp.asarray(mem),
        **kw)
    if mode == "prefill":
        want, wc = r["attention"].attn_apply(
            rp, jnp.asarray(x), mode="prefill",
            cross_memory=jnp.asarray(mem), **kw)
        got, gc = tattn.attn_apply(
            tp, torch.from_numpy(x), mode="prefill",
            cross_memory=torch.from_numpy(mem),
            **{**kw, "positions": torch.arange(Sq)})
    else:
        want, wc = r["attention"].attn_apply(
            rp, jnp.asarray(x), mode="decode", cache=wcache, cur_pos=30,
            **kw)
        cache = tuple(torch.from_numpy(np.array(c)) for c in wcache)
        got, gc = tattn.attn_apply(
            tp, torch.from_numpy(x), mode="decode", cache=cache, cur_pos=30,
            **{**kw, "positions": torch.tensor([30])})
        assert all(g is c for g, c in zip(gc, cache))   # read, not written
    assert tuple(got.shape) == (B, Sq, cfg.d_model)
    _close(got, want, f"cross {mode} out")
    for g, w in zip(gc, wc):
        assert tuple(g.shape) == (B, ENC_LEN, cfg.n_kv_heads, cfg.head_dim)
        _close(g, w, f"cross {mode} cache")


def test_encode_equals_reference_and_is_non_causal():
    r = _ref()
    jnp = r["jnp"]
    rlm, params, lm = _carried("seamless-m4t-large-v2")
    frames = _batch(lm.cfg, 2, 4, 5)["frames"]
    want, _ = rlm._encode(params, jnp.asarray(frames), None, ("data",))
    with torch.inference_mode():
        got = lm._encode(lm.params, frames)
        assert tuple(got.shape) == (2, ENC_LEN, lm.cfg.d_model)
        _close(got, want, "encoder output")
        moved = frames.copy()
        moved[:, -1] += 1.0
        got2 = lm._encode(lm.params, moved)
    # the first frame's output sees the last frame
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_seeded_caches_and_decode_equal_reference(arch):
    """Prefill logits, every seeded decode-cache leaf (the cross leaves
    included, "cross" before "self" as jax orders the keys) and one decode
    step at the position past the patches."""
    r = _ref()
    jnp = r["jnp"]
    rlm, params, lm = _carried(arch)
    b = _batch(lm.cfg, 2, 11, 3)
    wl, wc = rlm.prefill(params, _jax_batch(b))
    gl, gc = lm.prefill(None, b)
    _close(gl, wl, "prefill logits")
    enc_len = ENC_LEN if "frames" in b else 0
    prompt = 11 + (b["patches"].shape[1] if "patches" in b else 0)
    want = r["engine"].seed_caches(rlm, wc, 2, 48, prompt, enc_len)
    got = seed_caches(lm, gc, 2, 48, prompt, enc_len)
    wleaves = r["jax"].tree.leaves(want)
    gleaves = tparams.leaves(got)
    assert len(gleaves) == len(wleaves) > 0
    for i, (g, w) in enumerate(zip(gleaves, wleaves)):
        assert tuple(g.shape) == w.shape
        _close(g, w, f"seeded cache leaf {i}")
    if enc_len:     # one stacked segment of cross layers
        assert len(gleaves) == 4 and gleaves[0].shape[2] == ENC_LEN
    nxt = np.argmax(np.asarray(wl)[:, -1], -1)[:, None]
    wl2, wc2 = rlm.decode_step(params, want, jnp.asarray(nxt, jnp.int32),
                               jnp.asarray(prompt, jnp.int32))
    gl2, gc2 = lm.decode_step(None, got, nxt, prompt)
    _close(gl2, wl2, "decode logits")
    for i, (g, w) in enumerate(zip(tparams.leaves(gc2),
                                   r["jax"].tree.leaves(wc2))):
        _close(g, w, f"decoded cache leaf {i}")
    assert all(a is b_ for a, b_ in zip(tparams.leaves(gc2), gleaves))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference(arch):
    r = _ref()
    rlm, params, lm = _carried(arch, 1)
    b = _batch(lm.cfg, 2, 16, 1)
    want = r["ServeEngine"](rlm, params).generate(_jax_batch(b), n_new=6,
                                                  max_len=40)
    got = ServeEngine(lm, device="cpu").generate(b, n_new=6, max_len=40)
    assert got.tokens.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    _close(got.logits_last, want.logits_last, "last logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_teacher_forcing(arch):
    """Greedy tokens equal argmax over repeated full prefills on the same
    frames or patches: decoding writes and ropes at the positions past
    the patches, and reads the encoder through its cached projections."""
    _, _, lm = _carried(arch, 2)
    b = _batch(lm.cfg, 2, 9, 2)
    out = ServeEngine(lm, device="cpu").generate(b, n_new=4, max_len=40)
    cur, want = b["tokens"], []
    for _ in range(4):
        lg, _ = lm.prefill(None, {**b, "tokens": cur})
        nxt = torch.argmax(lg[:, -1], dim=-1).numpy()
        want.append(nxt)
        cur = np.concatenate([cur, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(out.tokens, np.stack(want, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serves_each_front_end(arch):
    out = serve.main(["--device", "cpu", "--arch", arch, "--requests", "8",
                      "--n", "400"])
    assert out["arch"] == arch and out["generated"] == [4, 8]
    assert out["served"] == out["requests"] == out["non_empty"] == 8


def test_seed_caches_raises_on_a_cross_leaf_of_another_enc_len():
    """A cross leaf has no sequence axis to pad along: the decode layout
    asks for the encoder's enc_len entries, and prefill caches of another
    enc_len raise instead of being padded."""
    _, _, lm = _carried("seamless-m4t-large-v2")
    b = _batch(lm.cfg, 2, 8, 4)
    _, pc = lm.prefill(None, b)
    seed_caches(lm, pc, 2, 32, 8, ENC_LEN)
    with pytest.raises(ValueError, match="no sequence axis"):
        seed_caches(lm, pc, 2, 32, 8, ENC_LEN + 3)
    metas = lm.decode_cache_meta(2, 32, ENC_LEN)
    assert metas[0]["L0"]["cross"][0].seq_axis is None
    assert metas[0]["L0"]["self"][0].seq_axis == -3


@pytest.mark.parametrize("arch", ARCHS)
def test_parity_weights_keep_rounding_inside_the_tolerance(arch):
    """The control behind ``WQ_SCALE``: a 1e-7 relative change of every
    weight moves the port's float32 prefill logits by less than the
    parity tolerance on the weights the tests carry; for seamless, by more
    on the reference's init as drawn (on one of these batches at least),
    so there a comparison at that tolerance would measure float32
    rounding, not the port."""
    def moved_over_atol(lm, b, seed):
        gen = torch.Generator().manual_seed(seed)
        moved = tparams.map_tree(
            lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)),
            lm.params)
        gl, _ = lm.prefill(None, b)
        ml, _ = lm.prefill(moved, b)
        atol = 1e-5 * max(1.0, float(gl.abs().max()))
        return float((ml - gl).abs().max()) / atol

    _, _, tamed = _carried(arch, 0)
    batches = [_batch(tamed.cfg, 2, 16, s) for s in range(3)]
    assert max(moved_over_atol(tamed, b, s)
               for s, b in enumerate(batches)) < 1.0
    if tamed.cfg.n_enc_layers:
        _, _, raw = _carried(arch, 0, 1.0)
        assert max(moved_over_atol(raw, b, s)
                   for s, b in enumerate(batches)) > 1.0
