"""The port's ``ServeEngine`` and serving driver
(``repro_torch.serving.ServeEngine``, ``repro_torch.launch.serve``) against
the reference's on the CPU: greedy tokens equal the reference's on the same
(carried) weights, generation equals argmax over repeated full prefills
(teacher forcing, with ring caches), determinism, the driver's four
modes, and each ported layer family (MoE, RG-LRU, RWKV-6, MLA) through
``ServeEngine`` and the driver. The reference is imported inside :func:`_ref` with
``DeprecationWarning`` ignored there only.
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
from repro_torch.serving import GenerationResult, ServeEngine


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        import jax.numpy as jnp
        from repro import configs
        from repro.models.transformer import LM as RLM
        from repro.serving import ServeEngine as RServeEngine
    return dict(jax=jax, jnp=jnp, configs=configs, LM=RLM,
                ServeEngine=RServeEngine)


@functools.lru_cache(maxsize=None)
def _carried(arch: str, seed: int):
    r = _ref()
    rlm = r["LM"](r["configs"].get_smoke_config(arch))
    params = rlm.init(r["jax"].random.key(seed))
    lm = LM(tcfg.get_smoke_config(arch))
    lm.set_params(lm_params_from_arrays(
        lm.cfg, r["jax"].tree.map(np.asarray, params), device="cpu"))
    return rlm, params, lm


def test_generate_equals_reference_and_is_deterministic():
    r = _ref()
    rlm, params, lm = _carried("olmo-1b", 0)
    toks = np.random.default_rng(0).integers(0, lm.cfg.vocab, (2, 16))
    want = r["ServeEngine"](rlm, params).generate(
        {"tokens": r["jnp"].asarray(toks, r["jnp"].int32)}, n_new=6,
        max_len=32)
    eng = ServeEngine(lm, device="cpu")
    g1 = eng.generate({"tokens": toks}, n_new=6, max_len=32)
    g2 = eng.generate({"tokens": toks}, n_new=6, max_len=32)
    assert isinstance(g1, GenerationResult)
    assert g1.tokens.shape == (2, 6) and g1.tokens.dtype == np.int32
    np.testing.assert_array_equal(g1.tokens, want.tokens)
    np.testing.assert_array_equal(g1.tokens, g2.tokens)
    np.testing.assert_array_equal(g1.logits_last, g2.logits_last)
    np.testing.assert_allclose(g1.logits_last, np.asarray(want.logits_last),
                               rtol=1e-4, atol=1e-5)
    assert (g1.tokens >= 0).all() and (g1.tokens < lm.cfg.vocab).all()
    # a tensor prompt and an explicit params tree give the same tokens
    g3 = ServeEngine(lm, lm.params, device="cpu").generate(
        {"tokens": torch.as_tensor(toks)}, n_new=6, max_len=32)
    np.testing.assert_array_equal(g3.tokens, g1.tokens)


@pytest.mark.parametrize("P", [16, 24])
def test_generate_matches_teacher_forcing_with_ring_caches(P):
    """gemma3-1b's local layers keep a ring cache of window (16) entries;
    P = 24 seeds a ring from a prompt longer than the window."""
    r = _ref()
    rlm, params, lm = _carried("gemma3-1b", 1)
    toks = np.random.default_rng(1).integers(0, lm.cfg.vocab, (1, P))
    out = ServeEngine(lm, device="cpu").generate({"tokens": toks}, n_new=4,
                                                 max_len=32)
    cur, want = toks.copy(), []
    for _ in range(4):
        lg, _ = lm.prefill(None, {"tokens": cur})
        nxt = int(torch.argmax(lg[0, -1]))
        want.append(nxt)
        cur = np.concatenate([cur, [[nxt]]], axis=1)
    assert out.tokens[0].tolist() == want
    if P == 16:          # the reference seeds rings only up to the window
        ref = r["ServeEngine"](rlm, params).generate(
            {"tokens": r["jnp"].asarray(toks, r["jnp"].int32)}, n_new=4,
            max_len=32)
        assert out.tokens[0].tolist() == np.asarray(ref.tokens)[0].tolist()


MIXED = ("qwen3-moe-30b-a3b", "recurrentgemma-2b", "rwkv6-7b",
         "deepseek-v3-671b")


@pytest.mark.parametrize("arch", MIXED)
def test_generate_equals_reference_for_each_family(arch):
    """Greedy tokens on carried weights equal the reference's: MoE routing
    in prefill and decode, recurrent states carried from the prompt, MLA's
    latent caches seeded and decoded in the absorbed form."""
    r = _ref()
    rlm, params, lm = _carried(arch, 2)
    toks = np.random.default_rng(2).integers(0, lm.cfg.vocab, (2, 16))
    want = r["ServeEngine"](rlm, params).generate(
        {"tokens": r["jnp"].asarray(toks, r["jnp"].int32)}, n_new=6,
        max_len=32)
    got = ServeEngine(lm, device="cpu").generate({"tokens": toks}, n_new=6,
                                                 max_len=32)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    scale = max(1.0, float(np.abs(np.asarray(want.logits_last)).max()))
    np.testing.assert_allclose(got.logits_last, np.asarray(want.logits_last),
                               rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("arch", MIXED)
def test_serve_main_serves_each_family(arch):
    out = serve.main(["--device", "cpu", "--arch", arch, "--requests", "8",
                      "--n", "400"])
    assert out["arch"] == arch and out["generated"] == [4, 8]
    assert out["served"] == out["requests"] == out["non_empty"] == 8


@pytest.mark.parametrize("route", ["auto", "graph", "pruned", "flat"])
def test_serve_main_pins_the_route(route):
    """``--route`` sends both mask groups down one route; ``auto`` leaves
    the choice to the work-model router, which picks ``pruned`` here."""
    out = serve.main(["--device", "cpu", "--arch", "qwen3-moe-30b-a3b",
                      "--requests", "8", "--n", "400", "--route", route])
    assert out["route"] == route
    assert out["served"] == out["non_empty"] == 8
    taken = "pruned" if route == "auto" else route
    assert out["routes"] == {r: 2 if r == taken else 0
                             for r in ("graph", "pruned", "flat")}


def test_serve_engine_runs_on_cuda_by_default(monkeypatch):
    lm = LM(tcfg.get_smoke_config("olmo-1b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(torch.Generator().manual_seed(0))
    lm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(lm)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "2", "--n", "200"])


@pytest.mark.parametrize("mode", [[], ["--async"], ["--streaming", "--n", "400"],
                                  ["--shards", "4", "--n", "1200"]],
                         ids=["sync", "async", "streaming", "shards"])
def test_serve_main_serves_every_request(mode, capsys):
    out = serve.main(["--device", "cpu", "--requests", "12",
                      "--metrics-port", "0"] + mode)
    assert out["served"] == out["requests"] == 12
    assert out["non_empty"] == 12
    assert out["generated"] == [4, 8]
    text = capsys.readouterr().out
    assert "LM generate ok: (4, 8) tokens" in text and "metrics: http" in text
    if "--streaming" in mode:
        assert out["mutations"] == 6 and "compacted" in text


def test_float64_model_keeps_float64_and_agrees_with_float32():
    """A float64 copy of the weights runs in float64 throughout (its
    statistics and accumulations too) and agrees with the float32 model."""
    from repro_torch.models.params import map_tree
    cfg = tcfg.get_smoke_config("olmo-1b")
    lm32 = LM(cfg)
    lm32.init(torch.Generator().manual_seed(4), device="cpu")
    lm64 = LM(cfg.scaled(param_dtype="float64", activ_dtype="float64"))
    lm64.set_params(map_tree(lambda t: t.double(), lm32.params))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    l32, c32 = lm32.prefill(None, {"tokens": toks})
    l64, c64 = lm64.prefill(None, {"tokens": toks})
    assert l64.dtype == torch.float64 and c64[0]["L0"][0].dtype == \
        torch.float64
    scale = float(l64.abs().max())
    np.testing.assert_allclose(l32.numpy(), l64.numpy(), rtol=1e-4,
                               atol=1e-5 * max(1.0, scale))
    g32 = ServeEngine(lm32, device="cpu").generate({"tokens": toks}, n_new=4,
                                                   max_len=32)
    g64 = ServeEngine(lm64, device="cpu").generate({"tokens": toks}, n_new=4,
                                                   max_len=32)
    np.testing.assert_array_equal(g64.tokens, g32.tokens)
