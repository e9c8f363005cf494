"""The port's training loss (``repro_torch.models``: ``LM.train_loss``,
``chunked_softmax_xent``, attention and MLA in ``mode="train"``, the MoE's
load-balance aux, per-unit rematerialisation) against the reference's
``jax.value_and_grad(LM.train_loss)`` on the CPU, for the dense and MoE
smoke configs; the recurrent, MLA and front-end configs are in
``test_torch_train_loss_families.py``.

Both sides start from the reference's weights, carried with
``repro_torch.convert.lm_params_from_arrays``, and take the same
``TokenLoader`` batch (B = 2, S = 32). Tolerances: the loss and its
metrics within 1e-5 relative; every gradient leaf within rtol 1e-4 and
atol 1e-5 of the leaf's own scale (``test_torch_models._close``). The
reference's init draws every ``wq`` at 1/sqrt(n_heads), and at the smoke
widths its attention scores then sit near the softmax's corners, where a
1e-7 relative change of the weights moves the gradients past that
tolerance in either implementation
(``test_torch_train_loss_families.py::test_grad_parity_weights_keep_rounding_inside_the_tolerance``);
RWKV-6's gradients are as sensitive through its value, gate and output
projections. So the leaves named in ``CONDITIONING`` are scaled before the
weights are carried (``wq`` and MLA's ``w_uq`` by 0.1, RWKV-6's ``w_v``,
``w_g`` and ``w_o`` by 0.25), as ``test_torch_frontends.py`` scales ``wq`` for
the forward; both sides get the same weights. The reference is imported
inside a cached function with ``DeprecationWarning`` ignored there only.
"""
import dataclasses
import functools
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.models.common import chunked_softmax_xent
from repro_torch.models.params import leaves
from repro_torch.training import loss_and_grads

from test_torch_models import _close

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card's smoke checks scale the same)

CONDITIONING = chip_smoke.TRAIN_CONDITIONING
LOSS_RTOL = 1e-5
B, S = 2, 32
ARCHS = ("olmo-1b", "gemma3-1b", "qwen3-32b", "qwen1.5-110b",
         "qwen3-moe-30b-a3b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The training tests run tiny products, where torch's intra-op
    threads only spin: under xdist, with one worker a core, they take the
    cores other test files time themselves against. One thread per module
    here, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        import jax.numpy as jnp
        from repro import configs
        from repro.data import TokenLoader
        from repro.models import attention, common
        from repro.models.transformer import LM as RLM
    return dict(jax=jax, jnp=jnp, configs=configs, TokenLoader=TokenLoader,
                attention=attention, common=common, LM=RLM)


def ref_params(arch: str, scales=None, seed: int = 0):
    """(reference LM, its params with each leaf named in ``scales``
    (``CONDITIONING`` by default) times its factor)."""
    r = _ref()
    jax = r["jax"]
    scales = CONDITIONING if scales is None else scales
    rlm = r["LM"](r["configs"].get_smoke_config(arch))
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * scales.get(path[-1].key, 1.0),
        rlm.init(jax.random.key(seed)))
    return rlm, params


def ref_batch(cfg, batch: int = B, seq: int = S, step: int = 0):
    """The reference loader's batch ``step`` (seed 1) for ``cfg``."""
    loader = _ref()["TokenLoader"](
        vocab=cfg.vocab, batch=batch, seq_len=seq, seed=1,
        frontend=cfg.frontend, n_frontend_tokens=cfg.n_frontend_tokens,
        frontend_dim=cfg.frontend_dim)
    return loader.batch_at(step)


def port_lm(arch: str, params, cfg=None):
    """A port LM for ``arch`` (or ``cfg``) holding the reference's
    ``params``, and their port tree."""
    lm = LM(cfg or tcfg.get_smoke_config(arch))
    tree = lm_params_from_arrays(
        lm.cfg, _ref()["jax"].tree.map(np.asarray, params), device="cpu")
    lm.set_params(tree)
    return lm


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference_case(arch: str):
    """The reference's (loss, metrics, gradient leaves) as numpy, its
    params and batch."""
    r = _ref()
    rlm, params = ref_params(arch)
    batch = ref_batch(rlm.cfg)
    (loss, met), grads = r["jax"].value_and_grad(
        rlm.train_loss, has_aux=True)(params, batch)
    return (float(loss), {k: float(v) for k, v in met.items()},
            [np.asarray(g) for g in r["jax"].tree.leaves(grads)],
            params, batch)


def assert_train_loss_equal_reference(arch: str):
    want_loss, want_met, want_grads, params, batch = reference_case(arch)
    lm = port_lm(arch, params)
    loss, met, grads = loss_and_grads(lm, lm.params, to_torch(batch))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert sorted(met) == sorted(want_met)
    for k in want_met:
        np.testing.assert_allclose(float(met[k]), want_met[k],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    got = leaves(grads)
    assert len(got) == len(want_grads)
    for i, (g, w) in enumerate(zip(got, want_grads)):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w, f"{arch} grad leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_equal_reference(arch):
    assert_train_loss_equal_reference(arch)


def test_moe_aux_reaches_the_loss_and_the_router():
    """qwen3-moe's loss is xent + 0.01 aux, and the aux is the mean over
    the MoE layers' switch losses, so the router's gradient carries it."""
    _, want_met, _, params, batch = reference_case("qwen3-moe-30b-a3b")
    lm = port_lm("qwen3-moe-30b-a3b", params)
    loss, met, grads = loss_and_grads(lm, lm.params, to_torch(batch))
    assert float(met["aux"]) > 0
    np.testing.assert_allclose(float(loss), float(met["xent"])
                               + 0.01 * float(met["aux"]), rtol=1e-6)
    routers = [g["mlp"]["router"] for seg in grads["segments"]
               for g in seg.values() if "router" in g["mlp"]]
    assert routers and all(float(r.abs().max()) > 0 for r in routers)
    # the routing bias only picks experts: no gradient reaches it
    assert all(float(g["mlp"]["bias"].abs().max()) == 0
               for seg in grads["segments"] for g in seg.values()
               if "bias" in g["mlp"])


@pytest.mark.parametrize("S_,chunk", [(37, 16), (32, 512), (16, 16)])
def test_chunked_softmax_xent_equals_reference(S_, chunk):
    """Full chunks and a remainder chunk, masked positions, the gradient
    through the logits; rtol 1e-5."""
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    rng = np.random.default_rng(S_)
    x = rng.normal(0, 1, (2, S_, 8)).astype(np.float32)
    w = rng.normal(0, 1, (8, 50)).astype(np.float32)
    lab = rng.integers(0, 50, (2, S_)).astype(np.int32)
    mask = (rng.random((2, S_)) < 0.8).astype(np.float32)

    def ref_loss(xx):
        return r["common"].chunked_softmax_xent(
            lambda xc: xc @ jnp.asarray(w), xx, jnp.asarray(lab),
            jnp.asarray(mask), chunk=chunk)

    (want, want_cnt), want_g = jax.value_and_grad(ref_loss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, cnt = chunked_softmax_xent(lambda xc: xc @ torch.from_numpy(w), xt,
                                    torch.from_numpy(lab),
                                    torch.from_numpy(mask), chunk=chunk)
    (g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(cnt) == float(want_cnt)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, None, None), (True, 7, None), (False, None, 30)])
def test_flash_attention_grads_equal_reference(causal, window, kv_len):
    """The port's training attention skips the blocks a q chunk cannot see;
    the reference's visits and masks them all. Output and the gradients
    of q, k, v agree at rtol 1e-5 (Sq = Skv = 37, chunks of 16: padded q
    rows and kv entries)."""
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(0, 1, (2, 37, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    cot = rng.normal(0, 1, (2, 37, 4, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=16,
              kv_len=kv_len)

    def ref(qq, kk, vv):
        out = r["attention"].flash_attention(qq, kk, vv, block_skip=False,
                                             **kw)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), want_g = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn.flash_attention(*ts, **kw)
    got_g = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_remat_gives_the_same_loss_and_grads():
    """``cfg.remat`` recomputes each stacked unit in the backward pass; the
    loss and every gradient are bit-equal to keeping the activations."""
    _, _, _, params, batch = reference_case("olmo-1b")
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg.get_smoke_config("olmo-1b"),
                                  remat=remat)
        lm = port_lm("olmo-1b", params, cfg)
        assert any(seg.repeats > 1 for seg in lm.layout)
        out.append(loss_and_grads(lm, lm.params, to_torch(batch)))
    (l1, _, g1), (l2, _, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
