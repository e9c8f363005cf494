"""The port's training substrate (``repro_torch.training``: AdamW, the
global-norm clip, int8 gradient compression, ``make_train_step`` with and
without microbatches) against the reference's ``repro.training`` on the
CPU, and the reference's own checks of it (``tests/test_training.py``,
``tests/test_models.py::test_training_reduces_loss_tiny_lm``) run on the
port.

Tolerances: optimizer arithmetic on the same inputs within rtol 1e-6 (the
same float32 operations); int8 codes bit-equal; one ``make_train_step``
against the reference's within rtol 1e-4 and atol 1e-5 of each leaf's
scale (``test_torch_models._close``: a first AdamW step moves a weight by
lr x g / (|g| + eps), which float32 rounding of g moves by far less); the
reference test's own rtol 2e-4 / atol 2e-5 for microbatching. The
reference is imported inside a cached function with ``DeprecationWarning``
ignored there only.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.convert import (arrays_from_tree, lm_params_from_arrays,
                                 opt_state_from_arrays)
from repro_torch.data import TokenLoader
from repro_torch.models import LM
from repro_torch.models.params import leaves, map_tree
from repro_torch.training import (AdamWConfig, adamw_init, adamw_update,
                                  clip_by_global_norm, compressed_grad_sync,
                                  compressed_mean, dequantize_int8,
                                  global_norm, init_residuals,
                                  make_train_step, quantize_int8)

from test_torch_models import _close
from test_torch_train_loss import ref_params
from test_torch_train_loss import one_torch_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        import jax.numpy as jnp
        from repro import configs
        from repro.data import TokenLoader as RTokenLoader
        from repro.models.transformer import LM as RLM
        from repro import training
        from repro.training import grad_compression, optimizer
    return dict(jax=jax, jnp=jnp, configs=configs, TokenLoader=RTokenLoader,
                LM=RLM, training=training, optimizer=optimizer,
                grad_compression=grad_compression)


def _tree(seed: int):
    """A small parameter-like tree: matrices (decayed), a vector (not), a
    stacked leaf, float32."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (4, 6)).astype(np.float32),
            "b": rng.normal(0, 1, (6,)).astype(np.float32),
            "stack": [rng.normal(0, 1, (2, 3, 5)).astype(np.float32)]}


def _t(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


def test_adamw_first_step_is_lr_sized():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.0)
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 0.5)}
    before = params["w"].clone()
    state = adamw_init(params)
    new, state = adamw_update(cfg, params, grads, state)
    # the bias-corrected first Adam step is lr x sign(g)
    np.testing.assert_allclose((before - new["w"]).numpy(), 1e-2, rtol=1e-3)
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    assert new["w"] is params["w"]                  # updated in place


def test_adamw_steps_equal_reference():
    """Three AdamW steps (warmup, weight decay on matrices only, bias
    corrections) on float32 leaves, and on bfloat16 parameters with
    float32 moments: parameters, m, v and step against the reference's."""
    r = _ref()
    jax, jnp, opt = r["jax"], r["jnp"], r["optimizer"]
    cfg = AdamWConfig(lr=3e-3, warmup_steps=2, weight_decay=0.1)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        p0 = _tree(0)
        rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdtype), p0)
        rs = opt.adamw_init(rp)
        tp = map_tree(lambda a: torch.from_numpy(a).to(dtype), p0)
        ts = adamw_init(tp)
        for step in range(3):
            g = _tree(10 + step)
            rp, rs = opt.adamw_update(cfg, rp, jax.tree.map(
                lambda a: jnp.asarray(a).astype(jdtype), g), rs)
            tp, ts = adamw_update(cfg, tp, map_tree(
                lambda a: torch.from_numpy(a).to(dtype), g), ts)
        assert int(ts["step"]) == int(rs["step"]) == 3
        for got, want in ((tp, rp), (ts["m"], rs["m"]), (ts["v"], rs["v"])):
            for a, b in zip(leaves(got), jax.tree.leaves(want)):
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
                np.testing.assert_allclose(a.to(torch.float32).numpy(),
                                           np.asarray(b, np.float32),
                                           rtol=1e-6, atol=1e-7)


def test_grad_clip():
    tree = {"a": torch.full((10,), 10.0)}
    clipped, gn = clip_by_global_norm(tree, 1.0)
    assert float(gn) > 1.0
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_grad_clip_equals_reference(max_norm):
    """The clip on and off, float32 and bfloat16 leaves keeping their
    dtypes."""
    r = _ref()
    jax, jnp, opt = r["jax"], r["jnp"], r["optimizer"]
    g = _tree(3)
    rg = dict(jax.tree.map(jnp.asarray, g), b=jnp.asarray(g["b"]).astype(
        jnp.bfloat16))
    tg = dict(_t(g), b=torch.from_numpy(g["b"]).to(torch.bfloat16))
    (want, wn), (got, gn) = (opt.clip_by_global_norm(rg, max_norm),
                             clip_by_global_norm(tg, max_norm))
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_allclose(a.to(torch.float32).numpy(),
                                   np.asarray(b, np.float32), rtol=1e-6)


def test_quantize_roundtrip_error_bounded_and_equals_reference():
    r = _ref()
    gc = r["grad_compression"]
    x = np.random.default_rng(0).normal(0, 1, (256,)).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    err = (dequantize_int8(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) * 0.51 + 1e-6
    wq, ws = gc.quantize_int8(r["jnp"].asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert float(s) == float(ws)


def test_compressed_sync_single_rank_equals_reference_shard_map():
    """16 error-feedback syncs of one gradient: the port's one-rank path
    against the reference's jitted ``shard_map`` over a one-device axis,
    means and residuals at rtol 1e-6 and atol 1e-6 (a residual is a
    difference of values up to |g| ~ 3, whose float32 spacing is 2.4e-7,
    and XLA may fuse its products); the mean of the 16 syncs is the
    gradient (error feedback cancels the bias), as the reference test
    holds."""
    r = _ref()
    jax, jnp, gc = r["jax"], r["jnp"], r["grad_compression"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax.experimental.shard_map as shm
        from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    g = np.random.default_rng(1).normal(0, 1, (64,)).astype(np.float32)

    def run(gw, rw):
        out, nr = gc.compressed_grad_sync({"w": gw}, "data", {"w": rw})
        return out["w"], nr["w"]

    f = jax.jit(shm.shard_map(run, mesh=mesh, in_specs=(P(), P()),
                              out_specs=(P(), P()), check_rep=False))
    rr = jnp.zeros_like(jnp.asarray(g))
    tr = init_residuals({"w": torch.from_numpy(g)})
    acc = torch.zeros(64)
    for _ in range(16):
        wo, rr = f(jnp.asarray(g), rr)
        out, tr = compressed_grad_sync({"w": torch.from_numpy(g)}, None, tr)
        np.testing.assert_allclose(out["w"].numpy(), np.asarray(wo),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tr["w"].numpy(), np.asarray(rr),
                                   rtol=1e-6, atol=1e-6)
        acc += out["w"]
    np.testing.assert_allclose((acc / 16).numpy(), g, atol=0.02)


def test_compressed_mean_refuses_more_than_one_rank():
    """Over several ranks ``compressed_mean`` reduces over an axis of a
    mesh of ranks (``tests/test_torch_mesh_train.py`` holds it to the
    reference's); an axis without its mesh, or of a logical mesh of two
    shards, which has no ranks to reduce over, raises."""
    from repro_torch.launch import make_mesh
    x = torch.ones(4)
    with pytest.raises(ValueError, match="needs its mesh"):
        compressed_mean(x, "data", torch.zeros(4))
    logical = make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="logical mesh"):
        compressed_mean(x, "data", torch.zeros(4), mesh=logical)


def test_compressed_mean_over_one_rank_is_its_own_quantized_value():
    """No axis is this rank alone: the mean is its codes times its own
    scale, the residual what they lost; a mesh without an axis is the
    same."""
    from repro_torch.launch import make_mesh
    x = torch.tensor([1.0, -0.5, 0.25, 2.0])
    r = torch.tensor([0.0, 0.01, 0.0, -0.02])
    q, s = quantize_int8(x + r)
    want = dequantize_int8(q, s)
    for mesh in (None, make_mesh((2,), ("data",), device="cpu")):
        m, nr = compressed_mean(x, None, r, mesh=mesh)
        assert torch.equal(m, want)
        assert torch.equal(nr, x + r - want)


def _tiny(arch="olmo-1b", **kw):
    return tcfg.get_smoke_config(arch).scaled(n_layers=2, vocab=64, **kw)


def _state_close(got, want, rtol, what):
    """Each optimizer-state leaf within ``rtol`` of ``want`` and ``rtol``
    of the leaf's own largest magnitude: ``m`` and ``v`` leaves are ~1e-2
    to ~1e-8 after one step, so an absolute floor would hide them."""
    for i, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * float(np.abs(b).max()),
                                   err_msg=f"{what} leaf {i}")


def test_microbatch_equals_full_batch():
    """The reference test on the port (rtol 2e-4, atol 2e-5 on the
    parameters), and what carries the accumulated gradient: ``grad_norm``
    before the clip, ``m`` (0.1 g after one step) and ``v`` (1e-3 g^2).
    Four microbatches against one within rtol 1e-5 (the same float32
    gradients summed in another order: 1.2e-6 of a leaf's scale at worst);
    the port's four against the reference's four within rtol 1e-5 for
    ``grad_norm`` and 1e-4 of each ``m`` / ``v`` element and its leaf's
    scale (the jitted reference's forward rounds elementwise gradients
    differently: 1.7e-5 of the scale at worst). A step that skipped the
    division by the count moves ``grad_norm`` 4x; one that kept a single
    microbatch moves ``m``."""
    r = _ref()
    jax = r["jax"]
    rcfg = r["configs"].get_smoke_config("olmo-1b").scaled(n_layers=2,
                                                           vocab=64)
    rlm = r["LM"](rcfg)
    rparams = rlm.init(jax.random.key(0))
    batch = TokenLoader(vocab=64, batch=8, seq_len=32, seed=2).batch_at(0)
    lm = LM(_tiny())
    host = jax.tree.map(np.asarray, rparams)
    out = {}
    for n in (1, 4):
        p = lm_params_from_arrays(lm.cfg, host, device="cpu")
        step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3),
                               microbatches=n)
        out[n] = step(p, adamw_init(p), batch)
    for a, b in zip(leaves(out[1][0]), leaves(out[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_allclose(float(out[4][2]["grad_norm"]),
                               float(out[1][2]["grad_norm"]), rtol=1e-5)
    for k in ("m", "v"):
        _state_close(out[4][1][k], out[1][1][k], 1e-5, f"microbatches {k}")
    rstep = r["training"].make_train_step(
        rlm, opt_cfg=r["training"].AdamWConfig(lr=1e-3), microbatches=4)
    rb = {k: r["jnp"].asarray(v.numpy()) for k, v in batch.items()}
    wp, wo, wm = rstep(rparams, r["training"].adamw_init(rparams), rb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[4][2][k]), float(wm[k]),
                                   rtol=1e-5, err_msg=k)
    for a, b in zip(leaves(out[4][0]), jax.tree.leaves(wp)):
        _close(a.numpy(), np.asarray(b), "microbatched step")
    for k in ("m", "v"):
        _state_close(out[4][1][k], jax.tree.map(np.asarray, wo[k]), 1e-4,
                     f"microbatched step {k}")
    # the accumulated gradients are float32 in a float32 model too
    assert all(m.dtype == torch.float32 for m in leaves(out[4][1]["m"]))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b"])
def test_train_step_equals_reference(arch):
    """One ``make_train_step`` from one state (the reference's weights and
    a reference optimizer state two steps in, carried with ``convert``):
    the metrics, and every updated parameter, ``m`` and ``v`` leaf and the
    step, against the reference's jitted step."""
    r = _ref()
    jax, jnp, tr = r["jax"], r["jnp"], r["training"]
    rlm, params = ref_params(arch)
    ocfg = tr.AdamWConfig(lr=1e-3, warmup_steps=20)
    rstep = tr.make_train_step(rlm, opt_cfg=ocfg)
    loader = r["TokenLoader"](vocab=rlm.cfg.vocab, batch=2, seq_len=32,
                              seed=1)
    opt = tr.adamw_init(params)
    for i in range(2):
        params, opt, _ = rstep(params, opt, loader.batch_at(i))
    host_p = jax.tree.map(np.asarray, params)
    host_o = jax.tree.map(np.asarray, opt)
    wp, wo, wm = rstep(params, opt, loader.batch_at(2))

    lm = LM(tcfg.get_smoke_config(arch))
    tp = lm_params_from_arrays(lm.cfg, host_p, device="cpu")
    to = opt_state_from_arrays(lm.cfg, host_o, device="cpu")
    tb = {k: torch.from_numpy(np.array(v))
          for k, v in loader.batch_at(2).items()}
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3,
                                                   warmup_steps=20))
    gp, go, gm = step(tp, to, tb)
    for k in ("loss", "grad_norm", "xent", "aux"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert int(go["step"]) == int(wo["step"]) == 3
    got = arrays_from_tree({"params": gp, "m": go["m"], "v": go["v"]})
    want = {"params": wp, "m": wo["m"], "v": wo["v"]}
    for part in got:
        for a, b in zip(jax.tree.leaves(got[part]),
                        jax.tree.leaves(want[part])):
            _close(a, np.asarray(b), f"{arch} {part}")


def test_training_reduces_loss_tiny_lm():
    """The reference's end-to-end check on the port: 40 steps on a tiny
    olmo reduce the loss below 0.7 of its start."""
    lm = LM(_tiny())
    params = lm.init(torch.Generator().manual_seed(7), device="cpu")
    loader = TokenLoader(vocab=64, batch=4, seq_len=32, seed=1)
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=3e-3,
                                                   warmup_steps=10))
    opt = adamw_init(params)
    losses = []
    for i in range(40):
        params, opt, m = step(params, opt, loader.batch_at(i % 4))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), \
        losses[:3] + losses[-3:]
    # the model's registered parameters are the ones trained
    assert lm.params["embed"]["table"] is params["embed"]["table"]


def test_h100_bfloat16_peak_is_the_data_sheets():
    """The training line's `mfu` divides by this peak (dense bfloat16 on
    the tensor cores, NVIDIA's H100 SXM data sheet)."""
    from repro_torch.obs.profile import PEAKS
    assert PEAKS["NVIDIA H100 80GB HBM3"].bf16_flop_per_s == 989e12
