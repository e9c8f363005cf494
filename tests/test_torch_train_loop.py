"""The port's data cursor, checkpoints, train loop and training driver
(``repro_torch.data.TokenLoader``, ``repro_torch.checkpoint.Checkpointer``,
``repro_torch.training.TrainLoop`` / ``StragglerWatchdog``,
``repro_torch.launch.train``) against the reference's on the CPU.

The loader's batches are bit-equal to the reference's; a checkpoint
written by either package restores bit-equal in the other (float32 and
int32 leaves; numpy has no bfloat16 of its own, so the port's bfloat16
round trip is held in the port, and against a leaf ``np.save`` wrote
from ``ml_dtypes``); a resumed ``TrainLoop`` is bit-equal to an unbroken
one. No test reads the wall clock. The reference is imported inside a
cached function with ``DeprecationWarning`` ignored there only.
"""
import functools
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import TokenLoader
from repro_torch.launch import train
from repro_torch.models import LM
from repro_torch.models.params import leaves, map_tree
from repro_torch.training import (AdamWConfig, StragglerWatchdog, TrainLoop,
                                  adamw_init, make_train_step)

from test_torch_train_loss import one_torch_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        import jax.numpy as jnp
        from repro.checkpoint import Checkpointer as RCheckpointer
        from repro.data import TokenLoader as RTokenLoader
    return dict(jax=jax, jnp=jnp, Checkpointer=RCheckpointer,
                TokenLoader=RTokenLoader)


@pytest.mark.parametrize("frontend,n_tok,dim", [
    (None, 0, 0), ("vision_stub", 5, 12), ("audio_stub", 0, 7)])
def test_token_loader_batches_equal_reference(frontend, n_tok, dim):
    kw = dict(vocab=97, batch=3, seq_len=19, seed=4, frontend=frontend,
              n_frontend_tokens=n_tok, frontend_dim=dim)
    ref = _ref()["TokenLoader"](**kw)
    port = TokenLoader(**kw)
    for step in (0, 1, 170):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert port.batch_at(0)["tokens"].dtype == torch.int32


def _state(seed: int = 0):
    """A params-and-optimizer-shaped tree: dict keys out of sorted order,
    a list, an int32 scalar step."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    params = {"segments": [{"L0": {"wq": f(2, 3, 4), "norm": f(4)}}],
              "embed": {"table": f(5, 4)}}
    return {"params": params,
            "opt": {"m": map_tree(lambda a: a * 0.1, params),
                    "v": map_tree(lambda a: a * a, params),
                    "step": np.asarray(7, np.int32)}}


def _torch(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


def test_checkpoint_written_by_either_package_restores_in_the_other(tmp_path):
    r = _ref()
    jax, jnp = r["jax"], r["jnp"]
    state = _state()
    # the port writes, the reference restores
    pw = Checkpointer(str(tmp_path / "a"))
    pw.save(3, _torch(state), {"cursor": 3})
    pw.wait()
    rc = r["Checkpointer"](str(tmp_path / "a"))
    got, step, extra = rc.restore(jax.tree.map(jnp.asarray, state))
    assert step == 3 and extra == {"cursor": 3}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the reference writes, the port restores
    rw = r["Checkpointer"](str(tmp_path / "b"), async_write=False)
    rw.save(5, jax.tree.map(jnp.asarray, state), {"cursor": 5})
    got, step, extra = Checkpointer(str(tmp_path / "b")).restore(
        _torch(state))
    assert step == 5 and extra == {"cursor": 5}
    for a, b in zip(leaves(got), leaves(state)):
        assert torch.is_tensor(a)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    # the same files and manifest entries
    man = lambda d: json.load(open(os.path.join(d, "manifest.json")))
    a = man(str(tmp_path / "a" / "step_00000003"))
    b = man(str(tmp_path / "b" / "step_00000005"))
    assert a["leaves"] == b["leaves"]
    assert "params/segments/0/L0/wq" in [x["name"] for x in a["leaves"]]


def test_bfloat16_leaves_round_trip_bit_equal(tmp_path):
    """A bfloat16 leaf is written as its raw 2-byte words (type ``V2``,
    what ``np.save`` writes for ml_dtypes' bfloat16) with ``bfloat16`` in
    the manifest; it comes back bit-equal, from the port's file and from
    one ``np.save`` wrote from an ``ml_dtypes`` array."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    ck = Checkpointer(str(tmp_path), async_write=False)
    d = ck.save(1, {"w": x, "f": x.to(torch.float32)})
    info = {l["name"]: l for l in json.load(
        open(os.path.join(d, "manifest.json")))["leaves"]}
    assert info["w"]["dtype"] == "bfloat16" and info["w"]["shape"] == [3, 5]
    assert np.load(os.path.join(d, "w.npy")).dtype.kind == "V"
    got, _, _ = ck.restore({"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                            "f": torch.zeros(3, 5)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
    ml_dtypes = pytest.importorskip("ml_dtypes")
    np.save(os.path.join(d, "w.npy"),
            x.to(torch.float32).numpy().astype(ml_dtypes.bfloat16))
    got, _, _ = ck.restore({"w": x, "f": x})
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))


def test_checkpointer_keeps_the_last_and_copies_before_writing(tmp_path):
    """``keep`` steps survive, a ``.tmp`` directory is no step, and a
    leaf changed right after ``save`` is written as it was."""
    ck = Checkpointer(str(tmp_path), keep=2)
    t = {"w": torch.zeros(1000)}
    for s in range(1, 5):
        ck.save(s, t)
        t["w"].add_(1.0)                        # the caller goes on at once
    ck.wait()
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ck.list_steps() == [3, 4] and ck.latest_step() == 4
    got, step, _ = ck.restore({"w": torch.zeros(1000)})
    assert step == 4 and float(got["w"].max()) == float(got["w"].min()) == 3
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "none")).restore(t)


def test_restore_puts_each_leaf_on_its_example_s_device(tmp_path):
    """A restored leaf goes to the device of the example's tensor at its
    path (the ``meta`` device stands in for a card here) and to the CPU
    where the example holds no tensor; the file's dtype is kept."""
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(2, {"a": torch.arange(6.0).reshape(2, 3),
                "b": torch.ones(4, dtype=torch.int32)})
    got, step, _ = ck.restore({"a": torch.zeros(2, 3, device="meta"),
                               "b": np.zeros(4, np.int32)})
    assert step == 2
    assert got["a"].device.type == "meta" and got["a"].shape == (2, 3)
    assert got["b"].device.type == "cpu" and got["b"].dtype == torch.int32
    np.testing.assert_array_equal(got["b"].numpy(), 1)


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(factor=3.0)
    times = [1.0, 1.1, 0.9, 1.0, 1.0, 5.0, 1.0, 2.9, 3.5]
    flags = [wd.observe(i, t) for i, t in enumerate(times)]
    assert flags == [False] * 5 + [True, False, False, True]
    assert [e[0] for e in wd.events] == [5, 8]
    assert wd.events[0][2] == 1.0                  # the running median
    assert not StragglerWatchdog().observe(0, 100.0)   # needs 5 first


def test_train_loop_resume_is_bit_equal(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, a fresh restore
    and 2 more: parameters and optimizer state bit-equal."""
    cfg = tcfg.get_smoke_config("olmo-1b").scaled(n_layers=2, vocab=64)
    lm = LM(cfg)
    loader = TokenLoader(vocab=64, batch=2, seq_len=16, seed=3)
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2))

    def fresh():
        p = lm.init(torch.Generator().manual_seed(1), device="cpu")
        return map_tree(lambda t: t.detach().clone(), p)

    p_a = fresh()
    p_a, o_a, h_a = TrainLoop(lm, loader, step).run(p_a, adamw_init(p_a),
                                                    0, 4, log_every=0)
    ck = Checkpointer(str(tmp_path), async_write=True)
    p_b = fresh()
    p_b, o_b, h_1 = TrainLoop(lm, loader, step, checkpointer=ck,
                              ckpt_every=2).run(p_b, adamw_init(p_b), 0, 2,
                                                log_every=0)
    ck.wait()
    del p_b, o_b
    p_c = fresh()
    state, start, _ = Checkpointer(str(tmp_path)).restore(
        {"params": p_c, "opt": adamw_init(p_c)})
    assert start == 2
    p_c, o_c, h_2 = TrainLoop(lm, loader, step).run(
        state["params"], state["opt"], start, 2, log_every=0)
    assert h_1 + h_2 == h_a
    assert int(o_c["step"]) == int(o_a["step"]) == 4
    for a, b in zip(leaves({"p": p_a, "o": o_a}), leaves({"p": p_c,
                                                          "o": o_c})):
        assert torch.equal(a, b)


def test_train_driver_on_cpu(tmp_path, capsys):
    """``launch.train.main`` on the smoke preset: it trains, checkpoints,
    and resumes from its last checkpoint; without ``--device`` and
    without a card it raises."""
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    res = train.main(argv)
    assert res["arch"] == "olmo-1b" and res["device"] == "cpu"
    assert res["steps"] == 3 and len(res["losses"]) == 3
    assert all(np.isfinite(res["losses"]))
    assert res["first_loss"] == res["losses"][0]
    assert os.path.isdir(res["checkpoint"])
    ck = Checkpointer(os.path.join(str(tmp_path), "olmo-1b"))
    assert ck.latest_step() == 3
    again = train.main(argv + ["--resume", "--steps", "1"])
    assert again["start_step"] == 3 and again["steps"] == 1
    assert "resumed from step 3" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--steps", "1"])


def test_preset_100m_equals_reference():
    from repro_torch.launch.train import preset_100m
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro import configs
        from repro.launch.train import preset_100m as ref_preset
    import dataclasses
    for arch in tcfg.ARCH_NAMES:
        assert dataclasses.asdict(preset_100m(tcfg.get_config(arch))) == \
            dataclasses.asdict(ref_preset(configs.get_config(arch)))
