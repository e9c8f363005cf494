"""Loss trajectories of the ``--preset 100m`` training run, port against
reference, on the CPU.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/train_100m_vs_reference.py \\
      --steps 30 [--out losses.json]

Three runs, each with the drivers' settings (olmo-1b rescaled by
``preset_100m``, ``TokenLoader`` batches of 8 x 256, AdamW at lr 1e-3
with 20 warmup steps):

- ``reference``: the reference's train step from the reference driver's
  init (``jax.random.key(0)``);
- ``port_same_init``: the port's train step from that same init, carried
  over with ``convert.lm_params_from_arrays``;
- ``port_driver``: ``repro_torch.launch.train.main`` itself (its own
  seeded torch init).

Prints each run's loss at every step, the mean of the first and of the
last five, and the largest relative gap between the first two runs. It is
not collected by pytest (a 30-step run takes minutes); the parity tests
hold single steps.
"""
import argparse
import json
import tempfile
import warnings

import numpy as np


def reference_run(steps: int, batch: int, seq: int):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax
        from repro.configs import get_config
        from repro.data import TokenLoader
        from repro.launch.train import preset_100m
        from repro.models.transformer import LM
        from repro.training import AdamWConfig, adamw_init, make_train_step
    lm = LM(preset_100m(get_config("olmo-1b")))
    params = lm.init(jax.random.key(0))
    init = jax.tree.map(np.asarray, params)
    loader = TokenLoader(vocab=lm.cfg.vocab, batch=batch, seq_len=seq)
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=20))
    opt = adamw_init(params)
    losses = []
    for i in range(steps):
        params, opt, m = step(params, opt, loader.batch_at(i))
        losses.append(float(m["loss"]))
    return init, losses


def port_run(init, steps: int, batch: int, seq: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.data import TokenLoader
    from repro_torch.launch.train import preset_100m
    from repro_torch.models import LM
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    lm = LM(preset_100m(get_config("olmo-1b")))
    params = lm_params_from_arrays(lm.cfg, init, device="cpu")
    loader = TokenLoader(vocab=lm.cfg.vocab, batch=batch, seq_len=seq)
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=20))
    opt = adamw_init(params)
    losses = []
    for i in range(steps):
        params, opt, m = step(params, opt, loader.batch_at(i))
        losses.append(float(m["loss"]))
    return losses


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    batch, seq = 8, 256                   # both drivers' defaults
    init, ref = reference_run(args.steps, batch, seq)
    same = port_run(init, args.steps, batch, seq)
    from repro_torch.launch.train import main as port_main
    with tempfile.TemporaryDirectory() as d:
        drv = port_main(["--preset", "100m", "--steps", str(args.steps),
                         "--device", "cpu", "--ckpt-dir", d])["losses"]
    runs = {"reference": ref, "port_same_init": same, "port_driver": drv}
    out = {name: {"losses": ls, "first5": float(np.mean(ls[:5])),
                  "last5": float(np.mean(ls[-5:]))}
           for name, ls in runs.items()}
    out["max_rel_gap_same_init"] = float(np.max(
        np.abs(np.array(same) - np.array(ref)) / np.abs(np.array(ref))))
    for name, ls in runs.items():
        print(name, " ".join(f"{x:.4f}" for x in ls))
    print(json.dumps({k: (v if not isinstance(v, dict) else
                          {"first5": v["first5"], "last5": v["last5"]})
                      for k, v in out.items()}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
