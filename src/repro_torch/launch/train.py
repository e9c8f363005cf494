"""End-to-end training driver of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --preset 100m --steps 200 --batch 8 --seq 512

``--preset 100m`` rescales the arch to ~100M parameters in float32
(:func:`preset_100m`); ``--preset smoke`` takes the arch's smoke config,
``--preset full`` its published one. Trains on ``--device`` (the card by
default; ``cpu`` runs on the CPU) from seeded weights on
:class:`repro_torch.data.TokenLoader` batches, with AdamW (warmup 20),
checkpoints every ``--ckpt-every`` steps and at the end, ``--resume``
from the latest one, and the straggler watchdog.

:func:`main` takes an argument list and returns a summary dict, so a
program can drive it in-process.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config, get_smoke_config
from ..core.engine import resolve_device
from ..data import TokenLoader
from ..models import LM
from ..training import (AdamWConfig, StragglerWatchdog, TrainLoop,
                        adamw_init, make_train_step)


def preset_100m(cfg):
    """~100M-parameter variant of the same family, float32."""
    return cfg.scaled(
        n_layers=max(4, min(cfg.n_layers, 8)),
        d_model=512, n_heads=8,
        n_kv_heads=min(8, max(1, cfg.n_kv_heads)),
        head_dim=64, d_ff=2048,
        vocab=min(cfg.vocab, 32768),
        n_experts=min(cfg.n_experts, 16) if cfg.n_experts else 0,
        moe_d_ff=512 if cfg.n_experts else 0,
        lru_width=512 if cfg.lru_width else 0,
        q_lora_rank=128 if cfg.q_lora_rank else 0,
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        qk_nope_dim=32 if cfg.qk_nope_dim else 0,
        qk_rope_dim=16 if cfg.qk_rope_dim else 0,
        v_head_dim=32 if cfg.v_head_dim else 0,
        n_enc_layers=min(cfg.n_enc_layers, 4),
        frontend_dim=min(cfg.frontend_dim, 256) if cfg.frontend_dim else 0,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16),
        q_chunk=128, kv_chunk=128,
        param_dtype="float32", activ_dtype="float32")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' trains on the "
                         "CPU)")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = {"smoke": lambda: get_smoke_config(args.arch),
           "100m": lambda: preset_100m(get_config(args.arch)),
           "full": lambda: get_config(args.arch)}[args.preset]()
    lm = LM(cfg)
    print(f"arch={cfg.name} preset={args.preset} "
          f"params={lm.param_count() / 1e6:.1f}M device={dev}")
    loader = TokenLoader(vocab=cfg.vocab, batch=args.batch,
                         seq_len=args.seq, frontend=cfg.frontend,
                         n_frontend_tokens=cfg.n_frontend_tokens,
                         frontend_dim=cfg.frontend_dim, device=dev)
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=args.lr,
                                                   warmup_steps=20))
    ckpt = Checkpointer(os.path.join(args.ckpt_dir, cfg.name))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(gen, device=dev)
    opt = adamw_init(params)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start, _ = ckpt.restore({"params": params, "opt": opt})
        lm.set_params(state["params"])
        params, opt = lm.params, state["opt"]
        print(f"resumed from step {start}")
    loop = TrainLoop(lm, loader, step, checkpointer=ckpt,
                     ckpt_every=args.ckpt_every,
                     watchdog=StragglerWatchdog())
    params, opt, hist = loop.run(params, opt, start, args.steps)
    final = ckpt.save(start + args.steps, {"params": params, "opt": opt})
    ckpt.wait()
    print(f"final loss {hist[-1]:.4f} (start {hist[0]:.4f}); "
          f"straggler events: {len(loop.watchdog.events)}")
    return {"arch": cfg.name, "preset": args.preset, "device": str(dev),
            "params": lm.param_count(), "start_step": start,
            "steps": len(hist), "first_loss": hist[0], "last_loss": hist[-1],
            "losses": hist, "straggler_events": list(loop.watchdog.events),
            "checkpoint": final}


if __name__ == "__main__":
    main()
