"""Roofline terms of each (arch x shape) cell on the single-pod mesh, from
the dry-run's records (:mod:`repro_torch.launch.dryrun`), against the
published peaks of a named card (:data:`repro_torch.obs.profile.PEAKS`):

    compute    = flops_per_device / the card's bfloat16 tensor-core peak
    memory     = analytic_memory_bytes / the card's HBM rate
    memory_hlo = bytes_per_device / the card's HBM rate (unfused bound)
    collective = collective operand bytes a rank / the card's NVLink
                 rate each way

The port of the reference's ``repro.launch.roofline``, which prices XLA's
costs against TPU v5e constants and re-measures each segment because XLA
costs a scan body once. The port's dry-run counts every layer, so the
record's ``corrected`` is what was counted (``hlo``), and no scan
correction runs; ``segment_repeats`` is kept. :func:`model_flops`,
:func:`analytic_memory_bytes` and :func:`_cache_bytes` are the
reference's formulas. No card is needed; a card not in ``PEAKS`` is
refused.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--arch A]
       [--shape S] [--card NAME] [--markdown]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Iterable, Optional

from ..configs import ALL_SHAPES, ARCH_NAMES, SHAPES_BY_NAME, get_config
from ..models import params as pr
from ..models.transformer import LM
from ..obs.profile import PEAKS, DevicePeaks
from .dryrun import ARTIFACT_DIR

ROOF_DIR = os.environ.get(
    "ROOFLINE_TORCH_ARTIFACTS",
    os.path.join(os.path.dirname(ARTIFACT_DIR), "roofline_torch"))

DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def card_peaks(card: str = DEFAULT_CARD) -> DevicePeaks:
    """The published peaks of ``card``; ``KeyError`` for a card not in
    ``PEAKS`` (no other card's peaks stand in)."""
    if card not in PEAKS:
        raise KeyError(f"no published peaks for {card!r} in "
                       f"repro_torch.obs.profile.PEAKS ({sorted(PEAKS)})")
    return PEAKS[card]


def analytic_memory_bytes(cfg, lm: LM, shape, mesh_shape) -> float:
    """First-principles per-device HBM traffic estimate (the reference's,
    documented ±2x): weight reads (after the FSDP gather, so TP-sharded
    only; x3 for forward, backward and remat in training), optimizer and
    gradient traffic on the fully sharded copies, a per-layer activation
    constant, logits chunks, and the KV cache in serving."""
    dp = int(math.prod([v for k, v in mesh_shape.items() if k != "model"]))
    mp = int(mesh_shape.get("model", 1))
    devices = dp * mp
    pb = cfg.pdtype.itemsize
    ab = cfg.adtype.itemsize
    n_params = lm.param_count()
    n_active = lm.active_param_count()
    P_tp = n_params * pb / mp          # per-device weight bytes after gather
    P_dev = n_params * pb / devices    # fully-sharded (FSDP) weight bytes
    B_loc = max(shape.global_batch // dp, 1)
    L = cfg.n_layers + cfg.n_enc_layers
    D = cfg.d_model
    F = (cfg.top_k * cfg.moe_d_ff + cfg.n_shared_experts * cfg.moe_d_ff
         if cfg.n_experts else cfg.d_ff)

    if shape.kind == "train":
        T = B_loc * shape.seq_len
        w = 3 * P_tp + (1 + 4 * 4 / pb) * P_dev * 2
        acts = L * T * ab * (10 * D + 6 * F / max(mp, 1))
        logits = 4 * T * (cfg.vocab / mp) * 4
        return w + acts + logits
    if shape.kind == "prefill":
        T = B_loc * shape.seq_len
        w = P_tp
        acts = L * T * ab * (6 * D + 3 * F / max(mp, 1))
        cache = _cache_bytes(lm, shape, devices)
        return w + acts + cache
    # decode: weights read once per step (a batch touches ~all experts) +
    # the whole resident cache; experts shard over the full mesh at serve
    # time when divisible (SERVE_RULES)
    del n_active
    if cfg.n_experts:
        moe_layers = sum(1 for d in lm.descs if d.mlp == "moe")
        expert_params = (moe_layers * cfg.n_experts * 3 * cfg.d_model
                         * cfg.moe_d_ff)
        ep = devices if cfg.n_experts % devices == 0 else mp
        w = (n_params - expert_params) * pb / mp + expert_params * pb / ep
    else:
        w = P_tp
    return w + _cache_bytes(lm, shape, devices)


def _cache_bytes(lm: LM, shape, devices: int) -> float:
    """The decode caches' bytes over ``devices`` (the reference's layout
    splits them, and so does the port's serving on a mesh)."""
    n_front = (lm.cfg.n_frontend_tokens
               if lm.cfg.frontend == "vision_stub" else 0)
    enc_len = shape.seq_len if lm.cfg.n_enc_layers else 0
    metas = lm.decode_cache_meta(shape.global_batch, shape.seq_len + n_front,
                                 enc_len)
    total = 0
    for seg in metas:
        for s in pr.leaves(seg):
            total += int(math.prod(s.shape)) * s.dtype.itemsize
    return total / devices


def model_flops(cfg, lm: LM, shape, devices: int) -> float:
    """Per-device MODEL_FLOPS: 6·N·D for training, 2·N_active·D for
    serving."""
    n_active = lm.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / devices
    tokens = shape.global_batch  # one token per sequence per step
    return 2.0 * n_active * tokens / devices


def analyze_cell(arch: str, shape_name: str, artifact_dir: str,
                 out_dir: str, force: bool = False,
                 card: str = DEFAULT_CARD) -> Optional[dict]:
    """The roofline record of one cell from its single-pod dry-run record
    (None where there is none), written to ``out_dir``."""
    peaks = card_peaks(card)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    cell_path = os.path.join(artifact_dir,
                             f"{arch}__{shape_name}__single_pod.json")
    if not os.path.exists(cell_path):
        return None
    with open(cell_path) as f:
        cell = json.load(f)
    if cell["status"] != "ok":
        rec = {"arch": arch, "shape": shape_name, "status": cell["status"],
               "reason": cell.get("reason", cell.get("error", ""))}
        _write(out_path, rec)
        return rec

    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    devices = cell["devices"]
    lm = LM(cfg)
    counted = {"flops": float(cell["flops_per_device"]),
               "bytes": float(cell["bytes_per_device"]),
               "coll": float(sum(cell["collective_bytes"].values())),
               "wire": float(sum(cell["collective_wire_bytes"].values()))}
    mf = model_flops(cfg, lm, shape, devices)
    terms = {
        "compute_s": counted["flops"] / peaks.bf16_flop_per_s,
        "memory_hlo_s": counted["bytes"] / peaks.hbm_bytes_per_s,
        "memory_s": analytic_memory_bytes(cfg, lm, shape, cell["mesh_shape"])
        / peaks.hbm_bytes_per_s,
        "collective_s": counted["coll"] / peaks.link_bytes_per_s,
        "collective_wire_s": counted["wire"] / peaks.link_bytes_per_s,
    }
    core = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    dominant = max(core, key=core.get)
    bound = max(core.values())
    rec = {
        "arch": arch, "shape": shape_name, "status": "ok",
        "kind": cell["kind"], "devices": devices, "card": card,
        "peaks": peaks._asdict(),
        "hlo": counted, "corrected": dict(counted),
        "segment_repeats": [s.repeats for s in lm.layout],
        "model_flops_per_device": mf,
        "useful_ratio": mf / counted["flops"] if counted["flops"] else None,
        "terms": terms,
        "dominant": dominant,
        "roofline_fraction": (terms["compute_s"] / bound) if bound else None,
        "analysis_s": round(time.time() - t0, 1),
    }
    _write(out_path, rec)
    print(f"[roofline] {arch:24s} {shape_name:12s} dominant={dominant:12s} "
          f"compute={terms['compute_s']*1e3:9.2f}ms "
          f"memory={terms['memory_s']*1e3:9.2f}ms "
          f"coll={terms['collective_s']*1e3:9.2f}ms "
          f"useful={rec['useful_ratio']:.3f}")
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def emit_markdown(out_dir: str) -> str:
    rows = []
    for a in ARCH_NAMES:
        for s in ALL_SHAPES:
            p = os.path.join(out_dir, f"{a}__{s.name}.json")
            if os.path.exists(p):
                with open(p) as f:
                    rows.append(json.load(f))
    lines = ["| arch | shape | dominant | compute (ms) | memory (ms) | "
             "mem-HLO-ub (ms) | collective (ms) | MODEL/HLO flops | "
             "roofline frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — skipped: "
                         f"{r.get('reason', '')[:60]} | | | | | | |")
            continue
        t = r["terms"]
        mh = t.get("memory_hlo_s", t["memory_s"])
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['dominant'].replace('_s', '')} "
            f"| {t['compute_s']*1e3:.2f} | {t['memory_s']*1e3:.2f} "
            f"| {mh*1e3:.2f} "
            f"| {t['collective_s']*1e3:.2f} | {r['useful_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def main(argv: Optional[Iterable[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--artifacts", default=ARTIFACT_DIR)
    ap.add_argument("--out", default=ROOF_DIR)
    ap.add_argument("--card", default=DEFAULT_CARD,
                    help="the card whose peaks price the terms (a key of "
                         "repro_torch.obs.profile.PEAKS)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(None if argv is None else list(argv))
    card_peaks(args.card)
    if args.markdown:
        print(emit_markdown(args.out))
        return 0
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    failed = 0
    for a in archs:
        for s in shapes:
            try:
                analyze_cell(a, s, args.artifacts, args.out, force=args.force,
                             card=args.card)
            except Exception as e:  # noqa: BLE001
                failed += 1
                print(f"[roofline-ERROR] {a} {s}: {type(e).__name__}: {e}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
