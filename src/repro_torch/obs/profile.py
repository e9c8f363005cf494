"""Profiling hooks: an opt-in ``torch.profiler`` capture and a roofline
annotation against the card's published peaks.

* :func:`profiler_capture` — a context manager around ``torch.profiler``
  (CPU activity, and CUDA activity where a card is present) that writes a
  Chrome trace of the enclosed block into ``log_dir``. It never raises: a
  capture that cannot start or finish records ``.error`` and leaves
  ``.ok`` False, and the block still runs — profiling must never take down
  a serving process.

* :data:`PEAKS` and :func:`device_peaks` — the published peaks of each
  card this repository measures on, keyed by ``torch.cuda.get_device_name``.
  Kernel spans (:mod:`repro_torch.kernels.ops`), ``chip_smoke.py``'s
  bounds and the roofline (:mod:`repro_torch.launch.roofline`, in place
  of the reference's TPU constants) read the same numbers. A card not in the table, and the CPU, have
  no peaks: :func:`bandwidth_annotation` then reports ``frac_of_peak`` as
  None rather than a fraction of a guessed peak.
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import torch

__all__ = ["DevicePeaks", "PEAKS", "device_peaks", "bandwidth_annotation",
           "profiler_capture"]


class DevicePeaks(NamedTuple):
    hbm_bytes_per_s: float
    fp32_flop_per_s: float     # outside the tensor cores
    int8_op_per_s: float       # tensor cores, dense
    tf32_flop_per_s: float     # tensor cores, dense
    bf16_flop_per_s: float     # tensor cores, dense
    link_bytes_per_s: float    # one card's NVLink, each way


# NVIDIA's data sheet, H100 SXM at its 700 W limit: HBM3, float32 on the
# CUDA cores, int8, TF32 and bfloat16 on the tensor cores without
# sparsity, and NVLink 4: 900 GB/s in total, 450 GB/s each way. The
# roofline's collective term (repro_torch.launch.roofline) divides a
# rank's collective bytes by the 450 GB/s a card sends each way.
PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(3.35e12, 67e12, 1979e12, 495e12,
                                         989e12, 450e9),
}


def device_peaks(device=None) -> Optional[DevicePeaks]:
    """Peaks of the card ``device`` names (``None``: the current CUDA
    device); None on the CPU, without a card, or for a card not in
    :data:`PEAKS`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return PEAKS.get(torch.cuda.get_device_name(index))


def bandwidth_annotation(nbytes: float, seconds: float,
                         peak_bw: Optional[float] = None) -> Dict[str, object]:
    """Achieved memory bandwidth of a measured region against ``peak_bw``
    (bytes per second). Returns ``{"bytes", "gb_per_s", "frac_of_peak"}``,
    the dict a kernel span attaches via ``sp.set``; ``frac_of_peak`` is
    None when no peak is given. ``seconds <= 0`` reports 0 bandwidth rather
    than dividing by zero (a clock can quantize to 0 on tiny kernels)."""
    gbs = (nbytes / seconds / 1e9) if seconds > 0 else 0.0
    frac = None if peak_bw is None else round(gbs * 1e9 / peak_bw, 6)
    return {"bytes": float(nbytes), "gb_per_s": round(gbs, 3),
            "frac_of_peak": frac}


class profiler_capture:
    """``with obs.profiler_capture("build/prof") as cap:`` — profile the
    block with ``torch.profiler`` and write its Chrome trace to
    ``cap.path`` (``<log_dir>/trace.json``; open it in chrome://tracing or
    Perfetto). ``cap.ok`` says whether the capture ran and was written;
    ``cap.error`` holds the reason when it was not."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "trace.json")
        self.ok = False
        self.error: Optional[str] = None
        self._prof = None

    def __enter__(self) -> "profiler_capture":
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.log_dir, exist_ok=True)
            prof = profile(activities=acts)
            prof.__enter__()
            self._prof = prof
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            self.error = f"{type(e).__name__}: {e}"
        return self

    def __exit__(self, *exc) -> bool:
        if self._prof is not None:
            try:
                self._prof.__exit__(None, None, None)   # waits for the card
                self._prof.export_chrome_trace(self.path)
                self.ok = True
            except Exception as e:  # noqa: BLE001
                self.error = f"{type(e).__name__}: {e}"
            self._prof = None
        return False
