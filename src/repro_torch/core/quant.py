"""Scalar-quantized vector storage tier (int8 / float16) with exact re-rank.

At millions of vectors the float32 corpus dominates memory *and* bandwidth:
every route — flat scan, pruned scan, graph beam — is a streaming read of
vector rows, so shrinking the bytes per row is a direct speedup on any
bandwidth-bound backend. This module holds the storage side of that trade:

* ``int8`` — per-dimension min/max affine quantization. For dimension ``d``
  with corpus range ``[vmin_d, vmax_d]``::

      scale_d  = (vmax_d - vmin_d) / 254        (1.0 when the range is 0)
      code     = round((x - vmin_d) / scale_d) - 127     in [-127, 127]
      offset_d = vmin_d + 127 * scale_d
      x_hat    = offset_d + scale_d * code

  Codes are symmetric around 0 so integer dot products (int8 x int8 with
  int32 accumulation) need no zero-point correction,
  and constant dimensions reconstruct exactly. 4x smaller than float32.
* ``float16`` — plain downcast; ``scale``/``offset`` are identity
  (ones/zeros) so every downstream consumer handles both tiers uniformly.
  2x smaller, reconstruction error ~1e-3 relative.

Alongside the codes the store precomputes ``sq_norm[i] = ||x_hat_i||^2``
(float32), which turns the scan distance into

    ||q - x_hat||^2 = ||q||^2 - 2 q·x_hat + sq_norm
                    = (||q||^2 - 2 q·offset) - 2 (q*scale)·code + sq_norm

— one fused (Q, n) code matmul plus rank-1 corrections, with no dequantized
copy of the corpus ever materialized.

Quantization is *lossy on the scan, exact on the answer*: the engine scans
codes to a top-``rerank_k`` candidate list and re-ranks those rows against
the retained float32 corpus (:mod:`repro_torch.core.compressed`), so end recall
is preserved. The float32 rows are kept host-side only — they never occupy
accelerator memory on the quantized path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

#: Accepted ``storage_dtype`` spellings, in decreasing precision order.
STORAGE_DTYPES = ("float32", "float16", "int8")

_ITEMSIZE = {"int8": 1, "float16": 2, "float32": 4}


def check_storage_dtype(dtype: Optional[str]) -> str:
    """Validate and normalize a ``storage_dtype`` knob (None -> float32)."""
    dtype = dtype or "float32"
    if dtype not in STORAGE_DTYPES:
        raise ValueError(f"storage_dtype must be one of {STORAGE_DTYPES}, "
                         f"got {dtype!r}")
    return dtype


@dataclasses.dataclass
class QuantizedStore:
    """Compressed codes + affine dequantization parameters for one corpus
    (or one streaming segment — each segment quantizes against its own
    min/max, so flush/compact re-fit the scales to the surviving rows)."""

    dtype: str                # "int8" | "float16"
    codes: np.ndarray         # (n, d) int8 or float16
    scale: np.ndarray         # (d,) float32 (ones for float16)
    offset: np.ndarray        # (d,) float32 (zeros for float16)
    sq_norm: np.ndarray       # (n,) float32: ||dequantize(codes)||^2

    @classmethod
    def from_vectors(cls, vectors: np.ndarray, dtype: str) -> "QuantizedStore":
        vectors = np.ascontiguousarray(vectors, np.float32)
        n, d = vectors.shape
        if dtype == "float16":
            codes = vectors.astype(np.float16)
            scale = np.ones(d, np.float32)
            offset = np.zeros(d, np.float32)
            deq = codes.astype(np.float32)
        elif dtype == "int8":
            if n == 0:
                vmin = np.zeros(d, np.float32)
                span = np.zeros(d, np.float32)
            else:
                vmin = vectors.min(axis=0)
                span = vectors.max(axis=0) - vmin
            scale = np.where(span > 0, span / 254.0, 1.0).astype(np.float32)
            codes = (np.rint((vectors - vmin) / scale) - 127.0)
            codes = np.clip(codes, -127, 127).astype(np.int8)
            offset = (vmin + 127.0 * scale).astype(np.float32)
            deq = offset + scale * codes.astype(np.float32)
        else:
            raise ValueError(f"no quantized tier for dtype {dtype!r} "
                             f"(float32 means: no QuantizedStore)")
        sq_norm = np.einsum("nd,nd->n", deq, deq).astype(np.float32)
        return cls(dtype=dtype, codes=codes, scale=scale, offset=offset,
                   sq_norm=sq_norm)

    # ---- reconstruction ----
    def dequantize(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Reconstructed float32 vectors (``x_hat``); optionally a row
        subset. This is what every scan distance is computed against."""
        codes = self.codes if rows is None else self.codes[rows]
        return self.offset + self.scale * codes.astype(np.float32)

    @property
    def itemsize(self) -> int:
        """Bytes per stored component — the router's scan-cost ratio vs
        float32 is ``itemsize / 4``."""
        return _ITEMSIZE[self.dtype]

    # ---- accounting ----
    @property
    def nbytes(self) -> int:
        return int(self.codes.nbytes + self.scale.nbytes
                   + self.offset.nbytes + self.sq_norm.nbytes)

    def bytes_breakdown(self) -> Dict[str, int]:
        """Per-tier byte split of what the compressed scan actually streams:
        ``codes`` (the (n, d) code matrix), ``scales`` (per-dim scale +
        offset), ``sq_norm`` (per-row norms)."""
        return {"codes": int(self.codes.nbytes),
                "scales": int(self.scale.nbytes + self.offset.nbytes),
                "sq_norm": int(self.sq_norm.nbytes),
                "total": self.nbytes}

    # ---- persistence (embedded into the index .npz payload) ----
    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"codes": self.codes, "code_scale": self.scale,
                "code_offset": self.offset, "code_sq_norm": self.sq_norm}

    @classmethod
    def from_arrays(cls, dtype: str,
                    arrays: Dict[str, np.ndarray]) -> Optional["QuantizedStore"]:
        """Rehydrate from payload arrays; returns None when the artifact
        predates the storage tier (no ``codes`` key) — callers fall back to
        float32 (old artifacts keep loading)."""
        if "codes" not in arrays:
            return None
        return cls(dtype=dtype,
                   codes=np.asarray(arrays["codes"]),
                   scale=np.asarray(arrays["code_scale"], np.float32),
                   offset=np.asarray(arrays["code_offset"], np.float32),
                   sq_norm=np.asarray(arrays["code_sq_norm"], np.float32))


def maybe_quantize(vectors: np.ndarray,
                   dtype: Optional[str]) -> Optional[QuantizedStore]:
    """``None`` for float32 (no compression), a :class:`QuantizedStore`
    otherwise. The single entry point used by build/flush/compact and by
    the engine's on-the-fly override path."""
    dtype = check_storage_dtype(dtype)
    if dtype == "float32":
        return None
    return QuantizedStore.from_vectors(vectors, dtype)
