"""Deterministic LM token pipeline: a synthetic corpus and a pure
step -> batch cursor (preemption-safe: resuming at step s replays batch s).

The port of the reference's ``repro.data.loader``: the same numpy draws
from the same seed, so the tokens, labels, patches and frames are the
reference's bit for bit; they are handed over as torch tensors on
``device`` (the CPU by default), ``tokens`` and ``labels`` as int32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class TokenLoader:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    n_docs: int = 512
    frontend: Optional[str] = None      # vision_stub | audio_stub
    n_frontend_tokens: int = 0
    frontend_dim: int = 0
    device: Any = "cpu"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # zipf-ish synthetic documents with local structure (bigram chains)
        self.trans = rng.integers(0, self.vocab, size=(self.vocab, 4))
        self.doc_starts = rng.integers(0, self.vocab, self.n_docs)

    def _doc_tokens(self, doc_id: int, length: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + doc_id)
        out = np.empty(length, np.int32)
        t = self.doc_starts[doc_id % self.n_docs]
        for i in range(length):
            out[i] = t
            t = self.trans[t, rng.integers(0, 4)]
        return out

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch ``step``: ``tokens`` (B, S) and ``labels`` (B, S), the
        tokens shifted by one; ``patches`` (B, n_frontend_tokens,
        frontend_dim) for a vision stub, ``frames`` (B, S, frontend_dim)
        for an audio stub, float32 normal draws."""
        toks = np.stack([
            self._doc_tokens((step * self.batch + b) % self.n_docs,
                             self.seq_len + 1)
            for b in range(self.batch)])
        arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend == "vision_stub":
            rng = np.random.default_rng(self.seed + 7 + step)
            arrays["patches"] = rng.normal(
                0, 1, (self.batch, self.n_frontend_tokens, self.frontend_dim)
            ).astype(np.float32)
        elif self.frontend == "audio_stub":
            rng = np.random.default_rng(self.seed + 11 + step)
            arrays["frames"] = rng.normal(
                0, 1, (self.batch, self.seq_len, self.frontend_dim)
            ).astype(np.float32)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}
