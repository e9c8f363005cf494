"""Shared neural building blocks, as plain functions on tensors.

The port of the reference's ``repro.models.common``: the same parameter
layouts (``(d_model, d_ff)`` MLP weights, a ``(vocab, d_model)`` embedding
table) and the same arithmetic, norms and rotary angles in float32. The
reference's ``chunked_softmax_xent`` is training and waits for the port's
training slice (ROADMAP §1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import meta


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the reference's float32 statistics and accumulations
    for inputs of ``dtype``: float32, or float64 for float64 inputs (a
    float64 model, which the reference's jax without x64 never has, keeps
    float64 throughout)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------- norms ----------------
def rmsnorm_meta(d, dtype):
    return {"scale": meta((d,), ("embed",), dtype, init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    x32 = x.to(acc_dtype(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(x32.dtype)).to(x.dtype)


def layernorm_np(x, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    x32 = x.to(acc_dtype(x.dtype))
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def make_norm(cfg):
    """(meta fn, apply fn) of the config's norm."""
    if cfg.norm_type == "layernorm_np":
        return (lambda d, dt: {}), (lambda p, x: layernorm_np(x))
    return rmsnorm_meta, rmsnorm


# ---------------- rope ----------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, Dh) with rotary over Dh; positions: (..., S) or (S,)."""
    Dh = x.shape[-1]
    acc = acc_dtype(x.dtype)
    inv = rope_freqs(Dh, theta, x.device).to(acc)             # (Dh/2,)
    ang = positions[..., None].to(acc) * inv                  # (..., S, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(acc), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------- MLP ----------------
def mlp_meta(d_model, d_ff, dtype, bias=False):
    p = {"w_gate": meta((d_model, d_ff), ("embed", "mlp"), dtype),
         "w_up": meta((d_model, d_ff), ("embed", "mlp"), dtype),
         "w_down": meta((d_ff, d_model), ("mlp", "embed"), dtype)}
    if bias:
        p["b_gate"] = meta((d_ff,), ("mlp",), dtype, init="zeros")
        p["b_up"] = meta((d_ff,), ("mlp",), dtype, init="zeros")
        p["b_down"] = meta((d_model,), ("embed",), dtype, init="zeros")
    return p


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(params, x, act: str = "silu"):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    if "b_gate" in params:
        g = g + params["b_gate"]
        u = u + params["b_up"]
    h = act_fn(act)(g) * u
    y = h @ params["w_down"]
    if "b_down" in params:
        y = y + params["b_down"]
    return y


# ---------------- embedding / unembedding ----------------
def embed_meta(vocab, d_model, dtype):
    # N(0, 1/sqrt(d)): O(1) logits under tied unembedding; models with
    # embed_scale (gemma) restore O(1) activations via the sqrt(d) multiplier
    return {"table": meta((vocab, d_model), ("vocab", "embed"), dtype,
                          init="embed", scale=d_model ** -0.5)}


def embed(params, tokens):
    return params["table"][tokens]


def unembed_meta(vocab, d_model, dtype, tied: bool):
    if tied:
        return {}
    return {"w_out": meta((d_model, vocab), ("embed", "vocab"), dtype)}


def logits_fn(head_params, embed_params, x, tied: bool):
    if tied:
        return x @ embed_params["table"].T
    return x @ head_params["w_out"]

