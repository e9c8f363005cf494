"""Recurrent sequence mixers: RG-LRU (Griffin / RecurrentGemma) and RWKV-6.

The port of the reference's ``repro.models.recurrent``. A prefill runs the
sequence in parallel form, a decode step is the O(1) state update; both
take and return a cache of recurrent states, which have the decode shape
from the first token on (no sequence axis).

* RG-LRU's recurrence ``h_t = a_t h_{t-1} + b_t`` is the reference's
  ``lax.associative_scan``. Here it is a Hillis-Steele doubling over the
  pairs (a, b): ceil(log2(S + 1)) elementwise steps, each composing every
  position with the one ``2**j`` before it. It stays in float32 products of
  decays, never in log space: ``log a`` reaches -8 softplus(a) a step, so an
  ``exp(cumsum(log a))`` underflows float32 within a few steps.
* RWKV-6's prefill is the reference's chunkwise WKV scan (``rwkv_chunk`` =
  16 tokens a chunk; S must be a multiple of the chunk, or shorter than
  one), kept formula for formula. It inherits the reference's range: inside
  a chunk ``exp(-c_incl)`` overflows float32 once a chunk's cumulative log
  decay passes -88, which per-step decays clipped at -8 can reach
  (ROADMAP §3, reference caveats).

A decode step writes the new states **into the cache tensors it was
given** (``copy_``) and returns them, as the attention caches are updated
(ROADMAP §3 (u)).
"""
from __future__ import annotations

import torch

from .common import acc_dtype, act_fn, rmsnorm
from .params import meta

# ---------------- RG-LRU recurrent block (Griffin) ----------------
_LRU_C = 8.0


def rglru_meta(cfg, dtype):
    D, W = cfg.d_model, cfg.lru_width
    ck = cfg.conv_width
    return {
        "w_x": meta((D, W), ("embed", "mlp"), dtype),
        "w_gate_branch": meta((D, W), ("embed", "mlp"), dtype),
        "conv": meta((ck, W), ("conv", "mlp"), dtype, scale=0.1),
        "conv_b": meta((W,), ("mlp",), dtype, init="zeros"),
        "lru_in_gate": meta((W,), ("mlp",), dtype, init="ones"),
        "lru_in_gate_b": meta((W,), ("mlp",), dtype, init="zeros"),
        "lru_rec_gate": meta((W,), ("mlp",), dtype, init="ones"),
        "lru_rec_gate_b": meta((W,), ("mlp",), dtype, init="zeros"),
        "lru_a": meta((W,), ("mlp",), torch.float32, init="ones", scale=1.0),
        "w_out": meta((W, D), ("mlp", "embed"), dtype),
    }


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b, state):
    """Depthwise causal conv. x: (B, S, W); w: (ck, W); state: (B, ck-1, W).
    Returns (out, the last ck-1 inputs as the new state)."""
    ck = w.shape[0]
    xx = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xx[:, i:i + x.shape[1]] * w[i] for i in range(ck)) + b
    new_state = xx[:, -(ck - 1):] if ck > 1 else state
    return out, new_state


def _lru_coeffs(r_gate, i_gate, x, a_param):
    """(a, b) of h_t = a_t h_{t-1} + b_t in the state's float dtype."""
    acc = r_gate.dtype
    log_a = -_LRU_C * _softplus(a_param.to(acc)) * r_gate
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (i_gate * x).to(acc)


def _rglru_scan(x, r_gate, i_gate, a_param, h0):
    """h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t) over the sequence.
    x / r_gate / i_gate: (B, S, W); h0: (B, W). Returns (h (B, S, W) in
    x's dtype, the last h in float32)."""
    a, b = _lru_coeffs(r_gate, i_gate, x, a_param)
    # the carry enters as a pseudo-step with a = 1
    a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    b = torch.cat([h0[:, None].to(b.dtype), b], dim=1)
    n = a.shape[1]
    step = 1
    while step < n:          # Hillis-Steele: compose with position t - step
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        b = torch.cat([b[:, :step], b_prev * a[:, step:] + b[:, step:]], 1)
        a = torch.cat([a[:, :step], a_prev * a[:, step:]], 1)
        step *= 2
    return b[:, 1:].to(x.dtype), b[:, -1]


def rglru_apply(p, x, *, cfg, mode: str, cache=None):
    """Griffin recurrent block. cache: (conv_state (B, ck-1, W), h (B, W));
    ``None`` starts from zeros. Returns (out, new_cache); in ``decode`` the
    new states are written into ``cache``'s tensors."""
    B, S, D = x.shape
    W = cfg.lru_width
    ck = cfg.conv_width
    acc = acc_dtype(x.dtype)
    given = cache
    if cache is None:
        cache = (torch.zeros((B, ck - 1, W), dtype=x.dtype, device=x.device),
                 torch.zeros((B, W), dtype=acc, device=x.device))
    conv_state, h0 = cache
    gate = act_fn("gelu")(x @ p["w_gate_branch"])
    u = x @ p["w_x"]
    u, conv_state = _causal_conv(u, p["conv"], p["conv_b"], conv_state)
    r = torch.sigmoid(u * p["lru_rec_gate"] + p["lru_rec_gate_b"]).to(acc)
    i = torch.sigmoid(u * p["lru_in_gate"] + p["lru_in_gate_b"]).to(acc)
    if mode == "decode":
        a, b = _lru_coeffs(r[:, 0], i[:, 0], u[:, 0], p["lru_a"])
        h = a * h0.to(acc) + b
        y = h[:, None].to(x.dtype)
    else:
        y, h = _rglru_scan(u, r, i, p["lru_a"], h0)
    out = (y * gate) @ p["w_out"]
    if mode == "decode" and given is not None:
        new_cache = (given[0].copy_(conv_state), given[1].copy_(h))
    else:
        new_cache = (conv_state, h)
    return out, new_cache


# ---------------- RWKV-6 (Finch) ----------------
def rwkv6_meta(cfg, dtype):
    D = cfg.d_model
    H = cfg.n_heads
    Dh = D // H
    lora = cfg.rwkv_lora
    return {
        "mu": meta((5, D), (None, "embed"), dtype, scale=0.5),       # w,k,v,r,g
        "mu_x": meta((D,), ("embed",), dtype, scale=0.5),
        "ddl_a": meta((D, 5 * lora), ("embed", None), dtype, scale=0.02),
        "ddl_b": meta((5, lora, D), (None, None, "embed"), dtype,
                      scale=0.02),
        "w0": meta((D,), ("embed",), torch.float32, init="zeros"),
        "w_lora_a": meta((D, lora), ("embed", None), dtype, scale=0.02),
        "w_lora_b": meta((lora, D), (None, "embed"), dtype, scale=0.02),
        "bonus": meta((H, Dh), ("heads", "head_dim"), torch.float32,
                      init="zeros"),
        "w_r": meta((D, D), ("embed", "mlp"), dtype),
        "w_k": meta((D, D), ("embed", "mlp"), dtype),
        "w_v": meta((D, D), ("embed", "mlp"), dtype),
        "w_g": meta((D, D), ("embed", "mlp"), dtype),
        "ln_scale": meta((H, Dh), ("heads", "head_dim"), dtype, init="ones"),
        "w_o": meta((D, D), ("mlp", "embed"), dtype),
    }


def _rwkv_mix(p, x, shifted):
    """RWKV-6 data-dependent token shift (ddlerp): the five mixed streams
    (w, k, v, r, g). x / shifted: (B, S, D) -> (B, S, 5, D)."""
    dx = shifted - x
    base = x + dx * p["mu_x"]
    low = torch.tanh(base @ p["ddl_a"])                    # (B, S, 5*lora)
    low = low.reshape(*low.shape[:-1], 5, -1)              # (B, S, 5, lora)
    mix = p["mu"] + torch.einsum("bsfl,fld->bsfd", low, p["ddl_b"])
    return x[..., None, :] + dx[..., None, :] * mix


def _rwkv_chunk_scan(r, k, v, lw, u, S0, chunk: int):
    """Chunkwise-parallel WKV6. r / k / v: (B, H, S, Dh); lw: log decay
    (B, H, S, Dh) (<= 0); u: (H, Dh) bonus; S0: (B, H, Dh, Dh) initial
    state. Returns (out (B, H, S, Dh), final state), in the state's float
    dtype."""
    B, H, S, Dh = r.shape
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"RWKV prefill of {S} tokens: the chunk scan needs "
                         f"a multiple of {C} (the reference asserts it)")
    acc = S0.dtype
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)                          # strict lower
    S_prev = S0
    outs = []
    for c in range(S // C):
        sl = slice(c * C, (c + 1) * C)
        rb, kb, vb, lwb = r[:, :, sl], k[:, :, sl], v[:, :, sl], lw[:, :, sl]
        c_incl = torch.cumsum(lwb, dim=2)                  # inclusive
        c_prev = c_incl - lwb                              # exclusive
        r_tld = (rb * torch.exp(c_prev)).to(acc)
        k_tld = (kb * torch.exp(-c_incl)).to(acc)
        vf = vb.to(acc)
        # intra-chunk: A[t, j] = sum_d r~[t, d] k~[j, d]  (j < t)
        A = torch.einsum("bhtd,bhjd->bhtj", r_tld, k_tld)
        A = torch.where(tri, A, 0.0)
        intra = torch.einsum("bhtj,bhjd->bhtd", A, vf)
        # diagonal bonus term
        diag = torch.einsum("bhtd,bhtd->bht", rb.to(acc),
                            u[None, :, None, :] * kb.to(acc))
        intra = intra + diag[..., None] * vf
        # inter-chunk from the carried state
        inter = torch.einsum("bhtd,bhdv->bhtv", r_tld, S_prev)
        # state update
        tot = c_incl[:, :, -1:, :]                         # (B, H, 1, Dh)
        k_dec = (kb * torch.exp(tot - c_incl)).to(acc)
        S_prev = S_prev * torch.exp(tot[:, :, 0, :])[..., None] + \
            torch.einsum("bhtd,bhtv->bhdv", k_dec, vf)
        outs.append(intra + inter)
    return torch.cat(outs, dim=2), S_prev


def rwkv6_apply(p, x, *, cfg, mode: str, cache=None, chunk: int = 64):
    """RWKV-6 time-mix block. cache: (shift (B, D), state (B, H, Dh, Dh));
    ``None`` starts from zeros. Returns (y, new_cache); in ``decode`` the
    new states are written into ``cache``'s tensors."""
    B, S, D = x.shape
    H = cfg.n_heads
    Dh = D // H
    acc = acc_dtype(x.dtype)
    given = cache
    if cache is None:
        cache = (torch.zeros((B, D), dtype=x.dtype, device=x.device),
                 torch.zeros((B, H, Dh, Dh), dtype=acc, device=x.device))
    shift_in, S0 = cache
    shifted = torch.cat([shift_in[:, None].to(x.dtype), x[:, :-1]], dim=1)
    mixed = _rwkv_mix(p, x, shifted)                       # (B, S, 5, D)
    xw, xk, xv, xr, xg = [mixed[:, :, i] for i in range(5)]
    lw = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    lw = -torch.exp(torch.clamp(lw.to(acc), -8.0, 4.0))   # log decay <= 0
    lw = torch.clamp(lw, -8.0, -1e-4)

    def heads(t):
        return t.reshape(B, S, H, Dh).transpose(1, 2)

    r = heads(xr @ p["w_r"])
    k = heads(xk @ p["w_k"])
    v = heads(xv @ p["w_v"])
    g = torch.nn.functional.silu(xg @ p["w_g"])
    lwh = heads(lw)
    u = p["bonus"].to(acc)
    S0 = S0.to(acc)

    if mode == "decode":
        rb, kb, vb = r[:, :, 0].to(acc), k[:, :, 0].to(acc), v[:, :, 0].to(acc)
        kv = torch.einsum("bhd,bhv->bhdv", kb, vb)
        wkv = S0 + u[None, :, :, None] * kv
        out = torch.einsum("bhd,bhdv->bhv", rb, wkv)[:, :, None]
        S_new = S0 * torch.exp(lwh[:, :, 0])[..., None] + kv
    else:
        out, S_new = _rwkv_chunk_scan(r, k, v, lwh, u, S0, chunk)

    out = rmsnorm({"scale": p["ln_scale"]},
                  out.transpose(1, 2)).reshape(B, S, D)
    y = ((out.to(x.dtype) * g) @ p["w_o"]).to(x.dtype)
    shift = x[:, -1]
    if mode == "decode" and given is not None:
        new_cache = (given[0].copy_(shift), given[1].copy_(S_new))
    else:
        new_cache = (shift, S_new)
    return y, new_cache
