"""Attention: the chunked (flash-style) prefill path, the cache decode path,
GQA with qk-norm / bias / sliding window, and MLA (DeepSeek's latent
attention).

The port of the reference's ``repro.models.attention``, as plain torch
loops over blocks. The (Sq, Skv) score matrix is never materialized: a loop
over q chunks, and inside it over the kv chunks a chunk can see, carries
online-softmax statistics (m, l, acc) exactly like FlashAttention, in
float32. Products take float32 operands and accumulate in float32, as the
reference's ``preferred_element_type=float32`` einsums do on bfloat16
inputs (float64 inputs keep float64 throughout, see
:func:`repro_torch.models.common.acc_dtype`).

Cross-attention (``is_cross`` / ``cross_memory``, the encoder-decoder
configs) takes its keys and values from the encoder's output at prefill
and from their cached projections at decode, with no rope and no mask.

Decode on a mesh of ranks may hold a cache's sequence split over a mesh
axis (``seq_axis``, ``model`` in the reference's layout): each rank scores
its block of positions and the softmax's reductions run locally, then
across the axis (:func:`_softmax`: a ``pmax`` of each row's maximum, a
``psum`` of its sum of exp), and so does the product with the values (a
``psum`` of the partial p·v): the reference's distributed LSE combine,
which its XLA partitioner derives from the same masked softmax. The
rank that holds a token's slot writes it.

``mode="train"`` is the prefill's arithmetic under autograd, with no
cache. Training skips the kv blocks a causal or windowed q chunk cannot
see, as the prefill does; the reference visits and masks every block in
training (its loop bound must be static to differentiate), which gives
the same result and the same gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import collectives as coll
from .common import acc_dtype, apply_rope, rmsnorm
from .params import meta

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None and window > 0:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def kv_blocks(q_lo: int, q_chunk: int, kv_chunk: int, nk: int,
              causal: bool, window: Optional[int]):
    """The kv blocks [lo, hi) that the q chunk starting at position
    ``q_lo`` can see: up to its last row's position when causal, from its
    first row's window when windowed."""
    lo, hi = 0, nk
    if causal:
        hi = min(nk, (q_lo + q_chunk - 1) // kv_chunk + 1)
    if window is not None and window > 0:
        lo = max(0, (q_lo - window + 1) // kv_chunk)
    return lo, hi


def _inv_sqrt(d: int) -> float:
    """1 / sqrt(d) as the reference takes it: both steps in float32."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    softcap: Optional[float] = None, q_chunk: int = 512,
                    kv_chunk: int = 512, kv_len=None,
                    block_skip: bool = True):
    """q: (B, Sq, H, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv).
    GQA via head grouping (H % Hkv == 0). Returns (B, Sq, H, Dv).

    Both sequence axes are padded to chunk multiples: padded kv entries are
    masked through ``kv_len``, padded q rows are sliced off at the end.
    ``block_skip`` visits only the kv blocks a causal or windowed q chunk
    can see (the reference's forward-only loop); without it every block is
    visited and masked, with the same result."""
    B, Sq, H, Dk = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    Dv = v.shape[-1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    Sq_p = -(-Sq // q_chunk) * q_chunk
    Skv_p = -(-Skv // kv_chunk) * kv_chunk
    if Skv_p != Skv:
        kv_len = (torch.clamp(torch.as_tensor(kv_len), max=Skv)
                  if kv_len is not None else Skv)
        k = F.pad(k, (0, 0, 0, 0, 0, Skv_p - Skv))
        v = F.pad(v, (0, 0, 0, 0, 0, Skv_p - Skv))
    if Sq_p != Sq:
        q = F.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    Sq_full, Sq, Skv = Sq, Sq_p, Skv_p
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = _inv_sqrt(Dk)
    dev = q.device
    acc_t = acc_dtype(q.dtype)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)
    qg = q.reshape(B, Sq, Hkv, G, Dk)

    blocks = []
    for qi in range(nq):
        q_lo = q_offset + qi * q_chunk
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk].to(acc_t)
        lo, hi = (kv_blocks(q_lo, q_chunk, kv_chunk, nk, causal, window)
                  if block_skip else (0, nk))
        m_i = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=acc_t,
                         device=dev)
        l_i = torch.zeros((B, Hkv, G, q_chunk), dtype=acc_t, device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dv), dtype=acc_t, device=dev)
        for ki in range(lo, hi):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            k_blk, v_blk = k[:, sl], v[:, sl]
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk,
                             k_blk.to(acc_t)) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            mask = _block_mask(q_pos, k_pos, causal, window)
            if kv_len is not None:
                mask = mask & (k_pos[None, :] < kv_len)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_i, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_i - m_new)
            l_i = l_i * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd",
                              p.to(v_blk.dtype).to(acc_t), v_blk.to(acc_t))
            acc = acc * corr[..., None] + pv
            m_i = m_new
        blocks.append(acc / torch.clamp(l_i, min=1e-30)[..., None])
    out = torch.cat(blocks, dim=3)                       # (B, Hkv, G, Sq, Dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
    return out[:, :Sq_full].to(v.dtype)


def _softmax(s, mesh=None, axis=None):
    """Softmax over the last dim of ``s``, whose entries are split over
    the mesh ``axis`` (``None``: whole here, ``torch.softmax``): each
    row's maximum by a ``pmax`` and its sum of exp by a ``psum`` of the
    local ones, then normalised by the global sum."""
    if axis is None:
        return torch.softmax(s, dim=-1)
    m = coll.pmax(s.amax(dim=-1, keepdim=True), mesh, axis)
    e = torch.exp(s - m)
    return e / coll.psum(e.sum(dim=-1, keepdim=True), mesh, axis)


def _seq_block(M_loc: int, mesh, axis):
    """(the whole sequence's length, this rank's first position) of a
    cache whose ``M_loc`` positions are its block over ``axis``."""
    return (M_loc * coll.axis_size(mesh, axis),
            coll.axis_index(mesh, axis) * M_loc)


def _write(cache, new, slot: int, lo: int):
    """Write ``new`` (B, S, ...) at global positions slot .. slot + S into
    ``cache``, this rank's block of positions from ``lo``: only the part
    that falls inside the block."""
    a = max(slot, lo)
    b = min(slot + new.shape[1], lo + cache.shape[1])
    if a < b:
        cache[:, a - lo:b - lo] = new[:, a - slot:b - slot].to(cache.dtype)


def decode_attention(q, k_cache, v_cache, key_valid, *,
                     softcap: Optional[float] = None, mesh=None,
                     seq_axis=None):
    """Single-token attention over a cache. q: (B, 1, H, Dk); caches:
    (B, M, Hkv, D*); ``key_valid``: (M,) bool mask of live entries (linear
    and ring caches alike). With ``seq_axis`` the caches and
    ``key_valid`` are this rank's block of the sequence over that axis of
    ``mesh``: the softmax reduces across it (:func:`_softmax`) and so does
    the product with the values, so every rank returns the whole
    attention."""
    B, _, H, Dk = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    acc_t = acc_dtype(q.dtype)
    qg = q.reshape(B, Hkv, G, Dk).to(acc_t)
    s = torch.einsum("bhgd,bmhd->bhgm", qg, k_cache.to(acc_t)) * _inv_sqrt(Dk)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(key_valid[None, None, None, :], s, NEG_INF)
    p = _softmax(s, mesh, seq_axis)
    out = torch.einsum("bhgm,bmhd->bhgd", p.to(v_cache.dtype).to(acc_t),
                       v_cache.to(acc_t))
    out = coll.psum(out, mesh, seq_axis)
    return out.reshape(B, 1, H, -1).to(v_cache.dtype)


def cache_slot_and_mask(cur_pos: int, M: int, window: Optional[int],
                        device=None):
    """Write slot + validity mask for a decode cache of capacity M.

    Linear cache (M >= sequence): slot = cur_pos, valid = pos <= cur_pos
    (+ window). Ring cache (local attention, M <= window): slot = cur_pos %
    M, valid = entries whose absolute position is within the window."""
    pos = torch.arange(M, device=device)
    ring = window is not None and window > 0 and M <= window
    if ring:
        slot = cur_pos % M
        abs_pos = cur_pos - ((cur_pos - pos) % M)
        valid = abs_pos >= 0
    else:
        slot = cur_pos
        valid = pos <= cur_pos
        if window is not None and window > 0:
            valid &= pos > cur_pos - window
    return slot, valid


# ---------------- GQA attention block ----------------
def attn_meta(cfg, dtype):
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": meta((D, H, Dh), ("embed", "heads", "head_dim"), dtype),
        "wk": meta((D, Hkv, Dh), ("embed", "kv_heads", "head_dim"), dtype),
        "wv": meta((D, Hkv, Dh), ("embed", "kv_heads", "head_dim"), dtype),
        "wo": meta((H, Dh, D), ("heads", "head_dim", "embed"), dtype),
    }
    if cfg.attn_bias:
        p["bq"] = meta((H, Dh), ("heads", "head_dim"), dtype, init="zeros")
        p["bk"] = meta((Hkv, Dh), ("kv_heads", "head_dim"), dtype,
                       init="zeros")
        p["bv"] = meta((Hkv, Dh), ("kv_heads", "head_dim"), dtype,
                       init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = meta((Dh,), ("head_dim",), dtype, init="ones")
        p["k_norm"] = meta((Dh,), ("head_dim",), dtype, init="ones")
    return p


def _qk_normalize(p, q, k):
    if "q_norm" in p:
        q = rmsnorm({"scale": p["q_norm"]}, q)
        k = rmsnorm({"scale": p["k_norm"]}, k)
    return q, k


def _cross_apply(p, x, *, cfg, mode: str, cache, cross_memory, kv_len,
                 mesh=None, seq_axis=None):
    """Cross-attention: keys and values are projected from
    ``cross_memory`` (the encoder's output, (B, enc_len, D)) at prefill,
    and returned as the cache, and in training (no cache); decode reads
    them from ``cache`` (this rank's block of enc_len with ``seq_axis``)
    and leaves it as it is. No rope, no causal mask; ``q_norm`` applies to
    the queries only, and decode attends over every cached entry."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if mode == "decode":
        k, v = cache                                  # projected at prefill
    else:
        k = torch.einsum("bsd,dhk->bshk", cross_memory, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", cross_memory, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rmsnorm({"scale": p["q_norm"]}, q)
    if mode == "decode":
        every = torch.ones(k.shape[1], dtype=torch.bool, device=x.device)
        out = decode_attention(q, k, v, every, softcap=cfg.attn_logit_softcap,
                               mesh=mesh, seq_axis=seq_axis)
    else:
        out = flash_attention(q, k, v, causal=False, window=None,
                              softcap=cfg.attn_logit_softcap,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                              kv_len=kv_len)
    return (torch.einsum("bshk,hkd->bsd", out, p["wo"]),
            None if mode == "train" else (k, v))


def attn_apply(p, x, *, cfg, rope_theta: float, window: Optional[int],
               positions, mode: str, cache=None, cur_pos=None,
               kv_len=None, cross_memory=None, causal: bool = True,
               is_cross: bool = False, mesh=None, seq_axis=None):
    """Self-attention in ``mode`` ``"train"`` (no cache: returns None),
    ``"prefill"`` (returns the prompt's (k, v) as the new cache) or
    ``"decode"`` (writes this token's k and v into the cache **in place**,
    at the slot :func:`cache_slot_and_mask` gives, and returns the same
    cache tensors). With ``is_cross`` or a ``cross_memory``,
    cross-attention (:func:`_cross_apply`). ``seq_axis`` (decode): the
    axis of ``mesh`` the cache's sequence is split over, the cache this
    rank's block of it (module docstring). Returns (out, new_cache)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"attn_apply mode {mode!r}")
    if is_cross or cross_memory is not None:
        return _cross_apply(p, x, cfg=cfg, mode=mode, cache=cache,
                            cross_memory=cross_memory, kv_len=kv_len,
                            mesh=mesh, seq_axis=seq_axis)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k, v = k + p["bk"], v + p["bv"]
    q, k = _qk_normalize(p, q, k)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if mode == "decode":
        k_cache, v_cache = cache
        M_loc, S = k_cache.shape[1], k.shape[1]
        M, lo = _seq_block(M_loc, mesh, seq_axis)
        slot, valid = cache_slot_and_mask(cur_pos, M, window, x.device)
        # the reference's dynamic_update_slice clamps the start so the
        # update fits; so does this
        slot = min(max(int(slot), 0), M - S)
        _write(k_cache, k, slot, lo)
        _write(v_cache, v, slot, lo)
        out = decode_attention(q, k_cache, v_cache, valid[lo:lo + M_loc],
                               softcap=cfg.attn_logit_softcap, mesh=mesh,
                               seq_axis=seq_axis)
        new_cache = (k_cache, v_cache)
    else:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                              kv_len=kv_len)
        new_cache = None if mode == "train" else (k, v)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


# ---------------- MLA (DeepSeek-V3) ----------------
def mla_meta(cfg, dtype):
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": meta((D, qr), ("embed", "q_lora"), dtype),
        "q_norm": meta((qr,), ("q_lora",), dtype, init="ones"),
        "w_uq": meta((qr, H, dn + dr), ("q_lora", "heads", "head_dim"),
                     dtype),
        "w_dkv": meta((D, kvr + dr), ("embed", None), dtype),
        "kv_norm": meta((kvr,), (None,), dtype, init="ones"),
        "w_uk": meta((kvr, H, dn), (None, "heads", "head_dim"), dtype),
        "w_uv": meta((kvr, H, dv), (None, "heads", "head_dim"), dtype),
        "wo": meta((H, dv, D), ("heads", "head_dim", "embed"), dtype),
    }


def mla_apply(p, x, *, cfg, positions, mode: str, cache=None, cur_pos=None,
              mesh=None, seq_axis=None, rank_axis=None, rope_axis=None):
    """Latent attention. ``prefill`` and ``train`` expand the latent into
    per-head keys (nope part from the latent, one shared rope part) and
    values and run :func:`flash_attention` with Dk = dn + dr against Dv; a
    prefill returns the prompt's (latent (B, S, kv_lora_rank), k_rope (B,
    S, qk_rope_dim)) as the cache, training None. ``decode`` writes this
    token's latent and rope key into the caches **in place** at
    ``cur_pos`` and attends in the latent space (the absorbed form: the
    query is taken through ``w_uk``, the context back through ``w_uv``);
    with ``seq_axis`` the caches are this rank's block of the sequence over
    that axis of ``mesh``, the softmax reduces across it and the context
    is a ``psum`` of the local att·latent. Where ``model`` does not divide
    the sequence, the reference's layout splits the latent's rank
    (``rank_axis``) and the rope key's dims (``rope_axis``) instead: each
    rank's scores and output are partial sums over its block of them,
    completed by a ``psum``. Returns (y, new_cache)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mla_apply mode {mode!r}")
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    kvr = cfg.kv_lora_rank
    acc_t = acc_dtype(x.dtype)
    # queries
    ql = rmsnorm({"scale": p["q_norm"]}, x @ p["w_dq"])
    q = torch.einsum("bsr,rhk->bshk", ql, p["w_uq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    # latent kv
    dkv = x @ p["w_dkv"]
    latent, k_rope = dkv[..., :kvr], dkv[..., kvr:]
    latent = rmsnorm({"scale": p["kv_norm"]}, latent)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                  # one shared head

    if mode == "decode":
        lat_cache, rope_cache = cache
        M_loc = lat_cache.shape[1]
        M, lo = _seq_block(M_loc, mesh, seq_axis)
        rb = coll.block_slice(kvr, mesh, rank_axis)
        db = coll.block_slice(dr, mesh, rope_axis)
        # dynamic_update_slice clamps the start so the update fits
        slot = min(max(int(cur_pos), 0), M - S)
        _write(lat_cache, latent[..., rb], slot, lo)
        _write(rope_cache, k_rope[:, :, 0, db], slot, lo)
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
        # over a split feature dim each rank's score is a partial sum
        s_lat = torch.einsum("bshr,bmr->bhsm", q_abs[..., rb].to(acc_t),
                             lat_cache.to(acc_t))
        s_rope = torch.einsum("bshk,bmk->bhsm", q_rope[..., db].to(acc_t),
                              rope_cache.to(acc_t))
        s = (coll.psum(s_lat, mesh, rank_axis)
             + coll.psum(s_rope, mesh, rope_axis))
        s = s / torch.sqrt(torch.tensor(float(dn + dr), dtype=acc_t))
        ok = lo + torch.arange(M_loc, device=x.device) <= int(cur_pos)
        s = torch.where(ok, s, NEG_INF)
        att = _softmax(s, mesh, seq_axis)
        ctx = coll.psum(torch.einsum("bhsm,bmr->bshr",
                                     att.to(lat_cache.dtype).to(acc_t),
                                     lat_cache.to(acc_t)), mesh, seq_axis)
        out = coll.psum(torch.einsum("bshr,rhv->bshv", ctx.to(x.dtype),
                                     p["w_uv"][rb]), mesh, rank_axis)
        new_cache = (lat_cache, rope_cache)
    else:
        k_nope = torch.einsum("bsr,rhk->bshk", latent, p["w_uk"])
        v = torch.einsum("bsr,rhv->bshv", latent, p["w_uv"])
        k = torch.cat([k_nope, k_rope.expand(B, S, H, dr).to(k_nope.dtype)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(qq, k, v, causal=True, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        new_cache = (None if mode == "train"
                     else (latent, k_rope[:, :, 0, :]))
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return y, new_cache
