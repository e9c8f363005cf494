"""Mixture-of-Experts block (Qwen3-MoE, DeepSeek-V3 style), the local path.

The port of the reference's ``repro.models.moe`` for one device: the
router (softmax or sigmoid scores, top-k, optional renormalization, a
static routing bias), a capacity buffer of (E, C, D) into which each
expert's tokens are scattered in token order, the expert MLPs as dense
batched products over all E experts, and the gather back, weighted by the
gates. The reference's expert-parallel paths (its ``shard_map`` branch and
``_moe_full_ep``) need a device mesh and wait for the port's multi-process
mesh (ROADMAP §1); this module takes no mesh.

Where the reference's semantics need care in torch (each is a named step
below):

* **Router ties.** ``lax.top_k`` puts the lower expert first among equal
  scores. In a bfloat16 model the router logits are rounded to bfloat16
  before the float32 softmax, so exact ties among 128 experts are common,
  and ``torch.topk`` promises no order among them: :func:`_route` takes a
  stable descending sort, (score desc, expert asc), so the card and the
  CPU pick the same experts.
* **Dropped assignments.** An assignment past its expert's capacity is
  dropped. The reference scatters it as a zero row *added* at slot (0, 0);
  here it is sent to a dump row past the buffer, so it can never overwrite
  a kept token.
* **The combine.** The reference adds each token's k weighted rows with a
  scatter-add; on the card ``index_add_`` runs on atomics, in an order that
  changes from run to run. A token's rows are contiguous (assignment i
  belongs to token i // k), so ``view(T, k, D).sum(1)`` gives the sum in
  one fixed order.

Capacity is per call: ``max(ceil(T * k / E * capacity_factor), 4)`` for the
call's T = B * S tokens. A decode step (T = B) and a prefill (T = B * P) of
the same batch therefore drop differently under one capacity factor, and
teacher forcing holds only at a factor that drops nothing (>= E / k).

:func:`routing` gives the routing ``moe_apply`` takes on an input: the
experts the router chose, the assignments kept within capacity and the
experts that receive one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import act_fn, mlp
from .params import meta


def moe_meta(cfg, dtype):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": meta((D, E), ("embed", None), dtype, scale=0.02),
        "bias": meta((E,), (None,), torch.float32, init="zeros"),
        "w_gate": meta((E, D, Fd), ("expert", "embed", "expert_mlp"), dtype),
        "w_up": meta((E, D, Fd), ("expert", "embed", "expert_mlp"), dtype),
        "w_down": meta((E, Fd, D), ("expert", "expert_mlp", "embed"), dtype),
    }
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": meta((D, Fs), ("embed", "mlp"), dtype),
            "w_up": meta((D, Fs), ("embed", "mlp"), dtype),
            "w_down": meta((Fs, D), ("mlp", "embed"), dtype),
        }
    return p


def _expert_ffn(x, wg, wu, wd, act):
    h = act_fn(act)(torch.einsum("ecd,edf->ecf", x, wg)) * torch.einsum(
        "ecd,edf->ecf", x, wu)
    return torch.einsum("ecf,efd->ecd", h, wd)


def _route(x, router_w, bias, cfg):
    """Router: (logits (T, E) float32, gates (T, k), experts (T, k)).
    The top-k is a stable descending sort of ``scores + bias``: among equal
    scores the lower expert comes first, as in ``lax.top_k``."""
    logits = (x @ router_w).to(torch.float32)
    if cfg.router_fn == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    order = torch.sort(scores + bias[None, :], dim=-1, descending=True,
                       stable=True).indices
    eidx = order[:, :cfg.top_k]
    gates = torch.gather(scores, 1, eidx)            # the bias only routes
    if cfg.router_norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, gates, eidx


def _slots(eidx, E: int, capacity: int):
    """Each assignment's expert (T*k,), its slot in that expert's buffer
    (the number of earlier assignments, token-major then rank, to the same
    expert) and whether the slot is within ``capacity``."""
    flat_e = eidx.reshape(-1)
    onehot = F.one_hot(flat_e, E)                               # (T*k, E)
    pos_e = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    return flat_e, pos_e, pos_e < capacity


def _local_moe(x, router_w, bias, wg, wu, wd, *, cfg, capacity: int,
               act: str):
    """x: (T, D) -> (out (T, D), aux). The reference's ``_local_moe`` with
    every expert local (``e_lo = 0``, no mesh axes)."""
    E = wg.shape[0]
    T, D = x.shape
    k = cfg.top_k
    logits, gates, eidx = _route(x, router_w, bias, cfg)

    flat_e, pos_e, keep = _slots(eidx, E, capacity)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)

    # dropped assignments go to the dump row E * C, never onto a kept slot
    dest = torch.where(keep, flat_e * capacity + pos_e,
                       torch.full_like(pos_e, E * capacity))
    buf = torch.zeros((E * capacity + 1, D), dtype=x.dtype, device=x.device)
    buf[dest] = x[tok]
    out_buf = _expert_ffn(buf[:-1].view(E, capacity, D), wg, wu, wd, act)
    out_flat = torch.cat([out_buf.reshape(E * capacity, D),
                          out_buf.new_zeros((1, D))])
    vals = out_flat[dest] * gates.reshape(-1)[:, None]          # (T*k, D)
    # the combine: a token's k rows are contiguous; a fixed-order sum
    out = vals.to(x.dtype).view(T, k, D).sum(1)

    # load-balance aux (switch-style) on the router state
    me = torch.mean(torch.softmax(logits, -1), dim=0)
    ce = torch.mean(F.one_hot(eidx[:, 0], cfg.n_experts).to(torch.float32),
                    dim=0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return out, aux


def capacity_for(T: int, cfg, capacity_factor: float) -> int:
    """Slots per expert for a call of T tokens: max(ceil(T k / E * cf), 4)."""
    return max(int(math.ceil(T * cfg.top_k / cfg.n_experts
                             * capacity_factor)), 4)


def routing(p, x, *, cfg, capacity_factor: float = 1.25) -> dict:
    """The routing :func:`moe_apply` takes on x (B, S, D), by the same
    steps: ``tokens`` (T = B * S), ``assignments`` (T * k) and
    ``capacity`` (ints); ``experts`` (T, k), the router's choice; ``kept``
    (T, k) bool, the assignments within capacity; ``dropped``, a scalar;
    and ``experts_used`` (E,) bool, the experts that receive a kept
    assignment. Tensors stay on x's device."""
    B, S, D = x.shape
    T, E, k = B * S, p["w_gate"].shape[0], cfg.top_k
    capacity = capacity_for(T, cfg, capacity_factor)
    _, _, eidx = _route(x.reshape(T, D), p["router"], p["bias"], cfg)
    flat_e, _, keep = _slots(eidx, E, capacity)
    used = torch.zeros(E + 1, dtype=torch.bool, device=x.device)
    used[torch.where(keep, flat_e, E)] = True
    return {"tokens": T, "assignments": T * k, "capacity": capacity,
            "experts": eidx, "kept": keep.view(T, k),
            "dropped": (~keep).sum(), "experts_used": used[:E]}


def moe_apply(p, x, *, cfg, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (y (B, S, D), aux). Every mode runs the same local
    path on one device (the reference picks a mesh path by mode)."""
    B, S, D = x.shape
    capacity = capacity_for(B * S, cfg, capacity_factor)
    out, aux = _local_moe(x.reshape(B * S, D), p["router"], p["bias"],
                          p["w_gate"], p["w_up"], p["w_down"], cfg=cfg,
                          capacity=capacity, act=cfg.act)
    y = out.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x, cfg.act)
    return y, aux
