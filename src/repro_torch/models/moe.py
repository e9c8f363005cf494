"""Mixture-of-Experts block (Qwen3-MoE, DeepSeek-V3 style).

The port of the reference's ``repro.models.moe``: the router (softmax or
sigmoid scores, top-k, optional renormalization, a static routing bias), a
capacity buffer of (E_loc, C, D) into which each local expert's tokens are
scattered in token order, the expert MLPs as dense batched products over
the local experts, and the gather back, weighted by the gates.

:func:`moe_apply` picks the reference's path:

* no mesh: the local path, every expert on the one device;
On a mesh of ranks x is this rank's rows of the batch, split over
``batch_axes`` before the model ran, in every mode, and so is the output.

* ``_moe_full_ep`` (serving, ``mode != "train"``, at most 16,384 tokens
  in the whole batch, more than one expert-parallel axis dividing E):
  tokens replicated (the rows all-gathered over the batch axes), each
  rank runs its E / ep experts of the whole mesh (the experts' layout
  under ``SERVE_RULES``), one ``psum`` over the EP axes combines, and the
  rank keeps its rows;
* otherwise the reference's ``shard_map`` branch: experts over ``model``,
  the rows as they come, capacity reckoned per batch shard from ``T_loc =
  (B / dp) * S``, one ``psum`` over ``model``, the aux ``pmean``'d over
  the batch axes and ``model``. The
  tokens and the router enter through ``pvary`` over ``model``, so their
  gradients sum the experts' partial results (the reference's
  ``shard_map`` transpose). Under ``DEFAULT_RULES`` (training) the expert weights are
  FSDP-sharded over ``data`` on D and all-gathered here, as in the
  reference. Under ``SERVE_RULES`` each rank holds experts over the whole
  mesh, with D whole: the branch reshards explicitly, all-gathering over
  the expert spec's axes but ``model`` along the expert axis, so model
  rank m holds the full-mesh expert blocks (c, m) for every c of the other
  axes (not the reference's contiguous block m: each expert still sits on
  exactly one model rank, so the sum differs only in its order);
* on a mesh without a ``model`` axis that divides E: the local path on the
  whole batch, its expert weights gathered whole, with the capacity of
  ``T_loc`` (the reference's local branch on a mesh): the ranks' rows
  are gathered first and each keeps its own rows of the output; the aux,
  the same on every rank, is ``pmean``'d over the batch axes, so that its
  gradient is counted once.

``mesh.counts`` records the path each call took (``moe_full_ep``,
``moe_shard_map``, ``moe_local``).

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
call's T = B * S tokens (T_loc in the ``shard_map`` branch). A decode step
(T = B) and a prefill (T = B * P) of the same batch therefore drop
differently under one capacity factor, and teacher forcing holds only at a
factor that drops nothing (>= E / k).

:func:`routing` gives the routing ``moe_apply`` takes on an input: the
experts the router chose, the assignments kept within capacity and the
experts that receive one, on the local path.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import collectives as coll
from .common import act_fn, mlp
from .params import meta, rules_for, spec_for


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


def _slots(loc_e, mine, E_loc: int, capacity: int):
    """Each assignment's slot in its local expert's buffer (the number of
    earlier assignments, token-major then rank, to the same expert) and
    whether it is kept: the expert is local (``mine``; ``None``: every
    expert is) and the slot within ``capacity``. ``loc_e``: each
    assignment's local expert (any value where not ``mine``)."""
    if mine is None:
        onehot = F.one_hot(loc_e, E_loc)                    # (T*k, E_loc)
    else:
        onehot = (F.one_hot(torch.where(mine, loc_e, 0), E_loc)
                  * mine[:, None])
    pos_e = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    keep = pos_e < capacity
    return pos_e, keep if mine is None else mine & keep


def _local_moe(x, router_w, bias, wg, wu, wd, *, cfg, capacity: int,
               act: str, experts: Optional[torch.Tensor] = None, mesh=None,
               fsdp_axis=None, model_axis=None, batch_axes=()):
    """x: (T, D) -> (out (T, D), aux): the reference's ``_local_moe``.

    ``experts`` are the global ids of the experts in ``wg`` / ``wu`` /
    ``wd``, in their order (the reference's contiguous ``e_lo`` ..
    ``e_lo + E_loc``; ``None``: all of them, ``e_lo = 0``); an assignment
    to another expert is not ``mine`` and adds nothing here. On ``mesh``:
    ``fsdp_axis`` all-gathers the expert weights' D (dim 1 of ``wg`` /
    ``wu``, dim 2 of ``wd``) first (their gradients summed over
    ``batch_axes``), and ``model_axis`` sums the output over its ranks
    last."""
    if fsdp_axis is not None:
        wg, wu = (coll.all_gather(w, mesh, fsdp_axis, 1,
                                  batch_axes=batch_axes) for w in (wg, wu))
        wd = coll.all_gather(wd, mesh, fsdp_axis, 2, batch_axes=batch_axes)
    E_loc = wg.shape[0]
    T, D = x.shape
    k = cfg.top_k
    logits, gates, eidx = _route(x, router_w, bias, cfg)

    flat_e = eidx.reshape(-1)
    if experts is None:
        loc_e, mine = flat_e, None
    else:
        local_of = torch.full((cfg.n_experts,), -1, dtype=flat_e.dtype,
                              device=x.device)
        local_of[experts] = torch.arange(E_loc, device=x.device)
        loc_e = local_of[flat_e]
        mine = loc_e >= 0
    pos_e, keep = _slots(loc_e, mine, E_loc, capacity)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)

    # dropped (or not local) assignments go to the dump row E_loc * C,
    # never onto a kept slot
    dest = torch.where(keep, loc_e * capacity + pos_e,
                       torch.full_like(pos_e, E_loc * capacity))
    buf = torch.zeros((E_loc * capacity + 1, D), dtype=x.dtype,
                      device=x.device)
    buf[dest] = x[tok]
    out_buf = _expert_ffn(buf[:-1].view(E_loc, capacity, D), wg, wu, wd, act)
    out_flat = torch.cat([out_buf.reshape(E_loc * capacity, D),
                          out_buf.new_zeros((1, D))])
    vals = out_flat[dest] * gates.reshape(-1)[:, None]          # (T*k, D)
    # the combine: a token's k rows are contiguous; a fixed-order sum
    out = vals.to(x.dtype).view(T, k, D).sum(1)
    if model_axis is not None:
        out = coll.psum(out, mesh, model_axis)

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
    flat_e = eidx.reshape(-1)
    _, keep = _slots(flat_e, None, E, capacity)
    used = torch.zeros(E + 1, dtype=torch.bool, device=x.device)
    used[torch.where(keep, flat_e, E)] = True
    return {"tokens": T, "assignments": T * k, "capacity": capacity,
            "experts": eidx, "kept": keep.view(T, k),
            "dropped": (~keep).sum(), "experts_used": used[:E]}


def _expert_specs(p, cfg, mesh, mode: str):
    """The specs of ``w_gate`` / ``w_up`` / ``w_down`` as held on ``mesh``
    in ``mode`` (:func:`repro_torch.models.params.rules_for`)."""
    metas = moe_meta(cfg, p["w_gate"].dtype)
    rules = rules_for(mode)
    return tuple(spec_for(metas[n], mesh, rules)
                 for n in ("w_gate", "w_up", "w_down"))


def _shared(p, x, y, cfg):
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x, cfg.act)
    return y


def moe_apply(p, x, *, cfg, mesh=None, batch_axes=("data",),
              capacity_factor: float = 1.25, mode: str = "train"):
    """x: (B, S, D) -> (y (B, S, D), aux), by the reference's choice of
    path (module docstring). Without a mesh every mode runs the local
    path. On a mesh of ranks the parameters are this rank's shards under
    ``rules_for(mode)`` (the shared experts and the router whole, as the
    model's per-unit gather leaves them), and x and y are this rank's rows
    of the batch, split over the present ``batch_axes``, in every mode.
    Where the reference holds the tokens replicated (full expert
    parallelism in serving, the local path on a mesh) the rows are
    all-gathered over the batch axes, the path runs on the whole batch,
    and the rank keeps its rows of the output."""
    B, S, D = x.shape
    E = cfg.n_experts
    if mesh is None:
        capacity = capacity_for(B * S, cfg, capacity_factor)
        out, aux = _local_moe(x.reshape(B * S, D), p["router"], p["bias"],
                              p["w_gate"], p["w_up"], p["w_down"], cfg=cfg,
                              capacity=capacity, act=cfg.act)
        return _shared(p, x, out.reshape(B, S, D), cfg), aux

    data_axes = tuple(a for a in (batch_axes or ()) if a in mesh.shape)
    dp = coll.axis_size(mesh, data_axes)

    def rows(y):
        """This rank's rows of the whole batch's ``y``."""
        return y.view(-1, S, D)[coll.block_slice(B * dp, mesh, data_axes)]

    if mode != "train" and B * dp * S <= 16384:
        ep_axes = tuple(a for a in ("pod", "data", "model")
                        if a in mesh.shape)
        while ep_axes and E % coll.axis_size(mesh, ep_axes) != 0:
            ep_axes = ep_axes[1:]
        if len(ep_axes) > 1:
            # the reference's tokens are replicated and its capacity
            # counts the whole batch's
            y, aux = _moe_full_ep(p, coll.all_gather(x, mesh, data_axes, 0),
                                  cfg=cfg, mesh=mesh, ep_axes=ep_axes,
                                  capacity_factor=capacity_factor)
            return rows(y), aux

    model_ok = ("model" in mesh.shape and mesh.shape["model"] > 1
                and E % mesh.shape["model"] == 0)
    capacity = capacity_for(B * S, cfg, capacity_factor)
    specs = _expert_specs(p, cfg, mesh, mode)
    if not model_ok:
        mesh.counts["moe_local"] += 1
        wg, wu, wd = (coll.unshard(p[n], sp, mesh, batch_axes=data_axes)
                      for n, sp in zip(("w_gate", "w_up", "w_down"), specs))
        # the reference's local path runs the whole batch at the capacity
        # of a batch shard's tokens
        xg = coll.all_gather(x, mesh, data_axes, 0, batch_axes=data_axes)
        out, aux = _local_moe(xg.reshape(-1, D), p["router"], p["bias"],
                              wg, wu, wd, cfg=cfg, capacity=capacity,
                              act=cfg.act)
        aux = coll.pmean(aux, mesh, data_axes)
        return _shared(p, x, rows(out), cfg), aux

    # the shard_map branch: experts over model, the batch over data_axes
    mesh.counts["moe_shard_map"] += 1
    mp = mesh.shape["model"]
    m = mesh.coord["model"]
    e_axes = specs[0][0]
    e_axes = (e_axes,) if isinstance(e_axes, str) else tuple(e_axes)
    if e_axes[-1:] != ("model",) or any(sp[0] != specs[0][0]
                                        for sp in specs):
        raise ValueError(f"expert weights laid out as {specs}: the "
                         f"shard_map branch needs the expert axis over "
                         f"model")
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    outer = e_axes[:-1]
    E_blk = E // coll.axis_size(mesh, e_axes)
    if outer:
        # SERVE_RULES: experts over the whole mesh; gather this model
        # rank's blocks (c, m) over the other axes, c in rank order
        wg, wu, wd = (coll.all_gather(w, mesh, outer, 0)
                      for w in (wg, wu, wd))
    blocks = torch.arange(coll.axis_size(mesh, outer)) * mp + m
    experts = (blocks[:, None] * E_blk
               + torch.arange(E_blk)[None, :]).reshape(-1).to(x.device)
    # D over data (DEFAULT_RULES' FSDP): gathered in _local_moe, as in the
    # reference; every other sharded dim of the experts is gathered here
    fsdp_axis = specs[0][1]
    if specs[1][1] != fsdp_axis or specs[2][2] != fsdp_axis:
        raise ValueError(f"expert weights laid out as {specs}")
    wg = coll.unshard(wg, (None, None) + specs[0][2:], mesh,
                      batch_axes=data_axes)
    wu = coll.unshard(wu, (None, None) + specs[1][2:], mesh,
                      batch_axes=data_axes)
    wd = coll.unshard(wd, (None, specs[2][1], None), mesh,
                      batch_axes=data_axes)

    router, bias, x_in = (coll.pvary(t, mesh, "model")
                          for t in (p["router"], p["bias"], x))
    out, aux = _local_moe(x_in.reshape(B * S, D), router, bias, wg, wu, wd,
                          cfg=cfg, capacity=capacity, act=cfg.act,
                          experts=experts, mesh=mesh, fsdp_axis=fsdp_axis,
                          model_axis="model", batch_axes=data_axes)
    aux = coll.pmean(aux, mesh, data_axes + ("model",))
    return _shared(p, x, out.reshape(B, S, D), cfg), aux


def _moe_full_ep(p, x, *, cfg, mesh, ep_axes, capacity_factor):
    """Serving-time full-mesh expert parallelism: tokens replicated (tiny),
    each rank runs its E / ep experts (contiguous, the last EP axis varying
    fastest), one ``psum`` over all EP axes; the aux ``pmean``'d."""
    mesh.counts["moe_full_ep"] += 1
    B, S, D = x.shape
    E = cfg.n_experts
    E_loc = E // coll.axis_size(mesh, ep_axes)
    if p["w_gate"].shape[0] != E_loc:
        raise ValueError(f"full expert parallelism over {ep_axes} needs "
                         f"{E_loc} experts a rank, got "
                         f"{p['w_gate'].shape[0]}: hold the experts under "
                         f"SERVE_RULES")
    T = B * S
    capacity = capacity_for(T, cfg, capacity_factor)
    e_lo = coll.axis_index(mesh, ep_axes) * E_loc
    out, aux = _local_moe(x.reshape(T, D), p["router"], p["bias"],
                          p["w_gate"], p["w_up"], p["w_down"], cfg=cfg,
                          capacity=capacity, act=cfg.act,
                          experts=torch.arange(e_lo, e_lo + E_loc,
                                               device=x.device),
                          mesh=mesh, model_axis=ep_axes)
    aux = coll.pmean(aux, mesh, ep_axes)
    return _shared(p, x, out.reshape(B, S, D), cfg), aux
