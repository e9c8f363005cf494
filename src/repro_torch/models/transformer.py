"""Model assembly: decoder LMs, encoder-decoders and front ends on the
port's mixers and MLPs.

The port of the reference's ``repro.models.transformer``: ``attn`` /
``attn_local`` (GQA), ``mla`` (DeepSeek's latent attention), ``rg``
(RG-LRU) and ``rwkv`` (RWKV-6) mixers, each with a dense or a
mixture-of-experts MLP (olmo-1b, gemma3-1b, qwen3-32b, qwen1.5-110b,
qwen3-moe-30b-a3b, recurrentgemma-2b, rwkv6-7b, deepseek-v3-671b); a
non-causal encoder whose output the decoder's cross-attention layers read
(seamless-m4t-large-v2, fed precomputed audio frames); and a vision front
end that prepends projected patch embeddings to the tokens
(llava-next-mistral-7b). Layers are grouped into *segments*, (pattern,
repeats) pairs, exactly as the reference groups them; a segment's
parameters and caches are stacked with the repeat axis first, and this
port walks the repeats in a Python loop (the reference's
``scan_layers=False`` walk).
Parameter layouts are the reference's, so its weights carry across by name
(:func:`repro_torch.convert.lm_params_from_arrays`); only training reads
deepseek-v3's ``mtp`` block.

Every mode (``train``, ``prefill``, ``decode``) walks the same segments.
``train`` keeps no cache and runs under autograd: :meth:`LM.train_loss`
is the next-token cross entropy, plus DeepSeek's multi-token-prediction
loss (``_mtp_loss``) and the MoE load-balance loss where the config has
them; with ``cfg.remat`` each unit of a stacked segment is recomputed in
the backward pass (``torch.utils.checkpoint``), so only one unit's
activations live at a time. Serving runs the encoder as a prefill whose
caches are dropped, training in ``train`` mode (the reference's mode for
it; the two differ only in the caches).

On a mesh of ranks (:func:`repro_torch.launch.mesh.make_rank_mesh`),
serving takes the reference's layout (its ``launch.steps.cache_specs``).
:meth:`LM.prefill` is given the whole batch and runs this rank's rows of
it, split over the present ``batch_axes`` that divide the batch (the
leading ones dropped until they do, :func:`repro_torch.distributed.
sharding.batch_split`; none: the batch is replicated); it returns those
rows' logits and prompt caches. :func:`repro_torch.serving.seed_caches`
keeps this rank's block of every decode cache leaf under
:func:`cache_specs`: its rows; a kv, latent or cross-attention cache's
sequence over ``model``; a recurrent state's channels or heads over
``model``. :meth:`LM.decode_step` takes those blocks and its rows'
tokens. Decode attention over a sequence-split cache reduces each of
softmax's reductions locally and then across ``model`` (a ``pmax`` of the
rows' maxima, a ``psum`` of their sums of exp and of the partial p·v: the
reference's distributed LSE combine); only the rank that holds a token's
slot writes it. RG-LRU runs the rank's channels and RWKV-6 the rank's
heads (its token shift, the previous input, is all-gathered whole), each
completing its output projection by a ``psum`` over ``model``. A leaf
that ``model`` does not divide stays whole. Parameters are sharded under
``SERVE_RULES``.
:meth:`LM.train_loss` trains from parameters sharded under
``DEFAULT_RULES`` (FSDP over ``data``, tensor-parallel over ``model``):
every rank is given the whole batch and scores its rows of it, split over
``batch_axes``; its activations are whole along ``model``. In every mode
the embedding table and an untied head are vocabulary-parallel (a masked
lookup summed over the vocabulary's axes; local logits gathered along the
vocabulary), and before each unit of a segment runs, each rank all-gathers
the unit's leaves that are sharded outside the MoE's experts
(:meth:`LM._unit_unshard`), so the unit computes on whole dense weights;
the MoE's experts stay sharded and take the reference's expert-parallel
paths (:mod:`repro_torch.models.moe`). The gradients flow back through
the collectives' backward rules (:mod:`repro_torch.distributed.collectives`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from ..distributed import collectives as coll
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec
from ..distributed.sharding import batch_rows, batch_split
from .common import (acc_dtype, chunked_softmax_xent, embed, embed_meta,
                     logits_fn, make_norm, mlp, mlp_meta, unembed_meta)
from .params import (ParamMeta, count_params, init_tree, map_tree, meta,
                     rules_for, shard_metas, spec_for)


# ---------------- layer descriptors & segments ----------------
@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str     # attn | attn_local | rg | rwkv | mla
    mlp: str       # dense | moe
    cross: bool = False


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerDesc, ...]
    repeats: int


def layer_descs(cfg: ModelConfig, cross: bool = False) -> List[LayerDesc]:
    kinds = cfg.layer_kinds()
    descs = []
    for i, k in enumerate(kinds):
        if cfg.use_mla and k == "attn":
            k = "mla"
        mlp_kind = ("moe" if (cfg.n_experts and i >= cfg.first_dense_layers)
                    else "dense")
        descs.append(LayerDesc(k, mlp_kind, cross))
    return descs


def make_segments(descs: Sequence[LayerDesc]) -> List[Segment]:
    """Greedy periodic segmentation: find the shortest repeating unit of the
    remaining prefix, take as many whole repeats as possible."""
    segs: List[Segment] = []
    i = 0
    n = len(descs)
    while i < n:
        best = (1, 1)  # fall back to a single unrolled layer
        for plen in range(1, min(8, (n - i) // 2) + 1):
            pat = descs[i:i + plen]
            reps = 1
            while descs[i + reps * plen: i + (reps + 1) * plen] == pat:
                reps += 1
            # only repeating units are worth a stacked segment; unrolled
            # singletons otherwise (keeps heterogeneous prefixes like
            # deepseek's 3 dense layers out of wide unrolled patterns)
            if reps >= 2 and reps * plen > best[0] * best[1]:
                best = (plen, reps)
        plen, reps = best
        segs.append(Segment(tuple(descs[i:i + plen]), reps))
        i += plen * reps
    return segs


# ---------------- per-layer params ----------------
def _mixer_meta(cfg: ModelConfig, kind: str, dtype):
    if kind in ("attn", "attn_local"):
        return attn.attn_meta(cfg, dtype)
    if kind == "mla":
        return attn.mla_meta(cfg, dtype)
    if kind == "rg":
        return rec.rglru_meta(cfg, dtype)
    if kind == "rwkv":
        return rec.rwkv6_meta(cfg, dtype)
    raise ValueError(kind)


def layer_meta(cfg: ModelConfig, desc: LayerDesc):
    norm_meta_fn, _ = make_norm(cfg)
    dtype = cfg.pdtype
    p = {
        "norm1": norm_meta_fn(cfg.d_model, dtype),
        "mixer": _mixer_meta(cfg, desc.mixer, dtype),
        "norm2": norm_meta_fn(cfg.d_model, dtype),
        "mlp": (moe_mod.moe_meta(cfg, dtype) if desc.mlp == "moe"
                else mlp_meta(cfg.d_model, cfg.d_ff, dtype, bias=False)),
    }
    if desc.cross:
        p["norm_cross"] = norm_meta_fn(cfg.d_model, dtype)
        p["cross"] = attn.attn_meta(cfg, dtype)
    return p


def _stack_meta(tree, n: int):
    return map_tree(lambda m: ParamMeta((n,) + m.shape, ("stack",) + m.axes,
                                        m.dtype, m.init, m.scale), tree)


def segment_meta(cfg: ModelConfig, seg: Segment):
    pat = {f"L{j}": layer_meta(cfg, d) for j, d in enumerate(seg.pattern)}
    return _stack_meta(pat, seg.repeats) if seg.repeats > 1 else pat


# ---------------- layer forward ----------------
def _theta_window(cfg: ModelConfig, desc: LayerDesc):
    if desc.mixer == "attn_local":
        return cfg.rope_theta, cfg.window
    theta = cfg.rope_theta_global or cfg.rope_theta
    return theta, None


def _split_axis(mesh, spec, leaf: int, dim: int):
    """The mesh axis over which ``spec`` (a layer's tree of cache specs,
    :func:`cache_specs`) splits dim ``dim`` of cache leaf ``leaf``, or
    ``None``: no spec, a whole dim, or an axis of one rank."""
    if mesh is None or spec is None:
        return None
    entry = spec[leaf][dim]
    return entry if entry is not None and coll.axis_size(mesh, entry) > 1 \
        else None


def layer_apply(lp, x, desc: LayerDesc, *, cfg: ModelConfig, mode: str,
                cache, positions, cur_pos, mesh=None, batch_axes=("data",),
                cross_memory=None, kv_len=None, cache_spec=None):
    """One pre-norm block: mixer, then (in a ``cross`` layer)
    cross-attention over ``cross_memory``, then MLP (dense or MoE), each
    added to the residual. A cross layer's cache is ``{"self": mixer
    cache, "cross": (k, v)}``. Returns (x, new_cache, aux): the MoE's
    load-balance loss, a float32 scalar (0.0 for a dense MLP). On a mesh,
    every leaf but the MoE's experts is whole (:meth:`LM._unit_unshard`),
    ``x`` holds this rank's rows of the batch (split over ``batch_axes``
    in serving) and the MoE takes ``mesh`` / ``batch_axes``; in decode,
    ``cache`` is this rank's block of the layer's caches, laid out by
    ``cache_spec`` (the layer's subtree of :func:`cache_specs`, without a
    stack entry), whose split dims the mixers read."""
    _, norm = make_norm(cfg)
    aux = 0.0
    cross_spec = None
    if desc.cross and isinstance(cache, dict):
        cache, cross_cache = cache["self"], cache["cross"]
        if cache_spec is not None:
            cache_spec, cross_spec = cache_spec["self"], cache_spec["cross"]
    else:
        cross_cache = None
    h = norm(lp["norm1"], x)
    if desc.mixer in ("attn", "attn_local"):
        theta, window = _theta_window(cfg, desc)
        h, new_cache = attn.attn_apply(
            lp["mixer"], h, cfg=cfg, rope_theta=theta, window=window,
            positions=positions, mode=mode, cache=cache, cur_pos=cur_pos,
            kv_len=kv_len, causal=cfg.causal, mesh=mesh,
            seq_axis=_split_axis(mesh, cache_spec, 0, 1))
    elif desc.mixer == "mla":
        h, new_cache = attn.mla_apply(
            lp["mixer"], h, cfg=cfg, positions=positions, mode=mode,
            cache=cache, cur_pos=cur_pos, mesh=mesh,
            seq_axis=_split_axis(mesh, cache_spec, 0, 1),
            rank_axis=_split_axis(mesh, cache_spec, 0, 2),
            rope_axis=_split_axis(mesh, cache_spec, 1, 2))
    elif desc.mixer == "rg":
        if _split_axis(mesh, cache_spec, 0, 1) is not None:
            raise ValueError(f"RG-LRU's conv state split over its window "
                             f"({cache_spec[0]}): the model axis divides "
                             f"conv_width - 1")
        h, new_cache = rec.rglru_apply(
            lp["mixer"], h, cfg=cfg, mode=mode, cache=cache, mesh=mesh,
            channel_axis=_split_axis(mesh, cache_spec, 1, 1))
    elif desc.mixer == "rwkv":
        h, new_cache = rec.rwkv6_apply(
            lp["mixer"], h, cfg=cfg, mode=mode, cache=cache,
            chunk=cfg.rwkv_chunk, mesh=mesh,
            shift_axis=_split_axis(mesh, cache_spec, 0, 1),
            head_axis=_split_axis(mesh, cache_spec, 1, 1))
    else:
        raise ValueError(desc.mixer)
    x = x + h
    if desc.cross:
        h = norm(lp["norm_cross"], x)
        h, new_cross = attn.attn_apply(
            lp["cross"], h, cfg=cfg, rope_theta=cfg.rope_theta, window=None,
            positions=positions, mode=mode, cache=cross_cache,
            cur_pos=cur_pos, cross_memory=cross_memory, is_cross=True,
            mesh=mesh, seq_axis=_split_axis(mesh, cross_spec, 0, 1))
        x = x + h
        new_cache = {"self": new_cache, "cross": new_cross}
    h = norm(lp["norm2"], x)
    if desc.mlp == "moe":
        h, aux = moe_mod.moe_apply(lp["mlp"], h, cfg=cfg, mesh=mesh,
                                   batch_axes=batch_axes,
                                   capacity_factor=cfg.capacity_factor,
                                   mode=mode)
    else:
        h = mlp(lp["mlp"], h, cfg.act)
    return x + h, new_cache, aux


# ---------------- cache construction ----------------
@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A cache leaf's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``), and where its sequence axis lies, counted
    from the end (-3 for a (.., B, S, Hkv, Dh) kv leaf, -2 for MLA's
    (.., B, S, r) leaves), or ``None`` for a leaf that the prompt does not
    extend: a recurrent state, or a cross-attention leaf, which holds the
    encoder's enc_len entries. :func:`repro_torch.serving.seed_caches`
    places a prompt along that axis."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    seq_axis: Optional[int] = None


def cache_meta_for_desc(cfg: ModelConfig, desc: LayerDesc, batch: int,
                        max_len: int, enc_len: int = 0):
    """The shape tree of one layer's decode cache: (k, v) for attention,
    where a local layer holds min(max_len, window) entries (a ring once
    the window is shorter than the sequence); (latent, k_rope) for MLA;
    (conv window, h) for RG-LRU; (token shift, state) for RWKV. The
    recurrent states are float32 (float64 in a float64 model). A cross
    layer's cache is ``{"self": that, "cross": (k, v)}`` with (B, enc_len,
    Hkv, Dh) cross leaves."""
    ad, D, B = cfg.adtype, cfg.d_model, int(batch)
    acc = acc_dtype(ad)
    if desc.mixer in ("attn", "attn_local"):
        _, window = _theta_window(cfg, desc)
        M = min(max_len, window) if window else max_len
        kv = ShapeDtype((B, int(M), cfg.n_kv_heads, cfg.head_dim), ad, -3)
        base = (kv, kv)
    elif desc.mixer == "mla":
        base = (ShapeDtype((B, int(max_len), cfg.kv_lora_rank), ad, -2),
                ShapeDtype((B, int(max_len), cfg.qk_rope_dim), ad, -2))
    elif desc.mixer == "rg":
        base = (ShapeDtype((B, cfg.conv_width - 1, cfg.lru_width), ad),
                ShapeDtype((B, cfg.lru_width), acc))
    elif desc.mixer == "rwkv":
        Dh = D // cfg.n_heads
        base = (ShapeDtype((B, D), ad),
                ShapeDtype((B, cfg.n_heads, Dh, Dh), acc))
    else:
        raise ValueError(desc.mixer)
    if desc.cross:
        ckv = ShapeDtype((B, int(enc_len), cfg.n_kv_heads, cfg.head_dim), ad)
        return {"self": base, "cross": (ckv, ckv)}
    return base


def _unit_cache_meta(cfg: ModelConfig, seg: Segment, batch: int,
                     max_len: int, enc_len: int = 0):
    """One unit of ``seg``'s cache shape tree, unstacked."""
    return {f"L{j}": cache_meta_for_desc(cfg, d, batch, max_len, enc_len)
            for j, d in enumerate(seg.pattern)}


def cache_meta(cfg: ModelConfig, segments: Sequence[Segment], batch: int,
               max_len: int, enc_len: int = 0):
    out = []
    for seg in segments:
        unit = _unit_cache_meta(cfg, seg, batch, max_len, enc_len)
        if seg.repeats > 1:
            unit = map_tree(lambda s: dataclasses.replace(
                s, shape=(seg.repeats,) + s.shape), unit)
        out.append(unit)
    return out


def _seq_axis(mesh, n: int) -> Optional[str]:
    """``model`` where the mesh has it and it divides ``n``, else
    ``None`` (reads ``mesh.shape``)."""
    size = mesh.shape.get("model", 0)
    return "model" if size > 0 and n % size == 0 else None


def _leaf_spec(mesh, b_axes, shape) -> tuple:
    """A decode cache leaf's spec (the reference's ``leaf_spec``)."""
    if len(shape) == 4:     # (B, M, Hkv, Dh) kv / (B, H, Dk, Dv) rwkv state
        return (b_axes, _seq_axis(mesh, shape[1]), None, None)
    if len(shape) == 3:     # (B, M, r) latent / (B, ck-1, W) conv
        ax = _seq_axis(mesh, shape[1])
        if ax:
            return (b_axes, ax, None)
        return (b_axes, None, _seq_axis(mesh, shape[2]))
    if len(shape) == 2:     # (B, W) state / (B, D) shift
        return (b_axes, _seq_axis(mesh, shape[1]))
    return (None,) * len(shape)


def cache_unit_specs(cfg: ModelConfig, seg: Segment, mesh, batch_axes,
                     batch: int, max_len: int, enc_len: int = 0):
    """:func:`cache_specs` of one unit of ``seg``, without the stack
    entry: ``{"L<j>": the layer's tree of specs}``."""
    b_axes = tuple(batch_axes)
    b_axes = None if not b_axes else (b_axes[0] if len(b_axes) == 1
                                      else b_axes)
    return map_tree(lambda sd: _leaf_spec(mesh, b_axes, sd.shape),
                    _unit_cache_meta(cfg, seg, batch, max_len, enc_len))


def cache_specs(lm, mesh, batch_axes, batch: int, max_len: int,
                enc_len: int = 0):
    """The reference's layout of the decode caches
    (``repro.launch.steps.cache_specs``), a spec tree shaped as
    ``lm.decode_cache_meta``: the batch over ``batch_axes`` (a single axis
    by its name, several as a tuple, none as ``None``), a kv, latent or
    cross-attention cache's sequence axis over ``model``, a recurrent
    state's heads or channels over ``model`` (an RG-LRU conv window over
    ``model`` where ``model`` divides ``conv_width - 1``), each only where
    ``model`` divides the dim; a stacked segment's leaves get a leading
    ``None``. Reads ``mesh.shape`` only. Serving on a mesh of ranks holds
    each rank's block of every leaf under these specs
    (:func:`repro_torch.distributed.sharding.rank_box`; module
    docstring)."""
    out = []
    for seg in lm.layout:
        stack = (None,) if seg.repeats > 1 else ()
        unit = cache_unit_specs(lm.cfg, seg, mesh, batch_axes, batch,
                                max_len, enc_len)
        out.append(map_tree(lambda sd, sp: stack + sp,
                            _unit_cache_meta(lm.cfg, seg, batch, max_len,
                                             enc_len), unit))
    return out


def zeros_like_meta(tree, device):
    return map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), tree)


# ---------------- segment walk ----------------
def segment_apply(seg_p, x, seg: Segment, *, cfg: ModelConfig, mode: str,
                  caches, positions, cur_pos, mesh=None,
                  batch_axes=("data",), cross_memory=None, kv_len=None,
                  unshard=None, cache_spec=None):
    """Run one segment: its pattern once, or for each of its repeats the
    repeat's slice of the stacked parameters and caches. Returns (x, new
    caches, the summed load-balance aux).

    ``train`` returns no caches; with ``cfg.remat`` each repeat of a
    stacked segment runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` around its scanned unit). ``prefill`` returns the
    prompt's caches, stacked like the parameters. ``decode`` updates
    ``caches`` in place (a repeat's slice is a view of the stacked tensor)
    and returns them.

    ``unshard``: on ``mesh``, one unit's (unstacked) tree of the specs its
    leaves are held under (:meth:`LM._unit_unshard`), ``None`` for a leaf
    used as it is; each unit all-gathers those leaves whole before it
    runs (in training, their gradients are summed over ``batch_axes``).
    ``cache_spec``: in decode on ``mesh``, one unit's tree of the specs
    its caches are laid out by (:func:`cache_unit_specs`)."""

    def unit(lp, xx, cache_unit):
        if unshard is not None:
            lp = map_tree(lambda t, sp: t if sp is None
                          else coll.unshard(t, sp, mesh,
                                            batch_axes=batch_axes),
                          lp, unshard)
        new_c, aux = {}, 0.0
        for j, d in enumerate(seg.pattern):
            c = cache_unit[f"L{j}"] if cache_unit is not None else None
            xx, new_c[f"L{j}"], a = layer_apply(
                lp[f"L{j}"], xx, d, cfg=cfg, mode=mode, cache=c,
                positions=positions, cur_pos=cur_pos, mesh=mesh,
                batch_axes=batch_axes, cross_memory=cross_memory,
                kv_len=kv_len, cache_spec=None if cache_spec is None
                else cache_spec[f"L{j}"])
            aux = aux + a
        return xx, new_c, aux

    if seg.repeats == 1:
        x, nc, aux = unit(seg_p, x, caches)
        return x, None if mode == "train" else nc, aux
    remat = mode == "train" and cfg.remat
    ncs, aux = [], 0.0
    for r in range(seg.repeats):
        lp = map_tree(lambda t: t[r], seg_p)
        cu = map_tree(lambda t: t[r], caches) if caches is not None else None
        if remat:
            x, nc, a = checkpoint(unit, lp, x, cu, use_reentrant=False)
        else:
            x, nc, a = unit(lp, x, cu)
        ncs.append(nc)
        aux = aux + a
    if mode == "train":
        return x, None, aux
    if mode == "decode":
        return x, caches, aux
    return x, map_tree(lambda *ts: torch.stack(ts), *ncs), aux


# ---------------- the model ----------------

class _Params(nn.Module):
    """A parameter tree as modules: a dict's keys (or a list's positions)
    name the children, and each tensor leaf is a parameter. So a leaf's
    ``state_dict`` key is its path in the reference's tree."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, list)
        items = list(enumerate(tree) if self._is_list else tree.items())
        self._keys = [str(k) for k, _ in items]
        for k, v in items:
            if isinstance(v, (dict, list)):
                self.add_module(str(k), _Params(v))
            else:
                self.register_parameter(
                    str(k), nn.Parameter(v, requires_grad=False))

    def tree(self):
        vals = [self._modules[k].tree() if k in self._modules
                else self._parameters[k] for k in self._keys]
        return vals if self._is_list else dict(zip(self._keys, vals))


def _check_tree(metas, tree, path: str = "") -> None:
    """Raise ``KeyError`` on a missing or unknown path and ``ValueError``
    on a leaf whose shape is not its meta's."""
    if isinstance(metas, (dict, list)):
        keys = (list(metas) if isinstance(metas, dict)
                else list(range(len(metas))))
        if not isinstance(tree, type(metas)):
            raise KeyError(f"{path or '<root>'}: expected a "
                           f"{type(metas).__name__}, got "
                           f"{type(tree).__name__}")
        have = list(tree) if isinstance(tree, dict) else list(range(len(tree)))
        missing = [k for k in keys if k not in have]
        unknown = [k for k in have if k not in keys]
        if missing or unknown:
            raise KeyError(f"{path or '<root>'}: missing {missing}, unknown "
                           f"{unknown}")
        for k in keys:
            _check_tree(metas[k], tree[k], f"{path}.{k}" if path else str(k))
        return
    if tuple(tree.shape) != metas.shape:
        raise ValueError(f"{path}: shape {tuple(tree.shape)}, the config "
                         f"needs {metas.shape}")


class LM(nn.Module):
    """Decoder-only or encoder-decoder language model (attention, MLA,
    RG-LRU or RWKV-6 mixers; dense or MoE MLPs; an optional vision or
    audio front end).

    ``LM(cfg)`` allocates nothing: the parameter count and the cache shapes
    come from metadata. :meth:`init` draws the parameters from a
    ``torch.Generator`` onto a device, and :meth:`set_params` takes a tree
    (e.g. the reference's weights through
    :func:`repro_torch.convert.lm_params_from_arrays`); either registers
    them under the reference's tree paths (``embed.table``,
    ``segments.0.L0.mixer.wq``, ...). The segment layout (the reference's
    ``LM.segments``) is :attr:`layout`, the encoder's (the reference's
    ``LM.enc_segments``) :attr:`enc_layout`.

    A batch is a dict of ``tokens`` (B, P), and ``frames`` (B, enc_len,
    frontend_dim) for an encoder-decoder config (``n_enc_layers``) or
    ``patches`` (B, n_frontend_tokens, frontend_dim) for a
    ``vision_stub`` front end; arrays or tensors, moved to the parameters'
    device.

    :meth:`train_loss`, :meth:`prefill` and :meth:`decode_step` take a
    parameter tree first, as the reference's do; ``None`` means the
    registered parameters (registered with ``requires_grad=False``, so a
    training step hands :meth:`train_loss` a tree of leaves that require
    gradients, see :func:`repro_torch.training.make_train_step`).
    :meth:`prefill` and :meth:`decode_step` run under
    ``torch.inference_mode()`` on the parameters' device; with ``mesh``
    (a mesh of ranks) they take this rank's shards (:meth:`check_params`)
    and run this rank's rows of the batch over its blocks of the caches
    (module docstring).
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.descs = layer_descs(cfg, cross=cfg.n_enc_layers > 0)
        self.layout = make_segments(self.descs)
        self.enc_cfg = None
        self.enc_layout = None
        if cfg.n_enc_layers:
            self.enc_cfg = dataclasses.replace(cfg, causal=False,
                                               n_layers=cfg.n_enc_layers,
                                               n_experts=0, use_mla=False,
                                               block_pattern=(),
                                               local_per_global=0)
            self.enc_layout = make_segments(layer_descs(self.enc_cfg))
        self._metas = self.abstract_params()
        self._top = tuple(self._metas)

    # ----- params -----
    def abstract_params(self):
        cfg = self.cfg
        norm_meta_fn, _ = make_norm(cfg)
        p = {
            "embed": embed_meta(cfg.vocab, cfg.d_model, cfg.pdtype),
            "final_norm": norm_meta_fn(cfg.d_model, cfg.pdtype),
            "head": unembed_meta(cfg.vocab, cfg.d_model, cfg.pdtype,
                                 cfg.tie_embeddings),
            "segments": [segment_meta(cfg, s) for s in self.layout],
        }
        if self.enc_cfg is not None:
            p["encoder"] = {
                "segments": [segment_meta(self.enc_cfg, s)
                             for s in self.enc_layout],
                "final_norm": norm_meta_fn(cfg.d_model, cfg.pdtype),
            }
        if cfg.frontend in ("vision_stub", "audio_stub") and cfg.frontend_dim:
            p["frontend_proj"] = {
                "w": meta((cfg.frontend_dim, cfg.d_model), (None, "embed"),
                          cfg.pdtype)}
        if cfg.mtp:
            # DeepSeek-V3's multi-token-prediction block (_mtp_loss)
            p["mtp"] = {
                "proj": meta((2 * cfg.d_model, cfg.d_model), (None, "embed"),
                             cfg.pdtype),
                "norm_h": norm_meta_fn(cfg.d_model, cfg.pdtype),
                "norm_e": norm_meta_fn(cfg.d_model, cfg.pdtype),
                "layer": layer_meta(cfg, LayerDesc(
                    "mla" if cfg.use_mla else "attn",
                    "moe" if cfg.n_experts else "dense")),
            }
        return p

    def init(self, generator: torch.Generator, device=None):
        """Draw the parameters (the reference's init kinds and scales, see
        :func:`repro_torch.models.params.init_tree`) onto ``device``
        (``None`` means ``"cuda"``), register them and return the tree."""
        tree = init_tree(self.abstract_params(), generator,
                         resolve_device(device))
        self.set_params(tree)
        return self.params

    def set_params(self, tree) -> None:
        """Register ``tree`` (nested dicts and lists of tensors, shaped as
        :meth:`abstract_params`) as this model's parameters."""
        self.check_params(tree)
        for k in self._top:
            setattr(self, k, _Params(tree[k]))

    def check_params(self, tree, mesh=None, mode: str = "prefill") -> None:
        """Raise ``KeyError`` on a missing or unknown path of ``tree`` and
        ``ValueError`` on a leaf of another shape than the whole
        parameter's or, on ``mesh``, than this rank's shard of it under
        the rules of ``mode`` (``rules_for(mode)``: ``SERVE_RULES`` in
        serving, ``DEFAULT_RULES`` in ``train``; see
        :func:`repro_torch.models.params.init_tree` with ``mesh=``)."""
        metas = (self._metas if mesh is None
                 else shard_metas(self._metas, mesh, rules_for(mode)))
        _check_tree(metas, tree)

    @property
    def params(self):
        """The registered parameters as the reference's tree."""
        if "embed" not in self._modules:
            raise RuntimeError("LM has no parameters yet: call init() or "
                               "set_params()")
        return {k: self._modules[k].tree() for k in self._top}

    def param_count(self) -> int:
        return count_params(self.abstract_params())

    def active_param_count(self) -> int:
        """Activated params per token: a MoE layer counts top_k of its
        routed experts (the reference's count; the ``mtp`` block's experts
        are counted whole, as there)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        moe_layers = sum(1 for d in self.descs if d.mlp == "moe")
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        return total - moe_layers * (cfg.n_experts - cfg.top_k) * per_expert

    # ----- the mesh -----
    @staticmethod
    def _ranks(mesh):
        if mesh is not None and mesh.device_mesh is None:
            raise ValueError("the LM runs on a mesh of ranks "
                             "(make_rank_mesh), not on a logical mesh")
        return mesh

    def _unit_unshard(self, seg: Segment, mesh, cfg, mode: str):
        """One unit of ``seg``: the spec each leaf is held under on
        ``mesh`` in ``mode``, for the leaves the unit all-gathers whole
        before it runs, and ``None`` for the rest: the MoE's expert leaves
        (which ``moe_apply`` gathers as its path needs) and whole leaves.
        ``None`` without a mesh. The reference constrains the same leaves
        to their unsharded specs and lets XLA partition the products; the
        port gathers the tensor-parallel ``model`` axis too."""
        if mesh is None:
            return None
        rules = rules_for(mode)
        pat = {f"L{j}": layer_meta(cfg, d) for j, d in enumerate(seg.pattern)}

        def f(m):
            if any(a in ("expert", "expert_mlp") for a in m.axes):
                return None
            sp = spec_for(m, mesh, rules)
            return sp if any(e is not None for e in sp) else None

        return map_tree(f, pat)

    @staticmethod
    def _vocab_parallel(w, m: ParamMeta, vdim: int, mesh, mode: str,
                        batch_axes=()):
        """(``w``, this rank's shard of a leaf of meta ``m``, gathered
        whole but for its vocabulary dim ``vdim``; that dim's axes, or
        ``None`` where it is whole; the first vocabulary row it holds)."""
        if mesh is None:
            return w, None, 0
        spec = spec_for(m, mesh, rules_for(mode))
        w = coll.unshard(w, tuple(None if d == vdim else e
                                  for d, e in enumerate(spec)), mesh,
                         batch_axes=batch_axes)
        v_ax = spec[vdim]
        return w, v_ax, coll.axis_index(mesh, v_ax) * w.shape[vdim]

    def _table(self, params, mesh, mode: str, batch_axes=()):
        return self._vocab_parallel(params["embed"]["table"],
                                    self._metas["embed"]["table"], 0, mesh,
                                    mode, batch_axes)

    def _head(self, params, mesh, mode: str, batch_axes=()):
        if self.cfg.tie_embeddings:
            return self._table(params, mesh, mode, batch_axes)
        return self._vocab_parallel(params["head"]["w_out"],
                                    self._metas["head"]["w_out"], 1, mesh,
                                    mode, batch_axes)

    def _vocab_weights(self, params, mesh, mode: str, batch_axes=()):
        """``{"embed": ..., "head": ...}``, :meth:`_vocab_parallel`'s
        triple for the table and for the head (the table's, tied): gathered
        once for every lookup and logits chunk of a training step (the
        reference's ``_gather_embed``)."""
        emb = self._table(params, mesh, mode, batch_axes)
        return {"embed": emb, "head": emb if self.cfg.tie_embeddings
                else self._head(params, mesh, mode, batch_axes)}

    # ----- embedding -----
    def _embed_tokens(self, params, tokens, mesh=None, mode="train",
                      vocab=None):
        """The tokens' rows of the table, in the activation dtype (times
        sqrt(d_model) with ``embed_scale``). On a mesh whose vocabulary
        axes split the table, each rank looks up the tokens in its rows
        (zeros elsewhere) and a ``psum`` over those axes completes it.
        ``vocab``: :meth:`_vocab_weights` gathered already."""
        table, v_ax, v_lo = (vocab["embed"] if vocab
                             else self._table(params, mesh, mode))
        if v_ax is None:
            x = embed({"table": table}, tokens)
        else:
            loc = tokens - v_lo
            inside = (loc >= 0) & (loc < table.shape[0])
            x = torch.where(inside[..., None],
                            table[loc.clamp(0, table.shape[0] - 1)], 0)
            x = coll.psum(x, mesh, v_ax)
        x = x.to(self.cfg.adtype)
        if self.cfg.embed_scale:
            d = torch.tensor(float(self.cfg.d_model), dtype=torch.float32,
                             device=x.device)
            x = x * torch.sqrt(d).to(x.dtype)
        return x

    def _on_device(self, params, a):
        return torch.as_tensor(a, device=params["embed"]["table"].device)

    def _frontend(self, params, batch, tokens_x):
        """Prepend the projected patch embeddings (the vision stub) to the
        token embeddings."""
        emb = self._on_device(params, batch["patches"]).to(self.cfg.adtype)
        if "frontend_proj" in params:
            emb = emb @ params["frontend_proj"]["w"].to(emb.dtype)
        return torch.cat([emb, tokens_x], dim=1)

    def _encode(self, params, frames, mode: str = "prefill", mesh=None,
                batch_axes=("data",)):
        """The encoder over ``frames`` (B, enc_len, frontend_dim): cast to
        the activation dtype, projected by ``frontend_proj``, the
        non-causal layers at positions 0..enc_len-1 (in serving a prefill
        whose caches are dropped; ``mode="train"`` in training), then the
        encoder's final norm. The encoder has no experts, so the
        reference's aux is zero and not returned."""
        cfg = self.enc_cfg
        x = self._on_device(params, frames).to(cfg.adtype)
        if "frontend_proj" in params:
            x = x @ params["frontend_proj"]["w"].to(x.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        for sp, seg in zip(params["encoder"]["segments"], self.enc_layout):
            x, _, _ = segment_apply(
                sp, x, seg, cfg=cfg, mode=mode, caches=None,
                positions=positions, cur_pos=None, mesh=mesh,
                batch_axes=batch_axes,
                unshard=self._unit_unshard(seg, mesh, cfg, mode))
        _, norm = make_norm(cfg)
        return norm(params["encoder"]["final_norm"], x)

    def _logits(self, params, x, mesh, mode: str, vocab=None):
        """Logits of ``x`` over the vocabulary, whole (``logits_fn``). On a
        mesh whose vocabulary axes split the head (or the tied table),
        each rank multiplies by its vocabulary rows and the pieces are
        all-gathered along the vocabulary. ``vocab``:
        :meth:`_vocab_weights` gathered already."""
        tied = self.cfg.tie_embeddings
        w, v_ax, _ = (vocab["head"] if vocab
                      else self._head(params, mesh, mode))
        # each rank's logits are a part of the whole: x's gradient sums them
        x = coll.pvary(x, mesh, v_ax)
        local = logits_fn({"w_out": w}, {"table": w}, x, tied)
        return coll.all_gather(local, mesh, v_ax, -1)

    # ----- train -----
    def _whole_outside_units(self, params, mesh, batch_axes):
        """``params`` with the leaves that training reads outside the
        segments' units, the embedding and the head (the final norms,
        ``frontend_proj``, ``mtp``'s projection and norms) all-gathered
        whole from their ``DEFAULT_RULES`` shards."""
        rules = rules_for("train")

        def whole(key_tree, meta_tree):
            return map_tree(lambda t, m: coll.unshard(
                t, spec_for(m, mesh, rules), mesh, batch_axes=batch_axes),
                key_tree, meta_tree)

        out = dict(params, final_norm=whole(params["final_norm"],
                                            self._metas["final_norm"]))
        if "encoder" in params:
            out["encoder"] = dict(params["encoder"], final_norm=whole(
                params["encoder"]["final_norm"],
                self._metas["encoder"]["final_norm"]))
        if "frontend_proj" in params:
            out["frontend_proj"] = whole(params["frontend_proj"],
                                         self._metas["frontend_proj"])
        if "mtp" in params:
            out["mtp"] = dict(params["mtp"], **{
                k: whole(params["mtp"][k], self._metas["mtp"][k])
                for k in ("proj", "norm_h", "norm_e")})
        return out

    def train_loss(self, params, batch: Dict[str, Any], *, mesh=None,
                   batch_axes=("data",)):
        """The training loss of ``batch`` (``tokens`` (B, S) and their
        next-token ``labels`` (B, S); ``frames`` or ``patches`` as the
        config needs; a label below 0 is not scored): the cross entropy
        over every scored position (the patches' positions take label -1),
        plus 0.3 x the multi-token-prediction loss for an ``mtp`` config
        and 0.01 x the summed load-balance aux for a MoE config. Returns
        (loss, metrics): the loss is a scalar in the accumulation dtype
        under autograd; ``metrics`` holds ``xent``, ``aux``, ``tokens``
        (the scored positions) and, with ``mtp``, ``mtp``, detached.

        On ``mesh`` (a mesh of ranks; one rank is the mesh-less run)
        ``params`` are this rank's shards under ``DEFAULT_RULES``
        (:meth:`check_params` with ``mode="train"``) and ``batch`` the
        whole batch, the same on every rank: each rank scores its rows of
        it, split over the present ``batch_axes``
        (:func:`repro_torch.distributed.sharding.batch_rows`, which raises
        ``ValueError`` where they do not divide it). The cross entropy's
        sum over the rank's rows is divided by the scored positions of the
        whole batch and summed over ``batch_axes``, so every rank returns
        the loss of the whole batch and its gradients with respect to its
        shards are the slices of the whole batch's (the collectives'
        backward rules, :mod:`repro_torch.distributed.collectives`; a leaf
        replicated over a batch axis still needs its gradient summed over
        it, :func:`repro_torch.training.train_loop.sync_grads`). The MoE's
        aux is the reference's on a mesh: the mean over the batch shards
        of each shard's aux."""
        cfg = self.cfg
        mesh = self._ranks(mesh)
        if mesh is not None and mesh.size == 1:
            mesh = None
        params = self.params if params is None else params
        ba = ()
        if mesh is not None:
            ba = tuple(a for a in batch_axes if a in mesh.shape)
            batch = batch_rows(batch, mesh, ba)
            params = self._whole_outside_units(params, mesh, ba)
        vocab = self._vocab_weights(params, mesh, "train", ba)
        tokens = self._on_device(params, batch["tokens"])
        labels = self._on_device(params, batch["labels"])
        x = self._embed_tokens(params, tokens, mesh, "train", vocab)
        cross_memory = None
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.enc_cfg is not None:
            cross_memory = self._encode(params, batch["frames"], "train",
                                        mesh, ba)
        if cfg.frontend == "vision_stub":
            x = self._frontend(params, batch, x)
            pad = torch.full((labels.shape[0], x.shape[1] - labels.shape[1]),
                             -1, dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        for sp, seg in zip(params["segments"], self.layout):
            x, _, a = segment_apply(
                sp, x, seg, cfg=cfg, mode="train", caches=None,
                positions=positions, cur_pos=None, mesh=mesh, batch_axes=ba,
                cross_memory=cross_memory,
                unshard=self._unit_unshard(seg, mesh, cfg, "train"))
            aux_total = aux_total + a
        _, norm = make_norm(cfg)
        x = norm(params["final_norm"], x)
        logits = lambda xc: self._logits(params, xc, mesh, "train", vocab)
        loss, denom = self._xent(logits, x, labels, mesh, ba)
        metrics = {"xent": loss.detach(), "aux": aux_total.detach(),
                   "tokens": denom.detach()}
        if cfg.mtp:
            mtp_loss = self._mtp_loss(params, x, tokens, labels, positions,
                                      mesh, ba, vocab)
            metrics["mtp"] = mtp_loss.detach()
            loss = loss + 0.3 * mtp_loss
        if cfg.n_experts:
            loss = loss + 0.01 * aux_total
        return loss, metrics

    @staticmethod
    def _xent(logits, x, labels, mesh, ba):
        """(the cross entropy of the scored positions, their count), of
        the whole batch on a mesh: this rank's sum over the global count,
        summed over the batch axes ``ba``."""
        mask = (labels >= 0).to(acc_dtype(x.dtype))
        lab = torch.clamp(labels, min=0)
        if mesh is None:
            return chunked_softmax_xent(logits, x, lab, mask)
        denom = coll.psum(mask.sum(), mesh, ba)
        loss, _ = chunked_softmax_xent(logits, x, lab, mask, denom=denom)
        return coll.psum(loss, mesh, ba), denom

    def _mtp_loss(self, params, h, tokens, labels, positions, mesh=None,
                  ba=(), vocab=None):
        """DeepSeek-V3 multi-token prediction: one extra block predicts
        token t + 2 from [norm(h_t) ; norm(emb(token_{t+1}))] projected to
        d_model, through the final norm and the shared head. On a mesh
        the block's layer is gathered as a unit is."""
        cfg = self.cfg
        _, norm = make_norm(cfg)
        h_in = norm(params["mtp"]["norm_h"], h[:, :-1])
        e_in = norm(params["mtp"]["norm_e"],
                    self._embed_tokens(params, tokens[:, 1:], mesh, "train",
                                       vocab))
        x = (torch.cat([h_in, e_in], dim=-1)
             @ params["mtp"]["proj"].to(h.dtype))
        desc = LayerDesc("mla" if cfg.use_mla else "attn",
                         "moe" if cfg.n_experts else "dense")
        lp = params["mtp"]["layer"]
        if mesh is not None:
            us = self._unit_unshard(Segment((desc,), 1), mesh, cfg,
                                    "train")["L0"]
            lp = map_tree(lambda t, sp: t if sp is None else coll.unshard(
                t, sp, mesh, batch_axes=ba), lp, us)
        x, _, _ = layer_apply(lp, x, desc, cfg=cfg, mode="train", cache=None,
                              positions=positions[:-1], cur_pos=None,
                              mesh=mesh, batch_axes=ba)
        x = norm(params["final_norm"], x)
        logits = lambda xc: self._logits(params, xc, mesh, "train", vocab)
        loss, _ = self._xent(logits, x, labels[:, 1:], mesh, ba)
        return loss

    # ----- prefill -----
    @torch.inference_mode()
    def prefill(self, params, batch: Dict[str, Any], *, mesh=None,
                batch_axes=("data",), global_batch: Optional[int] = None):
        """Full-prompt forward; returns (last_logits (B, 1, V), caches).

        Prefill caches are emitted at prompt length (the patches count
        toward it; cross leaves hold the encoder's enc_len entries); the
        decode cache layout (:meth:`decode_cache_meta`) is seeded from them
        by :func:`repro_torch.serving.seed_caches`. On ``mesh`` (a mesh of
        ranks) ``params`` are this rank's shards and ``batch`` the whole
        batch, of which this rank runs its rows, split over the present
        ``batch_axes`` that divide it
        (:func:`repro_torch.distributed.sharding.batch_split`): the logits
        and caches returned are those rows', whole along ``model``. With
        ``global_batch`` (the whole batch's row count), ``batch`` holds this
        rank's rows of it already (a dry-run step's argument)."""
        cfg = self.cfg
        mesh = self._ranks(mesh)
        params = self.params if params is None else params
        ba = ()
        if mesh is not None:
            B = len(batch["tokens"]) if global_batch is None else global_batch
            ba = batch_split(mesh, B, batch_axes)
            if global_batch is None:
                batch = batch_rows(batch, mesh, ba)
            elif len(batch["tokens"]) * coll.axis_size(mesh, ba) != B:
                raise ValueError(f"{len(batch['tokens'])} rows: this rank "
                                 f"holds {B // coll.axis_size(mesh, ba)} of "
                                 f"{B} (split over {ba})")
        tokens = self._on_device(params, batch["tokens"])
        x = self._embed_tokens(params, tokens, mesh, "prefill")
        cross_memory = None
        if self.enc_cfg is not None:
            cross_memory = self._encode(params, batch["frames"], "prefill",
                                        mesh, ba)
        if cfg.frontend == "vision_stub":
            x = self._frontend(params, batch, x)
        positions = torch.arange(x.shape[1], device=x.device)
        caches = []
        for sp, seg in zip(params["segments"], self.layout):
            x, nc, _ = segment_apply(
                sp, x, seg, cfg=cfg, mode="prefill", caches=None,
                positions=positions, cur_pos=None, mesh=mesh,
                batch_axes=ba, cross_memory=cross_memory,
                unshard=self._unit_unshard(seg, mesh, cfg, "prefill"))
            caches.append(nc)
        _, norm = make_norm(cfg)
        x = norm(params["final_norm"], x)
        return self._logits(params, x[:, -1:], mesh, "prefill"), caches

    # ----- decode -----
    @torch.inference_mode()
    def decode_step(self, params, caches, tokens, cur_pos: int,
                    cross_memory=None, *, mesh=None, batch_axes=("data",),
                    batch: Optional[int] = None,
                    max_len: Optional[int] = None, enc_len: int = 0):
        """One token for every sequence. tokens: (B, 1); cur_pos: the
        position of that token (past the patches, in a front-end model).
        ``caches`` are updated in place and returned; cross-attention reads
        its cached projections, so ``cross_memory`` is taken for the
        reference's signature and not read.

        On ``mesh`` (a mesh of ranks) the step serves a batch of ``batch``
        rows whose caches have the layout of ``decode_cache_meta(batch,
        max_len, enc_len)`` (both required): ``caches`` are this rank's
        blocks of them under :meth:`decode_cache_specs`, as
        :func:`repro_torch.serving.seed_caches` leaves them, and
        ``tokens`` its rows' (split over ``batch_axes`` as
        :meth:`prefill` splits them); the logits returned are those rows'.
        No collective of the step carries a cache leaf: attention over a
        sequence-split cache sums softmax statistics and partial outputs
        over ``model`` (module docstring)."""
        cfg = self.cfg
        mesh = self._ranks(mesh)
        params = self.params if params is None else params
        tokens = self._on_device(params, tokens)
        ba, unit_specs = (), [None] * len(self.layout)
        if mesh is not None:
            if batch is None or max_len is None:
                raise ValueError("decode_step on a mesh needs the batch's "
                                 "rows (batch=) and the caches' max_len")
            ba = batch_split(mesh, batch, batch_axes)
            want = batch // coll.axis_size(mesh, ba)
            if tokens.shape[0] != want:
                raise ValueError(f"{tokens.shape[0]} token rows: this rank "
                                 f"holds {want} of {batch} (split over "
                                 f"{ba})")
            unit_specs = [cache_unit_specs(cfg, seg, mesh, ba, batch,
                                           max_len, enc_len)
                          for seg in self.layout]
        x = self._embed_tokens(params, tokens, mesh, "decode")
        cur_pos = int(cur_pos)
        positions = torch.tensor([cur_pos], device=x.device)
        new_caches = []
        for sp, seg, cu, us in zip(params["segments"], self.layout, caches,
                                   unit_specs):
            x, nc, _ = segment_apply(
                sp, x, seg, cfg=cfg, mode="decode", caches=cu,
                positions=positions, cur_pos=cur_pos, mesh=mesh,
                batch_axes=ba, cross_memory=cross_memory,
                unshard=self._unit_unshard(seg, mesh, cfg, "decode"),
                cache_spec=us)
            new_caches.append(nc)
        _, norm = make_norm(cfg)
        x = norm(params["final_norm"], x)
        return self._logits(params, x, mesh, "decode"), new_caches

    # ----- shapes -----
    def decode_cache_meta(self, batch: int, max_len: int, enc_len: int = 0):
        return cache_meta(self.cfg, self.layout, batch, max_len, enc_len)

    def decode_cache_specs(self, mesh, batch: int, max_len: int,
                           enc_len: int = 0, batch_axes=("data",)):
        """:func:`cache_specs` of :meth:`decode_cache_meta` on ``mesh``,
        the batch split over ``batch_split(mesh, batch, batch_axes)``: the
        layout serving holds its caches in."""
        return cache_specs(self, mesh, batch_split(mesh, batch, batch_axes),
                           batch, max_len, enc_len)
