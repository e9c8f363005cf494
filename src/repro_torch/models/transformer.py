"""Model assembly: the decoder LM on the port's mixers and MLPs.

The port of the reference's ``repro.models.transformer`` for decoder-only
configs: ``attn`` / ``attn_local`` (GQA), ``mla`` (DeepSeek's latent
attention), ``rg`` (RG-LRU) and ``rwkv`` (RWKV-6) mixers, each with a
dense or a mixture-of-experts MLP (olmo-1b, gemma3-1b, qwen3-32b,
qwen1.5-110b, qwen3-moe-30b-a3b, recurrentgemma-2b, rwkv6-7b,
deepseek-v3-671b). Layers are grouped into *segments*, (pattern, repeats)
pairs, exactly as the reference groups them; a segment's parameters and
caches are stacked with the repeat axis first, and this port walks the
repeats in a Python loop (the reference's ``scan_layers=False`` walk).
Parameter layouts are the reference's, so its weights carry across by name
(:func:`repro_torch.convert.lm_params_from_arrays`); deepseek-v3's ``mtp``
block is declared for that reason, though only training reads it.

Configs with an encoder or a front end raise ``NotImplementedError`` at
``LM(cfg)``, naming the ROADMAP item that ports them. Training
(``train_loss``, the MoE load-balance loss, ``_mtp_loss``) waits for the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec
from .common import (acc_dtype, embed, embed_meta, logits_fn, make_norm, mlp,
                     mlp_meta, unembed_meta)
from .params import ParamMeta, count_params, init_tree, map_tree, meta


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


# What LM(cfg) cannot run yet, and the ROADMAP §1 item that ports it.
_NOT_PORTED = {
    "encoder": "encoders and cross-attention: ROADMAP §1 item 4",
    "frontend": "vision and audio front ends: ROADMAP §1 item 4",
}


def _not_ported(cfg: ModelConfig) -> List[str]:
    why = []
    if cfg.n_enc_layers:
        why.append(_NOT_PORTED["encoder"])
    if cfg.frontend:
        why.append(_NOT_PORTED["frontend"])
    return why


def _require_ported(desc: LayerDesc) -> None:
    if desc.cross:
        raise NotImplementedError(_NOT_PORTED["encoder"])


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
    _require_ported(desc)
    norm_meta_fn, _ = make_norm(cfg)
    dtype = cfg.pdtype
    return {
        "norm1": norm_meta_fn(cfg.d_model, dtype),
        "mixer": _mixer_meta(cfg, desc.mixer, dtype),
        "norm2": norm_meta_fn(cfg.d_model, dtype),
        "mlp": (moe_mod.moe_meta(cfg, dtype) if desc.mlp == "moe"
                else mlp_meta(cfg.d_model, cfg.d_ff, dtype, bias=False)),
    }


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


def layer_apply(lp, x, desc: LayerDesc, *, cfg: ModelConfig, mode: str,
                cache, positions, cur_pos, kv_len=None):
    """One pre-norm block: mixer, then MLP (dense or MoE), each added to
    the residual. Returns (x, new_cache); the MoE's load-balance loss is
    training's and is dropped here."""
    _require_ported(desc)
    _, norm = make_norm(cfg)
    h = norm(lp["norm1"], x)
    if desc.mixer in ("attn", "attn_local"):
        theta, window = _theta_window(cfg, desc)
        h, new_cache = attn.attn_apply(
            lp["mixer"], h, cfg=cfg, rope_theta=theta, window=window,
            positions=positions, mode=mode, cache=cache, cur_pos=cur_pos,
            kv_len=kv_len, causal=cfg.causal)
    elif desc.mixer == "mla":
        h, new_cache = attn.mla_apply(lp["mixer"], h, cfg=cfg,
                                      positions=positions, mode=mode,
                                      cache=cache, cur_pos=cur_pos)
    elif desc.mixer == "rg":
        h, new_cache = rec.rglru_apply(lp["mixer"], h, cfg=cfg, mode=mode,
                                       cache=cache)
    elif desc.mixer == "rwkv":
        h, new_cache = rec.rwkv6_apply(lp["mixer"], h, cfg=cfg, mode=mode,
                                       cache=cache, chunk=cfg.rwkv_chunk)
    else:
        raise ValueError(desc.mixer)
    x = x + h
    h = norm(lp["norm2"], x)
    if desc.mlp == "moe":
        h, _ = moe_mod.moe_apply(lp["mlp"], h, cfg=cfg,
                                 capacity_factor=cfg.capacity_factor)
    else:
        h = mlp(lp["mlp"], h, cfg.act)
    return x + h, new_cache


# ---------------- cache construction ----------------
@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A cache leaf's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``), and where its sequence axis lies, counted
    from the end (-3 for a (.., B, S, Hkv, Dh) kv leaf, -2 for MLA's
    (.., B, S, r) leaves), or ``None`` for a recurrent state, which has
    no sequence axis. :func:`repro_torch.serving.seed_caches` places a
    prompt along that axis."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    seq_axis: Optional[int] = None


def cache_meta_for_desc(cfg: ModelConfig, desc: LayerDesc, batch: int,
                        max_len: int, enc_len: int = 0):
    """The shape tree of one layer's decode cache: (k, v) for attention,
    where a local layer holds min(max_len, window) entries (a ring once
    the window is shorter than the sequence); (latent, k_rope) for MLA;
    (conv window, h) for RG-LRU; (token shift, state) for RWKV. The
    recurrent states are float32 (float64 in a float64 model)."""
    _require_ported(desc)
    ad, D, B = cfg.adtype, cfg.d_model, int(batch)
    acc = acc_dtype(ad)
    if desc.mixer in ("attn", "attn_local"):
        _, window = _theta_window(cfg, desc)
        M = min(max_len, window) if window else max_len
        kv = ShapeDtype((B, int(M), cfg.n_kv_heads, cfg.head_dim), ad, -3)
        return (kv, kv)
    if desc.mixer == "mla":
        return (ShapeDtype((B, int(max_len), cfg.kv_lora_rank), ad, -2),
                ShapeDtype((B, int(max_len), cfg.qk_rope_dim), ad, -2))
    if desc.mixer == "rg":
        return (ShapeDtype((B, cfg.conv_width - 1, cfg.lru_width), ad),
                ShapeDtype((B, cfg.lru_width), acc))
    if desc.mixer == "rwkv":
        Dh = D // cfg.n_heads
        return (ShapeDtype((B, D), ad),
                ShapeDtype((B, cfg.n_heads, Dh, Dh), acc))
    raise ValueError(desc.mixer)


def cache_meta(cfg: ModelConfig, segments: Sequence[Segment], batch: int,
               max_len: int, enc_len: int = 0):
    out = []
    for seg in segments:
        unit = {f"L{j}": cache_meta_for_desc(cfg, d, batch, max_len, enc_len)
                for j, d in enumerate(seg.pattern)}
        if seg.repeats > 1:
            unit = map_tree(lambda s: dataclasses.replace(
                s, shape=(seg.repeats,) + s.shape), unit)
        out.append(unit)
    return out


def zeros_like_meta(tree, device):
    return map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), tree)


# ---------------- segment walk ----------------
def segment_apply(seg_p, x, seg: Segment, *, cfg: ModelConfig, mode: str,
                  caches, positions, cur_pos, kv_len=None):
    """Run one segment: its pattern once, or for each of its repeats the
    repeat's slice of the stacked parameters and caches.

    ``prefill`` returns the prompt's caches, stacked like the parameters.
    ``decode`` updates ``caches`` in place (a repeat's slice is a view of
    the stacked tensor) and returns them."""

    def unit(lp, xx, cache_unit):
        new_c = {}
        for j, d in enumerate(seg.pattern):
            c = cache_unit[f"L{j}"] if cache_unit is not None else None
            xx, new_c[f"L{j}"] = layer_apply(
                lp[f"L{j}"], xx, d, cfg=cfg, mode=mode, cache=c,
                positions=positions, cur_pos=cur_pos, kv_len=kv_len)
        return xx, new_c

    if seg.repeats == 1:
        return unit(seg_p, x, caches)
    ncs = []
    for r in range(seg.repeats):
        lp = map_tree(lambda t: t[r], seg_p)
        cu = map_tree(lambda t: t[r], caches) if caches is not None else None
        x, nc = unit(lp, x, cu)
        ncs.append(nc)
    if mode == "decode":
        return x, caches
    return x, map_tree(lambda *ts: torch.stack(ts), *ncs)


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
    """Decoder-only language model (attention, MLA, RG-LRU or RWKV-6
    mixers; dense or MoE MLPs).

    ``LM(cfg)`` allocates nothing: the parameter count and the cache shapes
    come from metadata. :meth:`init` draws the parameters from a
    ``torch.Generator`` onto a device, and :meth:`set_params` takes a tree
    (e.g. the reference's weights through
    :func:`repro_torch.convert.lm_params_from_arrays`); either registers
    them under the reference's tree paths (``embed.table``,
    ``segments.0.L0.mixer.wq``, ...). The segment layout (the reference's
    ``LM.segments``) is :attr:`layout`.

    :meth:`prefill` and :meth:`decode_step` take a parameter tree first, as
    the reference's do; ``None`` means the registered parameters. They run
    under ``torch.inference_mode()`` on the parameters' device.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        descs = layer_descs(cfg, cross=cfg.n_enc_layers > 0)
        why = _not_ported(cfg)
        if why:
            raise NotImplementedError(f"LM({cfg.name!r}) is not ported yet: "
                                      + "; ".join(why))
        self.cfg = cfg
        self.descs = descs
        self.layout = make_segments(descs)
        self._top = tuple(self.abstract_params())

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
        if cfg.mtp:
            # DeepSeek-V3's multi-token-prediction block: parameters only,
            # so the reference's tree carries across; training reads them
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
        _check_tree(self.abstract_params(), tree)
        for k in self._top:
            setattr(self, k, _Params(tree[k]))

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

    # ----- embedding -----
    def _embed_tokens(self, params, tokens):
        x = embed(params["embed"], tokens).to(self.cfg.adtype)
        if self.cfg.embed_scale:
            d = torch.tensor(float(self.cfg.d_model), dtype=torch.float32,
                             device=x.device)
            x = x * torch.sqrt(d).to(x.dtype)
        return x

    def _tokens(self, params, tokens):
        return torch.as_tensor(tokens, device=params["embed"]["table"].device)

    # ----- prefill -----
    @torch.inference_mode()
    def prefill(self, params, batch: Dict[str, Any]):
        """Full-prompt forward; returns (last_logits (B, 1, V), caches).

        Prefill caches are emitted at prompt length; the decode cache layout
        (:meth:`decode_cache_meta`) is seeded from them by
        :func:`repro_torch.serving.seed_caches`."""
        cfg = self.cfg
        params = self.params if params is None else params
        tokens = self._tokens(params, batch["tokens"])
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        caches = []
        for sp, seg in zip(params["segments"], self.layout):
            x, nc = segment_apply(sp, x, seg, cfg=cfg, mode="prefill",
                                  caches=None, positions=positions,
                                  cur_pos=None)
            caches.append(nc)
        _, norm = make_norm(cfg)
        x = norm(params["final_norm"], x)
        logits = logits_fn(params.get("head", {}), params["embed"],
                           x[:, -1:], cfg.tie_embeddings)
        return logits, caches

    # ----- decode -----
    @torch.inference_mode()
    def decode_step(self, params, caches, tokens, cur_pos: int):
        """One token for every sequence. tokens: (B, 1); cur_pos: the
        position of that token. ``caches`` are updated in place and
        returned."""
        cfg = self.cfg
        params = self.params if params is None else params
        tokens = self._tokens(params, tokens)
        x = self._embed_tokens(params, tokens)
        cur_pos = int(cur_pos)
        positions = torch.tensor([cur_pos], device=x.device)
        new_caches = []
        for sp, seg, cu in zip(params["segments"], self.layout, caches):
            x, nc = segment_apply(sp, x, seg, cfg=cfg, mode="decode",
                                  caches=cu, positions=positions,
                                  cur_pos=cur_pos)
            new_caches.append(nc)
        _, norm = make_norm(cfg)
        x = norm(params["final_norm"], x)
        logits = logits_fn(params.get("head", {}), params["embed"], x,
                           cfg.tie_embeddings)
        return logits, new_caches

    # ----- shapes -----
    def decode_cache_meta(self, batch: int, max_len: int, enc_len: int = 0):
        return cache_meta(self.cfg, self.layout, batch, max_len, enc_len)
