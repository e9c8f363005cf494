"""Per-(arch x shape) step bundles: the port's step function, its
arguments as shape trees and their layouts, for one rank of a mesh. The
dry-run (:mod:`repro_torch.launch.dryrun`) and the roofline
(:mod:`repro_torch.launch.roofline`) read them.

The port of the reference's ``repro.launch.steps``. Where the reference
holds ``jax.ShapeDtypeStruct`` trees of global arrays and
``NamedSharding``s for ``jax.jit(...).lower``, a bundle here holds
:class:`repro_torch.models.transformer.ShapeDtype` trees of what one rank
is handed (its parameter shards, ``params.shard_metas``; the batch and
the caches whole, as the port runs them, ROADMAP §3 (an)) and spec tuples
(:mod:`repro_torch.distributed.sharding`) for the reference's layout of
each argument. Nothing is allocated: :func:`materialize` makes tensors of
a shape tree (fake ones under ``FakeTensorMode``). ``[audio]`` / ``[vlm]``
front ends are stubs: the batch carries precomputed frame / patch
embeddings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import ModelConfig, ShapeConfig
from ..models import params as pr
from ..models.transformer import (LM, Segment, ShapeDtype,
                                  cache_meta_for_desc)
from ..training import AdamWConfig, make_train_step


def _divides(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def batch_axes_for(mesh, batch: int) -> Tuple[str, ...]:
    """The present (pod, data) axes that divide ``batch``, the leading
    ones dropped until they do; () if none does (reads ``mesh.shape``)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    while axes:
        if _divides(batch, math.prod(mesh.shape[a] for a in axes)):
            return axes
        axes = axes[1:]
    return ()


def _entry(axes) -> Any:
    """A spec entry for ``axes``: ``None`` for none, a single axis by its
    name, several as a tuple (as a ``PartitionSpec`` entry reads)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _seq_axis(mesh, M: int) -> Optional[str]:
    return "model" if ("model" in mesh.shape
                       and _divides(M, mesh.shape["model"])) else None


def cache_specs(lm: LM, mesh, batch_axes, batch: int, max_len: int,
                enc_len: int = 0) -> Any:
    """The reference's layout of the decode caches, a spec tree shaped as
    ``lm.decode_cache_meta``: the batch over (pod, data), a cache's
    sequence axis over ``model`` (distributed-LSE decode), recurrent
    state heads / channels over ``model``; a stacked segment's leaves get
    a leading ``None`` for the stack. The port holds its caches whole on
    every rank (ROADMAP §3 (an)); these specs say how the reference splits
    them."""
    B_axes = _entry(batch_axes)

    def leaf_spec(sds):
        shp = sds.shape
        if len(shp) == 4:       # (B, M, Hkv, Dh) kv / (B, H, Dk, Dv) rwkv state
            return (B_axes, _seq_axis(mesh, shp[1]), None, None)
        if len(shp) == 3:       # (B, M, r) latent / (B, ck-1, W) conv
            ax = _seq_axis(mesh, shp[1])
            if ax:
                return (B_axes, ax, None)
            return (B_axes, None, _seq_axis(mesh, shp[2]))
        if len(shp) == 2:       # (B, W) state / (B, D) shift
            return (B_axes, _seq_axis(mesh, shp[1]))
        return (None,) * len(shp)

    out = []
    for seg in lm.layout:
        stack = (None,) if seg.repeats > 1 else ()
        out.append({f"L{j}": pr.map_tree(
                        lambda s: stack + leaf_spec(s), cache_meta_for_desc(
                            lm.cfg, d, batch, max_len, enc_len))
                    for j, d in enumerate(seg.pattern)})
    return out


@dataclasses.dataclass
class StepBundle:
    """One step to run on a rank: ``fn(*args)``, ``args`` as shape trees
    (:func:`materialize` makes them tensors; a Python int stays one).
    ``in_specs`` / ``out_specs`` are the reference's layouts as spec
    trees: the parameters (and ``m`` / ``v``) are this rank's shards under
    them; the batch and the caches are whole on every rank in the port,
    and their specs say how the reference splits them. ``donate`` names
    the arguments the reference donates; the port updates those in place
    instead (ROADMAP §3 (u), (ak))."""
    name: str
    fn: Any
    args: Tuple
    in_specs: Tuple
    out_specs: Any = None
    donate: Tuple[int, ...] = ()


def _shape_tree(metas) -> Any:
    return pr.map_tree(lambda m: ShapeDtype(m.shape, m.dtype), metas)


def materialize(tree) -> Any:
    """Each :class:`ShapeDtype` of ``tree`` as an empty CPU tensor of its
    shape and dtype (under ``FakeTensorMode``, a fake one); any other leaf
    as it is."""
    return pr.map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype)
                       if isinstance(s, ShapeDtype) else s, tree)


class ArchRunner:
    """Builds the train / prefill / decode bundles of one architecture on
    ``mesh`` (a mesh of ranks; its shape decides the layouts).

    ``segment_repeats`` overrides each segment's repeat count. The
    reference needs it for its roofline's scan-cost correction (XLA costs
    a scan body once); the port counts every repeat, so a count at full
    depth equals the count at one repeat each plus (R_k - 1) units."""

    def __init__(self, cfg: ModelConfig, mesh,
                 segment_repeats: Optional[Tuple[int, ...]] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.lm = LM(cfg)
        if segment_repeats is not None:
            if len(segment_repeats) != len(self.lm.layout):
                raise ValueError(f"{len(segment_repeats)} repeats for "
                                 f"{len(self.lm.layout)} segments")
            self.lm.layout = [Segment(s.pattern, int(r)) for s, r in
                              zip(self.lm.layout, segment_repeats)]
            self.lm._metas = self.lm.abstract_params()
        self.metas = self.lm.abstract_params()

    def _param_args(self, rules) -> Tuple[Any, Any]:
        """(this rank's parameter shapes, their specs) under ``rules``."""
        return (_shape_tree(pr.shard_metas(self.metas, self.mesh, rules)),
                pr.spec_tree(self.metas, self.mesh, rules))

    def _batch_sds(self, shape: ShapeConfig, seq: Optional[int] = None,
                   with_labels: bool = True) -> Dict[str, ShapeDtype]:
        cfg = self.cfg
        B = shape.global_batch
        S = seq if seq is not None else shape.seq_len
        n_front = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0
        act = (torch.bfloat16 if cfg.activ_dtype == "bfloat16"
               else torch.float32)
        sds = {"tokens": ShapeDtype((B, S - n_front), torch.int32)}
        if with_labels:
            sds["labels"] = ShapeDtype((B, S - n_front), torch.int32)
        if cfg.frontend == "vision_stub":
            sds["patches"] = ShapeDtype((B, n_front, cfg.frontend_dim), act)
        if cfg.frontend == "audio_stub":
            sds["frames"] = ShapeDtype((B, S, cfg.frontend_dim), act)
        return sds

    @staticmethod
    def _batch_specs(batch_sds, batch_axes):
        ba = _entry(batch_axes)
        return {k: (ba,) + (None,) * (len(s.shape) - 1)
                for k, s in batch_sds.items()}

    # ---- bundles ----
    def train_bundle(self, shape: ShapeConfig) -> StepBundle:
        ba = batch_axes_for(self.mesh, shape.global_batch)
        params, psp = self._param_args(pr.DEFAULT_RULES)
        f32 = pr.map_tree(lambda s: ShapeDtype(s.shape, torch.float32),
                          params)
        opt = {"m": f32, "v": f32, "step": ShapeDtype((), torch.int32)}
        osp = {"m": psp, "v": psp, "step": ()}
        batch = self._batch_sds(shape)
        step = make_train_step(self.lm, AdamWConfig(), mesh=self.mesh,
                               batch_axes=ba)
        return StepBundle(name="train_step", fn=step,
                          args=(params, opt, batch),
                          in_specs=(psp, osp, self._batch_specs(batch, ba)),
                          out_specs=(psp, osp, None), donate=(0, 1))

    def prefill_bundle(self, shape: ShapeConfig) -> StepBundle:
        mesh, lm = self.mesh, self.lm
        ba = batch_axes_for(mesh, shape.global_batch)
        params, psp = self._param_args(pr.SERVE_RULES)
        batch = self._batch_sds(shape, with_labels=False)

        def prefill(params, batch):
            return lm.prefill(params, batch, mesh=mesh, batch_axes=ba)

        return StepBundle(name="prefill", fn=prefill, args=(params, batch),
                          in_specs=(psp, self._batch_specs(batch, ba)))

    def decode_bundle(self, shape: ShapeConfig) -> StepBundle:
        """The decode step at the cache's last position (a Python int:
        the port's ``decode_step`` takes the position as one; it reads the
        whole cache at any position)."""
        mesh, lm, cfg = self.mesh, self.lm, self.cfg
        B = shape.global_batch
        ba = batch_axes_for(mesh, B)
        params, psp = self._param_args(pr.SERVE_RULES)
        enc_len = shape.seq_len if cfg.n_enc_layers else 0
        n_front = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0
        max_len = shape.seq_len + n_front
        caches = lm.decode_cache_meta(B, max_len, enc_len)
        csp = cache_specs(lm, mesh, ba, B, max_len, enc_len)

        def decode(params, caches, tokens, pos):
            return lm.decode_step(params, caches, tokens, pos, mesh=mesh,
                                  batch_axes=ba)

        return StepBundle(name="serve_step", fn=decode,
                          args=(params, caches,
                                ShapeDtype((B, 1), torch.int32), max_len - 1),
                          in_specs=(psp, csp, (_entry(ba), None), ()),
                          donate=(1,))

    def bundle_for(self, shape: ShapeConfig) -> StepBundle:
        return {"train": self.train_bundle, "prefill": self.prefill_bundle,
                "decode": self.decode_bundle}[shape.kind](shape)


def params_sds_serve(metas):
    """Each parameter's whole shape (the reference's serving shape tree)."""
    return _shape_tree(metas)
