"""Per-(arch x shape) step bundles: the port's step function, its
arguments as shape trees and their layouts, for one rank of a mesh. The
dry-run (:mod:`repro_torch.launch.dryrun`) and the roofline
(:mod:`repro_torch.launch.roofline`) read them.

The port of the reference's ``repro.launch.steps``. Where the reference
holds ``jax.ShapeDtypeStruct`` trees of global arrays and
``NamedSharding``s for ``jax.jit(...).lower``, a bundle here holds
:class:`repro_torch.models.transformer.ShapeDtype` trees of what one rank
is handed (its parameter shards, ``params.shard_metas``; in serving its
rows of the batch and its blocks of the caches under :func:`cache_specs`,
the reference's layout; in training the whole batch, of which the step
scores its rows) and spec tuples
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
from ..models.transformer import LM, Segment, ShapeDtype, cache_specs
from ..distributed.sharding import NamedSharding
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


@dataclasses.dataclass
class StepBundle:
    """One step to run on a rank: ``fn(*args)``, ``args`` as shape trees
    (:func:`materialize` makes them tensors; a Python int stays one).
    ``in_specs`` / ``out_specs`` are the reference's layouts as spec
    trees of the global arguments: the parameters (and ``m`` / ``v``),
    a serving step's batch and its caches are this rank's shards under
    them; a training step is handed the whole batch. ``donate`` names
    the arguments the reference donates; the port updates those in place
    instead (ROADMAP §3 (u), (ak))."""
    name: str
    fn: Any
    args: Tuple
    in_specs: Tuple
    out_specs: Any = None
    donate: Tuple[int, ...] = ()


def _shard(s: ShapeDtype, spec, mesh) -> ShapeDtype:
    """``s`` as this rank's shard of it under ``spec``."""
    return dataclasses.replace(
        s, shape=NamedSharding(mesh, tuple(spec)).shard_shape(s.shape))


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
        """The prefill of this rank's rows of the batch."""
        mesh, lm = self.mesh, self.lm
        B = shape.global_batch
        ba = batch_axes_for(mesh, B)
        params, psp = self._param_args(pr.SERVE_RULES)
        batch = self._batch_sds(shape, with_labels=False)
        bsp = self._batch_specs(batch, ba)
        rows = {k: _shard(s, bsp[k], mesh) for k, s in batch.items()}

        def prefill(params, rows):
            return lm.prefill(params, rows, mesh=mesh, batch_axes=ba,
                              global_batch=B)

        return StepBundle(name="prefill", fn=prefill, args=(params, rows),
                          in_specs=(psp, bsp))

    def _decode_dims(self, shape: ShapeConfig) -> Tuple[int, int, int]:
        """(batch, max_len, enc_len) of a decode cell's caches."""
        cfg = self.cfg
        n_front = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0
        return (shape.global_batch, shape.seq_len + n_front,
                shape.seq_len if cfg.n_enc_layers else 0)

    def decode_cache_layout(self, shape: ShapeConfig):
        """(the decode caches' whole shape tree, their specs) on the mesh:
        the reference's ``cache_specs`` layout."""
        B, max_len, enc_len = self._decode_dims(shape)
        return (self.lm.decode_cache_meta(B, max_len, enc_len),
                cache_specs(self.lm, self.mesh, batch_axes_for(self.mesh, B),
                            B, max_len, enc_len))

    def decode_bundle(self, shape: ShapeConfig) -> StepBundle:
        """The decode step at the cache's last position (a Python int:
        the port's ``decode_step`` takes the position as one), handed this
        rank's blocks of the caches and its rows' tokens."""
        mesh, lm = self.mesh, self.lm
        B, max_len, enc_len = self._decode_dims(shape)
        ba = batch_axes_for(mesh, B)
        params, psp = self._param_args(pr.SERVE_RULES)
        caches, csp = self.decode_cache_layout(shape)
        tsp = (_entry(ba), None)

        def decode(params, caches, tokens, pos):
            return lm.decode_step(params, caches, tokens, pos, mesh=mesh,
                                  batch_axes=ba, batch=B, max_len=max_len,
                                  enc_len=enc_len)

        blocks = pr.map_tree(lambda s, sp: _shard(s, sp, mesh), caches, csp)
        return StepBundle(name="serve_step", fn=decode,
                          args=(params, blocks,
                                _shard(ShapeDtype((B, 1), torch.int32), tsp,
                                       mesh), max_len - 1),
                          in_specs=(psp, csp, tsp, ()), donate=(1,))

    def bundle_for(self, shape: ShapeConfig) -> StepBundle:
        return {"train": self.train_bundle, "prefill": self.prefill_bundle,
                "decode": self.decode_bundle}[shape.kind](shape)


def params_sds_serve(metas):
    """Each parameter's whole shape (the reference's serving shape tree)."""
    return _shape_tree(metas)
