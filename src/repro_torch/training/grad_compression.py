"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback.

The port of the reference's ``repro.training.grad_compression``: ``int8
quantize -> all-reduce -> dequantize``, with the quantization residual
carried to the next step so compression bias does not accumulate
(Seide et al. / EF-SGD). The reference reduces over a mesh axis inside
``shard_map``; the port reduces over an axis (or a tuple of axes) of a
mesh of ranks given beside it (:func:`repro_torch.launch.make_rank_mesh`),
through :mod:`repro_torch.distributed.collectives`: the int8 codes summed
in int32 by one ``psum``, the scales by one ``pmean``. No axis (or no
mesh) is this rank alone: the sum is its own codes and the mean scale its
own scale.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..distributed import collectives as coll
from ..models.params import map_tree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 in [-127, 127], scale max|x| / 127 + 1e-12)."""
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_mean(x: torch.Tensor, axis, residual: torch.Tensor, *,
                    mesh=None):
    """Error-feedback int8 all-reduce-mean over ``axis`` of ``mesh`` (an
    axis name or a tuple of them; ``None``, or no mesh: this rank alone).
    Returns (mean, new_residual): the codes are summed in int32 and
    divided by the ranks' count, each dequantized by the mean of the
    ranks' scales; the residual is what this rank's contribution lost,
    ``x + residual - q * scale_mean``. An axis without a mesh raises
    ``ValueError``."""
    if axis is not None and mesh is None:
        raise ValueError(f"compressed_mean over {axis!r} needs its mesh")
    if mesh is None:
        axis = None
    x32 = x.to(torch.float32) + residual
    q, scale = quantize_int8(x32)
    summed = coll.psum(q.to(torch.int32), mesh, axis)   # no int8 overflow
    n = float(coll.axis_size(mesh, axis))
    scale_mean = coll.pmean(scale, mesh, axis)
    new_residual = x32 - dequantize_int8(q, scale_mean)
    return summed.to(torch.float32) * scale_mean / n, new_residual


def compressed_grad_sync(grads, axis, residuals, *, mesh=None):
    """:func:`compressed_mean` leaf by leaf; each mean is cast back to its
    gradient's dtype. grads / residuals: matching trees. Returns (means,
    new residuals)."""
    new_res = []

    def one(g, r):
        m, nr = compressed_mean(g, axis, r, mesh=mesh)
        new_res.append(nr)
        return m.to(g.dtype)

    means = map_tree(one, grads, residuals)
    it = iter(new_res)
    return means, map_tree(lambda _: next(it), grads)


def init_residuals(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
