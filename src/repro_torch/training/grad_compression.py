"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback.

The port of the reference's ``repro.training.grad_compression``: ``int8
quantize -> all-reduce -> dequantize``, with the quantization residual
carried to the next step so compression bias does not accumulate
(Seide et al. / EF-SGD). The reference reduces over a mesh axis inside
``shard_map``; the port reduces over a process group, of which only one
rank is supported until training runs on a mesh of ranks (ROADMAP §1,
item 6's training half): its all-reduce is the identity, and the mean of
the scales is the rank's own scale.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.params import map_tree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 in [-127, 127], scale max|x| / 127 + 1e-12)."""
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _group_size(group) -> int:
    """1 for ``group=None`` or a one-rank process group; anything else
    raises ``NotImplementedError``."""
    if group is None:
        return 1
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n != 1:
        raise NotImplementedError(
            f"compressed_mean over {n} ranks: the port reduces over one rank "
            f"until training runs on a mesh (ROADMAP §1, item 6)")
    return n


def compressed_mean(x: torch.Tensor, group, residual: torch.Tensor):
    """Error-feedback int8 all-reduce-mean over ``group`` (``None``: this
    rank alone). Returns (mean, new_residual): the residual is what this
    rank's contribution lost, ``x + residual - q * scale_mean``."""
    x32 = x.to(torch.float32) + residual
    q, scale = quantize_int8(x32)
    n = float(_group_size(group))
    summed = q.to(torch.int32)              # int32, as the sum across ranks
    scale_mean = scale
    new_residual = x32 - dequantize_int8(q, scale_mean)
    return summed.to(torch.float32) * scale_mean / n, new_residual


def compressed_grad_sync(grads, group, residuals):
    """:func:`compressed_mean` leaf by leaf; each mean is cast back to its
    gradient's dtype. grads / residuals: matching trees. Returns (means,
    new residuals)."""
    new_res = []

    def one(g, r):
        m, nr = compressed_mean(g, group, r)
        new_res.append(nr)
        return m.to(g.dtype)

    means = map_tree(one, grads, residuals)
    it = iter(new_res)
    return means, map_tree(lambda _: next(it), grads)


def init_residuals(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
