"""Dispatch for the port's three kernels.

A tensor on the CPU goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. A tensor on a CUDA device launches the
hand-written kernel from ``csrc/`` (built on first use by
:mod:`repro_torch.kernels._build`) or raises; there is no fallback. Any
other device raises.

``LAUNCHES`` counts kernel launches per entry point; a wrapper adds one
where it launches its kernel and nowhere else, so CPU runs leave it at 0.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ref

NO_EDGE = -1
LAUNCHES: Dict[str, int] = {"gathered_topk": 0, "gathered_l2": 0,
                            "pairwise_l2_masked": 0}
# a block of the gathered_topk kernel holds its (L + M) list in shared memory
MAX_SHARED_BYTES = 232448


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    from . import _build
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")
    LAUNCHES[name] += 1


def pairwise_l2_masked(queries, corpus, lo, hi, ql, qh, mask: int):
    """(Q, d) x (N, d) float32 -> (Q, N) float32 masked squared L2."""
    if _on_cpu(queries, corpus, lo, hi, ql, qh):
        return ref.pairwise_l2_masked_ref(queries, corpus, lo, hi, ql, qh,
                                          mask)
    Q, d = queries.shape
    N = corpus.shape[0]
    f32 = torch.float32
    _check("queries", queries, f32, (Q, d))
    _check("corpus", corpus, f32, (N, d))
    for nm, t, m in (("lo", lo, N), ("hi", hi, N), ("ql", ql, Q),
                     ("qh", qh, Q)):
        _check(nm, t, f32, (m,))
    if not 0 <= int(mask) <= 63:
        raise ValueError(f"mask {mask} outside [0, 63]")
    out = torch.empty((Q, N), dtype=f32, device=queries.device)
    _launch("pairwise_l2_masked", queries.device, queries.data_ptr(),
            corpus.data_ptr(), lo.data_ptr(), hi.data_ptr(), ql.data_ptr(),
            qh.data_ptr(), out.data_ptr(), Q, N, d, int(mask))
    return out


def gathered_l2(queries, cand_vecs):
    """(Q, d) x (Q, S, d) float32 -> (Q, S) float32 squared L2."""
    if _on_cpu(queries, cand_vecs):
        return ref.gathered_l2_ref(queries, cand_vecs)
    Q, d = queries.shape
    S = cand_vecs.shape[1]
    _check("queries", queries, torch.float32, (Q, d))
    _check("cand_vecs", cand_vecs, torch.float32, (Q, S, d))
    out = torch.empty((Q, S), dtype=torch.float32, device=queries.device)
    _launch("gathered_l2", queries.device, queries.data_ptr(),
            cand_vecs.data_ptr(), out.data_ptr(), Q, S, d)
    return out


def gathered_topk_smem_bytes(d: int, M: int, L: int) -> int:
    """Dynamic shared memory one gathered_topk block needs."""
    return 4 * (d + 3 * (L + M))


def gathered_topk(queries, vectors, ids, avail, b, e, version,
                  pool_ids, pool_d, pool_exp):
    """One fused wavefront step (gather + L2 + label mask + beam merge):
    -> merged ((Q, L) int32 ids, (Q, L) float32 dists, (Q, L) bool
    expanded)."""
    if _on_cpu(queries, vectors, ids, avail, b, e, version, pool_ids,
               pool_d, pool_exp):
        return ref.gathered_topk_ref(queries, vectors, ids, avail, b, e,
                                     version, pool_ids, pool_d, pool_exp)
    Q, d = queries.shape
    n = vectors.shape[0]
    M = ids.shape[1]
    L = pool_d.shape[1]
    i32 = torch.int32
    _check("queries", queries, torch.float32, (Q, d))
    _check("vectors", vectors, torch.float32, (n, d))
    _check("ids", ids, i32, (Q, M))
    _check("avail", avail, torch.bool, (Q, M))
    _check("b", b, i32, (Q, M))
    _check("e", e, i32, (Q, M))
    _check("version", version, i32, (Q,))
    _check("pool_ids", pool_ids, i32, (Q, L))
    _check("pool_d", pool_d, torch.float32, (Q, L))
    _check("pool_exp", pool_exp, torch.bool, (Q, L))
    smem = gathered_topk_smem_bytes(d, M, L)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"gathered_topk needs {smem} bytes of shared memory "
                         f"for d={d}, M={M}, L={L}; a block has at most "
                         f"{MAX_SHARED_BYTES}")
    dev = queries.device
    out_i = torch.empty((Q, L), dtype=i32, device=dev)
    out_d = torch.empty((Q, L), dtype=torch.float32, device=dev)
    out_e = torch.empty((Q, L), dtype=torch.bool, device=dev)
    _launch("gathered_topk", dev, queries.data_ptr(), vectors.data_ptr(),
            ids.data_ptr(), avail.data_ptr(), b.data_ptr(), e.data_ptr(),
            version.data_ptr(), pool_ids.data_ptr(), pool_d.data_ptr(),
            pool_exp.data_ptr(), out_i.data_ptr(), out_d.data_ptr(),
            out_e.data_ptr(), Q, n, d, M, L)
    return out_i, out_d, out_e


def gathered_stream_bytes(Q: int, M: int, L: int, d: int,
                          live: int) -> int:
    """Bytes one wavefront step must move: the queries, the ``live``
    candidate rows that pass the mask (``d*4`` bytes each), each
    candidate's id, avail, lab_b and lab_e (13 bytes), the versions, and
    the (Q, L) beam in and out (9 bytes per entry each way)."""
    return (Q * d * 4 + live * d * 4 + Q * M * 13 + Q * 4
            + 2 * Q * L * 9)


def pairwise_stream_bytes(Q: int, N: int, d: int) -> int:
    """Bytes of a full masked scan: corpus, queries, endpoints, and the
    (Q, N) float32 output."""
    return N * d * 4 + Q * d * 4 + 2 * N * 4 + 2 * Q * 4 + Q * N * 4
