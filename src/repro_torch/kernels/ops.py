"""Dispatch for the port's hand-written kernels.

A tensor on the CPU goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`. A tensor on a CUDA device launches the
hand-written kernel from ``csrc/`` (built on first use by
:mod:`repro_torch.kernels._build`) or raises; there is no fallback. Any
other device raises.

``LAUNCHES`` counts kernel launches per C entry point (a wrapper that
serves several element types has one entry point, and one count, for
each); a wrapper adds one where it launches its kernel and nowhere else,
so CPU runs leave it at 0.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ref

NO_EDGE = -1
LAUNCHES: Dict[str, int] = {
    "gathered_topk": 0, "gathered_topk_quant_int8": 0,
    "gathered_topk_quant_f16": 0, "gathered_l2": 0, "pairwise_l2_masked": 0,
    "pairwise_l2_masked_f16": 0, "pairwise_l2_int8": 0}
# code-table entry points by element type
_QUANT_SUFFIX = {torch.int8: "int8", torch.float16: "f16"}
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


def _check_endpoints(lo, hi, ql, qh, N: int, Q: int, mask: int) -> None:
    for nm, t, m in (("lo", lo, N), ("hi", hi, N), ("ql", ql, Q),
                     ("qh", qh, Q)):
        _check(nm, t, torch.float32, (m,))
    if not 0 <= int(mask) <= 63:
        raise ValueError(f"mask {mask} outside [0, 63]")


def pairwise_l2_masked(queries, corpus, lo, hi, ql, qh, mask: int):
    """(Q, d) float32 x (N, d) float32 or float16 -> (Q, N) float32 masked
    squared L2 (a float16 corpus is widened as it is read)."""
    if _on_cpu(queries, corpus, lo, hi, ql, qh):
        return ref.pairwise_l2_masked_ref(queries, corpus, lo, hi, ql, qh,
                                          mask)
    Q, d = queries.shape
    N = corpus.shape[0]
    f32 = torch.float32
    if corpus.dtype not in (f32, torch.float16):
        raise TypeError(f"corpus: expected float32 or float16, got "
                        f"{corpus.dtype}")
    _check("queries", queries, f32, (Q, d))
    _check("corpus", corpus, corpus.dtype, (N, d))
    _check_endpoints(lo, hi, ql, qh, N, Q, mask)
    name = ("pairwise_l2_masked" if corpus.dtype == f32
            else "pairwise_l2_masked_f16")
    out = torch.empty((Q, N), dtype=f32, device=queries.device)
    _launch(name, queries.device, queries.data_ptr(), corpus.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), ql.data_ptr(), qh.data_ptr(),
            out.data_ptr(), Q, N, d, int(mask))
    return out


def pairwise_l2_int8(queries, codes, scale, offset, sq_norm, lo, hi, ql, qh,
                     mask: int):
    """(Q, d) float32 queries x (N, d) int8 codes -> (Q, N) float32
    approximate masked squared L2 against the dequantized corpus. The
    query prologue (:func:`ref.quantize_query_weights_ref`) runs in plain
    torch before the kernel, as it runs outside the reference's
    ``pallas_call``."""
    if _on_cpu(queries, codes, scale, offset, sq_norm, lo, hi, ql, qh):
        return ref.pairwise_l2_int8_ref(queries, codes, scale, offset,
                                        sq_norm, lo, hi, ql, qh, mask)
    Q, d = queries.shape
    N = codes.shape[0]
    f32 = torch.float32
    _check("queries", queries, f32, (Q, d))
    _check("codes", codes, torch.int8, (N, d))
    _check("scale", scale, f32, (d,))
    _check("offset", offset, f32, (d,))
    _check("sq_norm", sq_norm, f32, (N,))
    _check_endpoints(lo, hi, ql, qh, N, Q, mask)
    wq, alpha, cq = ref.quantize_query_weights_ref(queries, scale, offset)
    out = torch.empty((Q, N), dtype=f32, device=queries.device)
    _launch("pairwise_l2_int8", queries.device, wq.data_ptr(),
            codes.data_ptr(), alpha.data_ptr(), cq.data_ptr(),
            sq_norm.data_ptr(), lo.data_ptr(), hi.data_ptr(), ql.data_ptr(),
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
    """Dynamic shared memory one gathered_topk block needs: q, then
    (dist, id, expanded) for each of the L + M list entries."""
    return 4 * (d + 3 * (L + M))


def gathered_topk_quant_smem_bytes(d: int, M: int, L: int) -> int:
    """Dynamic shared memory one gathered_topk_quant block needs: the
    float32 step's, plus the (d,) scale and offset beside q."""
    return 4 * (3 * d + 3 * (L + M))


def _check_step(queries, ids, avail, b, e, version, pool_ids, pool_d,
                pool_exp, smem: int, name: str) -> None:
    """Shapes and types of a wavefront step's inputs. Refuses a step whose
    block would need more shared memory than a block can have."""
    Q, d = queries.shape
    M = ids.shape[1]
    L = pool_d.shape[1]
    i32 = torch.int32
    _check("queries", queries, torch.float32, (Q, d))
    _check("ids", ids, i32, (Q, M))
    _check("avail", avail, torch.bool, (Q, M))
    _check("b", b, i32, (Q, M))
    _check("e", e, i32, (Q, M))
    _check("version", version, i32, (Q,))
    _check("pool_ids", pool_ids, i32, (Q, L))
    _check("pool_d", pool_d, torch.float32, (Q, L))
    _check("pool_exp", pool_exp, torch.bool, (Q, L))
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"{name} needs {smem} bytes of shared memory for "
                         f"d={d}, M={M}, L={L}; a block has at most "
                         f"{MAX_SHARED_BYTES}")


def _launch_step(name: str, queries, table_ptrs, ids, avail, b, e, version,
                 pool_ids, pool_d, pool_exp, n: int, d: int, M: int, L: int):
    dev = queries.device
    Q = queries.shape[0]
    out_i = torch.empty((Q, L), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, L), dtype=torch.float32, device=dev)
    out_e = torch.empty((Q, L), dtype=torch.bool, device=dev)
    _launch(name, dev, queries.data_ptr(), *table_ptrs, ids.data_ptr(),
            avail.data_ptr(), b.data_ptr(), e.data_ptr(), version.data_ptr(),
            pool_ids.data_ptr(), pool_d.data_ptr(), pool_exp.data_ptr(),
            out_i.data_ptr(), out_d.data_ptr(), out_e.data_ptr(), Q, n, d, M,
            L)
    return out_i, out_d, out_e


def gathered_topk(queries, vectors, ids, avail, b, e, version,
                  pool_ids, pool_d, pool_exp):
    """One fused wavefront step (gather + L2 + label mask + beam merge):
    -> merged ((Q, L) int32 ids, (Q, L) float32 dists, (Q, L) bool
    expanded)."""
    if _on_cpu(queries, vectors, ids, avail, b, e, version, pool_ids,
               pool_d, pool_exp):
        return ref.gathered_topk_ref(queries, vectors, ids, avail, b, e,
                                     version, pool_ids, pool_d, pool_exp)
    d, M, L = queries.shape[1], ids.shape[1], pool_d.shape[1]
    _check_step(queries, ids, avail, b, e, version, pool_ids, pool_d,
                pool_exp, gathered_topk_smem_bytes(d, M, L), "gathered_topk")
    n = vectors.shape[0]
    _check("vectors", vectors, torch.float32, (n, d))
    return _launch_step("gathered_topk", queries, (vectors.data_ptr(),), ids,
                        avail, b, e, version, pool_ids, pool_d, pool_exp, n,
                        d, M, L)


def gathered_topk_quant(queries, codes, scale, offset, ids, avail, b, e,
                        version, pool_ids, pool_d, pool_exp):
    """:func:`gathered_topk` over an (n, d) int8 or float16 code table with
    (d,) float32 dequant params: distances are to ``codes * scale +
    offset``, dequantized in registers, row by gathered row."""
    if _on_cpu(queries, codes, scale, offset, ids, avail, b, e, version,
               pool_ids, pool_d, pool_exp):
        return ref.gathered_topk_quant_ref(queries, codes, scale, offset,
                                           ids, avail, b, e, version,
                                           pool_ids, pool_d, pool_exp)
    if codes.dtype not in _QUANT_SUFFIX:
        raise TypeError(f"codes: expected int8 or float16, got {codes.dtype}")
    d, M, L = queries.shape[1], ids.shape[1], pool_d.shape[1]
    _check_step(queries, ids, avail, b, e, version, pool_ids, pool_d,
                pool_exp, gathered_topk_quant_smem_bytes(d, M, L),
                "gathered_topk_quant")
    n = codes.shape[0]
    _check("codes", codes, codes.dtype, (n, d))
    _check("scale", scale, torch.float32, (d,))
    _check("offset", offset, torch.float32, (d,))
    return _launch_step(
        "gathered_topk_quant_" + _QUANT_SUFFIX[codes.dtype], queries,
        (codes.data_ptr(), scale.data_ptr(), offset.data_ptr()), ids, avail,
        b, e, version, pool_ids, pool_d, pool_exp, n, d, M, L)


def gathered_stream_bytes(Q: int, M: int, L: int, d: int, live: int,
                          itemsize: int = 4) -> int:
    """Bytes one wavefront step must move: the queries, the ``live``
    candidate rows that pass the mask (``d * itemsize`` bytes each), each
    candidate's id, avail, lab_b and lab_e (13 bytes), the versions, and
    the (Q, L) beam in and out (9 bytes per entry each way). A step over a
    code table also reads its (d,) float32 scale and offset: add 8 * d."""
    return (Q * d * 4 + live * d * itemsize + Q * M * 13 + Q * 4
            + 2 * Q * L * 9)


def pairwise_stream_bytes(Q: int, N: int, d: int, itemsize: int = 4) -> int:
    """Bytes of a full masked scan: the corpus at its itemsize, the float32
    queries, the endpoints, and the (Q, N) float32 output."""
    return N * d * itemsize + Q * d * 4 + 2 * N * 4 + 2 * Q * 4 + Q * N * 4


def int8_scan_stream_bytes(Q: int, N: int, d: int) -> int:
    """Bytes of :func:`pairwise_l2_int8`: the int8 codes and the float32
    queries, endpoints and output of a masked scan, plus the per-row
    ``sq_norm`` and the (d,) scale and offset."""
    return pairwise_stream_bytes(Q, N, d, 1) + N * 4 + 2 * d * 4
