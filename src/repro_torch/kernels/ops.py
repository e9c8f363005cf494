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

When a trace is active (:mod:`repro_torch.obs`), each wrapper runs inside
a ``kernel:<name>`` span, in one of two modes:

* under a per-request or scoped trace (:func:`repro_torch.obs.timing_kernels`
  is True) the current stream is synchronized before and after the call,
  so the span times the kernel and not its enqueue, and the span carries
  ``bytes``, ``gb_per_s`` and ``frac_of_peak``
  (:func:`repro_torch.obs.profile.bandwidth_annotation`, from the byte
  models below and the card's HBM peak; None on the CPU or an unknown
  card) and ``impl`` (``"cuda"`` or ``"plain"``);
* under a window capture (``obs.capture(timeline=True)``) the span covers
  the enqueue alone and carries nothing: it waits for nothing, so the
  device's timeline is the untraced one, and a profiler of the window
  holds the kernel's own time.

With tracing off the wrappers stay asynchronous and add no work.
"""
from __future__ import annotations

import functools
import time
from typing import Dict

import torch

from .. import obs
from ..obs import profile
from . import ref

NO_EDGE = -1
LAUNCHES: Dict[str, int] = {
    "gathered_topk": 0, "gathered_topk_quant_int8": 0,
    "gathered_topk_quant_f16": 0, "gathered_l2": 0, "gathered_l2_dot": 0,
    "pairwise_l2_masked": 0, "pairwise_l2_masked_f16": 0,
    "pairwise_l2_int8": 0, "fused_topk_l2": 0, "fused_topk_l2_f16": 0}
# code-table entry points by element type
_QUANT_SUFFIX = {torch.int8: "int8", torch.float16: "f16"}
# the most dynamic shared memory a block can have (a gathered_topk block
# holds its query and its list of keys there)
MAX_SHARED_BYTES = 232448
# candidates a gathered_topk block masks, scores and sorts at a time
# (gathered_topk.cu's kChunk)
STEP_CHUNK = 2048
# a fused_topk_l2 list is one warp wide
FUSED_TOPK_MAX_K = 32
# the query block and corpus tile of fused_topk.cu (pairwise_tile.cuh's BQ,
# BN)
_FUSED_QBLOCK = 64
_FUSED_TILE = 128
# candidate element types of gathered_l2.cu, by their code there
_GATHERED_ELEM = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


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


def _split_scratch(Q: int, d: int, device) -> torch.Tensor:
    """Scratch of the float scans' query split (pairwise_tile.cuh's
    scratch_floats): a big and a small (Q, d) plane, each padded to 4
    floats, then |q|^2."""
    return torch.empty(2 * (-(-Q * d // 4) * 4) + Q, dtype=torch.float32,
                       device=device)


def _check_endpoints(lo, hi, ql, qh, N: int, Q: int, mask: int) -> None:
    for nm, t, m in (("lo", lo, N), ("hi", hi, N), ("ql", ql, Q),
                     ("qh", qh, Q)):
        _check(nm, t, torch.float32, (m,))
    if not 0 <= int(mask) <= 63:
        raise ValueError(f"mask {mask} outside [0, 63]")


# ---- byte models -------------------------------------------------------------

def pairwise_stream_bytes(Q: int, N: int, d: int, itemsize: int = 4) -> int:
    """Bytes of a full masked scan: the corpus at its itemsize, the float32
    queries, the endpoints, and the (Q, N) float32 output."""
    return N * d * itemsize + Q * d * 4 + 2 * N * 4 + 2 * Q * 4 + Q * N * 4


def int8_scan_stream_bytes(Q: int, N: int, d: int) -> int:
    """Bytes of :func:`pairwise_l2_int8`: the int8 codes and the float32
    queries, endpoints and output of a masked scan, plus the per-row
    ``sq_norm`` and the (d,) scale and offset."""
    return pairwise_stream_bytes(Q, N, d, 1) + N * 4 + 2 * d * 4


def fused_topk_stream_bytes(Q: int, N: int, d: int, k: int,
                            itemsize: int = 4) -> int:
    """Bytes of :func:`fused_topk_l2`: the corpus at its itemsize, the
    float32 queries and endpoints, and the (Q, k) ids and dists out; no
    (Q, N) term, since the matrix is never written."""
    return N * d * itemsize + Q * d * 4 + 2 * N * 4 + 2 * Q * 4 + 8 * Q * k


def gathered_l2_stream_bytes(Q: int, S: int, d: int,
                             itemsize: int = 4) -> int:
    """Bytes of :func:`gathered_l2` and :func:`gathered_l2_dot`: the
    (Q, S, d) candidates at their itemsize, the float32 queries, and the
    (Q, S) float32 output."""
    return Q * S * d * itemsize + Q * d * 4 + Q * S * 4


def gathered_stream_bytes(Q: int, M: int, L: int, d: int, live: int,
                          itemsize: int = 4) -> int:
    """Bytes one wavefront step must move: the queries, the ``live``
    candidate rows that pass the mask (``d * itemsize`` bytes each), each
    candidate's id, avail, lab_b and lab_e (13 bytes), the versions, and
    the (Q, L) beam in and out (9 bytes per entry each way). A step over a
    code table also reads its (d,) float32 scale and offset: add 8 * d."""
    return (Q * d * 4 + live * d * itemsize + Q * M * 13 + Q * 4
            + 2 * Q * L * 9)


def live_rows(ids, avail, b, e, version, n: int) -> int:
    """Candidates of a wavefront step whose table row the step reads:
    available, an id in [0, n), and a label window that holds the query's
    version. Waits for the device."""
    ver = version.to(torch.int32)[:, None]
    return int((avail.to(torch.bool) & (ids >= 0) & (ids < n) & (b <= ver)
                & (ver <= e)).sum())


def _step_bytes(queries, table, ids, avail, b, e, version, pool_d,
                extra: int = 0) -> int:
    Q, d = queries.shape
    live = live_rows(ids, avail, b, e, version, table.shape[0])
    return gathered_stream_bytes(Q, ids.shape[1], pool_d.shape[1], d, live,
                                 table.element_size()) + extra


# ---- tracing -----------------------------------------------------------------

def _traced(name: str, nbytes):
    """Run the wrapped entry point inside a ``kernel:<name>`` span when a
    trace is active; ``nbytes`` takes the entry point's arguments and
    returns its byte model (read only when the span times the kernel).
    The traced call returns exactly what an untraced one returns."""
    span_name = f"kernel:{name}"

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not obs.tracing():
                return fn(*args, **kwargs)
            if not obs.timing_kernels():
                with obs.span(span_name):
                    return fn(*args, **kwargs)
            dev = args[0].device
            cuda = dev.type == "cuda"
            with obs.span(span_name) as sp:
                if cuda:
                    torch.cuda.current_stream(dev).synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if cuda:
                    torch.cuda.current_stream(dev).synchronize()
                seconds = time.perf_counter() - t0
                peaks = profile.device_peaks(dev)
                ann = profile.bandwidth_annotation(
                    nbytes(*args, **kwargs), seconds,
                    None if peaks is None else peaks.hbm_bytes_per_s)
                for key, v in ann.items():
                    sp.set(key, v)
                sp.set("impl", "cuda" if cuda else "plain")
            return out
        return run
    return wrap


# ---- masked scans --------------------------------------------------------------

@_traced("pairwise_l2_masked", lambda q, c, *a: pairwise_stream_bytes(
    q.shape[0], c.shape[0], q.shape[1], c.element_size()))
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
    scratch = _split_scratch(Q, d, queries.device)
    _launch(name, queries.device, queries.data_ptr(), corpus.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), ql.data_ptr(), qh.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), Q, N, d, int(mask))
    return out


@_traced("pairwise_l2_int8", lambda q, codes, *a: int8_scan_stream_bytes(
    q.shape[0], codes.shape[0], q.shape[1]))
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


@functools.cache
def _fused_slots(index: int, f16: bool) -> int:
    """Blocks of fused_topk.cu's first grid that card ``index`` runs at
    once."""
    from . import _build
    with torch.cuda.device(index):
        slots = _build.load().fused_topk_l2_slots(int(f16))
    if slots <= 0:
        raise RuntimeError(f"fused_topk_l2: occupancy query failed "
                           f"(cudaError {-slots})")
    return slots


@_traced("fused_topk_l2", lambda q, c, lo, hi, ql, qh, mask, k=10:
         fused_topk_stream_bytes(q.shape[0], c.shape[0], q.shape[1], k,
                                 c.element_size()))
def fused_topk_l2(queries, corpus, lo, hi, ql, qh, mask: int, k: int = 10):
    """Exact filtered k-NN in one pass: (Q, d) float32 x (N, d) float32 or
    float16 -> ((Q, k) int32 ids, (Q, k) float32 squared L2), ordered by
    (dist, id); (NO_EDGE, +inf) where fewer than k rows qualify. The
    (Q, N) matrix is never built. On the card k is at most
    :data:`FUSED_TOPK_MAX_K`."""
    if _on_cpu(queries, corpus, lo, hi, ql, qh):
        return ref.fused_topk_l2_ref(queries, corpus, lo, hi, ql, qh, mask,
                                     k)
    k = int(k)
    if not 1 <= k <= FUSED_TOPK_MAX_K:
        raise ValueError(f"fused_topk_l2: k={k} outside [1, "
                         f"{FUSED_TOPK_MAX_K}], the kernel's limit")
    Q, d = queries.shape
    N = corpus.shape[0]
    f32 = torch.float32
    if corpus.dtype not in (f32, torch.float16):
        raise TypeError(f"corpus: expected float32 or float16, got "
                        f"{corpus.dtype}")
    _check("queries", queries, f32, (Q, d))
    _check("corpus", corpus, corpus.dtype, (N, d))
    _check_endpoints(lo, hi, ql, qh, N, Q, mask)
    dev = queries.device
    f16 = corpus.dtype == torch.float16
    # one wave of the first grid: every block walks as many corpus tiles
    tiles = -(-N // _FUSED_TILE)
    qblocks = -(-Q // _FUSED_QBLOCK)
    splits = max(1, min(tiles, _fused_slots(dev.index, f16)
                            // max(qblocks, 1)))
    part_d = torch.empty((Q, splits, k), dtype=f32, device=dev)
    part_i = torch.empty((Q, splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, k), dtype=f32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    scratch = _split_scratch(Q, d, dev)
    _launch("fused_topk_l2_f16" if f16 else "fused_topk_l2", dev,
            queries.data_ptr(), corpus.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), ql.data_ptr(), qh.data_ptr(), part_d.data_ptr(),
            part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            scratch.data_ptr(), Q, N, d, int(mask), k, splits)
    return out_i, out_d


# ---- gathered distances ----------------------------------------------------------

def _gathered(name: str, plain, queries, cand_vecs):
    if _on_cpu(queries, cand_vecs):
        return plain(queries, cand_vecs)
    Q, d = queries.shape
    S = cand_vecs.shape[1]
    if cand_vecs.dtype not in _GATHERED_ELEM:
        raise TypeError(f"cand_vecs: expected float32, float16 or bfloat16, "
                        f"got {cand_vecs.dtype}")
    if queries.dtype in (torch.float16, torch.bfloat16):
        queries = queries.to(torch.float32)     # widened, as the kernel does
    _check("queries", queries, torch.float32, (Q, d))
    _check("cand_vecs", cand_vecs, cand_vecs.dtype, (Q, S, d))
    out = torch.empty((Q, S), dtype=torch.float32, device=queries.device)
    _launch(name, queries.device, queries.data_ptr(), cand_vecs.data_ptr(),
            out.data_ptr(), Q, S, d, _GATHERED_ELEM[cand_vecs.dtype])
    return out


def _gathered_bytes(queries, cand_vecs) -> int:
    return gathered_l2_stream_bytes(*cand_vecs.shape,
                                    cand_vecs.element_size())


@_traced("gathered_l2", _gathered_bytes)
def gathered_l2(queries, cand_vecs):
    """(Q, d) x (Q, S, d) -> (Q, S) float32 squared L2. On the card the
    candidates are float32, float16 or bfloat16 (widened as they are read)
    and a float16 or bfloat16 query is widened to float32 first."""
    return _gathered("gathered_l2", ref.gathered_l2_ref, queries, cand_vecs)


@_traced("gathered_l2_dot", _gathered_bytes)
def gathered_l2_dot(queries, cand_vecs):
    """:func:`gathered_l2` in the contraction form ``|q|^2 - 2 q.c +
    |c|^2``."""
    return _gathered("gathered_l2_dot", ref.gathered_l2_dot_ref, queries,
                     cand_vecs)


# ---- wavefront steps ---------------------------------------------------------------

def _step_smem_bytes(planes: int, d: int, M: int, L: int) -> int:
    # ``planes`` (d,) float32 vectors, padded to 8 bytes, then one 8-byte
    # key for each of the L + min(M, STEP_CHUNK) list entries
    return -(-4 * planes * d // 8) * 8 + 8 * (L + min(M, STEP_CHUNK))


def gathered_topk_smem_bytes(d: int, M: int, L: int) -> int:
    """Dynamic shared memory one gathered_topk block needs: q, then a key
    for each beam entry and each candidate of one chunk."""
    return _step_smem_bytes(1, d, M, L)


def gathered_topk_quant_smem_bytes(d: int, M: int, L: int) -> int:
    """Dynamic shared memory one gathered_topk_quant block needs: the
    float32 step's, plus the (d,) scale and offset beside q."""
    return _step_smem_bytes(3, d, M, L)


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


@_traced("gathered_topk", lambda q, vectors, ids, avail, b, e, version,
         pool_ids, pool_d, pool_exp: _step_bytes(q, vectors, ids, avail, b, e,
                                                 version, pool_d))
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


@_traced("gathered_topk_quant", lambda q, codes, scale, offset, ids, avail, b,
         e, version, pool_ids, pool_d, pool_exp: _step_bytes(
             q, codes, ids, avail, b, e, version, pool_d, 8 * q.shape[1]))
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
