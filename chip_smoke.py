#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one CUDA card and check it.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases env,kernels   # a short build-and-check run
    python3 chip_smoke.py --phases env,kernels,flat,graph,routes,profile
                                     # also profile one flat and one graph
                                     # request (device busy share)

Phases, each printing one JSON object per line:

1. ``env``: torch version, card name and power limit, kernel build seconds.
2. ``kernels``: each hand-written kernel against its plain PyTorch version
   on the card at edge shapes (ragged Q and N, all-masked rows, NO_EDGE ids,
   exact ties, wide steps, every predicate mask).
3. ``flat``: the flat route at n = 1M, d = 128 (the SIFT1M shape), checked
   against a float64 NumPy brute force.
4. ``graph``: an MSTG index built by the port's bulk builder, served on the
   graph route with Q = 256, checked against the port's CPU run on the same
   index; recall against the flat route is printed as information. A
   fanout sweep follows.
5. ``routes``: one ``auto`` and one ``pruned`` request on the graph index;
   the pruned route must have recall 1.0 against the flat route.
6. ``quant_flat``: the int8 and float16 storage tiers on the flat phase's
   index (quantized on the host by the engine): one scan launch per
   request, dists against the float64 brute force, recall@10 against the
   float32 flat route, and the float32 corpus never staged.
7. ``quant_graph``: both tiers on the graph phase's index, on the graph
   route: ``gathered_topk_quant`` launched and ``gathered_topk`` not, held
   against the port's CPU run of the same configuration.
8. ``quant_routes``: the int8 tier's ``pruned`` (recall against the
   float32 flat route) and ``auto`` (the work model's choice) routes.

Launch counts are set to 0 just before each main-path run (flat, graph,
and each tier's flat and graph run) and read just after. The kernel checks at the main path's shapes use the inputs
the main path handed to each kernel. The last lines are a ``{"kernels":
[...]}`` summary, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Without
a CUDA device, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.

TF32 is switched off for matmuls and cuDNN, so every float32 product here,
the yardstick ``torch.matmul`` included, runs in full float32.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
ALL_PHASES = ("env", "kernels", "flat", "quant_flat", "graph", "quant_graph",
              "routes", "quant_routes")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, float32
# outside the tensor cores, and int8 on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12

CSRC = "src/repro_torch/kernels/csrc/"
# row of the {"kernels": [...]} line -> (ops entry point, CUDA source, the
# TPU kernel's pallas_call it replaces)
KERNELS = {
    "gathered_topk": ("gathered_topk", CSRC + "gathered_topk.cu",
                      "src/repro/kernels/gathered_topk.py:130"),
    "gathered_topk_quant_int8": ("gathered_topk_quant",
                                 CSRC + "gathered_topk.cu",
                                 "src/repro/kernels/gathered_topk.py:186"),
    "gathered_topk_quant_f16": ("gathered_topk_quant",
                                CSRC + "gathered_topk.cu",
                                "src/repro/kernels/gathered_topk.py:186"),
    "gathered_l2": ("gathered_l2", CSRC + "gathered_l2.cu",
                    "src/repro/kernels/gathered_l2.py:49"),
    "pairwise_l2_masked": ("pairwise_l2_masked", CSRC + "pairwise_l2.cu",
                           "src/repro/kernels/pairwise_l2.py:64"),
    "pairwise_l2_masked_f16": ("pairwise_l2_masked", CSRC + "pairwise_l2.cu",
                               "src/repro/kernels/pairwise_l2.py:64"),
    "pairwise_l2_int8": ("pairwise_l2_int8", CSRC + "pairwise_l2_int8.cu",
                         "src/repro/kernels/pairwise_l2_int8.py:81"),
}
# Tolerances, kernel vs plain version on the same card, by ops entry point.
# The gathered kernels sum d positive squares in another order: relative
# error below d * 2^-24 (the quantized step's x_hat itself is bit-equal).
# The float pairwise kernel forms |q|^2 - 2 q.c + |c|^2 with its own FMA
# order; its error scales with the operands' norms, so it is held to 1e-4
# relative to (|dist| + 1), the tolerance of the reference's kernel tests.
# The int8 scan's integer sums are exact and its epilogue is rounded in the
# plain version's order, so it is expected bit-equal; it is held to the
# same 1e-4 as the float scan.
RTOL = {"gathered_topk": 1e-5, "gathered_topk_quant": 1e-5,
        "gathered_l2": 1e-5, "pairwise_l2_masked": 1e-4,
        "pairwise_l2_int8": 1e-4}


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    """One JSON line; a phase line also gets the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj, default=_jsonable), flush=True)


def _jsonable(v):
    if hasattr(v, "item"):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return str(v)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# ---- timing and bounds -------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events). A
    sleep kernel is queued before each run so the host's enqueue time does
    not show up as device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak: float = FP32_FLOP_PER_S):
    """(least ms, "bytes" or "operations"): the bytes over the HBM rate
    against the operations over ``peak`` (per second, for their type)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---- comparisons -----------------------------------------------------------

def compare_dists(got, want, rtol: float):
    """(max abs difference over finite entries, ok). +inf must match."""
    import torch
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    if not torch.equal(fin_g, fin_w):
        return float("inf"), False
    if not bool(fin_w.any()):
        return 0.0, True
    diff = (got[fin_w] - want[fin_w]).abs()
    ok = bool((diff <= rtol * (want[fin_w].abs() + 1.0)).all())
    return float(diff.max()), ok


def compare_beams(got, want, rtol: float):
    """Beam outputs (ids, dists, expanded): ids may differ only where the
    two dists tie within tolerance. Returns (max_abs_err, mismatched ids)."""
    import torch
    gi, gd, ge = got
    wi, wd, we = want
    err, ok = compare_dists(gd, wd, rtol)
    tie = (gd - wd).abs() <= rtol * (wd.abs() + 1.0)
    bad_ids = int(((gi != wi) & ~(tie & torch.isfinite(wd))).sum())
    bad_exp = int(((ge != we) & (gi == wi)).sum())
    return err, bad_ids + bad_exp + (0 if ok else 1)


class Capture:
    """Wraps an ``ops`` entry point: passes every call through and keeps the
    arguments of the call with the largest ``score`` (no extra launches)."""

    def __init__(self, ops_module, name: str, score=None):
        self.ops, self.name = ops_module, name
        self.fn = getattr(ops_module, name)
        self.score = score or (lambda *a: 0)
        self.best = None
        self.best_score = -1

    def __call__(self, *args):
        s = float(self.score(*args))
        if s > self.best_score:
            self.best, self.best_score = args, s
        return self.fn(*args)

    def __enter__(self):
        setattr(self.ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.fn)
        return False


def live_candidates(ids, avail, b, e, version):
    """Candidates of a wavefront step whose row the kernel reads."""
    ver = version[:, None]
    return int((avail & (ids >= 0) & (b <= ver) & (ver <= e)).sum())


def step_live(*args):
    """``live_candidates`` of a ``gathered_topk`` call's arguments, or of a
    ``gathered_topk_quant`` call's (which carry scale and offset)."""
    first = 4 if len(args) == 12 else 2
    return live_candidates(*args[first:first + 5])


# ---- kernel measurements at the main path's shapes ---------------------------

def measure_kernel(row: str, args, launches: int):
    """Hold the kernel of ``row`` against its plain version on the main
    path's captured ``args``, and time the kernel, the plain version and
    the library yardstick."""
    import torch
    from repro_torch.kernels import ops, ref
    name, src, replaces = KERNELS[row]
    kern = getattr(ops, name)
    plain = getattr(ref, name + "_ref")
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    lib = None
    if name.startswith("gathered_topk"):
        err, bad = compare_beams(got, want, RTOL[name])
        queries, table = args[:2]
        Q, d = queries.shape
        M, L = args[-8].shape[1], args[-2].shape[1]
        live = step_live(*args)
        quant = name == "gathered_topk_quant"
        nbytes = ops.gathered_stream_bytes(Q, M, L, d, live,
                                           table.element_size())
        # diff, square, add per element; a code is dequantized with two more
        bms, by = bound(nbytes + (8 * d if quant else 0),
                        (5.0 if quant else 3.0) * d * live)
    elif name == "gathered_l2":
        err, ok = compare_dists(got, want, RTOL[name])
        bad = 0 if ok else 1
        queries, cand = args
        Q, S, d = cand.shape
        bms, by = bound(4.0 * (Q * S * d + Q * d + Q * S), 3.0 * Q * S * d)
    elif name == "pairwise_l2_int8":
        err, ok = compare_dists(got, want, RTOL[name])
        bad = 0 if ok else 1
        queries, codes, scale, offset = args[:4]
        Q, d = queries.shape
        N = codes.shape[0]
        bms, by = bound(ops.int8_scan_stream_bytes(Q, N, d), 2.0 * Q * N * d,
                        INT8_OP_PER_S)
        wq = ref.quantize_query_weights_ref(queries, scale, offset)[0]
        lib = time_ms(lambda: torch._int_mm(wq, codes.T))
    else:
        err, ok = compare_dists(got, want, RTOL[name])
        bad = 0 if ok else 1
        queries, corpus = args[:2]
        Q, d = queries.shape
        N = corpus.shape[0]
        # the float16 scan still multiplies in float32: the fp32 rate
        bms, by = bound(ops.pairwise_stream_bytes(Q, N, d,
                                                  corpus.element_size()),
                        2.0 * Q * N * d)
        lhs = queries.to(corpus.dtype)
        lib = time_ms(lambda: torch.matmul(lhs, corpus.T))
    ms = time_ms(lambda: kern(*args))
    plain_ms = time_ms(lambda: plain(*args))
    out = {"name": row, "route": "cuda", "source": src, "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": lib}
    emit({"phase": "kernel_main_shapes", "shapes": [list(a.shape) for a in args
                                                    if hasattr(a, "shape")],
          "mismatches": bad, **out})
    check(bad == 0, f"{row} disagrees with its plain version at the main "
                    f"path's shapes (max_abs_err={err}, mismatches={bad})")
    return out


# ---- phase 2: edge shapes ----------------------------------------------------

def kernel_edge_checks(dev, S_wide: int):
    import numpy as np
    import torch
    from repro_torch.core import intervals as iv
    from repro_torch.core.quant import QuantizedStore
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    cases = 0

    # pairwise scans (float32 and float16 corpus, int8 codes): ragged Q/N
    # and d, every mask 0..63 at small N
    for (Q, N, d) in ((1, 1, 1), (3, 5, 8), (67, 1000, 17), (130, 4099, 128)):
        q = t(rng.normal(size=(Q, d)).astype(np.float32))
        c_np = rng.normal(size=(N, d)).astype(np.float32)
        c = t(c_np)
        c16 = c.half()
        st = QuantizedStore.from_vectors(c_np, "int8")
        i8 = [t(a) for a in (st.codes, st.scale, st.offset, st.sq_norm)]
        lo_np = rng.integers(0, 50, N).astype(np.float32)
        lo = t(lo_np)
        hi = t(lo_np + rng.integers(0, 20, N).astype(np.float32))
        ql_np = rng.integers(0, 50, Q).astype(np.float32)
        ql = t(ql_np)
        qh = t(ql_np + rng.integers(0, 20, Q).astype(np.float32))
        if N > 3:   # NaN-padded rows never qualify
            lo[-2:] = float("nan")
            hi[-2:] = float("nan")
        masks = range(64) if N <= 1000 else (iv.ANY_OVERLAP, iv.QUERY_CONTAINED,
                                             iv.BEFORE | iv.AFTER)
        scans = {
            "pairwise_l2_masked": lambda m: (
                ops.pairwise_l2_masked(q, c, lo, hi, ql, qh, m),
                ref.pairwise_l2_masked_ref(q, c, lo, hi, ql, qh, m)),
            "pairwise_l2_masked_f16": lambda m: (
                ops.pairwise_l2_masked(q, c16, lo, hi, ql, qh, m),
                ref.pairwise_l2_masked_ref(q, c16, lo, hi, ql, qh, m)),
            "pairwise_l2_int8": lambda m: (
                ops.pairwise_l2_int8(q, *i8, lo, hi, ql, qh, m),
                ref.pairwise_l2_int8_ref(q, *i8, lo, hi, ql, qh, m)),
        }
        for row, run in scans.items():
            worst = 0.0
            for mask in masks:
                got, want = run(mask)
                err, ok = compare_dists(got, want, RTOL[KERNELS[row][0]])
                check(ok, f"{row} Q={Q} N={N} d={d} mask={mask}: err={err}")
                worst = max(worst, err)
                cases += 1
            emit({"phase": "kernel_edges", "kernel": row, "Q": Q, "N": N,
                  "d": d, "masks": len(masks), "max_abs_err": worst})

    # gathered_l2: ragged Q, S and d
    for (Q, S, d) in ((1, 1, 1), (5, 37, 17), (256, 44, 128)):
        q = t(rng.normal(size=(Q, d)).astype(np.float32))
        cv = t(rng.normal(size=(Q, S, d)).astype(np.float32))
        err, ok = compare_dists(ops.gathered_l2(q, cv),
                                ref.gathered_l2_ref(q, cv), RTOL["gathered_l2"])
        check(ok, f"gathered_l2 Q={Q} S={S} d={d}: err={err}")
        cases += 1
        emit({"phase": "kernel_edges", "kernel": "gathered_l2", "Q": Q,
              "S": S, "d": d, "max_abs_err": err})

    # gathered_topk over a float32, int8 and float16 table: ragged Q,
    # NO_EDGE ids, all-masked rows, exact ties (duplicate table rows and
    # duplicate beam distances), and M up to 8*S. The int8 codes reach
    # +-127 (each dimension's min and max).
    for (Q, n, d, M, L) in ((1, 3, 4, 1, 1), (5, 50, 17, 12, 6),
                            (37, 2000, 128, 767, 64),
                            (256, 20000, 128, 8 * S_wide, 64)):
        table = rng.normal(size=(n, d)).astype(np.float32)
        table[1::2] = table[0::2][: len(table[1::2])]        # exact ties
        q = rng.normal(size=(Q, d)).astype(np.float32)
        ids = rng.integers(-1, n, (Q, M)).astype(np.int32)
        avail = (rng.random((Q, M)) < 0.7)
        b = rng.integers(0, 40, (Q, M)).astype(np.int32)
        e = b + rng.integers(0, 40, (Q, M)).astype(np.int32)
        ver = rng.integers(0, 70, Q).astype(np.int32)
        avail[Q // 2] = False                                  # all masked
        pool_d = np.sort(rng.random((Q, L)).astype(np.float32), axis=1)
        pool_d[:, 1::3] = pool_d[:, 0::3][:, : pool_d[:, 1::3].shape[1]]
        pool_d = np.sort(pool_d, axis=1)
        pool_ids = rng.integers(0, n, (Q, L)).astype(np.int32)
        tail = rng.integers(0, L + 1, Q)
        for qi in range(Q):
            pool_d[qi, tail[qi]:] = np.inf
            pool_ids[qi, tail[qi]:] = -1
        pool_exp = (rng.random((Q, L)) < 0.5) & np.isfinite(pool_d)
        step = tuple(t(a) for a in (ids, avail, b, e, ver, pool_ids, pool_d,
                                    pool_exp))
        tables = {"gathered_topk": (t(table),)}
        for tier, row in (("int8", "gathered_topk_quant_int8"),
                          ("float16", "gathered_topk_quant_f16")):
            st = QuantizedStore.from_vectors(table, tier)
            if tier == "int8":
                check(int(st.codes.min()) == -127
                      and int(st.codes.max()) == 127,
                      "int8 edge table does not reach +-127")
            tables[row] = (t(st.codes), t(st.scale), t(st.offset))
        for row, tab in tables.items():
            name = KERNELS[row][0]
            args = (t(q), *tab, *step)
            got = getattr(ops, name)(*args)
            want = getattr(ref, name + "_ref")(*args)
            err, bad = compare_beams(got, want, RTOL[name])
            check(bad == 0, f"{row} Q={Q} n={n} d={d} M={M} L={L}: "
                            f"err={err} mismatches={bad}")
            cases += 1
            smem = (ops.gathered_topk_smem_bytes if len(tab) == 1
                    else ops.gathered_topk_quant_smem_bytes)(d, M, L)
            emit({"phase": "kernel_edges", "kernel": row, "Q": Q, "n": n,
                  "d": d, "M": M, "L": L, "max_abs_err": err,
                  "mismatched_ids": bad, "smem_bytes": smem})
    torch.cuda.synchronize()
    return cases


# ---- helpers for the main path -----------------------------------------------

def subset_queries(ds, mask, selectivity, seed, n_sub=20000):
    """make_queries on a prefix of the corpus: the prefix has the same
    attribute distribution, and calibrating on it keeps the host cost small
    at n = 1M."""
    from repro_torch.data import RangeDataset, make_queries
    m = min(n_sub, ds.n)
    sub = RangeDataset(vectors=ds.vectors[:m], lo=ds.lo[:m], hi=ds.hi[:m],
                       queries=ds.queries, span=ds.span)
    return make_queries(sub, mask, selectivity, seed=seed)


def brute_force64(ds, qlo, qhi, mask, k, rows):
    import numpy as np
    from repro_torch.core import intervals as iv
    ids = np.full((len(rows), k), -1, np.int64)
    dd = np.full((len(rows), k), np.inf)
    for j, qi in enumerate(rows):
        sel = np.flatnonzero(iv.eval_predicate(mask, ds.lo, ds.hi,
                                               qlo[qi], qhi[qi]))
        diff = ds.vectors[sel].astype(np.float64) - ds.queries[qi].astype(
            np.float64)
        dist = np.einsum("nd,nd->n", diff, diff)
        order = np.argsort(dist, kind="stable")[:k]
        ids[j, :order.size] = sel[order]
        dd[j, :order.size] = dist[order]
    return ids, dd


def agreement(ids_a, d_a, ids_b, d_b, rtol):
    """Share of (query, rank) positions whose ids agree, counting a
    disagreement where the two distances tie within ``rtol`` as agreement."""
    import numpy as np
    same = ids_a == ids_b
    both_inf = ~np.isfinite(d_a) & ~np.isfinite(d_b)
    with np.errstate(invalid="ignore"):
        tie = np.abs(d_a - d_b) <= rtol * (np.abs(d_b) + 1e-30)
    return float(np.mean(same | both_inf | tie))


def misses_are_ties(ids, dists, ref_ids, ref_dists, rtol) -> bool:
    """True when every returned id that the reference's row lacks has a
    distance tied, within ``rtol``, with the reference's k-th."""
    import numpy as np
    in_row = (ids[:, :, None] == ref_ids[:, None, :]).any(axis=2)
    kth = ref_dists[:, -1:]
    return bool(np.all(in_row | (np.abs(dists - kth) <= rtol * (kth + 1.0))))


def timed_execute(eng, req, reps: int):
    import torch
    times = []
    res = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.execute(req)
        times.append(time.perf_counter() - t0)
    return res, statistics.median(times)


def profile_request(eng, req) -> dict:
    """Device busy share of one request, from a torch.profiler trace: the
    union of CUDA kernel intervals over the host's wall time, and device
    time by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.execute(req)                           # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.execute(req)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy = 0.0
    cur_s = cur_e = None
    by_name: dict = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1.0 - busy / wall_us) if spans else None,
            "device_kernels": len(spans),
            "top_device_ms": {name[:60]: us / 1e3 for name, us in top}}


def wavefront_steps(trace) -> int:
    return sum(int(sp.args.get("steps", 0)) for sp, _ in trace.walk()
               if sp.name == "wavefront_totals")


# ---- main --------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--flat-n", type=int, default=1_000_000)
    ap.add_argument("--graph-n", type=int, default=50_000)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np
    from repro_torch.core import (ANY_OVERLAP, EngineConfig, IndexSpec,
                                  MSTGIndex, Overlaps, QueryEngine,
                                  SearchRequest)
    from repro_torch.core import engine as engine_mod
    from repro_torch.data import make_range_dataset, recall_at_k
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "kernel_build_s": build_s,
          "kernel_build_log": str(_build.BUILD_LOG)})
    if _build.BUILD_LOG is not None and _build.BUILD_LOG.exists():
        for line in _build.BUILD_LOG.read_text().splitlines():
            if "registers" in line or "smem" in line or "==" in line:
                emit({"phase": "ptxas", "line": line.strip()})

    rows = {}
    if "kernels" in phases:
        n_cases = kernel_edge_checks(dev, S_wide=767)
        emit({"phase": "kernel_edges_done", "cases": n_cases})

    k = 10
    Qn = 256
    if "quant_flat" in phases:
        phases.add("flat")                     # its dataset, index and result
    if "quant_graph" in phases or "quant_routes" in phases:
        phases.add("graph")
    if "flat" in phases:
        t0 = time.perf_counter()
        ds = make_range_dataset(n=args.flat_n, d=128, n_queries=Qn,
                                quantize=1024, seed=args.seed)
        qlo, qhi = subset_queries(ds, ANY_OVERLAP, 0.10, seed=args.seed + 1)
        idx = MSTGIndex.build(IndexSpec(predicate=Overlaps(), builder="scan"),
                              ds.vectors, ds.lo, ds.hi)
        setup_s = time.perf_counter() - t0
        mem0 = torch.cuda.memory_allocated()
        eng = QueryEngine(idx, device="cuda")
        req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k,
                            route="flat")
        eng.execute(req)                       # stage the corpus
        torch.cuda.synchronize()
        staged_f32 = torch.cuda.memory_allocated() - mem0
        ops.reset_launches()
        with Capture(ops, "pairwise_l2_masked") as cap:
            res = eng.execute(req)
        launches = dict(ops.LAUNCHES)
        check(launches["pairwise_l2_masked"] > 0,
              "flat route did not launch pairwise_l2_masked")
        _, sec = timed_execute(eng, req, reps=5)
        f32_ms = sec * 1e3
        check_rows = list(range(16))
        bf_ids, bf_d = brute_force64(ds, qlo, qhi, ANY_OVERLAP, k, check_rows)
        got_ids, got_d = res.ids[check_rows], res.dists[check_rows]
        fin = np.isfinite(bf_d)
        rel = np.abs(got_d[fin] - bf_d[fin]) / np.maximum(bf_d[fin], 1e-30)
        agree = agreement(got_ids, got_d.astype(np.float64), bf_ids, bf_d,
                          1e-4)
        emit({"phase": "flat", "n": ds.n, "d": ds.d, "Q": Qn, "k": k,
              "setup_s": setup_s, "qps": Qn / sec, "request_ms": sec * 1e3,
              "staged_bytes": staged_f32,
              "launches": launches, "max_rel_err_vs_f64": float(rel.max()),
              "id_agreement_vs_f64": agree,
              "ids_equal_vs_f64": bool(np.array_equal(got_ids, bf_ids))})
        check(bool(np.all(np.isfinite(got_d) == fin)), "flat: +inf pattern "
              "differs from the brute force")
        check(float(rel.max()) <= 1e-4, f"flat: dists off by {rel.max()}")
        check(agree == 1.0, f"flat: ids disagree with the brute force "
                            f"({agree})")
        if "profile" in phases:
            emit({"phase": "profile", "route": "flat", "n": ds.n,
                  **profile_request(eng, req)})
        rows["pairwise_l2_masked"] = measure_kernel(
            "pairwise_l2_masked", cap.best, launches["pairwise_l2_masked"])
        del eng, cap
        torch.cuda.empty_cache()

    if "quant_flat" in phases:
        for tier, row in (("int8", "pairwise_l2_int8"),
                          ("float16", "pairwise_l2_masked_f16")):
            mem0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            qeng = QueryEngine(idx, EngineConfig(storage_dtype=tier),
                               device="cuda")
            quantize_s = time.perf_counter() - t0
            qeng.execute(req)                  # stage the codes
            torch.cuda.synchronize()
            staged = torch.cuda.memory_allocated() - mem0
            ops.reset_launches()
            with Capture(ops, KERNELS[row][0]) as cap:
                qres = qeng.execute(req)
            launches = dict(ops.LAUNCHES)
            check(launches[row] == 1 and sum(launches.values()) == 1,
                  f"{tier} flat route: expected one {row} launch, got "
                  f"{launches}")
            _, sec = timed_execute(qeng, req, reps=5)
            got_ids, got_d = qres.ids[check_rows], qres.dists[check_rows]
            rel = (np.abs(got_d[fin] - bf_d[fin])
                   / np.maximum(bf_d[fin], 1e-30))
            recall = recall_at_k(qres.ids, res.ids)
            emit({"phase": "quant_flat", "tier": tier, "n": ds.n, "Q": Qn,
                  "k": k, "rerank": qeng._rerank_width(k),
                  "quantize_s": quantize_s, "qps": Qn / sec,
                  "request_ms": sec * 1e3, "f32_request_ms": f32_ms,
                  "staged_bytes": staged, "f32_staged_bytes": staged_f32,
                  "launches": launches, "recall_vs_f32_flat": recall,
                  "max_rel_err_vs_f64": float(rel.max()),
                  "f32_corpus_staged": qeng._corpus_dev is not None})
            check(bool(np.all(np.isfinite(got_d) == fin)),
                  f"{tier} flat: +inf pattern differs from the brute force")
            check(float(rel.max()) <= 1e-4,
                  f"{tier} flat: dists off by {rel.max()}")
            check(recall >= 0.99, f"{tier} flat: recall {recall} against "
                                  f"the float32 flat route < 0.99")
            check(qeng._corpus_dev is None,
                  f"{tier} flat: the float32 corpus was staged")
            if "profile" in phases:
                emit({"phase": "profile", "route": "flat", "tier": tier,
                      "n": ds.n, **profile_request(qeng, req)})
            rows[row] = measure_kernel(row, cap.best, launches[row])
            del qeng, cap, qres
            torch.cuda.empty_cache()

    if "flat" in phases:
        del idx, ds, res

    if "graph" in phases or "routes" in phases:
        t0 = time.perf_counter()
        ds = make_range_dataset(n=args.graph_n, d=128, n_queries=Qn,
                                quantize=1024, seed=args.seed)
        spec = IndexSpec(predicate=Overlaps(), m=16, ef_con=64,
                         candidate_stage="coarse")
        idx = MSTGIndex.build(spec, ds.vectors, ds.lo, ds.hi,
                              workers=args.workers)
        build_total = time.perf_counter() - t0
        emit({"phase": "graph_build", "n": ds.n, "d": ds.d,
              "variants": sorted(idx.variants), "workers": idx.build_workers,
              "build_s": build_total,
              "variant_build_s": idx.build_seconds,
              "slots": {v: int(fv.nbr.shape[2]) for v, fv in
                        idx.variants.items()},
              "Lv": {v: fv.Lv for v, fv in idx.variants.items()},
              "Kpad": {v: fv.Kpad for v, fv in idx.variants.items()},
              "variant_bytes": {v: fv.nbytes() for v, fv in
                                idx.variants.items()}})
        qlo, qhi = subset_queries(ds, ANY_OVERLAP, 0.10, seed=args.seed + 1)
        eng = QueryEngine(idx, device="cuda")
        F = eng._resolve_fanout(None)
        flat_req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k,
                                 route="flat")
        flat_res = eng.execute(flat_req)

    if "graph" in phases:
        greq = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k, ef=64,
                             route="graph", trace=True)
        t_stage = time.perf_counter()
        for v in idx.variants:
            eng.graph_dev(v)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t_stage
        ops.reset_launches()
        with Capture(ops, "gathered_topk", step_live) as cap_t, \
                Capture(ops, "gathered_l2", lambda q, c: c.shape[1]) as cap_l:
            gres = eng.execute(greq)
        launches = dict(ops.LAUNCHES)
        check(launches["gathered_topk"] > 0 and launches["gathered_l2"] > 0,
              f"graph route did not launch its kernels: {launches}")
        steps = wavefront_steps(gres.trace)
        timed_req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k,
                                  ef=64, route="graph")
        _, sec = timed_execute(eng, timed_req, reps=3)
        f32_graph_ms, f32_steps = sec * 1e3, steps
        # the same queries through the port on the CPU, same index
        n_cpu = 32
        cpu_eng = QueryEngine(idx, device="cpu")
        before_cpu = dict(ops.LAUNCHES)
        creq = SearchRequest(ds.queries[:n_cpu], (qlo[:n_cpu], qhi[:n_cpu]),
                             ANY_OVERLAP, k=k, ef=64, route="graph", fanout=F)
        t0 = time.perf_counter()
        cres = cpu_eng.execute(creq)
        cpu_s = time.perf_counter() - t0
        agree = agreement(gres.ids[:n_cpu], gres.dists[:n_cpu], cres.ids,
                          cres.dists, 1e-5)
        check(ops.LAUNCHES == before_cpu, "the CPU run launched a kernel")
        emit({"phase": "graph", "n": ds.n, "Q": Qn, "ef": 64, "k": k,
              "fanout": F, "chunk": "auto", "stage_s": stage_s,
              "qps": Qn / sec, "request_ms": sec * 1e3, "steps": steps,
              "launches": launches, "cpu_agreement": agree,
              "cpu_queries": n_cpu, "cpu_request_s": cpu_s,
              "recall_vs_flat": recall_at_k(gres.ids, flat_res.ids),
              "slot_count": gres.report.slot_count})
        check(agree >= 0.99, f"graph: GPU/CPU agreement {agree} < 0.99")
        check(bool(np.all(np.isfinite(gres.dists) | (gres.ids < 0))),
              "graph: a returned id has a non-finite distance")
        if "profile" in phases:
            emit({"phase": "profile", "route": "graph", "n": ds.n,
                  "fanout": F, **profile_request(eng, timed_req)})
        rows["gathered_topk"] = measure_kernel(
            "gathered_topk", cap_t.best, launches["gathered_topk"])
        rows["gathered_l2"] = measure_kernel(
            "gathered_l2", cap_l.best, launches["gathered_l2"])
        del cap_t, cap_l

        # fanout sweep at these shapes (the CUDA default comes from it)
        sweep = []
        for f in (1, 2, 4, 8):
            sreq = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k,
                                 ef=64, route="graph", fanout=f, trace=True)
            sres = eng.execute(sreq)
            _, ssec = timed_execute(eng, SearchRequest(
                ds.queries, (qlo, qhi), ANY_OVERLAP, k=k, ef=64,
                route="graph", fanout=f), reps=2)
            sweep.append({"fanout": f, "qps": Qn / ssec,
                          "request_ms": ssec * 1e3,
                          "steps": wavefront_steps(sres.trace),
                          "recall_vs_flat": recall_at_k(sres.ids,
                                                        flat_res.ids)})
        emit({"phase": "fanout_sweep", "n": ds.n, "Q": Qn, "ef": 64,
              "default": engine_mod.CUDA_DEFAULT_FANOUT, "runs": sweep})

    if "quant_graph" in phases:
        n_cpu = 32
        for tier, sfx in (("int8", "int8"), ("float16", "f16")):
            row = "gathered_topk_quant_" + sfx
            cfg = EngineConfig(storage_dtype=tier)
            qeng = QueryEngine(idx, cfg, device="cuda")
            for v in idx.variants:
                qeng.graph_dev(v)
            torch.cuda.synchronize()
            ops.reset_launches()
            with Capture(ops, "gathered_topk_quant", step_live) as cap:
                qres = qeng.execute(greq)
            launches = dict(ops.LAUNCHES)
            check(launches[row] > 0 and launches["gathered_topk"] == 0,
                  f"{tier} graph route: expected {row} and no gathered_topk "
                  f"launch, got {launches}")
            steps = wavefront_steps(qres.trace)
            _, sec = timed_execute(qeng, timed_req, reps=3)
            cpu_q = QueryEngine(idx, cfg, device="cpu")
            before_cpu = dict(ops.LAUNCHES)
            cres = cpu_q.execute(creq)
            agree = agreement(qres.ids[:n_cpu], qres.dists[:n_cpu], cres.ids,
                              cres.dists, 1e-5)
            check(ops.LAUNCHES == before_cpu, "the CPU run launched a kernel")
            emit({"phase": "quant_graph", "tier": tier, "n": ds.n, "Q": Qn,
                  "ef": 64, "k": k, "fanout": F,
                  "rerank": qeng._rerank_width(k, upper=64),
                  "qps": Qn / sec, "request_ms": sec * 1e3,
                  "f32_request_ms": f32_graph_ms, "steps": steps,
                  "f32_steps": f32_steps, "launches": launches,
                  "cpu_agreement": agree, "cpu_queries": n_cpu,
                  "recall_vs_f32_flat": recall_at_k(qres.ids, flat_res.ids),
                  "recall_vs_f32_graph": recall_at_k(qres.ids, gres.ids),
                  "f32_corpus_staged": qeng._corpus_dev is not None})
            check(agree >= 0.99, f"{tier} graph: GPU/CPU agreement {agree} "
                                 f"< 0.99")
            check(bool(np.all(np.isfinite(qres.dists) | (qres.ids < 0))),
                  f"{tier} graph: a returned id has a non-finite distance")
            if "profile" in phases:
                emit({"phase": "profile", "route": "graph", "tier": tier,
                      "n": ds.n, "fanout": F,
                      **profile_request(qeng, timed_req)})
            rows[row] = measure_kernel(row, cap.best, launches[row])
            del qeng, cpu_q, cap, qres
            torch.cuda.empty_cache()

    if "routes" in phases:
        areq = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k, ef=64,
                             route="auto")
        ares = eng.execute(areq)
        preq = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k,
                             route="pruned")
        pres, psec = timed_execute(eng, preq, reps=2)
        recall = recall_at_k(pres.ids, flat_res.ids)
        # a miss counts only if its distance is not tied with the flat
        # route's k-th within the pairwise tolerance
        tie_ok = misses_are_ties(pres.ids, pres.dists, flat_res.ids,
                                 flat_res.dists, 1e-4)
        emit({"phase": "routes", "auto_route": ares.report.route,
              "auto_est_selectivity": float(ares.report.est_selectivity.mean()),
              "auto_recall_vs_flat": recall_at_k(ares.ids, flat_res.ids),
              "pruned_recall_vs_flat": recall, "pruned_ties_only": bool(tie_ok),
              "pruned_qps": Qn / psec})
        check(recall == 1.0 or bool(tie_ok),
              f"pruned route recall {recall} < 1.0")

    if "quant_routes" in phases:
        qeng = QueryEngine(idx, EngineConfig(storage_dtype="int8"),
                           device="cuda")
        preq = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k,
                             route="pruned")
        pres, psec = timed_execute(qeng, preq, reps=2)
        recall = recall_at_k(pres.ids, flat_res.ids)
        tie_ok = misses_are_ties(pres.ids, pres.dists, flat_res.ids,
                                 flat_res.dists, 1e-4)
        areq = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k, ef=64,
                             route="auto")
        ares = qeng.execute(areq)
        est = qeng.estimate_selectivity(ANY_OVERLAP, qlo, qhi)
        expect = qeng._auto_route(est, 64)
        emit({"phase": "quant_routes", "tier": "int8",
              "pruned_recall_vs_f32_flat": recall,
              "pruned_ties_only": bool(tie_ok), "pruned_qps": Qn / psec,
              "auto_route": ares.report.route, "auto_expected": expect,
              "scan_cost_ratio": qeng._scan_cost_ratio,
              "auto_est_selectivity": float(est.mean()),
              "auto_recall_vs_f32_flat": recall_at_k(ares.ids, flat_res.ids),
              "f32_corpus_staged": qeng._corpus_dev is not None})
        check(recall >= 0.99 or bool(tie_ok),
              f"int8 pruned route recall {recall} < 0.99 with misses that "
              f"are not ties")
        check(qeng._scan_cost_ratio == 0.25 and ares.report.route == expect,
              f"int8 auto route chose {ares.report.route}, the work model "
              f"gives {expect}")
        check(qeng._corpus_dev is None,
              "int8 pruned/auto: the float32 corpus was staged")
        del qeng

    name = torch.cuda.get_device_name(0)
    if rows:
        emit({"kernels": [rows[key] for key in KERNELS if key in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
