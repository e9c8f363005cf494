#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one CUDA card and check it.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases env,kernels   # a short build-and-check run
    python3 chip_smoke.py --phases env,kernels,flat,quant_flat
                                     # the scans at the main path's shapes,
                                     # without the 50k graph build
    python3 chip_smoke.py --phases env,scan_sweep
                                     # the scans' time against d
    python3 chip_smoke.py --phases env,kernels,gathered_sweep
                                     # gathered_l2 / gathered_l2_dot against
                                     # S, beside torch.bmm and torch.cdist
    python3 chip_smoke.py --phases env,kernels,flat,graph,routes,profile
                                     # also profile one flat and one graph
                                     # request (device busy share)
    python3 chip_smoke.py --phases env,streaming,sharded
                                     # the streaming index and sharded
                                     # serving (pulls in the flat phase)
    python3 chip_smoke.py --phases env,graph,streaming,sharded,serving
                                     # the serving front ends on those
                                     # backends
    python3 chip_smoke.py --phases env,baselines,lm
                                     # the paper's baselines and the LM
                                     # serving path (no other index build)

Phases, each printing one JSON object per line:

1. ``env``: torch version, card name and power limit, kernel build seconds.
2. ``kernels``: each hand-written kernel against its plain PyTorch version
   on the card at edge shapes (ragged Q and N, all-masked rows, NO_EDGE ids,
   exact ties, duplicate rows, k > N, wide steps, unsorted beams, steps
   whose candidates are all live, rows that are no whole number of 16-byte
   loads or do not start on 16 bytes, every predicate mask; for
   ``fused_topk_l2``, a corpus that overflows its survivor queues in every
   tile, ties across tiles and splits, selectivity 0 and 1 and NaN
   endpoints).
3. ``scan_sweep``: the three scans and ``fused_topk_l2`` (float32 and
   float16 corpus) timed at Q = 256 and the flat phase's n over d = 16 ..
   256 on random inputs, beside the rate of their tensor-core instructions
   alone (``csrc/mma_probe.cu``) and a fill of the (Q, N) output: what
   holds each scan above its bound.
   ``gathered_sweep``: ``gathered_l2`` and ``gathered_l2_dot`` timed at Q =
   256, d = 128, float32 over S = 1, 88, 176, 512 and 2048, beside
   ``torch.bmm`` (the cross term alone), ``torch.cdist`` (the unsquared
   distance) and an empty kernel: S = 1 shows the fixed cost of a launch,
   S = 88 to 176 the rate from L2, S = 2048 (268 MB) the rate from device
   memory.
4. ``flat``: the flat route at n = 1M, d = 128 (the SIFT1M shape), checked
   against a float64 NumPy brute force; then ``fused_topk_l2`` on the
   inputs the route handed to ``pairwise_l2_masked``, held against the
   route's result, without a (Q, N) buffer; each launch's device time
   over a float32 and a float16 corpus.
5. ``graph``: an MSTG index built by the port's bulk builder, served on the
   graph route with Q = 256, checked against the port's CPU run on the same
   index; recall against the flat route is printed as information;
   ``gathered_l2_dot`` on the arguments of the route's ``gathered_l2``
   call. A fanout sweep follows.
6. ``routes``: one ``auto`` and one ``pruned`` request on the graph index;
   the pruned route must have recall 1.0 against the flat route.
7. ``quant_flat``: the int8 and float16 storage tiers on the flat phase's
   index (quantized on the host by the engine): one scan launch per
   request, dists against the float64 brute force, recall@10 against the
   float32 flat route, and the float32 corpus never staged.
8. ``quant_graph``: both tiers on the graph phase's index, on the graph
   route: ``gathered_topk_quant`` launched and ``gathered_topk`` not, held
   against the port's CPU run of the same configuration.
9. ``quant_routes``: the int8 tier's ``pruned`` (recall against the
   float32 flat route) and ``auto`` (the work model's choice) routes.
10. ``trace``: the traced kernel path (pulls in ``flat`` and ``graph``):
   ``fused_topk_l2`` (over the float32 and the float16 corpus) and
   ``gathered_l2_dot`` under ``obs.capture()``, each a
   ``kernel:<name>`` span with ``impl == "cuda"`` and ``frac_of_peak`` in
   (0, 1.05]; a traced graph request equal to an untraced one, with
   ``kernel:gathered_topk`` spans under its slots, and its overhead; one
   flat request under ``obs.profiler_capture``.
11. ``streaming``: ``repro_torch.streaming.SegmentedIndex`` on the card at
   ``--stream-n`` rows (70,000: segments of 20k, 10k and 10k rows built by
   the graph phase's spec, a 16k-row delta, 1,000 tombstones in the first
   segment, 500 rows of the second upserted into the delta), every route
   served: flat against a float64 brute force over the live rows by
   external id, pruned recall 1.0 against flat, graph agreement ≥ 0.99
   with the port's CPU run of the same index on 32 queries; kernels 1 and
   3 held against their plain versions at the widest beam (1,010, from
   the tombstones), kernel 5 at the delta's scan. Then a size-tiered
   compaction: the policy must pick the two small segments, the exact
   routes' ids must not change and allocated device bytes must fall.
12. ``sharded``: ``repro_torch.distributed.ShardedDeployment.flat`` over
   the flat phase's corpus on D = 4 logical shards of the card, under the
   ``all_gather``, ``tournament`` and ``host`` merges: ids bit-equal to one
   another and to the flat route, four ``pairwise_l2_masked`` launches a
   request; shard 3 failed (degraded, the flat answer over the other
   rows, three launches); ``per_shard_k = 5``; and ``from_segmented`` over
   the streaming phase's index on D = 2, equal to the index's own pruned
   answer. Asking for it pulls in ``flat`` and ``streaming``.
13. ``serving``: the serving front ends (``repro_torch.serving``) on the
   backends the phases above built (it pulls in ``graph`` and ``sharded``;
   it builds no index). After ``sharded``: ``RetrievalServer`` on the
   streaming index, one tick of 100 upserts, deletes of 50 ids that its
   first 32 queries returned before the tick, those 32 queries and 32
   probes with the upserted vectors (no deleted id comes back, each probe
   finds its row first, the answers equal ``execute`` after the tick); then
   ``AsyncRetrievalServer`` on the D = 4 deployment with shard 3 failed
   (every response degraded, ids equal the degraded batched request's up
   to exact ties). After ``graph``: the 256 graph queries through
   ``AsyncRetrievalServer`` on the float32 engine, route ``graph``, in 4
   waves (``chunk`` 16, ``max_batch`` 64): a slot refilled, every hit
   bit-equal to the batched request and 16 of them to solo ``execute``,
   kernels 1 and 3 launched and held against their plain versions at the
   shapes the stream handed them; the same queries on the flat route
   (dists bit-equal to the batched flat route, ids up to exact ties;
   kernel 5 held at its micro-batch shape); and ``RetrievalServer`` over
   two masks on an engine whose config routes graph (each mask group
   equal to ``execute``, kernels 1 and 3 launched). Each line has the wall
   time, QPS and the server's e2e and queue-wait p50 / p99 (host clock).
14. ``baselines``: ``repro_torch.core.baselines.IRangeGraphLike`` (exp3's
   RFANN setting: m = 12, ef_con = 64, 256 queries between the point
   attribute's 0.3 and 0.4 quantiles, ef = 64) at ``--baselines-n`` rows
   (20,000), built once on the host and searched on the card and on the
   CPU: agreement ≥ 0.99 (ties within 1e-5 agree), every id inside the
   query range, recall@10 against the brute force reported; kernels 1
   and 3 held against their plain versions at the search's shapes
   (``baselines_kernel`` lines); ``Prefiltering`` on the same data must
   have recall 1.0.
15. ``lm``: the LM and ``ServeEngine``. Smoke olmo-1b, gemma3-1b,
   qwen3-moe-30b-a3b, recurrentgemma-2b, rwkv6-7b and deepseek-v3-671b
   (float32, one CPU init each): tokens on the card equal the CPU's, last
   logits within 1e-4. olmo-1b at full width in bfloat16 (16 x 2048,
   vocab 50,304), B = 8 prompts of 128 tokens, 32 new: init s, prefill
   ms, decode ms a token against the parameters' bytes over the HBM
   rate, tokens/s, peak allocated bytes, one prefill's and one decode
   step's device busy share (torch.profiler); the port's ``flash_attention``
   timed beside ``scaled_dot_product_attention`` at the prefill's shapes
   (a yardstick, not on the path). The same weights in float64: greedy
   tokens equal argmax over repeated full prefills (8 steps); in float32,
   on a (2, 32) prompt, every layer's output on the card from the CPU's
   input (and the head's logits) within 1e-3 of the CPU's. The reference's
   init makes the full-width model amplify rounding to O(1) logits, so
   float32's teacher forcing and end-to-end logits are reported, not held,
   beside the CPU logits' move under a 1e-7 relative change of the
   weights. Then, each after freeing the device memory of what ran
   before, qwen3-moe-30b-a3b (``lm_moe_full``: 48 x 2048, 128 experts
   top-8, 61.1 GB), recurrentgemma-2b and rwkv6-7b (``lm_rec_full``) at
   their published widths and full depth in bfloat16, seeded random
   weights, the same load and report; for the MoE the prefill's dropped
   assignments at capacity factor 1.25, by sequence beside the distinct
   experts a sequence and the batch chose, and the decode step's byte bound
   counting only the experts its router chose, beside the design's (all
   128 a layer). Held on each: float64 greedy tokens (a (2, 32) prompt,
   16 new) equal teacher forcing in one causal forward, on the first
   layers of the same weights (qwen3-moe 2, rwkv6 4, recurrentgemma all;
   the MoE at a capacity factor that drops nothing), and each distinct
   layer kind in float32 on the card within 1e-3 of the CPU's from the
   CPU's input. Then ``repro_torch.launch.serve.main`` in-process in each
   mode (plain, ``--async``, ``--streaming --n 400``, ``--shards 4 --n
   1200``, and ``--arch qwen3-moe-30b-a3b`` with ``--route graph`` and
   with ``--route flat``): 24 of 24 requests served, none empty; the
   streaming mode launches kernel 5 on its delta, the MoE's graph mode
   kernels 1 and 3 and its flat mode kernel 5, all through
   ``QueryEngine``. The LM path runs no hand-written kernel (the
   reference's has no Pallas kernel).

Launch counts are set to 0 just before each main-path run (flat, graph,
each tier's flat and graph run, the ``trace`` phase's kernel calls, the
path of ``gathered_l2_dot`` and ``fused_topk_l2``, which no route calls,
each streaming and sharded request, each serving run, the baselines' card
search and each ``launch.serve`` mode) and read just
after. The kernel
checks at the main path's shapes use the inputs the main path handed to
each kernel. The last lines are a ``{"kernels": [...]}`` summary, the
``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Without
a CUDA device, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.

TF32 is switched off for torch's matmuls and cuDNN, so the plain versions
and the yardstick ``torch.matmul`` run in full float32. The port's own
float scans multiply on the tensor cores in 3xTF32 (2xTF32 over a float16
corpus), which keeps float32 accuracy; their bounds count those passes at
the card's TF32 rate.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
ALL_PHASES = ("env", "kernels", "scan_sweep", "gathered_sweep", "flat",
              "quant_flat", "graph", "quant_graph", "routes", "quant_routes",
              "trace", "streaming", "sharded", "serving", "baselines", "lm")
# the card's published peaks (repro_torch.obs.profile.PEAKS), set in main
PEAKS = None

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
    "gathered_l2_dot": ("gathered_l2_dot", CSRC + "gathered_l2.cu",
                        "src/repro/kernels/gathered_l2.py:49"),
    "pairwise_l2_masked": ("pairwise_l2_masked", CSRC + "pairwise_l2.cu",
                           "src/repro/kernels/pairwise_l2.py:64"),
    "pairwise_l2_masked_f16": ("pairwise_l2_masked", CSRC + "pairwise_l2.cu",
                               "src/repro/kernels/pairwise_l2.py:64"),
    "pairwise_l2_int8": ("pairwise_l2_int8", CSRC + "pairwise_l2_int8.cu",
                         "src/repro/kernels/pairwise_l2_int8.py:81"),
    "fused_topk_l2": ("fused_topk_l2", CSRC + "fused_topk.cu",
                      "src/repro/kernels/fused_topk.py:85"),
    "fused_topk_l2_f16": ("fused_topk_l2", CSRC + "fused_topk.cu",
                          "src/repro/kernels/fused_topk.py:85"),
}
# Tolerances, kernel vs plain version on the same card, by ops entry point.
# The gathered kernels sum d positive squares in another order: relative
# error below d * 2^-24 (the quantized step's x_hat itself is bit-equal).
# The float pairwise kernel forms |q|^2 - 2 q.c + |c|^2 with its own sum
# order (3xTF32 on the tensor cores); its error scales with the operands'
# norms, so it is held to 1e-4 relative to (|dist| + 1), the tolerance of
# the reference's kernel tests.
# The int8 scan's integer sums are exact and its epilogue is rounded in the
# plain version's order, so it is held bit-equal at the edge shapes (its
# main-shape row reports max_abs_err under the float scan's 1e-4).
# gathered_l2_dot and fused_topk_l2 take the |q|^2 - 2 q.c + |c|^2 form
# too, and are held to the same 1e-4 (ids of fused_topk_l2 may differ only
# where its dists tie within it).
RTOL = {"gathered_topk": 1e-5, "gathered_topk_quant": 1e-5,
        "gathered_l2": 1e-5, "gathered_l2_dot": 1e-4,
        "pairwise_l2_masked": 1e-4, "pairwise_l2_int8": 1e-4,
        "fused_topk_l2": 1e-4}


# Edge shapes of the scans, (Q, N, d, case): d = 1, 17 and 129 take the
# element copy path, the rest the 16-byte one; "misaligned" hands every
# operand over one element past a 16-byte boundary. No N is a multiple of
# the 128-row corpus tile, and Q = 67, 130 and 300 are no multiple of the
# 64-row query block.
SCAN_EDGES = ((1, 1, 1, ""), (3, 5, 8, ""), (67, 1000, 17, ""),
              (130, 4099, 128, ""), (256, 3001, 64, ""), (300, 2055, 129, ""),
              (1, 777, 256, ""), (256, 20000, 128, ""),
              (67, 1000, 128, "misaligned"), (300, 333, 17, "misaligned"))
# (Q, S, d, case) of gathered_l2 / gathered_l2_dot, each run through both
# kernels over float32, float16 and bfloat16 candidates. d = 1, 17 and 129
# (and d = 4 over 16-bit types) take the element path, the rest the 16-byte
# one, with 1 to 514 units a row (17 and 34: a short last round). Only S =
# 44, 12 and 20 are a multiple of the 4-row unroll, and no S is one of a
# block's 16-row strip. "misaligned": the candidates start one element past
# 16 bytes; "qmisaligned": the float32 query does; "nonfinite": inf, -inf
# and NaN entries and one inf row among the candidates. Q = 70,000 is past
# the 65,535 a grid's y or z could hold.
GATHERED_EDGES = ((1, 1, 1, ""), (5, 37, 17, ""), (13, 9, 1, ""),
                  (256, 44, 128, ""), (67, 30, 64, ""), (300, 12, 129, ""),
                  (1, 20, 256, ""), (67, 30, 128, "misaligned"),
                  (3, 13, 128, ""), (9, 37, 4, ""), (33, 70, 8, ""),
                  (17, 29, 136, ""), (5, 9, 2056, ""),
                  (67, 30, 128, "qmisaligned"), (70000, 1, 128, ""),
                  (40, 21, 128, "nonfinite"), (13, 9, 17, "nonfinite"))


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


def bound(nbytes: float, ops: float, peak: float = None):
    """(least ms, "bytes" or "operations"): the bytes over the HBM rate
    against the operations over ``peak`` (per second, for their type; the
    fp32 rate by default)."""
    t_bytes = nbytes / PEAKS.hbm_bytes_per_s * 1e3
    t_ops = ops / (peak or PEAKS.fp32_flop_per_s) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def tf32_passes(corpus) -> int:
    """TF32 passes of the float scans' tensor-core product
    (pairwise_tile.cuh): 3 over a float32 corpus (3xTF32), 2 over a float16
    one, whose values are TF32 values."""
    import torch
    return 3 if corpus.dtype == torch.float32 else 2


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
    """Beam outputs (ids, dists, expanded) or top-k outputs (ids, dists):
    ids may differ only where the two dists tie within tolerance. Returns
    (max_abs_err, mismatched ids)."""
    import torch
    gi, gd = got[:2]
    wi, wd = want[:2]
    err, ok = compare_dists(gd, wd, rtol)
    tie = (gd - wd).abs() <= rtol * (wd.abs() + 1.0)
    bad_ids = int(((gi != wi) & ~(tie & torch.isfinite(wd))).sum())
    bad_exp = (int(((got[2] != want[2]) & (gi == wi)).sum())
               if len(got) == 3 else 0)
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


def step_live(*args):
    """``ops.live_rows`` of a ``gathered_topk`` call's arguments, or of a
    ``gathered_topk_quant`` call's (which carry scale and offset)."""
    from repro_torch.kernels import ops
    first = 4 if len(args) == 12 else 2
    return ops.live_rows(*args[first:first + 5], args[1].shape[0])


# ---- kernel measurements at the main path's shapes ---------------------------

def measure_kernel(row: str, args, launches: int,
                   phase: str = "kernel_main_shapes"):
    """Hold the kernel of ``row`` against its plain version on the main
    path's captured ``args``, and time the kernel, the plain version and
    the library yardstick; the line printed is tagged ``phase``."""
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
    elif name.startswith("gathered_l2"):
        err, ok = compare_dists(got, want, RTOL[name])
        bad = 0 if ok else 1
        queries, cand = args
        Q, S, d = cand.shape
        nbytes = ops.gathered_l2_stream_bytes(Q, S, d, cand.element_size())
        if name == "gathered_l2":          # diff, square, add
            bms, by = bound(nbytes, 3.0 * Q * S * d)
            # the unsquared distance over the same bytes
            qrow = queries.to(cand.dtype)[:, None, :]
            lib = time_ms(lambda: torch.cdist(qrow, cand))
        else:
            # q.c and |c|^2 per element, |q|^2 per query; the yardstick is
            # the cross term alone
            bms, by = bound(nbytes, 4.0 * Q * S * d + 2.0 * Q * d)
            qcol = queries[:, :, None]
            lib = time_ms(lambda: torch.bmm(cand, qcol))
    elif name == "fused_topk_l2":
        err, bad = compare_beams(got, want, RTOL[name])
        queries, corpus = args[:2]
        Q, d = queries.shape
        N = corpus.shape[0]
        bms, by = bound(ops.fused_topk_stream_bytes(Q, N, d, args[7],
                                                    corpus.element_size()),
                        tf32_passes(corpus) * 2.0 * Q * N * d,
                        PEAKS.tf32_flop_per_s)
        # the product alone: no norms, predicate or top-k
        lhs = queries.to(corpus.dtype)
        lib = time_ms(lambda: torch.matmul(lhs, corpus.T))
    elif name == "pairwise_l2_int8":
        err, ok = compare_dists(got, want, RTOL[name])
        bad = 0 if ok else 1
        queries, codes, scale, offset = args[:4]
        Q, d = queries.shape
        N = codes.shape[0]
        bms, by = bound(ops.int8_scan_stream_bytes(Q, N, d), 2.0 * Q * N * d,
                        PEAKS.int8_op_per_s)
        wq = ref.quantize_query_weights_ref(queries, scale, offset)[0]
        lib = time_ms(lambda: torch._int_mm(wq, codes.T))
    else:
        err, ok = compare_dists(got, want, RTOL[name])
        bad = 0 if ok else 1
        queries, corpus = args[:2]
        Q, d = queries.shape
        N = corpus.shape[0]
        bms, by = bound(ops.pairwise_stream_bytes(Q, N, d,
                                                  corpus.element_size()),
                        tf32_passes(corpus) * 2.0 * Q * N * d,
                        PEAKS.tf32_flop_per_s)
        lhs = queries.to(corpus.dtype)
        lib = time_ms(lambda: torch.matmul(lhs, corpus.T))
    ms = time_ms(lambda: kern(*args))
    plain_ms = time_ms(lambda: plain(*args))
    out = {"name": row, "route": "cuda", "source": src, "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": lib}
    emit({"phase": phase, "shapes": [list(a.shape) for a in args
                                     if hasattr(a, "shape")],
          "mismatches": bad, **out})
    check(bad == 0, f"{row} disagrees with its plain version at the main "
                    f"path's shapes (max_abs_err={err}, mismatches={bad})")
    return out


def scan_sweep(dev, Q: int, N: int, seed: int) -> None:
    """Time the three scans and fused_topk_l2 (float32 and float16 corpus)
    at Q x N over d = 16 .. 256 on random inputs: a scan's time against d
    splits into the part that grows with d (copies and product) and the
    part that does not (the epilogue and the (Q, N) output), which is what
    holds it above its bound. Beside them, the rate of the scans'
    tensor-core instructions alone (``mma_probe``) and a fill of the (Q, N)
    output (what writing it alone takes). One line per kernel and d; no
    launch counts."""
    import torch
    from repro_torch.core import intervals as iv
    from repro_torch.kernels import _build, ops
    g = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.rand(N, device=dev, generator=g) * 100
    hi = lo + torch.rand(N, device=dev, generator=g) * 30
    ql = torch.rand(Q, device=dev, generator=g) * 100
    qh = ql + torch.rand(Q, device=dev, generator=g) * 30
    ends = (lo, hi, ql, qh, iv.ANY_OVERLAP)
    # the warp-level tensor-core rate alone (csrc/mma_probe.cu): 4 blocks
    # of 8 warps an SM, each warp 8 * iters independent mma.sync
    lib = _build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, iters = 4 * sms, 256
    sink = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for kind, instr, ops_each, peak in (
            (0, "mma.sync.m16n8k8 tf32", 2048, PEAKS.tf32_flop_per_s),
            (1, "mma.sync.m16n8k32 s8", 8192, PEAKS.int8_op_per_s)):
        def probe():
            check(lib.mma_probe(kind, blocks, iters, sink.data_ptr(),
                                stream) == 0, "mma_probe failed to launch")
        ms = time_ms(probe, reps=5)
        rate = blocks * 8 * 8 * iters * ops_each / (ms / 1e3)
        emit({"phase": "scan_sweep", "kernel": "mma_probe",
              "instruction": instr, "ms": ms, "ops_per_s": rate,
              "frac_of_peak": rate / peak})
    # the output alone: a fill of the (Q, N) float32 matrix
    out = torch.empty((Q, N), device=dev)
    emit({"phase": "scan_sweep", "kernel": "fill_", "Q": Q, "N": N,
          "ms": time_ms(lambda: out.fill_(float("inf")), reps=10),
          "bound_ms": 4.0 * Q * N / PEAKS.hbm_bytes_per_s * 1e3,
          "bound_by": "bytes"})
    del out
    for d in (16, 32, 64, 128, 256):
        q = torch.randn(Q, d, device=dev, generator=g)
        c = torch.randn(N, d, device=dev, generator=g)
        codes = torch.randint(-127, 128, (N, d), device=dev, generator=g,
                              dtype=torch.int8)
        quant = (codes, torch.ones(d, device=dev), torch.zeros(d, device=dev),
                 torch.rand(N, device=dev, generator=g) * d)
        c16 = c.half()
        runs = [
            ("pairwise_l2_masked", lambda: ops.pairwise_l2_masked(
                q, c, *ends), c),
            ("pairwise_l2_masked_f16", lambda: ops.pairwise_l2_masked(
                q, c16, *ends), c16),
            ("pairwise_l2_int8", lambda: ops.pairwise_l2_int8(
                q, *quant, *ends), codes),
            ("fused_topk_l2", lambda: ops.fused_topk_l2(q, c, *ends, 10), c),
            ("fused_topk_l2_f16", lambda: ops.fused_topk_l2(
                q, c16, *ends, 10), c16)]
        for name, fn, corpus in runs:
            ms = time_ms(fn, reps=10)
            if name == "pairwise_l2_int8":
                bms, by = bound(ops.int8_scan_stream_bytes(Q, N, d),
                                2.0 * Q * N * d, PEAKS.int8_op_per_s)
            elif name.startswith("fused_topk_l2"):
                bms, by = bound(ops.fused_topk_stream_bytes(
                    Q, N, d, 10, corpus.element_size()),
                    tf32_passes(corpus) * 2.0 * Q * N * d,
                    PEAKS.tf32_flop_per_s)
            else:
                bms, by = bound(ops.pairwise_stream_bytes(
                    Q, N, d, corpus.element_size()),
                    tf32_passes(corpus) * 2.0 * Q * N * d,
                    PEAKS.tf32_flop_per_s)
            emit({"phase": "scan_sweep", "kernel": name, "Q": Q, "N": N,
                  "d": d, "ms": ms, "bound_ms": bms, "bound_by": by})
        del q, c, c16, codes, quant, runs
        torch.cuda.empty_cache()


def gathered_sweep(dev, Q: int, d: int, seed: int) -> None:
    """Time gathered_l2 and gathered_l2_dot on random float32 inputs at Q x
    d over S = 1, 88, 176, 512 and 2048, beside torch.bmm (the cross term
    alone) and torch.cdist (the unsquared distance) on the same inputs, and
    an empty kernel (``torch.cuda._sleep(0)``), what ``time_ms`` reads for a
    launch that does nothing. S = 1 shows the fixed cost of a launch; S =
    88 and 176 (11.5 and 23 MB at d = 128) stay in the 50 MB L2, S = 2048
    (268 MB) streams from device memory. One line per call and S (ms, GB/s,
    the share of the bound), then each call's split into a fixed cost (its
    S = 1 time), an L2 rate (the bytes S = 176 adds to S = 88 over the time
    it adds) and a device-memory rate (the same from S = 1 to 2048). No
    launch counts."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(Q, d, device=dev, generator=g)
    emit({"phase": "gathered_sweep", "kernel": "empty",
          "ms": time_ms(lambda: torch.cuda._sleep(0))})
    sizes = (1, 88, 176, 512, 2048)
    times = {}
    for S in sizes:
        cand = torch.randn(Q, S, d, device=dev, generator=g)
        nbytes = ops.gathered_l2_stream_bytes(Q, S, d)
        elems = Q * S * d
        runs = (("gathered_l2", lambda: ops.gathered_l2(q, cand), 3.0 * elems),
                ("gathered_l2_dot", lambda: ops.gathered_l2_dot(q, cand),
                 4.0 * elems + 2.0 * Q * d),
                ("torch.bmm", lambda: torch.bmm(cand, q[:, :, None]),
                 2.0 * elems),
                ("torch.cdist", lambda: torch.cdist(q[:, None, :], cand),
                 3.0 * elems))
        for name, fn, n_ops in runs:
            ms = time_ms(fn)
            bms, by = bound(nbytes, n_ops)
            times[name, S] = ms
            emit({"phase": "gathered_sweep", "kernel": name, "Q": Q, "S": S,
                  "d": d, "ms": ms, "gb_per_s": nbytes / ms / 1e6,
                  "bound_ms": bms, "bound_by": by, "frac_of_bound": bms / ms})
        del cand
        torch.cuda.empty_cache()

    def rate(name, s0, s1):
        added = (ops.gathered_l2_stream_bytes(Q, s1, d)
                 - ops.gathered_l2_stream_bytes(Q, s0, d))
        return added / (times[name, s1] - times[name, s0]) / 1e6
    for name in ("gathered_l2", "gathered_l2_dot", "torch.bmm",
                 "torch.cdist"):
        emit({"phase": "gathered_sweep_fit", "kernel": name,
              "fixed_ms": times[name, 1],
              "l2_gb_per_s": rate(name, 88, 176),
              "hbm_gb_per_s": rate(name, 1, 2048)})


# ---- phase 2: edge shapes ----------------------------------------------------

def kernel_edge_checks(dev, S_wide: int):
    import numpy as np
    import torch
    from repro_torch.core import intervals as iv
    from repro_torch.core.quant import QuantizedStore
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    cases = collections.Counter()       # cases checked, by ops entry point

    # pairwise scans (float32 and float16 corpus, int8 codes): ragged Q, N
    # and d, on both copy paths (d = 1, 17, 129: rows of no whole number of
    # 16-byte pieces; "misaligned": every operand starts one element past
    # 16 bytes), N past a multiple of the 128-row tile, Q past a multiple
    # of the 64-row block; every mask 0..63 at small N
    for (Q, N, d, case) in SCAN_EDGES:
        q = t(rng.normal(size=(Q, d)).astype(np.float32))
        c_np = rng.normal(size=(N, d)).astype(np.float32)
        c = t(c_np)
        c16 = c.half()
        st = QuantizedStore.from_vectors(c_np, "int8")
        i8 = [t(a) for a in (st.codes, st.scale, st.offset, st.sq_norm)]
        if case == "misaligned":
            q, c, c16 = (step_table(x, case) for x in (q, c, c16))
            i8[0] = step_table(i8[0], case)
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
                if row == "pairwise_l2_int8":      # integer sums: bit-equal
                    fin = torch.isfinite(want)
                    ok = ok and torch.equal(got[fin], want[fin])
                check(ok, f"{row} Q={Q} N={N} d={d} {case} mask={mask}: "
                          f"err={err}")
                worst = max(worst, err)
                cases[KERNELS[row][0]] += 1
            emit({"phase": "kernel_edges", "kernel": row, "Q": Q, "N": N,
                  "d": d, "case": case, "masks": len(masks),
                  "max_abs_err": worst})

    # gathered_l2 and gathered_l2_dot: GATHERED_EDGES over float32,
    # float16 and bfloat16 candidates
    for (Q, S, d, case) in GATHERED_EDGES:
        q_np, cv_np = gathered_edge_inputs(rng, Q, S, d, case)
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            q, cv = gathered_edge_tensors(q_np, cv_np, dtype, case, dev)
            for name in ("gathered_l2", "gathered_l2_dot"):
                err, ok = compare_dists(getattr(ops, name)(q, cv),
                                        getattr(ref, name + "_ref")(q, cv),
                                        RTOL[name])
                check(ok, f"{name} Q={Q} S={S} d={d} {dtype} {case}: "
                          f"err={err}")
                cases[name] += 1
                emit({"phase": "kernel_edges", "kernel": name, "Q": Q,
                      "S": S, "d": d, "dtype": str(dtype), "case": case,
                      "max_abs_err": err})

    cases["fused_topk_l2"] += fused_topk_edge_checks(dev, rng)

    # gathered_topk over a float32, int8 and float16 table: ragged Q,
    # NO_EDGE ids, all-masked rows, exact ties (duplicate table rows and
    # duplicate beam distances), M up to 8*S, an unsorted beam, every
    # candidate live at the widest step, beam entries tied exactly with
    # candidates, d with no whole number of 16-byte loads, and table views
    # that do not start on 16 bytes. The int8 codes reach +-127 (each
    # dimension's min and max).
    for (Q, n, d, M, L, case) in ((1, 3, 4, 1, 1, ""), (5, 50, 17, 12, 6, ""),
                                  (37, 2000, 128, 767, 64, ""),
                                  (256, 20000, 128, 8 * S_wide, 64, ""),
                                  (64, 2000, 128, 767, 64, "unsorted"),
                                  (64, 20000, 128, 8 * S_wide, 64,
                                   "all_live"),
                                  (16, 40, 8, 200, 64, "tie"),
                                  (37, 500, 1, 300, 16, ""),
                                  (37, 500, 129, 300, 64, ""),
                                  (37, 500, 17, 300, 16, "view"),
                                  (37, 500, 128, 300, 16, "misaligned")):
        q, table, step = step_case(rng, Q, n, d, M, L, case)
        step = tuple(t(a) for a in step)
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
            args = (t(q), step_table(tab[0], case), *tab[1:], *step)
            got = getattr(ops, name)(*args)
            want = getattr(ref, name + "_ref")(*args)
            err, bad = compare_beams(got, want, RTOL[name])
            if case == "tie" and row != "gathered_topk_quant_int8":
                # small integers: every distance is exact, so is every tie
                bad += int((got[0] != want[0]).sum())
            check(bad == 0, f"{row} Q={Q} n={n} d={d} M={M} L={L} {case}: "
                            f"err={err} mismatches={bad}")
            cases[name] += 1
            smem = (ops.gathered_topk_smem_bytes if len(tab) == 1
                    else ops.gathered_topk_quant_smem_bytes)(d, M, L)
            emit({"phase": "kernel_edges", "kernel": row, "Q": Q, "n": n,
                  "d": d, "M": M, "L": L, "case": case, "max_abs_err": err,
                  "mismatched_ids": bad, "smem_bytes": smem})
    torch.cuda.synchronize()
    return cases


def gathered_edge_inputs(rng, Q, S, d, case):
    """NumPy (queries, candidates) of one GATHERED_EDGES case; "nonfinite"
    puts an inf, a -inf and a NaN entry and one all-inf row among the
    candidates, each in another (query, slot) row."""
    import numpy as np
    q = rng.normal(size=(Q, d)).astype(np.float32)
    cv = rng.normal(size=(Q, S, d)).astype(np.float32)
    if case == "nonfinite":
        cv[0, 0, 0] = np.inf
        cv[Q // 2, S // 2] = np.inf
        cv[Q // 3, 0, d // 2] = -np.inf
        cv[Q - 1, S - 1, d - 1] = np.nan
    return q, cv


def gathered_edge_tensors(q_np, cv_np, dtype, case, dev):
    """A GATHERED_EDGES case on the card: candidates of ``dtype`` and a
    query of the same type where it is float16 (the wrapper widens it),
    else float32; "misaligned" and "qmisaligned" hand over the candidates
    or the float32 query one element past 16 bytes."""
    import torch
    cv = torch.as_tensor(cv_np).to(dev).to(dtype)
    q = torch.as_tensor(q_np).to(dev)
    if case == "qmisaligned":
        q = step_table(q, "misaligned")
    elif dtype == torch.float16:
        q = q.half()
    if case == "misaligned":
        cv = step_table(cv, case)
    return q, cv


def step_case(rng, Q, n, d, M, L, case):
    """(queries, table, step arrays) of one gathered_topk edge case, all
    NumPy. ``case``: "unsorted" shuffles each beam row; "all_live" makes
    every candidate pass the mask; "tie" takes small integer vectors, so
    every distance is exact and beam entries tie exactly with candidates of
    the same id; "view" gives the table one extra leading row (see
    :func:`step_table`)."""
    import numpy as np
    if case == "tie":
        table = rng.integers(-2, 3, (n, d)).astype(np.float32)
        q = rng.integers(-2, 3, (Q, d)).astype(np.float32)
    else:
        table = rng.normal(size=(n, d)).astype(np.float32)
        table[1::2] = table[0::2][: len(table[1::2])]        # exact ties
        q = rng.normal(size=(Q, d)).astype(np.float32)
    ids = rng.integers(-1, n, (Q, M)).astype(np.int32)
    avail = (rng.random((Q, M)) < 0.7)
    b = rng.integers(0, 40, (Q, M)).astype(np.int32)
    e = b + rng.integers(0, 40, (Q, M)).astype(np.int32)
    ver = rng.integers(0, 70, Q).astype(np.int32)
    if case in ("all_live", "tie"):
        ids = rng.integers(0, n, (Q, M)).astype(np.int32)
        avail[:] = True
        b[:] = 0
        e[:] = 100
    else:
        avail[Q // 2] = False                                  # all masked
    pool_d = np.sort(rng.random((Q, L)).astype(np.float32), axis=1)
    pool_d[:, 1::3] = pool_d[:, 0::3][:, : pool_d[:, 1::3].shape[1]]
    pool_d = np.sort(pool_d, axis=1)
    pool_ids = rng.integers(0, n, (Q, L)).astype(np.int32)
    if case == "tie":
        diff = table[pool_ids].astype(np.float64) - q[:, None, :]
        pool_d = (diff * diff).sum(-1).astype(np.float32)
    tail = rng.integers(0, L + 1, Q)
    for qi in range(Q):
        pool_d[qi, tail[qi]:] = np.inf
        pool_ids[qi, tail[qi]:] = -1
        if case in ("unsorted", "tie"):
            perm = rng.permutation(L)
            pool_d[qi], pool_ids[qi] = pool_d[qi, perm], pool_ids[qi, perm]
    pool_exp = (rng.random((Q, L)) < 0.5) & np.isfinite(pool_d)
    if case == "view":
        table = np.concatenate([rng.normal(size=(1, d)).astype(np.float32),
                                table])
    return q, table, (ids, avail, b, e, ver, pool_ids, pool_d, pool_exp)


def step_table(table, case):
    """The table (or code table) of a :func:`step_case` as the kernel gets
    it: ``table[1:]`` for "view"; for "misaligned" a contiguous copy whose
    data starts one element past a 16-byte boundary."""
    import torch
    if case == "view":
        return table[1:]
    if case == "misaligned":
        buf = torch.empty(table.numel() + 1, dtype=table.dtype,
                          device=table.device)
        buf[1:] = table.flatten()
        table = buf[1:].view(table.shape)
        check(table.data_ptr() % 16 != 0, "misaligned table is aligned")
    return table


def fused_edge_inputs(case, Q, N, d, seed):
    """NumPy inputs (q, c, lo, hi, ql, qh) of fused_topk_l2's filtered
    epilogue's edge cases: "falling": every query's distance falls strictly
    as the id grows (integer coordinates, exact in any order), so every
    entry beats its row's k-th entry and the row's queue overflows in every
    tile; "ties": identical integer rows, every distance of a query tied
    across tiles and splits; "sel0" / "sel1": no row / every row qualifies;
    "nan": NaN endpoints on a tenth of the rows (lo, hi or both) and on a
    few queries."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 50, N).astype(np.float32)
    hi = lo + rng.integers(0, 20, N).astype(np.float32)
    ql = rng.integers(0, 50, Q).astype(np.float32)
    qh = ql + rng.integers(0, 20, Q).astype(np.float32)
    q = rng.normal(size=(Q, d)).astype(np.float32)
    c = rng.normal(size=(N, d)).astype(np.float32)
    if case == "falling":
        n = np.arange(N)
        c = np.zeros((N, d), np.float32)
        c[:, 0], c[:, 1] = n // 64, n % 64
        q = np.zeros((Q, d), np.float32)
        q[:, 0] = 2400 + N // 64 + np.arange(Q) % 7
        q[:, 1] = 64 + np.arange(Q) % 5
    elif case == "ties":
        c = np.repeat(rng.integers(-3, 4, (1, d)), N, 0).astype(np.float32)
        q = rng.integers(-3, 4, (Q, d)).astype(np.float32)
    elif case == "sel0":
        ql[:], qh[:] = -100, -90
    elif case == "nan":
        nan = rng.random(N) < 0.1
        lo[nan & (rng.random(N) < 0.5)] = np.nan
        hi[nan & (rng.random(N) < 0.5)] = np.nan
        ql[::37] = np.nan
    if case in ("falling", "sel1"):
        lo[:], hi[:], ql[:], qh[:] = 0, 100, 10, 20
    return q, c, lo, hi, ql, qh


def fused_topk_edge_checks(dev, rng) -> int:
    """fused_topk_l2 over a float32 and a float16 corpus against its plain
    version: ragged Q and N, d = 1 and 17, k = 1, 32 and k > N, NaN-padded
    rows, an all-masked query, every mask at small N; duplicate rows across
    tiles and splits (ties to the lowest id); the filtered epilogue's cases
    (:func:`fused_edge_inputs`) at k = 1, 10 and 32; k beyond the limit
    refused."""
    import numpy as np
    import torch
    from repro_torch.core import intervals as iv
    from repro_torch.kernels import ops, ref
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    cases = 0
    for (Q, N, d, k, case) in ((1, 1, 1, 1, ""), (3, 5, 8, 10, ""),
                               (67, 1000, 17, 32, ""),
                               (130, 4099, 128, 10, ""),
                               (256, 20000, 128, 1, ""),
                               (256, 3001, 64, 10, ""),
                               (300, 2055, 129, 7, ""),
                               (1, 777, 256, 32, ""),
                               (67, 1000, 128, 10, "misaligned")):
        q = t(rng.normal(size=(Q, d)).astype(np.float32))
        c = t(rng.normal(size=(N, d)).astype(np.float32))
        c16 = c.half()
        if case == "misaligned":
            q, c, c16 = (step_table(x, case) for x in (q, c, c16))
        lo_np = rng.integers(0, 50, N).astype(np.float32)
        hi_np = lo_np + rng.integers(0, 20, N).astype(np.float32)
        if N > 3:                                   # NaN-padded rows
            lo_np[-2:] = hi_np[-2:] = np.nan
        ql_np = rng.integers(0, 50, Q).astype(np.float32)
        qh_np = ql_np + rng.integers(0, 20, Q).astype(np.float32)
        if Q > 1:                                   # an all-masked query
            ql_np[Q // 2] = qh_np[Q // 2] = np.nan
        rest = [t(a) for a in (lo_np, hi_np, ql_np, qh_np)]
        masks = range(64) if N <= 1000 else (iv.ANY_OVERLAP,
                                             iv.QUERY_CONTAINED,
                                             iv.BEFORE | iv.AFTER)
        for row, corpus in (("fused_topk_l2", c), ("fused_topk_l2_f16",
                                                   c16)):
            worst = 0.0
            for mask in masks:
                args = (q, corpus, *rest, mask, k)
                err, b = compare_beams(ops.fused_topk_l2(*args),
                                       ref.fused_topk_l2_ref(*args),
                                       RTOL["fused_topk_l2"])
                check(b == 0, f"{row} Q={Q} N={N} d={d} k={k} {case} "
                              f"mask={mask}: err={err} mismatches={b}")
                worst = max(worst, err)
                cases += 1
            emit({"phase": "kernel_edges", "kernel": row, "Q": Q, "N": N,
                  "d": d, "k": k, "case": case, "masks": len(masks),
                  "max_abs_err": worst})
    # duplicate rows 3, 5 (one tile) and 600, 4100 (later tiles and splits)
    Q, N, d = 4, 5000, 128
    c = rng.normal(size=(N, d)).astype(np.float32)
    c[[5, 600, 4100]] = c[3]
    q = rng.normal(size=(Q, d)).astype(np.float32)
    q[0] = c[3]
    lo = np.zeros(N, np.float32)
    hi = np.full(N, 100, np.float32)
    ql = np.full(Q, 10, np.float32)
    qh = np.full(Q, 20, np.float32)
    for corpus in (t(c), t(c).half()):
        args = (t(q), corpus, *map(t, (lo, hi, ql, qh)), iv.ANY_OVERLAP, 6)
        ids, dists = ops.fused_topk_l2(*args)
        got = ids[0, :4].tolist()
        check(got == [3, 5, 600, 4100], f"fused_topk_l2 duplicate rows "
                                        f"came out as {got}")
        err, b = compare_beams((ids, dists), ref.fused_topk_l2_ref(*args),
                               RTOL["fused_topk_l2"])
        check(b == 0, f"fused_topk_l2 duplicates: err={err} mismatches={b}")
        cases += 1
    emit({"phase": "kernel_edges", "kernel": "fused_topk_l2", "Q": Q, "N": N,
          "d": d, "duplicates": got})
    # the filtered epilogue: four query blocks, a split every few tiles, N
    # no multiple of the tile; exact distances where the case makes them so
    Q, N, d = 256, 20077, 64
    for case in ("falling", "ties", "sel0", "sel1", "nan"):
        base = [t(a) for a in fused_edge_inputs(case, Q, N, d, seed=11)]
        for row, dtype in (("fused_topk_l2", torch.float32),
                           ("fused_topk_l2_f16", torch.float16)):
            fargs = [base[0], base[1].to(dtype), *base[2:], iv.ANY_OVERLAP]
            worst, bad = 0.0, 0
            for k in (1, 10, 32):
                want = ref.fused_topk_l2_ref(*fargs, k)
                got = ops.fused_topk_l2(*fargs, k)
                err, b = compare_beams(got, want, RTOL["fused_topk_l2"])
                if case in ("falling", "ties", "sel0"):
                    b += int((got[0] != want[0]).sum()
                             + (got[1] != want[1]).sum())
                if case == "falling":
                    top = torch.arange(N - 1, N - 1 - k, -1, device=dev)
                    b += int((got[0] != top[None, :]).sum())
                worst, bad = max(worst, err), bad + b
                cases += 1
            emit({"phase": "kernel_edges", "kernel": row, "Q": Q, "N": N,
                  "d": d, "case": case, "k": [1, 10, 32],
                  "max_abs_err": worst, "mismatches": bad})
            check(bad == 0, f"{row} {case}: {bad} mismatches against the "
                            f"plain version (err={worst})")
    try:
        ops.fused_topk_l2(*args[:-1], ops.FUSED_TOPK_MAX_K + 1)
        refused = False
    except ValueError as e:
        refused = str(ops.FUSED_TOPK_MAX_K) in str(e)
    check(refused, "fused_topk_l2 did not refuse k beyond its limit")
    torch.cuda.synchronize()
    return cases + 1


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


def port_kernel_names() -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for fname in os.listdir(os.path.join(ROOT, CSRC)):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(ROOT, CSRC, fname)) as f:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(", f.read()))
    return names


def profile_request(eng, req) -> dict:
    """:func:`profile_call` of one ``eng.execute(req)``."""
    return profile_call(lambda: eng.execute(req))


def profile_call(fn) -> dict:
    """Device busy share of one warm call of ``fn``, from a torch.profiler
    trace: the union of CUDA kernel intervals over the host's wall time,
    device time by kernel name (the top eight), and the device time of
    each of the port's own kernels (:func:`port_kernel_names`), ranked or
    not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
            "top_device_ms": {name[:60]: us / 1e3 for name, us in top},
            "port_kernel_ms": port_kernel_ms(by_name)}


def port_kernel_ms(by_name: dict) -> dict:
    """Device ms of each of the port's kernels (:func:`port_kernel_names`)
    from device µs by profiler kernel name."""
    names = port_kernel_names()
    ours: dict = {}
    for name, us in by_name.items():
        base = re.split(r"[<(]", name.split("(anonymous namespace)::")[-1])[0]
        if base in names:
            ours[base] = ours.get(base, 0.0) + us / 1e3
    return ours


def device_split(fn) -> dict:
    """:func:`port_kernel_ms` of one warm call of ``fn``, from a
    torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0) + e.time_range.end
                               - e.time_range.start)
    return port_kernel_ms(by_name)


def wavefront_steps(trace) -> int:
    return sum(int(sp.args.get("steps", 0)) for sp, _ in trace.walk()
               if sp.name == "wavefront_totals")


def descendants(sp):
    stack = list(sp.children)
    while stack:
        ch = stack.pop()
        yield ch
        stack.extend(ch.children)


def trace_phase(eng, ds, qlo, qhi, k, fused_args, fused16_args, dot_args,
                steps, rows):
    """The traced kernel path: the kernel layer's entry points under
    ``obs.capture()`` (this slice's own path: launch counts are set to 0
    just before and read just after), a traced graph request against an
    untraced one, and one flat request under ``obs.profiler_capture``."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import ANY_OVERLAP, SearchRequest
    from repro_torch.kernels import ops

    # row of the {"kernels": [...]} line -> its call; each is one root span
    calls = {"fused_topk_l2": fused_args, "fused_topk_l2_f16": fused16_args,
             "gathered_l2_dot": dot_args}
    untraced = {row: getattr(ops, KERNELS[row][0])(*args)
                for row, args in calls.items()}
    torch.cuda.synchronize()
    ops.reset_launches()
    with obs.capture() as tracer:
        traced = {row: getattr(ops, KERNELS[row][0])(*args)
                  for row, args in calls.items()}
    launches = dict(ops.LAUNCHES)
    roots = tracer.trace().roots
    check(len(roots) == len(calls), f"{len(roots)} root spans for "
                                    f"{len(calls)} kernel calls")
    fracs = {}
    for row, sp in zip(calls, roots):
        name = KERNELS[row][0]
        check(sp.name == f"kernel:{name}", f"root span {sp.name} for {row}")
        frac = sp.args.get("frac_of_peak")
        fracs[row] = frac
        check(sp.args.get("impl") == "cuda", f"kernel:{name} impl is "
                                             f"{sp.args.get('impl')}")
        check(frac is not None and 0.0 < frac <= 1.05,
              f"kernel:{name} frac_of_peak {frac} outside (0, 1.05]")
        got, want = traced[row], untraced[row]
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"traced {row} returned another result than untraced")
        check(launches[row] == 1, f"{row}: {launches[row]} launches on "
                                  f"its traced path, expected 1")
        if row in rows:
            rows[row]["launches"] = launches[row]

    # one traced graph request against an untraced one, in turns
    def graph_req(trace):
        return SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k, ef=64,
                             route="graph", trace=trace)
    t_sec, u_sec = [], []
    for _ in range(3):
        ures, sec = timed_execute(eng, graph_req(False), reps=1)
        u_sec.append(sec)
        tres, sec = timed_execute(eng, graph_req(True), reps=1)
        t_sec.append(sec)
    check(bool(np.array_equal(tres.ids, ures.ids)
               and np.array_equal(tres.dists, ures.dists)),
          "a traced graph request returned other ids or dists")
    slots = [sp for sp, _ in tres.trace.walk() if sp.name == "slot"]
    under = [ch for sp in slots for ch in descendants(sp)
             if ch.name == "kernel:gathered_topk"]
    kernel_spans = [sp for sp, _ in tres.trace.walk()
                    if sp.name.startswith("kernel:")]
    t_steps = wavefront_steps(tres.trace)
    check(len(slots) > 0 and len(under) > 0,
          "no kernel:gathered_topk span under the slot spans")
    check(t_steps == steps, f"traced request ran {t_steps} steps, the "
                            f"graph phase {steps}")
    fr = [sp.args["frac_of_peak"] for sp in kernel_spans
          if sp.args.get("frac_of_peak") is not None]

    # one flat request under the profiler
    prof_dir = os.path.join(ROOT, "build", "profile")
    flat_req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k,
                             route="flat")
    with obs.profiler_capture(prof_dir) as pcap:
        eng.execute(flat_req)
    device_events = 0
    if pcap.ok and os.path.isfile(pcap.path):
        with open(pcap.path) as f:
            events = json.load(f).get("traceEvents", [])
        device_events = sum(1 for e in events if e.get("cat") == "kernel")
    emit({"phase": "trace", "kernel_frac_of_peak": fracs,
          "path_launches": {row: launches[row] for row in calls},
          "graph_spans": len(tres.trace), "graph_kernel_spans":
          len(kernel_spans), "gathered_topk_spans_under_slots": len(under),
          "max_frac_of_peak": max(fr) if fr else None, "steps": t_steps,
          "traced_request_ms": statistics.median(t_sec) * 1e3,
          "untraced_request_ms": statistics.median(u_sec) * 1e3,
          "traced_overhead": statistics.median(t_sec)
          / statistics.median(u_sec) - 1.0,
          "profiler_ok": pcap.ok, "profiler_error": pcap.error,
          "profiler_trace": pcap.path,
          "profiler_device_events": device_events})
    check(pcap.ok and os.path.isfile(pcap.path),
          f"profiler_capture failed: {pcap.error}")


# ---- streaming and sharded serving -------------------------------------------

def launched(counts: dict) -> dict:
    """The kernels of a launch count that ran."""
    return {name: n for name, n in counts.items() if n}


def segment_steps(trace) -> dict:
    """Wavefront steps of a traced SegmentedIndex request, by segment."""
    out = {}
    for root in trace.roots:
        for sp in descendants(root):
            if sp.name.startswith("segment-"):
                out[sp.name[len("segment-"):]] = sum(
                    int(ch.args.get("steps", 0)) for ch in descendants(sp)
                    if ch.name == "wavefront_totals")
    return out


def streaming_corpus(ds, n_rows: int, deleted, moved, new_rows):
    """The live rows the streaming phase's op sequence leaves, by external
    id: rows ``0 .. n_rows`` of ``ds`` less ``deleted``, the ``moved`` ids
    holding the vectors and ranges of rows ``new_rows``. Returns (the
    external ids, ascending; a RangeDataset of their rows with ``ds``'s
    queries)."""
    import numpy as np
    from repro_torch.data import RangeDataset
    vecs = ds.vectors[:n_rows].copy()
    lo, hi = ds.lo[:n_rows].copy(), ds.hi[:n_rows].copy()
    vecs[moved] = ds.vectors[new_rows]
    lo[moved], hi[moved] = ds.lo[new_rows], ds.hi[new_rows]
    alive = np.ones(n_rows, bool)
    alive[deleted] = False
    ext = np.flatnonzero(alive)
    return ext, RangeDataset(vectors=vecs[ext], lo=lo[ext], hi=hi[ext],
                             queries=ds.queries, span=ds.span)


def streaming_phase(dev, args, Qn: int, k: int) -> dict:
    """The streaming path (``repro_torch.streaming``): segments A (20k
    rows), B and C (10k each) and a 16k-row delta on the card, 1,000
    tombstones in A and 500 rows of B upserted into the delta; every route
    checked; then a size-tiered compaction. Sizes scale with
    ``--stream-n`` (70,000 gives these). Returns the index, its pruned
    request and that request's ids after the compaction."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core import (ANY_OVERLAP, IndexSpec, Overlaps,
                                  SearchRequest)
    from repro_torch.data import make_range_dataset, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.streaming import CompactionPolicy, SegmentedIndex

    scale = args.stream_n / 70_000
    n_a, n_b = round(20_000 * scale), round(10_000 * scale)
    n_delta = round(16_000 * scale)
    n_del, n_up = round(1_000 * scale), round(500 * scale)
    ds = make_range_dataset(n=args.stream_n, d=128, n_queries=Qn,
                            quantize=1024, seed=args.seed)
    spec = IndexSpec(predicate=Overlaps(), m=16, ef_con=64,
                     candidate_stage="coarse")
    sidx = SegmentedIndex(spec, policy=CompactionPolicy(tier_ratio=1.5),
                          build_workers=args.workers, device=dev)
    rng = np.random.default_rng(args.seed + 7)
    build_s = {}
    bounds = np.cumsum([0, n_a, n_b, n_b])
    for name, a, b in zip("ABC", bounds[:-1], bounds[1:]):
        sidx.add(np.arange(a, b), ds.vectors[a:b], ds.lo[a:b], ds.hi[a:b])
        t0 = time.perf_counter()
        sidx.flush()
        build_s[name] = time.perf_counter() - t0
    seg_b, seg_c = sidx.segments[1].seg_id, sidx.segments[2].seg_id
    n_rows = int(bounds[-1]) + n_delta
    tail = slice(int(bounds[-1]), n_rows)
    sidx.add(np.arange(bounds[-1], n_rows), ds.vectors[tail], ds.lo[tail],
             ds.hi[tail])
    deleted = rng.choice(n_a, n_del, replace=False)
    sidx.delete(deleted)
    moved = rng.choice(np.arange(bounds[1], bounds[2]), n_up, replace=False)
    new_rows = np.arange(n_rows, n_rows + n_up)
    sidx.add(moved, ds.vectors[new_rows], ds.lo[new_rows], ds.hi[new_rows])
    ext, live = streaming_corpus(ds, n_rows, deleted, moved, new_rows)
    emit({"phase": "streaming_build", "n_live": len(sidx),
          "segments": [{"id": s.seg_id, "n": s.n, "tombstones": len(s.tombs)}
                       for s in sidx.segments],
          "delta": len(sidx.delta), "delta_capacity": sidx.delta._cap,
          "workers": args.workers, "flush_build_s": build_s,
          "ops": dict(sidx.ops)})
    check(len(sidx) == ext.size, f"streaming: {len(sidx)} live rows, the "
                                 f"op sequence leaves {ext.size}")
    qlo, qhi = subset_queries(live, ANY_OVERLAP, 0.10, seed=args.seed + 1)
    F = 4     # the CUDA default fanout, pinned so the CPU run takes it too

    def request(route, rows=slice(None), trace=False):
        return SearchRequest(ds.queries[rows], (qlo[rows], qhi[rows]),
                             ANY_OVERLAP, k=k, ef=64, route=route, fanout=F,
                             trace=trace)

    res, ms, launches = {}, {}, {}
    for route in ("flat", "pruned", "auto", "graph"):
        sidx.execute(request(route))           # stage the segments
        torch.cuda.synchronize()
        ops.reset_launches()
        with Capture(ops, "gathered_topk", lambda *a: a[-2].shape[1]) as ct, \
                Capture(ops, "gathered_l2", lambda q, c: c.shape[1]) as cl, \
                Capture(ops, "pairwise_l2_masked",
                        lambda q, c, *a: c.shape[0]) as cp:
            res[route] = sidx.execute(request(route, trace=route == "graph"))
        launches[route] = launched(ops.LAUNCHES)
        _, sec = timed_execute(sidx, request(route),
                               reps=1 if route == "graph" else 3)
        ms[route] = sec * 1e3
        # each kernel at its widest call on this path: the graph route's
        # beam over A's tombstones, the delta's scan
        for cap in ((ct, cl) if route == "graph"
                    else (cp,) if route == "flat" else ()):
            measure_kernel(cap.name, cap.best,
                           launches[route].get(cap.name, 0),
                           phase="streaming_kernel")
        del ct, cl, cp
    g = launches["graph"]
    check(g.get("gathered_topk", 0) > 0 and g.get("gathered_l2", 0) > 0
          and g.get("pairwise_l2_masked") == 1,
          f"streaming graph request: expected kernels 1 and 3 and one delta "
          f"scan, got {g}")
    check(launches["flat"] == {"pairwise_l2_masked": len(sidx.segments) + 1},
          f"streaming flat request: {launches['flat']} for "
          f"{len(sidx.segments)} segments and the delta")

    # the exact routes against float64 over the live rows, by external id
    bf_ids, bf_d = brute_force64(live, qlo, qhi, ANY_OVERLAP, k,
                                 list(range(Qn)))
    bf_ext = np.where(bf_ids >= 0, ext[np.clip(bf_ids, 0, None)], -1)
    fl_ids, fl_d = res["flat"].ids, res["flat"].dists
    pr_ids, pr_d = res["pruned"].ids, res["pruned"].dists
    fin = np.isfinite(bf_d)
    rel = np.abs(fl_d[fin] - bf_d[fin]) / np.maximum(bf_d[fin], 1e-30)
    flat_agree = agreement(fl_ids, fl_d.astype(np.float64), bf_ext, bf_d,
                           1e-4)
    pruned_recall = recall_at_k(pr_ids, fl_ids)
    pruned_ties = misses_are_ties(pr_ids, pr_d, fl_ids, fl_d, 1e-4)

    # the graph route against the port's CPU run of the same index
    n_cpu = 32
    cpu = SegmentedIndex(spec, device="cpu")
    cpu.segments, cpu.delta = sidx.segments, sidx.delta
    before_cpu = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    cres = cpu.execute(request("graph", slice(0, n_cpu)))
    cpu_s = time.perf_counter() - t0
    check(ops.LAUNCHES == before_cpu, "the CPU run launched a kernel")
    gr = res["graph"]
    graph_agree = agreement(gr.ids[:n_cpu], gr.dists[:n_cpu], cres.ids,
                            cres.dists, 1e-5)
    emit({"phase": "streaming", "n_live": len(sidx), "Q": Qn, "k": k,
          "fanout": F, "request_ms": ms, "launches": launches,
          "segment_routes": {r: [(s.segment, s.route, s.k_fetched)
                                 for s in res[r].report.segments]
                             for r in res},
          "graph_steps_by_segment": segment_steps(gr.trace),
          "flat_id_agreement_vs_f64": flat_agree,
          "flat_max_rel_err_vs_f64": float(rel.max()),
          "pruned_recall_vs_flat": pruned_recall,
          "pruned_ties_only": bool(pruned_ties),
          "graph_cpu_agreement": graph_agree, "graph_cpu_queries": n_cpu,
          "graph_cpu_request_s": cpu_s,
          "graph_recall_vs_flat": recall_at_k(gr.ids, fl_ids),
          "auto_recall_vs_flat": recall_at_k(res["auto"].ids, fl_ids)})
    check(bool(np.all(np.isfinite(fl_d) == fin)),
          "streaming flat: +inf pattern differs from the brute force")
    check(float(rel.max()) <= 1e-4, f"streaming flat: dists off by "
                                    f"{rel.max()}")
    check(flat_agree == 1.0, f"streaming flat: ids disagree with float64 "
                             f"({flat_agree})")
    check(pruned_recall == 1.0 or bool(pruned_ties),
          f"streaming pruned recall {pruned_recall} < 1.0")
    check(graph_agree >= 0.99, f"streaming graph: GPU/CPU agreement "
                               f"{graph_agree} < 0.99")
    check(bool(np.all(np.isfinite(gr.dists) | (gr.ids < 0))),
          "streaming graph: a returned id has a non-finite distance")
    del cpu, cres, res, gr

    # size-tiered compaction: the policy merges B and C and their engines,
    # with every route's arrays staged, go
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rep = sidx.compact()
    compact_s = time.perf_counter() - t0
    gc.collect()
    mem_compacted = torch.cuda.memory_allocated()
    after = {r: sidx.execute(request(r)) for r in ("flat", "pruned")}
    torch.cuda.synchronize()
    mem_served = torch.cuda.memory_allocated()
    # ids may differ only where two distances are exactly equal
    same = {r: agreement(after[r].ids, after[r].dists, ids, d, 0.0)
            for r, ids, d in (("flat", fl_ids, fl_d),
                              ("pruned", pr_ids, pr_d))}
    emit({"phase": "streaming_compact", "policy_picked": rep["merged"],
          "new_segment": rep["new_segment"], "rows": rep["rows"],
          "dropped": rep["dropped"], "compact_s": compact_s,
          "segments": [{"id": s.seg_id, "n": s.n, "tombstones": len(s.tombs)}
                       for s in sidx.segments],
          "allocated_before": mem_before,
          "allocated_after_compact": mem_compacted,
          "allocated_after_exact_routes": mem_served,
          "exact_id_agreement_across_compact": same,
          "exact_ids_bit_equal": {r: bool(np.array_equal(
              after[r].ids, fl_ids if r == "flat" else pr_ids))
              for r in after}})
    check(set(rep["merged"]) == {seg_b, seg_c},
          f"compaction picked {rep['merged']}, expected B and C "
          f"({seg_b}, {seg_c})")
    check(all(v == 1.0 for v in same.values()),
          f"exact routes' ids changed across the compaction: {same}")
    check(mem_compacted < mem_before and mem_served < mem_before,
          f"allocated bytes did not fall across the compaction: "
          f"{mem_before} -> {mem_compacted} -> {mem_served}")
    return {"index": sidx, "request": request("pruned"),
            "pruned_ids": after["pruned"].ids, "ds": ds,
            "free_row": int(new_rows[-1]) + 1}


def sharded_phase(dev, ds, qlo, qhi, k: int, flat_ids, flat_ms: float,
                  stream: dict):
    """Sharded serving (``repro_torch.distributed``) on the one card: the
    flat phase's corpus as ``ShardedDeployment.flat`` over D = 4 logical
    shards under each merge schedule, a lost shard, a narrow fan-in, and
    the streaming phase's index dealt onto D = 2 shards. Returns the last
    D = 4 deployment (the host merge), for the serving phase."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core import ANY_OVERLAP, SearchRequest, flat_search
    from repro_torch.data import recall_at_k
    from repro_torch.distributed import DeploymentSpec, ShardedDeployment
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh

    D = 4
    mesh = make_mesh((D,), ("data",), device=dev)
    req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k)

    def served(dep, reps=5):
        """One counted request after a warm one; then the timed ones."""
        dep.execute(req)
        torch.cuda.synchronize()
        ops.reset_launches()
        out = dep.execute(req)
        launches = launched(ops.LAUNCHES)
        _, sec = timed_execute(dep, req, reps=reps)
        return out, launches, sec * 1e3

    out, ms, launches, stage_s = {}, {}, {}, {}
    for merge in ("all_gather", "tournament", "host"):
        t0 = time.perf_counter()
        dep = ShardedDeployment.flat(ds.vectors, ds.lo, ds.hi, mesh=mesh,
                                     spec=DeploymentSpec(n_shards=D,
                                                         merge=merge))
        stage_s[merge] = time.perf_counter() - t0
        out[merge], launches[merge], ms[merge] = served(dep)
        check(out[merge].report.merge == merge,
              f"sharded: asked for {merge}, ran {out[merge].report.merge}")
        check(launches[merge] == {"pairwise_l2_masked": D},
              f"sharded {merge}: expected {D} pairwise_l2_masked launches, "
              f"got {launches[merge]}")
    a = out["all_gather"]
    schedules_equal = all(np.array_equal(o.ids, a.ids)
                          and np.array_equal(o.dists, a.dists)
                          for o in out.values())
    equal_flat = bool(np.array_equal(a.ids, flat_ids))

    # shard 3 lost: the answer over the other three shards' rows
    dep.fail(D - 1)
    ops.reset_launches()
    lost = dep.execute(req)
    lost_launches = launched(ops.LAUNCHES)
    dep.restore(D - 1)
    corpus, lo, hi = dep._flat
    keep = (D - 1) * (ds.n // D)
    want, _ = flat_search(corpus[:keep], lo[:keep], hi[:keep],
                          *dep._query_tensors(req), mask=ANY_OVERLAP, k=k)
    lost_equal = bool(np.array_equal(lost.ids, want.cpu().numpy()))
    del corpus, lo, hi
    gc.collect()

    narrow = ShardedDeployment.flat(ds.vectors, ds.lo, ds.hi, mesh=mesh,
                                    spec=DeploymentSpec(n_shards=D,
                                                        per_shard_k=5))
    nres, nlaunches, nms = served(narrow)
    del narrow
    gc.collect()

    # the views share the source's segment engines: serving them stages
    # nothing more on the card
    torch.cuda.synchronize()
    seg_mem0 = torch.cuda.memory_allocated()
    seg = ShardedDeployment.from_segmented(
        stream["index"], mesh=make_mesh((2,), ("data",), device=dev),
        spec=DeploymentSpec(n_shards=2))
    sreq = stream["request"]
    seg.execute(sreq)
    torch.cuda.synchronize()
    ops.reset_launches()
    sres = seg.execute(sreq)
    slaunches = launched(ops.LAUNCHES)
    _, ssec = timed_execute(seg, sreq, reps=3)
    torch.cuda.synchronize()
    seg_mem1 = torch.cuda.memory_allocated()
    seg_equal = bool(np.array_equal(sres.ids, stream["pruned_ids"]))
    shared = all(s.engine._engines is stream["index"]._engines
                 for s in seg.shards)
    emit({"phase": "sharded", "n": ds.n, "shards": D, "Q": len(req), "k": k,
          "request_ms": ms, "flat_route_request_ms": flat_ms,
          "stage_s": stage_s, "launches": launches,
          "schedules_bit_equal": schedules_equal,
          "ids_equal_flat_route": equal_flat,
          "lost_shard": {"missing_shards": list(lost.report.missing_shards),
                         "degraded": lost.degraded,
                         "launches": lost_launches,
                         "ids_equal_flat_over_rest": lost_equal},
          "per_shard_k5": {"recall_vs_flat": recall_at_k(nres.ids, flat_ids),
                           "merge": nres.report.merge,
                           "request_ms": nms, "launches": nlaunches},
          "from_segmented": {"shards": 2, "route": "pruned",
                             "merge": sres.report.merge,
                             "shard_n": [s.n for s in seg.shards],
                             "request_ms": ssec * 1e3,
                             "launches": slaunches,
                             "ids_equal_segmented": seg_equal,
                             "engines_shared": shared,
                             "allocated_before": seg_mem0,
                             "allocated_after_served": seg_mem1}})
    check(schedules_equal, "sharded: the merge schedules disagree")
    check(equal_flat, "sharded: ids differ from the single-device flat route")
    check(lost.report.missing_shards == (D - 1,) and lost.degraded,
          f"sharded: lost shard reported as {lost.report.missing_shards}")
    check(lost_launches == {"pairwise_l2_masked": D - 1},
          f"sharded: a lost shard was scanned ({lost_launches})")
    check(lost_equal, "sharded: the degraded answer differs from the flat "
                      "route over the live shards' rows")
    check(seg_equal, "sharded from_segmented: ids differ from the "
                     "SegmentedIndex's own pruned answer")
    check(shared and seg_mem1 - seg_mem0 < 64 << 20,
          f"sharded from_segmented: the views staged segments again "
          f"(engines shared: {shared}; allocated {seg_mem0} -> {seg_mem1})")
    return dep


# ---- serving front ends -------------------------------------------------------

def serving_snapshot(srv, wall_s: float, n: int) -> dict:
    """Wall time, QPS and the server's latency percentiles (host clock)."""
    snap = srv.snapshot()
    out = {"wall_s": wall_s, "qps": n / wall_s,
           "e2e_ms": {p: snap["e2e_ms"][p] for p in ("p50", "p99")},
           "queue_wait_ms": {p: snap["queue_wait_ms"][p]
                             for p in ("p50", "p99")},
           "server_steps": snap["steps"], "served": snap["served"],
           "degraded": snap["degraded"], "shed_total": snap["shed_total"]}
    for key in ("batch_occupancy", "refill_efficiency", "refills",
                "refilled_rows", "chunks"):
        if key in snap:
            out[key] = snap[key]
    return out


def serve_waves(srv, ds, qlo, qhi, mask, waves: int, steps_between: int):
    """Submit the queries in ``waves`` equal waves with server steps in
    between (later waves are admitted mid-flight), then drain. Returns
    (outcome per query, wall seconds, tickets)."""
    import numpy as np
    import torch
    Q = len(qlo)
    per = -(-Q // waves)
    tickets = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(waves):
        for i in range(w * per, min(Q, (w + 1) * per)):
            tickets[srv.submit(i, qlo[i], qhi[i], mask)] = i
        for _ in range(steps_between):
            srv.step()
    res = srv.run_until_idle(max_steps=10_000)
    wall = time.perf_counter() - t0
    check(set(res) == set(tickets), f"serving: {len(res)} outcomes for "
                                    f"{len(tickets)} submissions")
    out = [None] * Q
    for t, i in tickets.items():
        check(bool(res[t]), f"serving: query {i} was shed ({res[t]})")
        out[i] = res[t]
    return out, wall


def serving_backends(stream: dict, dep, ds, qlo, qhi, k: int) -> None:
    """The serving front ends over the mutable and the sharded backend:
    ``RetrievalServer`` on the streaming phase's ``SegmentedIndex``
    (upserts, deletes and queries in one tick), and the async server on the
    sharded phase's 1M-row D = 4 deployment with shard 3 failed."""
    import numpy as np
    from repro_torch.core import ANY_OVERLAP, SearchRequest
    from repro_torch.kernels import ops
    from repro_torch.serving import (AsyncRetrievalServer, RetrievalServer,
                                     SLOPolicy)

    # -- the sync server on the streaming index: the tick's deletes are the
    # top answers of its first 32 queries before the tick, its upserts fresh
    # rows that 32 probe queries (their own vectors) must find first
    sidx, sds = stream["index"], stream["ds"]
    req = stream["request"]
    n_q, n_up = 32, 100
    before = sidx.execute(SearchRequest(req.vectors[:n_q],
                                        (req.qlo[:n_q], req.qhi[:n_q]),
                                        ANY_OVERLAP, k=k))
    dead = np.unique(before.ids[:, :2][before.ids[:, :2] >= 0])[:50]
    up = np.arange(stream["free_row"], stream["free_row"] + n_up)
    probes = up[:n_q]

    def embed(items):
        return np.stack([sds.vectors[it[1]] if isinstance(it, tuple)
                         else req.vectors[it] for it in items])

    srv = RetrievalServer(sidx, embed, k=k, ef=64, auto_compact=False)
    for e in up:
        srv.submit_upsert(int(e), ("row", int(e)), sds.lo[e], sds.hi[e])
    for e in dead:
        srv.submit_delete(int(e))
    for i in range(n_q):
        srv.submit(i, req.qlo[i], req.qhi[i], ANY_OVERLAP)
    for e in probes:
        srv.submit(("row", int(e)), sds.lo[e], sds.hi[e], ANY_OVERLAP)
    ops.reset_launches()
    got = srv.tick()
    launches = launched(ops.LAUNCHES)
    hits = [got[i] for i in sorted(got)]
    ids = np.stack([h.ids for h in hits])
    dists = np.stack([h.dists for h in hits])
    vecs = np.concatenate([req.vectors[:n_q], sds.vectors[probes]])
    after = sidx.execute(SearchRequest(
        vecs, (np.concatenate([req.qlo[:n_q], sds.lo[probes]]),
               np.concatenate([req.qhi[:n_q], sds.hi[probes]])),
        ANY_OVERLAP, k=k, ef=64))
    equal = bool(np.array_equal(ids, after.ids)
                 and np.array_equal(dists, after.dists))
    dead_returned = int(np.isin(ids, dead).sum())
    found = int((ids[n_q:, 0] == probes).sum())
    emit({"phase": "serving_streaming", "upserts": n_up,
          "deletes": int(dead.size), "queries": 2 * n_q,
          "tick_stats": srv.tick_stats, "launches": launches,
          "n_live": len(sidx), "equal_execute_after_tick": equal,
          "deleted_ids_returned": dead_returned,
          "upserted_probes_found_first": found})
    check(dead.size > 0 and dead_returned == 0,
          f"serving streaming: {dead_returned} deleted ids returned")
    check(found == n_q, f"serving streaming: {found} of {n_q} upserted rows "
                        f"came first for their own vectors")
    check(equal, "serving streaming: the tick's answers differ from "
                 "execute after it")

    # -- the async server on the sharded deployment with shard 3 lost
    D = dep.spec.n_shards
    dep.fail(D - 1)
    want = dep.execute(SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP,
                                     k=k))
    asrv = AsyncRetrievalServer(
        dep, lambda items: ds.queries[np.asarray(items)], k=k, ef=64,
        policy=SLOPolicy(max_wait_ms=0.0, max_batch=64))
    ops.reset_launches()
    out, wall = serve_waves(asrv, ds, qlo, qhi, ANY_OVERLAP, waves=4,
                            steps_between=1)
    launches = launched(ops.LAUNCHES)
    dep.restore(D - 1)
    a_ids = np.stack([o.hit.ids for o in out])
    a_d = np.stack([o.hit.dists for o in out])
    degraded = sum(o.degraded for o in out)
    agree = agreement(a_ids, a_d, want.ids, want.dists, 0.0)
    emit({"phase": "serving_sharded", "shards": D, "failed": [D - 1],
          "Q": len(qlo), **serving_snapshot(asrv, wall, len(qlo)),
          "launches": launches, "degraded_responses": degraded,
          "dists_bit_equal_batched": bool(np.array_equal(a_d, want.dists)),
          "id_agreement_batched": agree})
    check(degraded == len(qlo), f"serving sharded: {degraded} of "
                                f"{len(qlo)} responses degraded")
    check(launches.get("pairwise_l2_masked", 0) > 0,
          f"serving sharded: no scan launched ({launches})")
    check(agree == 1.0, f"serving sharded: ids differ from the degraded "
                        f"batched request beyond ties ({agree})")


def serving_front_ends(eng, idx, ds, qlo, qhi, k: int, F: int, gres,
                       flat_res, graph_ms: float,
                       graph_launches: dict) -> None:
    """The serving front ends on the graph phase's float32 engine: the async
    server's continuous path (graph) and micro-batches (flat), then the
    sync server on an engine whose config routes graph. Kernels 1, 3 and 5
    are held against their plain versions at the shapes serving hands
    them."""
    import numpy as np
    import torch
    from repro_torch.core import (ANY_OVERLAP, QUERY_CONTAINED, EngineConfig,
                                  QueryEngine, SearchRequest)
    from repro_torch.kernels import ops
    from repro_torch.serving import (AsyncRetrievalServer, RetrievalServer,
                                     SLOPolicy)

    Q, waves, chunk, max_batch = len(qlo), 4, 16, 64

    def embed(items):
        return ds.queries[np.asarray(items)]

    def server(route):
        return AsyncRetrievalServer(
            eng, embed, k=k, ef=64, route=route, chunk=chunk,
            max_inflight=256, policy=SLOPolicy(max_wait_ms=0.0,
                                               max_batch=max_batch))

    # -- continuous path: one warm run, then the counted and timed one
    serve_waves(server("graph"), ds, qlo, qhi, ANY_OVERLAP, waves, 1)
    srv = server("graph")
    ops.reset_launches()
    with Capture(ops, "gathered_topk", step_live) as cap_t, \
            Capture(ops, "gathered_l2",
                    lambda q, c: c.shape[0] * c.shape[1]) as cap_l:
        out, wall = serve_waves(srv, ds, qlo, qhi, ANY_OVERLAP, waves, 1)
    launches = launched(ops.LAUNCHES)
    g_ids = np.stack([o.hit.ids for o in out])
    g_d = np.stack([o.hit.dists for o in out])
    batched_equal = bool(np.array_equal(g_ids, gres.ids)
                         and np.array_equal(g_d, gres.dists))
    n_solo = 16
    solo_equal = 0
    for i in range(n_solo):
        s = eng.execute(SearchRequest(ds.queries[i:i + 1],
                                      (qlo[i:i + 1], qhi[i:i + 1]),
                                      ANY_OVERLAP, k=k, ef=64,
                                      route="graph"))
        solo_equal += bool(np.array_equal(s.ids[0], g_ids[i])
                           and np.array_equal(s.dists[0], g_d[i]))
    snap = serving_snapshot(srv, wall, Q)
    emit({"phase": "serving_async_graph", "Q": Q, "k": k, "ef": 64,
          "fanout": F, "waves": waves, "steps_between": 1, "chunk": chunk,
          "max_batch": max_batch, **snap, "launches": launches,
          "batched_request_ms": graph_ms,
          "batched_request_launches": graph_launches,
          "bit_equal_batched": batched_equal,
          "bit_equal_solo": f"{solo_equal}/{n_solo}"})
    check(snap["refills"] > 0, "serving graph: no slot was refilled")
    check(launches.get("gathered_topk", 0) > 0
          and launches.get("gathered_l2", 0) > 0,
          f"serving graph: kernels 1 and 3 not launched ({launches})")
    check(batched_equal, "serving graph: hits differ from the batched "
                         "request")
    check(solo_equal == n_solo, f"serving graph: {solo_equal} of {n_solo} "
                                f"hits equal solo execute")
    for cap in (cap_t, cap_l):
        measure_kernel(cap.name, cap.best, launches.get(cap.name, 0),
                       phase="serving_kernel")
    del cap_t, cap_l

    # -- flat micro-batches
    srv = server("flat")
    serve_waves(srv, ds, qlo, qhi, ANY_OVERLAP, waves, 1)
    srv = server("flat")
    ops.reset_launches()
    with Capture(ops, "pairwise_l2_masked") as cap_p:
        out, wall = serve_waves(srv, ds, qlo, qhi, ANY_OVERLAP, waves, 1)
    launches = launched(ops.LAUNCHES)
    f_ids = np.stack([o.hit.ids for o in out])
    f_d = np.stack([o.hit.dists for o in out])
    d_equal = bool(np.array_equal(f_d, flat_res.dists))
    ids_equal = bool(np.array_equal(f_ids, flat_res.ids))
    ties_only = agreement(f_ids, f_d, flat_res.ids, flat_res.dists,
                          0.0) == 1.0
    emit({"phase": "serving_async_flat", "Q": Q, "k": k,
          **serving_snapshot(srv, wall, Q), "launches": launches,
          "dists_bit_equal_batched": d_equal,
          "ids_equal_batched": ids_equal,
          "ids_differ_only_at_ties": ties_only})
    check(d_equal, "serving flat: dists differ from the batched flat route")
    check(ties_only, "serving flat: ids differ from the batched flat route "
                     "beyond exact ties")
    measure_kernel("pairwise_l2_masked", cap_p.best,
                   launches.get("pairwise_l2_masked", 0),
                   phase="serving_kernel")
    del cap_p

    # -- the sync server, two masks in one tick, on a graph-routed engine
    geng = QueryEngine(idx, EngineConfig(route="graph"), device="cuda")
    masks = (ANY_OVERLAP, QUERY_CONTAINED)
    ssrv = RetrievalServer(geng, embed, k=k, ef=64)
    for i in range(Q):
        ssrv.submit(i, qlo[i], qhi[i], masks[i % 2])
    geng.execute(SearchRequest(ds.queries[:8], (qlo[:8], qhi[:8]),
                               ANY_OVERLAP, k=k))    # stage the variants
    torch.cuda.synchronize()
    ops.reset_launches()
    got = ssrv.tick()
    launches = launched(ops.LAUNCHES)
    groups = {}
    for m in masks:
        sel = np.flatnonzero(np.arange(Q) % 2 == (0 if m == masks[0] else 1))
        res = geng.execute(SearchRequest(ds.queries[sel], (qlo[sel], qhi[sel]),
                                         m, k=k, ef=64))
        groups[str(m)] = bool(
            np.array_equal(np.stack([got[i].ids for i in sel]), res.ids)
            and np.array_equal(np.stack([got[i].dists for i in sel]),
                               res.dists))
    emit({"phase": "serving_sync", "Q": Q, "masks": list(masks),
          "tick_stats": ssrv.tick_stats, "launches": launches,
          "groups_equal_execute": groups})
    check(launches.get("gathered_topk", 0) > 0
          and launches.get("gathered_l2", 0) > 0,
          f"serving sync: the graph-routed tick launched {launches}")
    check(all(groups.values()), f"serving sync: a mask group differs from "
                                f"execute ({groups})")
    del geng, ssrv


# ---- main --------------------------------------------------------------------

# ---- the paper's baselines and the LM serving path ---------------------------

def baselines_phase(dev, n: int, Qn: int, k: int, seed: int) -> None:
    """``IRangeGraphLike`` (exp3's RFANN setting: m = 12, ef_con = 64, the
    attribute's 0.3 / 0.4 quantiles, ~10% selectivity) built once on the
    host and searched on the card and on the CPU; kernels 1 and 3 held
    against their plain versions at the shapes the search handed them;
    ``Prefiltering`` on the same data as a host check (recall 1.0)."""
    import numpy as np
    from repro_torch.core import intervals as iv
    from repro_torch.core.baselines import IRangeGraphLike, Prefiltering
    from repro_torch.data import (brute_force_topk, make_range_dataset,
                                  recall_at_k)
    from repro_torch.kernels import ops

    ds = make_range_dataset(n=n, d=128, n_queries=Qn, quantize=1024,
                            seed=seed)
    attr = (ds.lo + ds.hi) / 2
    qlo = np.full(Qn, np.quantile(attr, 0.3))
    qhi = np.full(Qn, np.quantile(attr, 0.4))
    selectivity = float(np.mean((attr >= qlo[0]) & (attr <= qhi[0])))
    tids, _ = brute_force_topk(ds.vectors, attr, attr, ds.queries, qlo, qhi,
                               iv.RFANN_MASK, k)
    t0 = time.perf_counter()
    irg = IRangeGraphLike(ds.vectors, attr, m=12, ef_con=64, device=dev)
    build_s = time.perf_counter() - t0
    cpu_irg = irg.to("cpu")                    # the same host index

    def search(b):
        return b.search(ds.queries, qlo, qhi, k=k, ef=64)

    t0 = time.perf_counter()
    search(irg)                                # stages the variant
    first_s = time.perf_counter() - t0
    ops.reset_launches()
    with Capture(ops, "gathered_topk", step_live) as cap_t, \
            Capture(ops, "gathered_l2", lambda q, c: c.shape[1]) as cap_l:
        ids, d = search(irg)
    launches = launched(dict(ops.LAUNCHES))
    check(launches.get("gathered_topk", 0) > 0
          and launches.get("gathered_l2", 0) > 0,
          f"IRangeGraphLike.search did not launch kernels 1 and 3: "
          f"{launches}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        search(irg)
        times.append(time.perf_counter() - t0)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    cids, cd = search(cpu_irg)
    cpu_s = time.perf_counter() - t0
    check(ops.LAUNCHES == before, "the CPU run launched a kernel")
    agree = agreement(ids, d, cids, cd, 1e-5)
    recall = recall_at_k(ids, tids)
    got = ids[ids >= 0]
    valid = bool(np.all((attr[got] >= qlo[0]) & (attr[got] <= qhi[0])))
    pf = Prefiltering(ds.vectors, attr, attr)
    t0 = time.perf_counter()
    pids, _ = pf.search(ds.queries, qlo, qhi, iv.RFANN_MASK, k=k)
    pf_s = time.perf_counter() - t0
    pf_recall = recall_at_k(pids, tids)
    emit({"phase": "baselines", "n": n, "d": 128, "Q": Qn, "k": k, "ef": 64,
          "selectivity": selectivity, "build_s": build_s,
          "first_request_s": first_s,
          "request_ms": statistics.median(times) * 1e3,
          "qps": Qn / statistics.median(times), "launches": launches,
          "cpu_agreement": agree, "cpu_request_s": cpu_s,
          "recall_at_10": recall, "ids_in_range": valid,
          "index_bytes": irg.index_bytes(),
          "prefilter_recall": pf_recall, "prefilter_s": pf_s,
          "prefilter_dist_evals": pf.last_dist_evals})
    check(agree >= 0.99, f"IRangeGraphLike: card/CPU agreement {agree} < "
                         f"0.99")
    check(valid, "IRangeGraphLike returned an id outside the query range")
    check(pf_recall == 1.0, f"Prefiltering recall {pf_recall} != 1.0")
    for row, cap in (("gathered_topk", cap_t), ("gathered_l2", cap_l)):
        measure_kernel(row, cap.best, launches.get(row, 0),
                       phase="baselines_kernel")


def _close(got, want, rtol: float):
    """(max abs difference, ok): |got - want| <= rtol |want| + rtol / 10 *
    max(1, max |want|), the tolerance the CPU parity tests hold."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    atol = rtol / 10 * max(1.0, float(np.abs(want).max()))
    return float(err.max()), bool(np.all(err <= rtol * np.abs(want) + atol))


def _margin(got, want, rtol: float) -> float:
    """The worst |got - want| / (rtol |want| + atol) under :func:`_close`'s
    tolerance: how much of its room the worst element uses (<= 1 passes)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol / 10 * max(1.0, float(np.abs(want).max()))
    return float((np.abs(got - want) / (rtol * np.abs(want) + atol)).max())


# Smoke configs held card = CPU; the full-width models of lm_moe_full /
# lm_rec_full with the depth their float64 teacher forcing keeps (None:
# every layer; float64 copies of all layers would not fit the card).
LM_SMOKE_ARCHS = ("olmo-1b", "gemma3-1b", "qwen3-moe-30b-a3b",
                  "recurrentgemma-2b", "rwkv6-7b", "deepseek-v3-671b")
LM_FULL = (("lm_moe_full", "qwen3-moe-30b-a3b", 2),
           ("lm_rec_full", "recurrentgemma-2b", None),
           ("lm_rec_full", "rwkv6-7b", 4))


def free_device() -> int:
    """Collect garbage, give cached blocks back and reset the peak; the
    bytes still allocated."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


@contextlib.contextmanager
def moe_routing_records():
    """Yield a list that gets ``moe.routing``'s record of every MoE call
    made inside the block (the model calls ``moe.moe_apply`` through its
    module, which is wrapped for the block's duration). The records' tensors
    stay on the device."""
    from repro_torch.models import moe
    records, apply = [], moe.moe_apply

    def recorded(p, x, *, cfg, capacity_factor=1.25):
        records.append(moe.routing(p, x, cfg=cfg,
                                   capacity_factor=capacity_factor))
        return apply(p, x, cfg=cfg, capacity_factor=capacity_factor)

    moe.moe_apply = recorded
    try:
        yield records
    finally:
        moe.moe_apply = apply


def lm_timed_run(dev, lm, rng, B: int, P: int, n_new: int, max_len: int):
    """One timed greedy run on the card: the prefill (CUDA events), the
    seeded caches, ``n_new`` decode steps each timed with CUDA events;
    then ``ServeEngine.generate`` on the same prompt (untimed, under
    :func:`moe_routing_records`) must give the same tokens; then one
    profiled prefill and decode step. Returns (report, routing records)."""
    import numpy as np
    import torch
    from repro_torch.serving import ServeEngine, seed_caches
    cfg = lm.cfg
    eng = ServeEngine(lm, device=dev)
    toks = rng.integers(0, cfg.vocab, (B, P))
    eng.generate({"tokens": toks[:, :16]}, n_new=2, max_len=32)  # warm up
    toks_t = torch.as_tensor(toks, device=dev)
    with torch.inference_mode():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        ev[0].record()
        logits, pc = lm.prefill(None, {"tokens": toks_t})
        ev[1].record()
        caches = seed_caches(lm, pc, B, max_len, P)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        steps, out = [], []
        for i in range(n_new):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            out.append(cur)
            a.record()
            logits, caches = lm.decode_step(None, caches, cur, P + i)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            b.record()
            steps.append((a, b))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_all
    step_ms = [a.elapsed_time(b) for a, b in steps]
    tokens = torch.cat(out, 1).cpu().numpy()
    del pc, logits
    with moe_routing_records() as routing:
        gen = eng.generate({"tokens": toks}, n_new=n_new, max_len=max_len)
    with torch.inference_mode():
        profiles = {
            "prefill": profile_call(
                lambda: lm.prefill(None, {"tokens": toks_t})),
            "decode_step": profile_call(
                lambda: lm.decode_step(None, caches, cur, P + n_new))}
    for prof in profiles.values():
        prof.pop("port_kernel_ms")
    finite = bool(np.isfinite(gen.logits_last).all())
    name = cfg.name
    check(gen.tokens.shape == (B, n_new), f"{name}: wrong token shape")
    check(finite, f"{name}: non-finite logits")
    check(bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()),
          f"{name}: a token outside the vocabulary")
    check(bool(np.array_equal(tokens, gen.tokens)),
          f"{name}: ServeEngine.generate differs from the timed loop")
    report = {"batch": B, "prompt": P, "new_tokens": n_new,
              "max_len": max_len,
              "prefill_ms": ev[0].elapsed_time(ev[1]),
              "decode_ms_median": statistics.median(step_ms),
              "decode_ms_min": min(step_ms), "decode_ms_max": max(step_ms),
              "tokens_per_s": B * n_new / (sum(step_ms) / 1e3),
              "wall_s": wall_s, "tokens_equal_generate": True,
              "logits_finite": finite, "profile": profiles}
    return report, routing


def moe_routing_report(lm, routing, B: int, P: int, pbytes: int) -> dict:
    """From one generation's routing records: the prefill's dropped
    assignments at the config's capacity factor, per sequence (token order
    is sequence-major, so a later sequence meets fuller experts) beside the
    distinct experts each sequence chose and the batch chose, a layer's
    busiest expert over its capacity; and each decode step's byte bound
    counting only the experts its router chose (the distinct experts of
    each MoE layer), beside the design's, which reads all E experts a layer
    (the capacity buffer's products run over every expert)."""
    import torch
    cfg = lm.cfg
    n_moe = sum(1 for d in lm.descs if d.mlp == "moe")
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff * cfg.pdtype.itemsize
    pre = [r for r in routing if r["tokens"] == B * P]
    dec = [r for r in routing if r["tokens"] == B]
    check(len(pre) == n_moe and dec and len(dec) % n_moe == 0,
          f"{cfg.name}: {len(pre)} prefill and {len(dec)} decode MoE calls "
          f"for {n_moe} MoE layers")
    used = [int(r["experts_used"].sum()) for r in dec]
    step_bytes = [pbytes - n_moe * cfg.n_experts * per_expert
                  + sum(used[i:i + n_moe]) * per_expert
                  for i in range(0, len(used), n_moe)]
    routed_ms = [b / PEAKS.hbm_bytes_per_s * 1e3 for b in step_bytes]
    # the prefill's routing by sequence, summed or averaged over its layers
    drop_seq = sum((~r["kept"]).view(B, -1).sum(1).cpu() for r in pre)
    per_seq = [len(torch.unique(r["experts"][b * P:(b + 1) * P]))
               for r in pre for b in range(B)]
    per_batch = [len(torch.unique(r["experts"])) for r in pre]
    busiest = [int(torch.bincount(r["experts"].reshape(-1),
                                  minlength=cfg.n_experts).max())
               / r["capacity"] for r in pre]
    return {"capacity_factor": cfg.capacity_factor,
            "prefill_capacity": pre[0]["capacity"],
            "prefill_assignments": sum(r["assignments"] for r in pre),
            "prefill_dropped": sum(int(r["dropped"]) for r in pre),
            "prefill_dropped_by_sequence": drop_seq.tolist(),
            "prefill_assignments_per_sequence": n_moe * P * cfg.top_k,
            "prefill_experts_per_sequence_mean": statistics.mean(per_seq),
            "prefill_experts_per_sequence_min": min(per_seq),
            "prefill_experts_per_batch_mean": statistics.mean(per_batch),
            "prefill_busiest_expert_over_capacity_mean":
                statistics.mean(busiest),
            "prefill_busiest_expert_over_capacity_max": max(busiest),
            "decode_capacity": dec[0]["capacity"],
            "decode_dropped": sum(int(r["dropped"]) for r in dec),
            "decode_experts_per_layer_mean": statistics.mean(used),
            "decode_experts_per_layer_max": max(used),
            "routed_bytes_per_step_median": statistics.median(step_bytes),
            "routed_bound_ms_median": statistics.median(routed_ms),
            "routed_bound_ms_max": max(routed_ms)}


def cut_params(params, lm_from, lm_to):
    """The first layers of ``lm_from``'s parameters, shaped for ``lm_to``
    (the same config at a smaller depth): each stacked segment keeps its
    first repeats."""
    from repro_torch.models.params import map_tree
    segs = []
    for sp, seg_f, seg_t in zip(params["segments"], lm_from.layout,
                                lm_to.layout):
        check(seg_f.pattern == seg_t.pattern
              and seg_t.repeats <= seg_f.repeats,
              f"cut_params: {lm_to.cfg.name} at {lm_to.cfg.n_layers} layers "
              f"is no cut of its {lm_from.cfg.n_layers}-layer layout")
        if seg_f.repeats == seg_t.repeats:
            segs.append(sp)
        elif seg_t.repeats == 1:
            segs.append(map_tree(lambda t: t[0], sp))
        else:
            segs.append(map_tree(lambda t, r=seg_t.repeats: t[:r], sp))
    return {**params, "segments": segs}


def all_logits(lm, tokens):
    """Logits at every position of ``tokens`` (B, S) in one causal
    forward, which is teacher forcing: the prefill's layers, then the head
    on every position instead of the last."""
    import torch
    from repro_torch.models.common import logits_fn, make_norm
    from repro_torch.models.transformer import segment_apply
    cfg, params = lm.cfg, lm.params
    with torch.inference_mode():
        x = lm._embed_tokens(params, tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        for sp, seg in zip(params["segments"], lm.layout):
            x, _ = segment_apply(sp, x, seg, cfg=cfg, mode="prefill",
                                 caches=None, positions=pos, cur_pos=None)
        _, norm = make_norm(cfg)
        return logits_fn(params.get("head", {}), params["embed"],
                         norm(params["final_norm"], x), cfg.tie_embeddings)


def layers_f32_vs_cpu(dev, lm_cut, params_cpu, toks):
    """Each distinct layer kind of ``lm_cut`` (mixer + MLP), in float32, on
    the card and on the CPU from the same input, the CPU's: the first
    layer of that kind, fed the CPU's output of the kind before it (the
    embedded tokens for the first). Returns ({kind: max abs error},
    whether each is within 1e-3 of the CPU's, atol 1e-4 of the output's
    magnitude)."""
    import torch
    from repro_torch.models.params import map_tree
    from repro_torch.models.transformer import layer_apply
    cfg = lm_cut.cfg.scaled(param_dtype="float32", activ_dtype="float32")
    f32 = lambda t: t.to(torch.float32) if t.is_floating_point() else t
    errs, margins, ok_all = {}, {}, True
    with torch.inference_mode():
        x = f32(params_cpu["embed"]["table"])[torch.as_tensor(toks)]
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model)))
        pos = torch.arange(toks.shape[1])
        kw = dict(cfg=cfg, mode="prefill", cache=None, cur_pos=None)
        for sp, seg in zip(params_cpu["segments"], lm_cut.layout):
            for j, desc in enumerate(seg.pattern):
                kind = f"{desc.mixer}+{desc.mlp}"
                if kind in errs:
                    continue
                pick = (lambda t: t[0]) if seg.repeats > 1 else (lambda t: t)
                lc = map_tree(lambda t: f32(pick(t)), sp[f"L{j}"])
                y_c, _ = layer_apply(lc, x, desc, positions=pos, **kw)
                y_g, _ = layer_apply(map_tree(lambda t: t.to(dev), lc),
                                     x.to(dev), desc, positions=pos.to(dev),
                                     **kw)
                got, want = y_g.cpu().numpy(), y_c.numpy()
                errs[kind], ok = _close(got, want, 1e-3)
                margins[kind] = _margin(got, want, 1e-3)
                ok_all &= ok
                x = y_c
    return errs, margins, ok_all


def lm_full_phase(dev, phase: str, arch: str, depth, seed: int, rng) -> None:
    """``arch`` at its published widths and full depth in bfloat16 on the
    card, seeded random weights (:func:`lm_timed_run`; a MoE's routing
    with :func:`moe_routing_report`); then the held checks on the first
    ``depth`` layers of the same weights (all of them for ``None``):
    float64 greedy tokens equal teacher forcing, a MoE at a capacity
    factor that drops nothing (>= E / k: a prefill and a decode step drop
    differently at 1.25), and each distinct layer kind in float32 on the
    card within 1e-3 of the CPU's from the CPU's input."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.models.params import map_tree, tree_bytes
    from repro_torch.serving import ServeEngine
    cfg = configs.get_config(arch)
    B, P, n_new, max_len = 8, 128, 32, 256
    before = free_device()
    lm = LM(cfg)
    pbytes = tree_bytes(lm.abstract_params())
    t0 = time.perf_counter()
    lm.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    report, routing = lm_timed_run(dev, lm, rng, B, P, n_new, max_len)
    line = {"phase": phase, "arch": arch, "dtype": cfg.param_dtype,
            "layers": cfg.n_layers, "params": lm.param_count(),
            "active_params": lm.active_param_count(),
            "param_bytes": pbytes, "allocated_before": before,
            "init_s": init_s, **report,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "decode_bound_ms": pbytes / PEAKS.hbm_bytes_per_s * 1e3,
            "decode_bound_by": "bytes"}
    if cfg.n_experts:
        line["moe"] = moe_routing_report(lm, routing, B, P, pbytes)
    del routing
    cut_cfg = cfg if depth is None else cfg.scaled(n_layers=depth)
    lm_cut = LM(cut_cfg)
    params_cpu = map_tree(lambda t: t.cpu(),
                          cut_params(lm.params, lm, lm_cut))
    del lm
    free_device()
    # float64: greedy decoding against teacher forcing over the prompt and
    # the generated tokens (one causal forward)
    cf = cfg.capacity_factor
    if cfg.n_experts:
        cf = max(cf, cfg.n_experts / cfg.top_k)
    lm64 = LM(cut_cfg.scaled(param_dtype="float64", activ_dtype="float64",
                             capacity_factor=cf))
    lm64.set_params(map_tree(lambda t: t.to(dev, torch.float64)
                             if t.is_floating_point() else t.to(dev),
                             params_cpu))
    P64, n64 = 32, 16
    toks = rng.integers(0, cfg.vocab, (2, P64))
    gen = ServeEngine(lm64, device=dev).generate({"tokens": toks},
                                                 n_new=n64, max_len=64)
    seq = torch.as_tensor(np.concatenate([toks, gen.tokens], 1), device=dev)
    forced = torch.argmax(all_logits(lm64, seq)[:, P64 - 1:P64 - 1 + n64],
                          dim=-1).cpu().numpy()
    teacher64 = bool(np.array_equal(forced, gen.tokens))
    del lm64, seq
    free_device()
    layer_errs, margins, layers_ok = layers_f32_vs_cpu(dev, lm_cut,
                                                       params_cpu, toks)
    line.update({
        "f64_layers": cut_cfg.n_layers,
        "f64_reduced": [] if depth is None else
        [f"n_layers {cfg.n_layers} -> {depth} (float64 of every layer "
         f"does not fit the card)"],
        "f64_capacity_factor": cf if cfg.n_experts else None,
        "f64_prompt": [2, P64], "f64_steps": n64,
        "teacher_forcing_equal_f64": teacher64,
        "f32_layer_max_abs_err": layer_errs,
        "f32_layer_tolerance_share": margins,
        "f32_layers_within_1e-3_of_cpu": layers_ok})
    emit(line)
    check(teacher64, f"{arch} float64 ({cut_cfg.n_layers} layers): greedy "
                     f"tokens differ from teacher forcing")
    check(layers_ok, f"{arch} float32: a layer is off the CPU's: "
                     f"{layer_errs}")
    del params_cpu
    free_device()


def olmo_held_checks(dev, cfg, params, rng, seed: int) -> None:
    """olmo-1b's full-width weights (``params``) in float64 and float32 on
    the card (``lm_full_f32``, ``lm_fp32_matmul`` lines)."""
    # The same weights in float64 and float32. The reference's init
    # draws wq / wk at 1/sqrt(fan_in) with fan_in = heads, so at full width
    # the attention scores have a std of ~126 and 16 layers amplify any
    # rounding difference to O(1) logits: the CPU's logits move by O(1)
    # when the weights move by 1e-7 relative (the control below). So the
    # card is held to the CPU layer by layer (each layer's output from the
    # CPU's input), and greedy decoding to teacher forcing in float64;
    # float32's teacher forcing and end-to-end logits are reported.
    import numpy as np
    import torch
    from repro_torch.models import LM
    from repro_torch.models.common import logits_fn, make_norm
    from repro_torch.models.params import map_tree
    from repro_torch.models.transformer import layer_apply
    from repro_torch.serving import ServeEngine
    toks = rng.integers(0, cfg.vocab, (2, 32))

    def teacher_forcing(lm_x):
        out = ServeEngine(lm_x, device=dev).generate(
            {"tokens": toks}, n_new=8, max_len=64)
        cur, want = toks.copy(), []
        for _ in range(8):
            lg, _ = lm_x.prefill(None, {"tokens": cur})
            nxt = torch.argmax(lg[:, -1], dim=-1).cpu().numpy()
            want.append(nxt)
            cur = np.concatenate([cur, nxt[:, None]], axis=1)
        return bool(np.array_equal(out.tokens, np.stack(want, 1)))

    def as_dtype(dtype):
        name = str(dtype).split(".")[-1]
        lm_x = LM(cfg.scaled(param_dtype=name, activ_dtype=name))
        lm_x.set_params(map_tree(lambda t: t.to(dtype), params))
        return lm_x

    lm64 = as_dtype(torch.float64)
    teacher64 = teacher_forcing(lm64)
    del lm64
    torch.cuda.empty_cache()
    lm32 = as_dtype(torch.float32)
    teacher32 = teacher_forcing(lm32)
    gpu_logits = lm32.prefill(None, {"tokens": toks})[0].cpu()
    lm_cpu = LM(lm32.cfg)
    lm_cpu.set_params(map_tree(lambda t: t.cpu(), lm32.params))
    t0 = time.perf_counter()
    cpu_logits = lm_cpu.prefill(None, {"tokens": toks})[0]
    cpu_s = time.perf_counter() - t0
    e2e_err, _ = _close(gpu_logits.numpy(), cpu_logits.numpy(), 1e-3)
    gen = torch.Generator().manual_seed(seed + 1)
    moved = map_tree(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)), lm_cpu.params)
    control = float((lm_cpu.prefill(moved, {"tokens": toks})[0]
                     - cpu_logits).abs().max())
    del moved
    # layer by layer: both devices take the CPU's hidden state
    gp, cp = lm32.params, lm_cpu.params
    with torch.inference_mode():
        x = lm_cpu._embed_tokens(cp, torch.as_tensor(toks))
        pos = torch.arange(toks.shape[1])
        layer_errs, layer_margins, layer_ok = [], [], True
        for sp_g, sp_c, seg in zip(gp["segments"], cp["segments"],
                                   lm32.layout):
            for r in range(seg.repeats):
                pick = (lambda t: t[r]) if seg.repeats > 1 else (lambda t: t)
                for j, desc in enumerate(seg.pattern):
                    kw = dict(cfg=lm32.cfg, mode="prefill", cache=None,
                              cur_pos=None)
                    lc = map_tree(pick, sp_c)[f"L{j}"]
                    lg_ = map_tree(pick, sp_g)[f"L{j}"]
                    y_c, _ = layer_apply(lc, x, desc, positions=pos, **kw)
                    y_g, _ = layer_apply(lg_, x.to(dev), desc,
                                         positions=pos.to(dev), **kw)
                    got, want = y_g.cpu().numpy(), y_c.numpy()
                    err, ok = _close(got, want, 1e-3)
                    layer_errs.append(err)
                    layer_margins.append(_margin(got, want, 1e-3))
                    layer_ok &= ok
                    x = y_c
        _, norm = make_norm(lm32.cfg)
        head_c = logits_fn(cp.get("head", {}), cp["embed"],
                           norm(cp["final_norm"], x[:, -1:]), True)
        head_g = logits_fn(gp.get("head", {}), gp["embed"],
                           norm(gp["final_norm"], x[:, -1:].to(dev)), True)
    head_err, head_ok = _close(head_g.cpu().numpy(), head_c.numpy(), 1e-3)
    emit({"phase": "lm_full_f32", "arch": cfg.name, "prompt": [2, 32],
          "steps": 8, "teacher_forcing_equal_f64": teacher64,
          "teacher_forcing_equal_f32": teacher32,
          "layers_within_1e-3_of_cpu": layer_ok,
          "layer_max_abs_err": max(layer_errs),
          "layer_errs": layer_errs,
          "layer_tolerance_share_max": max(layer_margins),
          "head_max_abs_err": head_err,
          "head_within_1e-3_of_cpu": head_ok,
          "e2e_logits_max_abs_err_vs_cpu": e2e_err,
          "logits_scale": float(cpu_logits.abs().max()),
          "cpu_logits_moved_by_1e-7_weights": control,
          "cpu_prefill_s": cpu_s})
    check(teacher64, "olmo-1b float64: greedy tokens differ from argmax "
                     "over repeated prefills")
    check(layer_ok and head_ok, f"olmo-1b float32: a layer is off the "
                                f"CPU's by {max(layer_errs + [head_err])}")
    del lm32, lm_cpu, gp, cp
    a = torch.randn(2048, 2048, device=dev)
    b = torch.randn(2048, 2048, device=dev)
    exact = a.double() @ b.double()
    emit({"phase": "lm_fp32_matmul", "allow_tf32":
          torch.backends.cuda.matmul.allow_tf32,
          "max_rel_err_vs_f64": float(((a @ b).double() - exact).abs().max()
                                      / exact.abs().max())})


def lm_phase(dev, seed: int) -> None:
    """The LM and ``ServeEngine`` on the card: smoke-size parity with the
    CPU (every ported family), olmo-1b at full width in bfloat16 (init,
    prefill, decode per token against its byte bound, memory), float64
    and float32 copies of the same weights (teacher forcing in float64,
    the CPU's layers in float32), then qwen3-moe-30b-a3b,
    recurrentgemma-2b and rwkv6-7b the same way (:func:`lm_full_phase`),
    and ``launch.serve.main`` in its four modes and, with the MoE, on the
    graph and flat routes."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.params import map_tree, tree_bytes
    from repro_torch.serving import ServeEngine

    rng = np.random.default_rng(seed)
    # 1. smoke size: one CPU init, generated on the CPU and on the card
    for arch in LM_SMOKE_ARCHS:
        cfg = configs.get_smoke_config(arch)
        lm = LM(cfg)
        lm.init(torch.Generator().manual_seed(seed), device="cpu")
        toks = rng.integers(0, cfg.vocab, (2, 16))
        want = ServeEngine(lm, device="cpu").generate({"tokens": toks},
                                                      n_new=8, max_len=32)
        got = ServeEngine(lm, device=dev).generate({"tokens": toks},
                                                   n_new=8, max_len=32)
        err, ok = _close(got.logits_last, want.logits_last, 1e-4)
        same = bool(np.array_equal(got.tokens, want.tokens))
        emit({"phase": "lm_smoke", "arch": arch, "tokens_equal_cpu": same,
              "logits_max_abs_err": err, "logits_ok": ok})
        check(same, f"{arch} smoke: card tokens differ from the CPU's")
        check(ok, f"{arch} smoke: last logits off by {err}")

    # 2. olmo-1b at full width, bfloat16 as published
    cfg = configs.get_config("olmo-1b")
    B, P, n_new, max_len = 8, 128, 32, 256
    free_device()
    lm = LM(cfg)
    t0 = time.perf_counter()
    lm.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = tree_bytes(lm.abstract_params())
    report, _ = lm_timed_run(dev, lm, rng, B, P, n_new, max_len)
    peak = torch.cuda.max_memory_allocated()
    # the attention yardstick: the port's flash_attention against torch's
    # scaled_dot_product_attention at the prefill's shapes (not on the path)
    H, Dh = cfg.n_heads, cfg.head_dim
    qkv = [torch.randn(B, P, H, Dh, device=dev, dtype=cfg.adtype)
           for _ in range(3)]
    fa_ms = time_ms(lambda: attn_mod.flash_attention(*qkv, causal=True),
                    reps=10)
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *[t.transpose(1, 2) for t in qkv], is_causal=True), reps=10)
    emit({"phase": "lm_full", "arch": cfg.name, "dtype": cfg.param_dtype,
          "params": lm.param_count(), "param_bytes": pbytes,
          "init_s": init_s, **report, "max_memory_allocated": peak,
          "decode_bound_ms": pbytes / PEAKS.hbm_bytes_per_s * 1e3,
          "decode_bound_by": "bytes", "flash_attention_ms": fa_ms,
          "sdpa_ms": sdpa_ms})

    # 3. the same weights in float64 and float32 (olmo_held_checks)
    params = lm.params
    del lm, qkv
    olmo_held_checks(dev, cfg, params, rng, seed)
    del params

    # 4. full width: the MoE, the hybrid recurrent model and RWKV-6
    for phase, arch, depth in LM_FULL:
        lm_full_phase(dev, phase, arch, depth, seed, rng)

    # 5. the serving driver, in-process, in each mode, and with the MoE.
    # At the driver's 1,500 rows the work-model router sends both mask
    # groups to the pruned route (plain torch): the plain mode launches no
    # kernel, the streaming mode kernel 5 on its delta. The MoE modes pin
    # the route, so QueryEngine launches kernels 1 and 3 (graph) and
    # kernel 5 (flat) under qwen3-moe-30b-a3b's LM endpoint.
    moe_kernels = {"graph": ("gathered_topk", "gathered_l2"),
                   "flat": ("pairwise_l2_masked",)}
    for mode in ([], ["--async"], ["--streaming", "--n", "400"],
                 ["--shards", "4", "--n", "1200"],
                 ["--arch", "qwen3-moe-30b-a3b", "--route", "graph"],
                 ["--arch", "qwen3-moe-30b-a3b", "--route", "flat"]):
        ops.reset_launches()
        t0 = time.perf_counter()
        res = serve.main(["--requests", "24"] + mode)
        sec = time.perf_counter() - t0
        launches = launched(dict(ops.LAUNCHES))
        emit({"phase": "lm_serve", "argv": mode, "main_s": sec,
              "launches": launches, **res})
        check(res["served"] == 24 and res["non_empty"] == 24,
              f"launch.serve {mode}: served {res['served']}, non-empty "
              f"{res['non_empty']} of 24")
        if "--streaming" in mode:
            check(launches.get("pairwise_l2_masked"),
                  "launch.serve --streaming: kernel 5 not launched on the "
                  "delta")
        if "--route" in mode:
            route = mode[mode.index("--route") + 1]
            check(res["routes"][route] == 2
                  and all(launches.get(k) for k in moe_kernels[route]),
                  f"launch.serve {mode}: routes {res['routes']}, launches "
                  f"{launches}; the {route} route must launch "
                  f"{moe_kernels[route]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated phases, all by default: "
                         + ", ".join(ALL_PHASES) + " (serving pulls in "
                         "graph, streaming, sharded and flat)")
    ap.add_argument("--baselines-n", type=int, default=20_000,
                    help="corpus rows of the baselines phase")
    ap.add_argument("--flat-n", type=int, default=1_000_000)
    ap.add_argument("--graph-n", type=int, default=50_000)
    ap.add_argument("--stream-n", type=int, default=70_000)
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
    from repro_torch import obs
    from repro_torch.core import engine as engine_mod
    from repro_torch.data import make_range_dataset, recall_at_k
    from repro_torch.kernels import _build, ops, ref

    global PEAKS
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    PEAKS = obs.device_peaks(dev)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "kernel_build_s": build_s,
          "kernel_build_log": str(_build.BUILD_LOG),
          "peaks": PEAKS._asdict() if PEAKS else None})
    check(PEAKS is not None, f"no published peaks for "
                             f"{torch.cuda.get_device_name(0)} in "
                             f"repro_torch.obs.profile.PEAKS")
    if _build.BUILD_LOG is not None and _build.BUILD_LOG.exists():
        for line in _build.BUILD_LOG.read_text().splitlines():
            if "registers" in line or "smem" in line or "==" in line:
                emit({"phase": "ptxas", "line": line.strip()})

    rows = {}
    if "kernels" in phases:
        cases = kernel_edge_checks(dev, S_wide=767)
        emit({"phase": "kernel_edges_done", "cases": sum(cases.values()),
              "cases_by_kernel": dict(cases)})
    if "scan_sweep" in phases:
        scan_sweep(dev, 256, args.flat_n, args.seed)
    if "gathered_sweep" in phases:
        gathered_sweep(dev, 256, 128, args.seed)

    k = 10
    Qn = 256
    if "baselines" in phases:
        baselines_phase(dev, args.baselines_n, Qn, k, args.seed)
    if "lm" in phases:
        lm_phase(dev, args.seed)
    if "trace" in phases:
        phases.update(("flat", "graph"))
    if "quant_flat" in phases:
        phases.add("flat")                     # its dataset, index and result
    if "quant_graph" in phases or "quant_routes" in phases:
        phases.add("graph")
    if "serving" in phases:     # the graph index, the streaming index and
        phases.update(("graph", "sharded"))        # the sharded deployment
    if "sharded" in phases:          # the flat corpus, the streaming index
        phases.update(("flat", "streaming"))
    if "streaming" in phases:
        stream = streaming_phase(dev, args, Qn, k)
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
        # fused_topk_l2 on the scan's inputs, against the route's result
        fused_args = cap.best + (k,)
        Qp, Np = cap.best[0].shape[0], cap.best[1].shape[0]
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        f_ids, f_d = ops.fused_topk_l2(*fused_args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - mem0
        f_ids = f_ids[:Qn].cpu().numpy()
        f_d = f_d[:Qn].cpu().numpy()
        fin_r = np.isfinite(res.dists)
        f_rel = float((np.abs(f_d[fin_r] - res.dists[fin_r])
                       / np.maximum(res.dists[fin_r], 1e-30)).max())
        f_agree = agreement(f_ids, f_d.astype(np.float64), res.ids,
                            res.dists.astype(np.float64), 1e-4)
        # the route's own scan and top-k, timed beside the fused kernel;
        # the kernel's launches' device split over the float32 and the
        # float16 corpus
        scan_topk_ms = time_ms(lambda: torch.topk(
            ops.pairwise_l2_masked(*cap.best), k, dim=1, largest=False))
        fused16_args = (fused_args[0], fused_args[1].half(), *fused_args[2:])
        split = {row: device_split(lambda a=a: ops.fused_topk_l2(*a))
                 for row, a in (("fused_topk_l2", fused_args),
                                ("fused_topk_l2_f16", fused16_args))}
        emit({"phase": "flat_fused", "Q": Qp, "N": Np, "k": k,
              "scan_topk_ms": scan_topk_ms, "device_split_ms": split,
              "id_agreement_vs_flat": f_agree, "max_rel_err_vs_flat": f_rel,
              "dists_bit_equal_vs_flat": bool(np.array_equal(
                  f_d[fin_r], res.dists[fin_r])),
              "ids_equal_vs_flat": bool(np.array_equal(f_ids, res.ids)),
              "extra_device_bytes": extra, "qn_matrix_bytes": 4 * Qp * Np,
              "route_launches": launches["fused_topk_l2"]})
        check(bool(np.array_equal(np.isfinite(f_d), fin_r)),
              "fused_topk_l2: +inf pattern differs from the flat route's")
        check(f_agree == 1.0, f"fused_topk_l2: ids disagree with the flat "
                              f"route's ({f_agree})")
        check(f_rel <= 1e-4, f"fused_topk_l2: dists off by {f_rel}")
        check(extra < Qp * Np, f"fused_topk_l2 allocated {extra} bytes, a "
                               f"(Q, N)-sized buffer")
        rows["fused_topk_l2"] = measure_kernel("fused_topk_l2", fused_args,
                                               0)
        rows["fused_topk_l2_f16"] = measure_kernel("fused_topk_l2_f16",
                                                   fused16_args, 0)
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

    serving_s = {}
    if "sharded" in phases:
        dep = sharded_phase(dev, ds, qlo, qhi, k, res.ids, f32_ms, stream)
        if "serving" in phases:
            t0 = time.perf_counter()
            serving_backends(stream, dep, ds, qlo, qhi, k)
            serving_s["backends"] = time.perf_counter() - t0
        del dep
    if "streaming" in phases:
        del stream
        torch.cuda.empty_cache()
    if "flat" in phases:
        del idx, ds, res
        if "trace" not in phases:
            del fused_args, fused16_args

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
        graph_launches = launched(launches)
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
        # gathered_l2_dot on the route's gathered_l2 arguments
        dot_args = cap_l.best
        err, ok = compare_dists(ops.gathered_l2_dot(*dot_args),
                                ref.gathered_l2_ref(*dot_args),
                                RTOL["gathered_l2_dot"])
        emit({"phase": "graph_dot", "shape": list(dot_args[1].shape),
              "max_abs_err_vs_gathered_l2_ref": err,
              "route_launches": launches["gathered_l2_dot"]})
        check(ok, f"gathered_l2_dot disagrees with gathered_l2_ref at the "
                  f"route's shapes (err={err})")
        rows["gathered_l2_dot"] = measure_kernel("gathered_l2_dot", dot_args,
                                                 0)
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

    if "serving" in phases:
        t0 = time.perf_counter()
        serving_front_ends(eng, idx, ds, qlo, qhi, k, F, gres, flat_res,
                           f32_graph_ms, graph_launches)
        serving_s["front_ends"] = time.perf_counter() - t0
        emit({"phase": "serving", "seconds": serving_s,
              "total_s": sum(serving_s.values())})

    if "trace" in phases:
        trace_phase(eng, ds, qlo, qhi, k, fused_args, fused16_args, dot_args,
                    f32_steps, rows)

    name = torch.cuda.get_device_name(0)
    if rows:
        emit({"kernels": [rows[key] for key in KERNELS if key in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
