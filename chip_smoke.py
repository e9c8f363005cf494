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
    python3 chip_smoke.py --phases env,train
                                     # training alone
    python3 chip_smoke.py --phases env,train_mesh
                                     # olmo-1b trained over two ranks
    python3 chip_smoke.py --phases env,flat,tools
                                     # the launch tools: the blocked scan,
                                     # FLOPs counted on the card and on
                                     # fake tensors, the dry-run on fake
                                     # ranks

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
4. ``flat``: the flat route at n = 1M, d = 128 (the SIFT1M shape), one
   ``fused_topk_l2`` launch, checked against a float64 NumPy brute force;
   then the unfused path (``pairwise_l2_masked``, then a select, as k > 32
   runs it) on the inputs the route handed to ``fused_topk_l2``: ids
   equal to the route's, distances bit-equal; the fused kernel without a
   (Q, N) buffer; each of its launches' device time over a float32 and a
   float16 corpus.
5. ``graph``: an MSTG index built by the port's bulk builder (on the host,
   in the background from the run's start: the phases before ``graph``
   run beside the build), served on the graph route with Q = 256,
   checked against the port's CPU run on the same index; recall against
   the flat route is printed as information;
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
   segment, 500 rows of the second upserted into the delta; that op
   sequence runs on the host in the background once the LM phases are
   done, beside training), every route
   served: flat against a float64 brute force over the live rows by
   external id, pruned recall 1.0 against flat, graph agreement ≥ 0.99
   with the port's CPU run of the same index on 32 queries; kernels 1 and
   3 held against their plain versions at the widest beam (1,010, from
   the tombstones), kernel 7 at the flat route's widest scan (kernel 5
   where a segment's tombstones widen k past 32). Then a size-tiered
   compaction: the policy must pick the two small segments, the exact
   routes' ids must not change and allocated device bytes must fall.
12. ``sharded``: ``repro_torch.distributed.ShardedDeployment.flat`` over
   the flat phase's corpus on D = 4 logical shards of the card, under the
   ``all_gather``, ``tournament`` and ``host`` merges: ids bit-equal to one
   another and to the flat route, four ``fused_topk_l2`` launches a
   request; shard 3 failed (degraded, the flat answer over the other
   rows, three launches); ``per_shard_k = 5``; and ``from_segmented`` over
   the streaming phase's index on D = 2, equal to the index's own pruned
   answer. Asking for it pulls in ``flat`` and ``streaming``.
   ``sharded_ranks`` (pulls in ``sharded``): the same corpus one shard a
   rank. (a) ``ShardedDeployment.flat`` on a one-rank NCCL mesh: ids and
   dists bit-equal to the flat route's, one ``fused_topk_l2``
   launch. (b) Four gloo ranks on the card (NCCL refuses two ranks on one
   GPU), a (data 4) mesh started with the ``spawn`` method, the corpus
   passed as ``.npy`` memmaps: under each merge each rank's ids and dists
   equal the ``sharded`` phase's answer and the flat route's, one kernel-7
   launch a rank, 130,000,000 staged corpus bytes a rank (a fourth of the
   float32 rows and ranges), shard 3 failed giving ``(3,)`` on every rank
   and the answer over the other rows; ``per_shard_k=5`` (recall
   reported); the build layout at 4 x 4,000 rows, each rank building its
   own slice, on the graph route (kernels 1 and 3 on every rank, ids equal
   a logical D = 4 build of the same rows on rank 0 under ``tournament``
   and on every rank under ``all_gather``); ``launch.serve.main(["--shards",
   "4", "--n", "1200", "--requests", "24"])`` on every rank, 24 served, 24
   non-empty. Then the async server on the ranks (rank 0's scheduler,
   clock and embedder decide each round and broadcast it): (d) over the
   flat layout (all_gather), 256 queries in four waves of 64 on rank 0's
   ``perf_counter``, ``SLOPolicy(max_wait_ms=1.0, max_batch=64)``, shard 3
   failed for wave 3: every rank's outcomes equal rank 0's, ids equal the
   flat route's (wave 3's the ``sharded`` phase's shard-3-failed answer),
   one kernel-7 launch a rank a round its shard is up, kernel 7 held
   against its plain version at the round's shape on rank 0; (e) over the
   build layout, its 64 queries: ids equal the batched rank answer,
   kernels 1 and 3 on every rank; (f) ``launch.serve.main`` with
   ``--async`` on every rank, 24 served, 24 non-empty, summaries equal but
   ``seconds``. Reported: request ms by schedule beside the logical
   deployment's, the collectives' calls and staged bytes a request; the
   async rounds, steps, broadcasts and staged bytes a round, rank 0's e2e
   and queue-wait p50 / p99 beside the logical D = 4 async server's.
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
   (ids and dists equal to the batched flat route's, ties included;
   kernel 7 held at its micro-batch shape); and ``RetrievalServer`` over
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
   qwen3-moe-30b-a3b, recurrentgemma-2b, rwkv6-7b, deepseek-v3-671b,
   seamless-m4t-large-v2 (16 frames) and llava-next-mistral-7b (its
   patches; both with ``wq`` times ``SMOKE_FRONT_WQ_SCALE``) (float32, one
   CPU init each): tokens on the card equal the CPU's, last logits within
   1e-4. olmo-1b at full width in bfloat16
   (16 x 2048, vocab 50,304), B = 8 prompts of 128 tokens, 32 new: init
   s, prefill ms, decode ms a token against the bytes a step reads (the
   parameters and the caches) over the HBM rate, tokens/s, peak
   allocated bytes, one prefill's and one decode step's device busy share
   (torch.profiler); the port's ``flash_attention`` timed beside
   ``scaled_dot_product_attention`` at the prefill's shapes
   (a yardstick, not on the path). The same weights in float64: greedy
   tokens equal argmax over repeated full prefills (8 steps); in float32,
   on a (2, 32) prompt, every layer's output on the card from the CPU's
   input (and the head's logits) within 1e-3 of the CPU's. The reference's
   init makes the full-width model amplify rounding to O(1) logits, so
   float32's teacher forcing and end-to-end logits are reported, not held,
   beside the CPU logits' move under a 1e-7 relative change of the
   weights. Then, each after freeing the device memory of what ran
   before, qwen3-moe-30b-a3b (``lm_moe_full``: 24 of its 48 layers, cut
   for the run's time limit, x 2048, 128 experts top-8, 31.2 GB),
   recurrentgemma-2b and rwkv6-7b (``lm_rec_full``),
   seamless-m4t-large-v2 (``lm_encdec_full``: 24 encoder and 24 decoder
   layers x 1024, 4.07 GB, on 512 frames of width 1,024; the encoder
   timed alone too) and llava-next-mistral-7b (``lm_vlm_full``: 32 x
   4096, 14.49 GB, after 576 patches of width 1,024, ``max_len`` 768) at
   their published widths and full depth (the MoE's cut above) in
   bfloat16, seeded random
   weights, the same load and report, the decode bound counting what a
   step reads (the parameters but the encoder, the front end's
   projection and an untied embedding table, and every cache leaf, self
   and cross, at its capacity); for the MoE the prefill's dropped
   assignments at capacity factor 1.25, by sequence beside the distinct
   experts a sequence and the batch chose, and the decode step's byte bound
   counting only the experts its router chose, beside the design's (all
   128 a layer). Held on each: float64 greedy tokens (a (2, 32) prompt,
   16 new; 64 frames, or the 576 patches) equal teacher forcing in one
   causal forward, on the first layers of the same weights (qwen3-moe 2,
   rwkv6 4, llava 4, seamless 4 encoder and 4 decoder layers,
   recurrentgemma all; the MoE at a capacity factor that drops nothing),
   beside the decode path's float64 logits against the forward's and the
   forward's move under a 1e-12 relative change of the weights (seamless
   at full depth too, reported: there that move is O(1)), and each
   distinct layer kind in float32 on the card within 1e-3 of the CPU's
   from the CPU's input (an encoder layer ``enc:attn+dense``, a cross layer ``attn+dense+cross``
   fed the CPU's encoder output, the front end's ``frontend_proj``). Then
   ``repro_torch.launch.serve.main`` in-process in each mode (plain,
   ``--async``, ``--streaming --n 400``, ``--shards 4 --n 1200``,
   ``--arch qwen3-moe-30b-a3b`` with ``--route graph`` and with ``--route
   flat``, ``--arch seamless-m4t-large-v2 --route graph`` and ``--arch
   llava-next-mistral-7b --route flat``): 24 of 24 requests served, none
   empty; the streaming mode launches kernel 7 on its delta, each graph
   mode kernels 1 and 3 and each flat mode kernel 7, all through
   ``QueryEngine``. The LM path runs no hand-written kernel (the
   reference's has no Pallas kernel).
16. ``train``: training (no hand-written kernel either: the reference's
   training reaches no Pallas kernel). (a) ``train_smoke``: one
   ``make_train_step`` of each of the ten smoke configs on the card and
   on the CPU from one CPU init (the leaves in ``TRAIN_CONDITIONING``
   scaled, as the CPU parity tests scale them) and one ``TokenLoader``
   batch: loss and grad_norm within 1e-4 relative, every updated
   parameter, ``m`` and ``v`` leaf within 1e-4. (b) ``train_microbatch``:
   ``microbatches=2`` against 1, the parameters at rtol 2e-4, atol 2e-5,
   ``grad_norm``, ``m`` and ``v`` within 1e-5, and against the CPU's
   ``microbatches=2`` within 1e-4. (c)
   ``train_resume``: ``TrainLoop`` 4 steps straight against 2, a
   ``Checkpointer`` save, a fresh restore and 2 more, bit-equal, under
   ``torch.use_deterministic_algorithms`` (``CUBLAS_WORKSPACE_CONFIG`` is
   set to ``:4096:8`` before the card is touched). ``train_full``:
   olmo-1b at its published widths in bfloat16 with per-unit remat, 2
   sequences of 4,096 tokens a step (TRAIN_4K's length; its global batch
   cut to one card): step ms by CUDA events (median of 4 after a warm-up
   step), tokens/s, ``mfu`` (model FLOPs 6 N T + 6 L S H Dh T over the
   bfloat16 peak), the bound (bfloat16 products over the bfloat16 peak
   plus the float32 attention products over the float32 peak, against
   the state's bytes), one step's kernels and device idle share, the clip
   and AdamW update alone, peak bytes and every step's loss. (f)
   ``train_ckpt_full``: the 11.8 GB of parameters and optimizer state
   through a ``Checkpointer`` round trip, bit-equal, seconds to write and
   to read. (d) ``train_f64_grad``: float64 on the first 4 layers,
   autograd's directional derivative within 1e-6 of the fourth-order
   central difference at h = 1e-5 (the two-point one at h = 1e-3 to 1e-6,
   and 8, 12 and 16 layers at h = 1e-4 to 1e-10, reported). (e)
   ``train_f32_layers``: olmo-1b's ``attn+dense`` and qwen3-moe-30b-a3b's
   ``attn+moe`` (aux included, a capacity factor that drops nothing)
   forward and backward in float32 at full width, output and every
   gradient within 1e-3 of the CPU's. (g) ``train_driver``:
   ``launch.train.main`` with ``--preset 100m`` for 30 steps at the
   default batch (reported) and with ``--batch 512 --seq 16`` (the same
   512 documents every step; the last 5 losses' mean below the first
   5's), and ``--preset smoke``.
17. ``lm_mesh``: qwen3-moe-30b-a3b at full width on a mesh of ranks (no
   hand-written kernel either). (a) ``ServeEngine(lm, params, mesh=)`` on
   a one-rank NCCL process group, a (data 1, model 1) mesh, with the
   model ``lm_moe_full`` holds (or, without ``lm``, one made from the same
   seed): the MoE takes ``_moe_full_ep`` (``mesh.counts``) and the
   bfloat16 tokens (B = 8, 128 + 32) are bit-equal to the mesh-less run.
   (b) With the model freed, two ranks on the one card over gloo (NCCL
   refuses two ranks on one GPU), a (data 1, model 2) mesh, started with
   the ``spawn`` method: each draws its shard with ``init_tree(...,
   mesh=)`` from the same seed; held: its parameter bytes equal the
   metas' reckoning under ``SERVE_RULES`` and are at most 0.55 of the
   whole; float32 layer 0 on the mesh (the MoE alone, and attention +
   MoE through ``segment_apply``'s per-unit gather) within 1e-3 of the
   scale of rank 0's mesh-less run on the gathered float32 weights, and
   those gathered weights (all but the experts) equal to the mesh-less
   model's layer 0 by order-free fingerprints taken before it was freed;
   a float32 decode step of layer 0 at position 128 over (8, 256) caches
   whose sequence is split over model (each rank its 128 positions, the
   softmax reduced across the ranks) within 1e-3 of the scale of rank 0's
   mesh-less step over the whole caches; each rank's resident decode
   cache bytes equal to the ``cache_specs`` reckoning, 50,331,648;
   ``generate`` of the first 8 new tokens (each decode step gathers every
   layer's attention leaves through the host) equal on both ranks.
   Reported: the share of those tokens equal to the mesh-less bfloat16
   run's, each rank's peak bytes, prefill and decode ms, the
   collectives' calls and staged bytes, and the world-2 run's wall time.
   (c) olmo-1b at full width in bfloat16 on two gloo ranks of the card, a
   (data 2, model 1) mesh, B = 8 prompts of 128 tokens and 32 new, each
   rank serving its 4 rows over its rows' caches. Held: each rank's rows
   of the gathered tokens bit-equal to a mesh-less ``generate`` of the
   same 4 rows; the gathered tokens equal on both ranks; each rank's
   resident cache bytes 134,217,728, the ``cache_specs`` reckoning.
   Reported: the share of tokens equal to the 8-row mesh-less run, peak
   bytes a rank, prefill and decode ms, wall time.
18. ``train_mesh``: olmo-1b at full width in bfloat16 (remat, 2 x 4,096
   tokens a step, ``train_full``'s seed, batch and optimizer) trained on
   two gloo ranks of the one card, a (data 2, model 1) mesh: FSDP over
   data, one sequence a rank, every collective staged through the host
   (no hand-written kernel: the reference's training reaches no Pallas
   kernel). The one-rank step runs first, in this process. Held: each
   rank's parameter bytes are half the whole's, the metas' reckoning
   under ``DEFAULT_RULES``; the first mesh step's loss and grad_norm
   within ``TRAIN_MESH_LOSS_RTOL`` / ``TRAIN_MESH_GNORM_RTOL`` of the
   one-rank step's, equal on both ranks; float32 unit 0 (``attn+dense``)
   and the embedding forward and backward on the mesh, each rank's
   gradient slice within 1e-3 of the scale of rank 0's mesh-less
   gradient's, and within 1e-6 of that run's taken one row at a time
   (the products' row count sets their float32 rounding); AdamW on each
   rank's shards bit-equal to the slice of the whole update, leaf by
   leaf; finite losses. Reported: step ms (CUDA
   events, ``TRAIN_MESH_TIMED`` steps after the first), the collectives'
   calls and staged bytes a step, each rank's peak bytes and the world-2
   wall time.
19. ``tools``: the launch tools (pulls in ``flat``). ``tools_blocked``:
   ``repro_torch.core.flat.flat_search_blocked`` on the flat route's scan
   arguments (the 1M corpus already on the card, Q = 256, 10%
   selectivity, k = 10) in blocks of 4,096 rows: one ``pairwise_l2_masked``
   launch a block, distances bit-equal to the flat route's, ids equal
   wherever a row's distances are distinct, within 1e-4 of the float64
   brute force; its ms beside ``flat_search``'s. ``tools_flops`` (inside
   ``lm``, on its olmo-1b at full width, or on one made from the same
   seed): one decode step (B = 8 at position 128 of 256) counted by
   ``FlopCounterMode`` on the card and by the dry-run's ``count_step`` on
   fake tensors of the same shapes, held equal, with ``model_flops``
   beside. ``tools_dryrun``: ``python -m repro_torch.launch.dryrun --arch
   olmo-1b --shape decode_32k --mesh single_pod``, the roofline of that
   cell and ``repro_torch.launch.dryrun_mstg``'s six cells, run as
   subprocesses one after another from the run's start, in the background
   as the graph build (no card shown to them, each within its time
   limit, records under ``build/tools/``): each exits with 0, every
   status is ``ok``, 256 and 512 ranks; each cell's per-rank bytes,
   FLOPs, collective bytes and terms against the card's peaks reported.

Launch counts are set to 0 just before each main-path run (flat, graph,
each tier's flat and graph run, the ``trace`` phase's kernel calls, the
path of ``gathered_l2_dot``, which no route calls,
each streaming and sharded request, each serving run, the baselines' card
search, each ``launch.serve`` mode and the blocked scan) and read just
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
import concurrent.futures
import contextlib
import json
import math
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
              "trace", "streaming", "sharded", "sharded_ranks", "serving",
              "baselines", "lm", "lm_mesh", "train", "train_mesh", "tools")
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


def flat_route_kernel(k: int, n: int) -> str:
    """The scan ``flat_search`` launches for the k nearest of n float32
    rows: ``fused_topk_l2`` (kernel 7, scan and top-k in one pass) for
    1 <= k <= min(32, n), else ``pairwise_l2_masked`` (kernel 5, then a
    select over its (Q, N) matrix)."""
    from repro_torch.kernels import ops
    return ("fused_topk_l2" if 1 <= k <= min(ops.FUSED_TOPK_MAX_K, n)
            else "pairwise_l2_masked")


def unfused_flat(scan_args, k: int):
    """The flat route's path for k > 32, called directly at any k: kernel
    5's (Q, N) matrix over ``scan_args`` (``pairwise_l2_masked``'s), then
    ``_smallest_stable``. Returns ((Q, k) int32 ids, NO_EDGE where the
    distance is not finite, and (Q, k) float32 dists)."""
    import torch
    from repro_torch.core.flat import _smallest_stable
    from repro_torch.kernels import ops
    vals, cols = _smallest_stable(ops.pairwise_l2_masked(*scan_args), k)
    ids = torch.where(torch.isfinite(vals), cols, ops.NO_EDGE)
    return ids.to(torch.int32), vals


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


def streaming_build(dev, args, Qn: int) -> dict:
    """The streaming index's op sequence, host work only (the three
    flushes build on the host; nothing is staged on the card until a
    request): segments A (20k rows), B and C (10k each), a 16k-row delta,
    1,000 tombstones in A and 500 rows of B upserted into the delta. It
    runs on the background builder thread (:func:`keep_in_background`)
    once the LM phases are done, beside training."""
    import numpy as np
    from repro_torch.core import IndexSpec, Overlaps
    from repro_torch.data import make_range_dataset
    from repro_torch.streaming import CompactionPolicy, SegmentedIndex

    t_wall = time.perf_counter()
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
    return {"ds": ds, "spec": spec, "index": sidx, "flush_build_s": build_s,
            "seg_b": seg_b, "seg_c": seg_c, "n_rows": n_rows,
            "deleted": deleted, "moved": moved, "new_rows": new_rows,
            "wall_s": time.perf_counter() - t_wall}


def streaming_phase(dev, args, Qn: int, k: int, job) -> dict:
    """The streaming path (``repro_torch.streaming``) on the index that
    :func:`streaming_build` (``job``, in the background) made: every route
    checked; then a size-tiered compaction. Sizes scale with
    ``--stream-n`` (70,000 gives those of :func:`streaming_build`).
    Returns the index, its pruned request and that request's ids after the
    compaction."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core import ANY_OVERLAP, SearchRequest
    from repro_torch.data import recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.streaming import SegmentedIndex

    t0 = time.perf_counter()
    built = job.result()
    waited = time.perf_counter() - t0
    ds, spec, sidx = built["ds"], built["spec"], built["index"]
    seg_b, seg_c = built["seg_b"], built["seg_c"]
    n_rows, deleted = built["n_rows"], built["deleted"]
    moved, new_rows = built["moved"], built["new_rows"]
    ext, live = streaming_corpus(ds, n_rows, deleted, moved, new_rows)
    emit({"phase": "streaming_build", "n_live": len(sidx),
          "segments": [{"id": s.seg_id, "n": s.n, "tombstones": len(s.tombs)}
                       for s in sidx.segments],
          "delta": len(sidx.delta), "delta_capacity": sidx.delta._cap,
          "workers": args.workers, "flush_build_s": built["flush_build_s"],
          "built_in_background": True, "build_wall_s": built["wall_s"],
          "waited_s": waited, "ops": dict(sidx.ops)})
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
                        lambda q, c, *a: c.shape[0]) as cp, \
                Capture(ops, "fused_topk_l2",
                        lambda q, c, *a: c.shape[0]) as cf:
            res[route] = sidx.execute(request(route, trace=route == "graph"))
        launches[route] = launched(ops.LAUNCHES)
        _, sec = timed_execute(sidx, request(route),
                               reps=1 if route == "graph" else 3)
        ms[route] = sec * 1e3
        # each kernel at its widest call on this path: the graph route's
        # beam over A's tombstones; the flat route's scans, kernel 7 where
        # k is at most 32 (the delta, a segment without tombstones), kernel
        # 5 where a segment's tombstones widen k past it
        for cap in ((ct, cl) if route == "graph"
                    else (cf, cp) if route == "flat" else ()):
            if cap.best is not None:
                measure_kernel(cap.name, cap.best,
                               launches[route].get(cap.name, 0),
                               phase="streaming_kernel")
        del ct, cl, cp, cf
    g = launches["graph"]
    delta_scan = flat_route_kernel(k, len(sidx.delta))
    check(g.get("gathered_topk", 0) > 0 and g.get("gathered_l2", 0) > 0
          and g.get(delta_scan) == 1,
          f"streaming graph request: expected kernels 1 and 3 and one delta "
          f"scan ({delta_scan}), got {g}")
    want = collections.Counter(flat_route_kernel(min(k + len(s.tombs), s.n),
                                                 s.n)
                               for s in sidx.segments)
    want[delta_scan] += 1
    check(launches["flat"] == dict(want),
          f"streaming flat request: {launches['flat']} for "
          f"{len(sidx.segments)} segments and the delta, expected "
          f"{dict(want)}")

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
    D = 4 deployment (the host merge), for the serving phase, beside the
    request ms by schedule and the answers the ``sharded_ranks`` phase is
    held to: the all_gather answer and the one with shard 3 lost."""
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
    scan = flat_route_kernel(k, ds.n // D)
    for merge in ("all_gather", "tournament", "host"):
        t0 = time.perf_counter()
        dep = ShardedDeployment.flat(ds.vectors, ds.lo, ds.hi, mesh=mesh,
                                     spec=DeploymentSpec(n_shards=D,
                                                         merge=merge))
        stage_s[merge] = time.perf_counter() - t0
        out[merge], launches[merge], ms[merge] = served(dep)
        check(out[merge].report.merge == merge,
              f"sharded: asked for {merge}, ran {out[merge].report.merge}")
        check(launches[merge] == {scan: D},
              f"sharded {merge}: expected {D} {scan} launches, got "
              f"{launches[merge]}")
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
    check(lost_launches == {scan: D - 1},
          f"sharded: a lost shard was scanned ({lost_launches})")
    check(lost_equal, "sharded: the degraded answer differs from the flat "
                      "route over the live shards' rows")
    check(seg_equal, "sharded from_segmented: ids differ from the "
                     "SegmentedIndex's own pruned answer")
    check(shared and seg_mem1 - seg_mem0 < 64 << 20,
          f"sharded from_segmented: the views staged segments again "
          f"(engines shared: {shared}; allocated {seg_mem0} -> {seg_mem1})")
    return {"dep": dep, "request_ms": ms, "ids": a.ids, "dists": a.dists,
            "lost_ids": lost.ids, "lost_dists": lost.dists,
            "per_shard_k5_ms": nms}


# ---- sharded retrieval on a mesh of ranks ----------------------------------

# (b): D ranks on the one card over gloo (NCCL refuses two ranks on one
# GPU), a (data D) mesh, started with the spawn method and joined within
# these limits
RANKS_D = 4
RANKS_LIMIT_S, RANKS_GRACE_S = 300, 60
RANKS_MERGES = ("all_gather", "tournament", "host")
# the build layout: rows a rank and queries, graph route
RANKS_BUILD_N, RANKS_BUILD_Q = 4_000, 64
RANKS_SERVE_ARGV = ["--shards", str(RANKS_D), "--n", "1200",
                    "--requests", "24"]
# the async server on the ranks: (d) the flat layout's queries in waves,
# shard D - 1 failed for one of them
RANKS_ASYNC_POLICY = dict(max_wait_ms=1.0, max_batch=64)
RANKS_ASYNC_WAVES, RANKS_ASYNC_FAILED_WAVE = 4, 2
# host threads a rank (torch's and, through OMP_NUM_THREADS, numpy's): the
# ranks and this process's logical build share the host's CPUs
RANKS_THREADS = 2


def ranks_build_spec():
    """The build layout's index: the serving driver's m and ef_con on
    graph-50k's predicate."""
    from repro_torch.core import IndexSpec, Overlaps
    return IndexSpec(predicate=Overlaps(), m=12, ef_con=64)


def ranks_logical_build(dev, args) -> dict:
    """The build layout's rows and queries, and the logical D = 4
    ``ShardedDeployment.build`` of them on the card (graph route) that the
    ranks' answers are held to. Host work but the engines' few range
    tensors; it runs on the background builder thread after the streaming
    build (:func:`keep_in_background`). Its shards' heartbeats never time
    out: it serves long after it was built."""
    from repro_torch.core import ANY_OVERLAP, EngineConfig
    from repro_torch.data import make_range_dataset
    from repro_torch.distributed import DeploymentSpec, ShardedDeployment
    from repro_torch.launch import make_mesh
    bds = make_range_dataset(n=RANKS_D * RANKS_BUILD_N, d=128,
                             n_queries=RANKS_BUILD_Q, quantize=1024,
                             seed=args.seed + 3)
    bqlo, bqhi = subset_queries(bds, ANY_OVERLAP, 0.10, seed=args.seed + 4)
    t0 = time.perf_counter()
    dep = ShardedDeployment.build(
        bds.vectors, bds.lo, bds.hi,
        mesh=make_mesh((RANKS_D,), ("data",), device=dev),
        spec=DeploymentSpec(n_shards=RANKS_D, merge="all_gather",
                            index=ranks_build_spec(),
                            engine=EngineConfig(route="graph"),
                            build_workers=args.workers,
                            shard_timeout_s=math.inf))
    return {"ds": bds, "qlo": bqlo, "qhi": bqhi, "dep": dep,
            "build_s": time.perf_counter() - t0}


def _ranks_world1(dev, ds, qlo, qhi, k: int, flat_res) -> dict:
    """(a): ``ShardedDeployment.flat`` over the whole corpus on a one-rank
    NCCL process group (a ``file://`` store) and a (data 1) mesh. Held:
    ids and dists bit-equal to the flat route's, one launch of the flat
    route's scan (:func:`flat_route_kernel`). The group is destroyed
    after."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import ANY_OVERLAP, SearchRequest
    from repro_torch.distributed import DeploymentSpec, ShardedDeployment
    from repro_torch.kernels import ops
    from repro_torch.launch import make_rank_mesh
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")       # one host
    store_dir = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(store_dir, 'store')}",
        rank=0, world_size=1)
    try:
        mesh = make_rank_mesh((1,), ("data",), device=dev)
        dep = ShardedDeployment.flat(ds.vectors, ds.lo, ds.hi, mesh=mesh,
                                     spec=DeploymentSpec(n_shards=1))
        req = SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=k)
        dep.execute(req)
        torch.cuda.synchronize()
        ops.reset_launches()
        mesh.counts.clear()
        got = dep.execute(req)
        launches = launched(ops.LAUNCHES)
        counts = dict(mesh.counts)
        _, sec = timed_execute(dep, req, reps=5)
        del dep
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    out = {"backend": "nccl", "mesh": {"data": 1}, "request_ms": sec * 1e3,
           "launches": launches, "counts": counts,
           "ids_bit_equal_flat_route": bool(np.array_equal(got.ids,
                                                           flat_res.ids)),
           "dists_bit_equal_flat_route": bool(np.array_equal(
               got.dists, flat_res.dists))}
    check(out["ids_bit_equal_flat_route"]
          and out["dists_bit_equal_flat_route"],
          "sharded_ranks (a): the one-rank NCCL mesh's answer differs from "
          "the flat route's")
    scan = flat_route_kernel(k, ds.n)
    check(launches == {scan: 1},
          f"sharded_ranks (a): expected one {scan} launch, got {launches}")
    return out


def _ranks_async(dep, mesh, queries, qlo, qhi, k: int, waves: int,
                 failed_wave=None, capture=None):
    """The async server over ``dep``, one rank's part of an SPMD run on
    rank 0's ``perf_counter``: the queries in ``waves`` equal waves, each
    drained by ``run_until_idle``, shard D - 1 failed for ``failed_wave``.
    ``capture`` names an ``ops`` entry point whose first call's arguments
    are kept. Returns (the line's record, the outcomes as arrays, the
    captured arguments)."""
    import numpy as np
    import torch
    from repro_torch.core import ANY_OVERLAP
    from repro_torch.kernels import ops
    from repro_torch.serving import AsyncRetrievalServer, SLOPolicy
    D, Q = dep.spec.n_shards, len(qlo)
    per = Q // waves
    embeds, rounds, alive = [0], [0], [0]

    def embed(items):
        embeds[0] += 1
        return queries[np.asarray(items)]

    srv = AsyncRetrievalServer(dep, embed, k=k, ef=64,
                               policy=SLOPolicy(**RANKS_ASYNC_POLICY))
    step = srv.step

    def counted_step():
        got = step()
        if srv.step_stats["dispatched"]:
            rounds[0] += 1
            alive[0] += bool(dep._alive()[dep.rank])
        return got

    srv.step = counted_step
    out = [None] * Q
    torch.cuda.synchronize()
    ops.reset_launches()
    mesh.counts.clear()
    cap = Capture(ops, capture) if capture else contextlib.nullcontext()
    t0 = time.perf_counter()
    with cap:
        for w in range(waves):
            if w == failed_wave:
                dep.fail(D - 1)
            tickets = {srv.submit(i, qlo[i], qhi[i], ANY_OVERLAP): i
                       for i in range(w * per, (w + 1) * per)}
            got = srv.run_until_idle()
            if w == failed_wave:
                dep.restore(D - 1)
            for t, i in tickets.items():
                out[i] = got[t]
    wall = time.perf_counter() - t0
    launches = launched(ops.LAUNCHES)
    counts = dict(mesh.counts)
    snap = srv.snapshot()
    rec = {"rounds": rounds[0], "rounds_shard_up": alive[0],
           "steps": snap["steps"], "embeds": embeds[0], "wall_s": wall,
           "launches": launches, "broadcasts": counts.get("broadcast", 0),
           "staged_bytes": counts.get("staged_bytes", 0),
           "staged_bytes_a_round": counts.get("staged_bytes", 0)
           / max(rounds[0], 1),
           "served": snap["served"], "degraded": snap["degraded"],
           "shed_total": snap["shed_total"],
           "e2e_ms": {p: snap["e2e_ms"][p] for p in ("p50", "p99")},
           "queue_wait_ms": {p: snap["queue_wait_ms"][p]
                             for p in ("p50", "p99")},
           "snapshot": json.dumps(snap, sort_keys=True)}
    served = [bool(o) for o in out]
    arrays = {"served": np.asarray(served)}
    if all(served):
        arrays.update(
            ids=np.stack([o.hit.ids for o in out]),
            dists=np.stack([o.hit.dists for o in out]),
            times=np.asarray([(o.queue_ms, o.e2e_ms) for o in out]),
            flags=np.asarray([(o.degraded, o.deadline_missed)
                              for o in out]))
    return rec, arrays, (cap.best if capture else None)


def _ranks_rank(rank: int, world: int, store: str, data_dir: str, k: int,
                device: str) -> None:
    """(b), one rank of the (data ``world``) mesh over gloo on the card:
    the flat layout over the ``.npy`` memmaps of ``data_dir`` under each
    merge (its staged bytes, one counted request, the timed ones, shard 3
    failed; under ``all_gather`` the async server, (d)),
    ``per_shard_k=5``, the build layout (its own slice built here, graph
    route) under ``tournament`` and ``all_gather`` and then the async
    server, (e), then ``launch.serve.main`` with ``--shards``, and with
    ``--async`` too, (f). Writes ``rank<r>.json`` and ``rank<r>.npz``, or
    ``rank<r>.err`` with the traceback."""
    import datetime
    import gc
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")     # one host
        torch.set_num_threads(RANKS_THREADS)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.core import ANY_OVERLAP, EngineConfig, SearchRequest
        from repro_torch.distributed import DeploymentSpec, ShardedDeployment
        from repro_torch.distributed.topk import local_flat_topk
        from repro_torch.kernels import ops, ref
        from repro_torch.launch import make_rank_mesh, serve
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_rank_mesh((world,), ("data",), device=dev)

        def load(name, **kw):
            return np.load(os.path.join(data_dir, name + ".npy"), **kw)

        def request(prefix):
            return SearchRequest(load(prefix + "queries"),
                                 (load(prefix + "qlo"), load(prefix + "qhi")),
                                 ANY_OVERLAP, k=k)

        def served(dep, req, reps):
            """One counted request after a warm one, then the timed ones:
            (result, launches, collective counts, ms)."""
            dep.execute(req)
            torch.cuda.synchronize()
            ops.reset_launches()
            mesh.counts.clear()
            got = dep.execute(req)
            launches = launched(ops.LAUNCHES)
            counts = dict(mesh.counts)
            _, sec = timed_execute(dep, req, reps=reps)
            return got, launches, counts, sec * 1e3

        corpus, lo, hi = (load(n, mmap_mode="r") for n in ("corpus", "lo",
                                                            "hi"))
        req = request("")
        res, arrays = {"rank": rank, "coord": mesh.coord["data"]}, {}

        def scan_ms(dep):
            """This rank's scan and top-k alone, as a request runs them
            (CUDA events, median of 5)."""
            args = (*dep._flat, *dep._query_tensors(req))
            shard = dep.shards[dep.rank]
            return time_ms(lambda: local_flat_topk(
                *args, mask=req.mask, k=k, offset=shard.id_offset),
                reps=5, warmup=1)

        for merge in RANKS_MERGES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            dep = ShardedDeployment.flat(
                corpus, lo, hi, mesh=mesh,
                spec=DeploymentSpec(n_shards=world, merge=merge))
            torch.cuda.synchronize()
            stage_s = time.perf_counter() - t0
            alloc = torch.cuda.memory_allocated() - mem0
            got, launches, counts, ms = served(dep, req, reps=5)
            if merge == "all_gather":
                res["scan_ms"] = scan_ms(dep)
            dep.fail(world - 1)
            lost = dep.execute(req)
            dep.restore(world - 1)
            if merge == "all_gather":
                # (d): the async server over this deployment, and the flat
                # route's scan at a round's shape against its plain version
                scan = flat_route_kernel(k, dep._flat[0].shape[0])
                rec, out, cap = _ranks_async(
                    dep, mesh, load("queries"), load("qlo"), load("qhi"), k,
                    RANKS_ASYNC_WAVES, RANKS_ASYNC_FAILED_WAVE,
                    capture=scan if rank == 0 else None)
                if cap is not None:
                    got_s = getattr(ops, scan)(*cap)
                    want_s = getattr(ref, scan + "_ref")(*cap)
                    if scan == "fused_topk_l2":
                        err, bad = compare_beams(got_s, want_s, RTOL[scan])
                        ok = bad == 0
                    else:
                        err, ok = compare_dists(got_s, want_s, RTOL[scan])
                    rec["round_scan"] = {
                        "kernel": scan,
                        "shape": [cap[0].shape[0], *cap[1].shape],
                        "max_abs_err": err, "ok": ok, "rtol": RTOL[scan]}
                    del got_s, want_s, cap
                res["async_flat"] = rec
                arrays.update({f"async_flat/{key}": v
                               for key, v in out.items()})
            res[merge] = {
                "stage_s": stage_s, "request_ms": ms, "launches": launches,
                "counts": counts, "merge": got.report.merge,
                "staged_corpus_bytes": sum(t.numel() * t.element_size()
                                           for t in dep._flat),
                "staged_allocated_bytes": alloc,
                "lost_missing_shards": list(lost.report.missing_shards),
                "lost_degraded": lost.degraded}
            arrays[f"{merge}/ids"], arrays[f"{merge}/dists"] = (got.ids,
                                                                got.dists)
            arrays[f"{merge}/lost_ids"] = lost.ids
            del dep
        dep = ShardedDeployment.flat(
            corpus, lo, hi, mesh=mesh,
            spec=DeploymentSpec(n_shards=world, per_shard_k=5))
        got, launches, counts, ms = served(dep, req, reps=3)
        res["per_shard_k5"] = {"request_ms": ms, "launches": launches,
                               "counts": counts}
        arrays["per_shard_k5/ids"] = got.ids
        del dep, corpus, lo, hi

        # the build layout: this rank builds its own slice only
        t0 = time.perf_counter()
        dep = ShardedDeployment.build(
            load("build_vectors", mmap_mode="r"), load("build_lo"),
            load("build_hi"), mesh=mesh,
            spec=DeploymentSpec(n_shards=world, merge="tournament",
                                index=ranks_build_spec(),
                                engine=EngineConfig(route="graph")))
        res["build_s"] = time.perf_counter() - t0
        breq = request("build_")
        for merge in ("tournament", "all_gather"):
            if merge != dep.spec.merge:
                dep = ShardedDeployment(dep.shards,
                                        dep.spec.replace(merge=merge), mesh)
            got, launches, counts, ms = served(dep, breq, reps=3)
            res[f"build_{merge}"] = {
                "request_ms": ms, "launches": launches, "counts": counts,
                "routes": [s.route for s in got.report.shards],
                "missing_shards": list(got.report.missing_shards)}
            arrays[f"build_{merge}/ids"] = got.ids
        # (e): the async server over the all_gather build deployment
        rec, out, _ = _ranks_async(dep, mesh, load("build_queries"),
                                   load("build_qlo"), load("build_qhi"), k, 1)
        res["async_build"] = rec
        arrays.update({f"async_build/{key}": v for key, v in out.items()})
        del dep

        # the serving driver, one shard a rank
        ops.reset_launches()
        t0 = time.perf_counter()
        summary = serve.main(RANKS_SERVE_ARGV)
        res["serve"] = {"main_s": time.perf_counter() - t0,
                        "launches": launched(ops.LAUNCHES),
                        **{key: summary[key] for key in (
                            "mode", "served", "non_empty", "ranks",
                            "degraded_queries", "seconds")}}
        # (f): launch.serve's async server on the ranks
        ops.reset_launches()
        t0 = time.perf_counter()
        summary = serve.main(RANKS_SERVE_ARGV + ["--async"])
        res["serve_async"] = {"main_s": time.perf_counter() - t0,
                              "launches": launched(ops.LAUNCHES),
                              "summary": summary}
        res["peak_allocated"] = torch.cuda.max_memory_allocated()
        np.savez(os.path.join(data_dir, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(data_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(data_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def sharded_ranks_phase(dev, ds, qlo, qhi, k: int, flat_res,
                        flat_ms: float, sharded: dict, job,
                        logical_async=None) -> None:
    """The ``sharded_ranks`` line: sharded retrieval on a mesh of ranks,
    one shard a rank, the merges as collectives. (a)
    :func:`_ranks_world1`. (b) :data:`RANKS_D` gloo ranks on the card,
    :func:`_ranks_rank`: the flat corpus passed to them as ``.npy``
    memmaps under a temporary directory, which each rank reads only its
    rows of; the logical D = 4 ``ShardedDeployment.build`` of the build
    layout's rows (:func:`ranks_logical_build`, ``job``, built in the
    background) serves first on the card. Held, on every rank: the flat
    layout's ids and dists equal to
    the ``sharded`` phase's logical D = 4 answer and to the flat route's
    under each merge, one launch of the flat route's scan
    (:func:`flat_route_kernel`) a request, the staged corpus
    bytes a D-th of the corpus's and its float32 ranges', shard 3 failed
    giving ``missing_shards == (3,)`` and the ``sharded`` phase's answer
    over the other rows; the build layout launching kernels 1 and 3, its
    ids equal to the logical build's on rank 0 under ``tournament`` and on
    every rank under ``all_gather``; ``launch.serve.main`` serving 24
    requests, 24 non-empty; the async server (:func:`_ranks_async`),
    every rank's outcomes and snapshot equal to rank 0's: (d) on the flat
    layout, ids equal to the flat route's (the ``sharded`` phase's
    shard-3-failed answer in the failed wave, degraded there alone), one
    launch of the flat route's scan a rank a round its shard is up, that
    scan against its plain version at the round's shape on rank 0; (e) on
    the build layout, ids equal to the batched rank answer, kernels 1 and
    3 on every rank;
    (f) ``launch.serve.main`` with ``--async``, 24 served, 24 non-empty,
    the summaries equal but ``seconds``. Reported: request ms by schedule
    beside the logical deployment's (gloo on one card stages every merge
    through the host) and a rank's scan alone, the collectives' calls and
    staged bytes a request, ``per_shard_k=5`` recall against the flat
    route; the async rounds, steps, broadcasts, staged bytes a round and
    rank 0's latency percentiles beside ``logical_async``, the
    ``serving`` phase's logical D = 4 async server. The temporary
    directory is removed once the ranks' files are read."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch import multiprocessing as tmp
    from repro_torch.core import ANY_OVERLAP, SearchRequest
    from repro_torch.data import recall_at_k
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    world1 = _ranks_world1(dev, ds, qlo, qhi, k, flat_res)
    free_device()

    # the logical build, served here before the ranks start
    t0 = time.perf_counter()
    built = job.result()
    waited = time.perf_counter() - t0
    bds, bqlo, bqhi = built["ds"], built["qlo"], built["qhi"]
    breq = SearchRequest(bds.queries, (bqlo, bqhi), ANY_OVERLAP, k=k)
    logical = built.pop("dep")
    logical.execute(breq)
    torch.cuda.synchronize()
    ops.reset_launches()
    lres = logical.execute(breq)
    logical_launches = launched(ops.LAUNCHES)
    check(not lres.degraded, f"sharded_ranks: the logical build lost shards "
                             f"{lres.report.missing_shards}")
    _, lsec = timed_execute(logical, breq, reps=3)
    del logical

    data_dir = tempfile.mkdtemp()
    try:
        for name, a in (("corpus", ds.vectors), ("lo", ds.lo), ("hi", ds.hi),
                        ("queries", ds.queries), ("qlo", qlo), ("qhi", qhi),
                        ("build_vectors", bds.vectors), ("build_lo", bds.lo),
                        ("build_hi", bds.hi), ("build_queries", bds.queries),
                        ("build_qlo", bqlo), ("build_qhi", bqhi)):
            np.save(os.path.join(data_dir, name + ".npy"), a)
        t0 = time.perf_counter()
        omp = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = str(RANKS_THREADS)    # the ranks' own
        try:
            ctx = tmp.start_processes(
                _ranks_rank, args=(RANKS_D, os.path.join(data_dir, "store"),
                                   data_dir, k, str(dev)),
                nprocs=RANKS_D, join=False, start_method="spawn")
        finally:
            if omp is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = omp

        ctx.processes[0].join(RANKS_LIMIT_S)
        for p in ctx.processes[1:]:
            p.join(RANKS_GRACE_S)
        hung = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        wall_s = time.perf_counter() - t0
        errs = [open(os.path.join(data_dir, f"rank{r}.err")).read()
                for r in range(RANKS_D)
                if os.path.exists(os.path.join(data_dir, f"rank{r}.err"))]
        check(not hung and not errs,
              f"sharded_ranks: ranks {hung} passed their time limit; {errs}")
        ranks = [json.load(open(os.path.join(data_dir, f"rank{r}.json")))
                 for r in range(RANKS_D)]
        arrs = []
        for r in range(RANKS_D):
            with np.load(os.path.join(data_dir, f"rank{r}.npz")) as f:
                arrs.append(dict(f))
    finally:
        # the corpus's copy (half a GB), the ranks' files and the store
        shutil.rmtree(data_dir, ignore_errors=True)
    # a D-th of the float32 rows and their float32 ranges
    want_staged = (ds.vectors.nbytes + 2 * 4 * ds.n) // RANKS_D
    flat_equal = {m: [bool(np.array_equal(a[f"{m}/ids"], sharded["ids"])
                           and np.array_equal(a[f"{m}/ids"], flat_res.ids)
                           and np.array_equal(a[f"{m}/dists"],
                                              flat_res.dists))
                      for a in arrs] for m in RANKS_MERGES}
    lost_equal = {m: [bool(np.array_equal(a[f"{m}/lost_ids"],
                                          sharded["lost_ids"]))
                      for a in arrs] for m in RANKS_MERGES}
    build_equal = {"tournament_rank0": bool(np.array_equal(
        arrs[0]["build_tournament/ids"], lres.ids)),
        "all_gather_every_rank": [bool(np.array_equal(
            a["build_all_gather/ids"], lres.ids)) for a in arrs]}

    # the async server on the ranks: (d) flat, (e) build, (f) launch.serve
    per = len(qlo) // RANKS_ASYNC_WAVES
    lost_rows = np.zeros(len(qlo), bool)
    lost_rows[RANKS_ASYNC_FAILED_WAVE * per:
              (RANKS_ASYNC_FAILED_WAVE + 1) * per] = True
    want_async = np.where(lost_rows[:, None], sharded["lost_ids"],
                          flat_res.ids)

    def same_as_rank0(layout, r):
        keys = [key for key in arrs[0] if key.startswith(f"async_{layout}/")]
        return (all(key in arrs[r] and np.array_equal(arrs[r][key],
                                                      arrs[0][key])
                    for key in keys)
                and ranks[r][f"async_{layout}"]["snapshot"]
                == ranks[0][f"async_{layout}"]["snapshot"])

    def all_served(layout):
        return [bool(a[f"async_{layout}/served"].all()) for a in arrs]

    served = {layout: all_served(layout) for layout in ("flat", "build")}
    async_equal = {layout: [same_as_rank0(layout, r) for r in range(RANKS_D)]
                   for layout in ("flat", "build")}
    a0 = arrs[0]
    flat_ids_ok = served["flat"][0] and bool(np.array_equal(
        a0["async_flat/ids"], want_async))
    flat_dists_equal = served["flat"][0] and bool(np.array_equal(
        a0["async_flat/dists"][~lost_rows], flat_res.dists[~lost_rows]))
    degraded_ok = served["flat"][0] and bool(np.array_equal(
        a0["async_flat/flags"][:, 0].astype(bool), lost_rows))
    build_ids_ok = [s and bool(np.array_equal(a["async_build/ids"],
                                              a["build_all_gather/ids"]))
                    for s, a in zip(served["build"], arrs)]
    serve_async = [dict(r["serve_async"]["summary"]) for r in ranks]
    for s in serve_async:
        s.pop("seconds")
    r0_flat = ranks[0]["async_flat"]
    scan = flat_route_kernel(k, ds.n // RANKS_D)
    async_line = {
        "policy": RANKS_ASYNC_POLICY, "waves": RANKS_ASYNC_WAVES,
        "failed_wave": RANKS_ASYNC_FAILED_WAVE,
        "flat": {key: [r["async_flat"][key] for r in ranks]
                 for key in ("rounds", "rounds_shard_up", "steps", "embeds",
                             "broadcasts", "staged_bytes_a_round",
                             "launches", "wall_s")},
        "flat_rank0": {key: r0_flat[key] for key in (
            "served", "degraded", "shed_total", "e2e_ms", "queue_wait_ms")},
        "logical_async_d4": logical_async,
        "round_scan_rank0": r0_flat.get("round_scan"),
        "build": {key: [r["async_build"][key] for r in ranks]
                  for key in ("rounds", "steps", "broadcasts",
                              "staged_bytes_a_round", "launches", "wall_s")},
        "build_rank0": {key: ranks[0]["async_build"][key] for key in (
            "e2e_ms", "queue_wait_ms")},
        "serve": [{"main_s": r["serve_async"]["main_s"],
                   "launches": r["serve_async"]["launches"],
                   **r["serve_async"]["summary"]} for r in ranks],
        "equal_rank0": async_equal,
        "flat_ids_equal_flat_route_and_lost": flat_ids_ok,
        "flat_dists_bit_equal_flat_route_up_waves": flat_dists_equal,
        "flat_degraded_in_failed_wave_only": degraded_ok,
        "build_ids_equal_batched": build_ids_ok,
        "serve_summaries_equal": all(s == serve_async[0]
                                     for s in serve_async)}
    emit({"phase": "sharded_ranks", "nvidia_smi": nvidia_smi_line(),
          "n": ds.n, "shards": RANKS_D, "Q": len(qlo), "k": k,
          "world1": world1,
          "world": {"backend": "gloo", "mesh": {"data": RANKS_D},
                    "wall_s": wall_s},
          "request_ms": {m: [r[m]["request_ms"] for r in ranks]
                         for m in RANKS_MERGES},
          "scan_ms": [r["scan_ms"] for r in ranks],
          "logical_request_ms": sharded["request_ms"],
          "flat_route_request_ms": flat_ms,
          "counts_a_request": {m: ranks[0][m]["counts"]
                               for m in RANKS_MERGES},
          "launches": {m: [r[m]["launches"] for r in ranks]
                       for m in RANKS_MERGES},
          "staged_corpus_bytes": [r["all_gather"]["staged_corpus_bytes"]
                                  for r in ranks],
          "staged_allocated_bytes": [r["all_gather"]["staged_allocated_bytes"]
                                     for r in ranks],
          "expected_staged_bytes": want_staged,
          "stage_s": [r["all_gather"]["stage_s"] for r in ranks],
          "ids_dists_equal_logical_and_flat": flat_equal,
          "lost_shard": {"missing_shards": {
              m: [r[m]["lost_missing_shards"] for r in ranks]
              for m in RANKS_MERGES},
              "ids_equal_flat_over_rest": lost_equal},
          "per_shard_k5": {
              "recall_vs_flat": recall_at_k(arrs[0]["per_shard_k5/ids"],
                                            flat_res.ids),
              "request_ms": [r["per_shard_k5"]["request_ms"] for r in ranks],
              "logical_request_ms": sharded["per_shard_k5_ms"]},
          "build": {"rows_a_rank": RANKS_BUILD_N, "Q": RANKS_BUILD_Q,
                    "build_s": [r["build_s"] for r in ranks],
                    "logical_build_s": built["build_s"],
                    "logical_built_in_background": True,
                    "logical_waited_s": waited,
                    "request_ms": {m: [r[f"build_{m}"]["request_ms"]
                                       for r in ranks]
                                   for m in ("tournament", "all_gather")},
                    "logical_request_ms": lsec * 1e3,
                    "launches": [r["build_tournament"]["launches"]
                                 for r in ranks],
                    "logical_launches": logical_launches,
                    "counts_a_request": {
                        m: ranks[0][f"build_{m}"]["counts"]
                        for m in ("tournament", "all_gather")},
                    "ids_equal_logical": build_equal},
          "serve": [r["serve"] for r in ranks],
          "async": async_line,
          "peak_allocated": [r["peak_allocated"] for r in ranks],
          "phase_s": time.perf_counter() - t_phase})
    for r, (res, a) in enumerate(zip(ranks, arrs)):
        for m in RANKS_MERGES:
            check(res[m]["merge"] == m, f"sharded_ranks rank {r}: asked for "
                  f"{m}, ran {res[m]['merge']}")
            check(flat_equal[m][r], f"sharded_ranks rank {r} {m}: ids or "
                  f"dists differ from the logical D = {RANKS_D} answer or "
                  f"the flat route's")
            check(res[m]["launches"] == {scan: 1},
                  f"sharded_ranks rank {r} {m}: expected one {scan} "
                  f"launch, got {res[m]['launches']}")
            check(res[m]["staged_corpus_bytes"] == want_staged
                  and res[m]["staged_allocated_bytes"] <= want_staged
                  + (1 << 20),
                  f"sharded_ranks rank {r} {m}: staged "
                  f"{res[m]['staged_corpus_bytes']} corpus bytes "
                  f"({res[m]['staged_allocated_bytes']} allocated), a "
                  f"{RANKS_D}-th of the corpus is {want_staged}")
            check(res[m]["lost_missing_shards"] == [RANKS_D - 1]
                  and res[m]["lost_degraded"] and lost_equal[m][r],
                  f"sharded_ranks rank {r} {m}: shard {RANKS_D - 1} failed "
                  f"gave {res[m]['lost_missing_shards']} and "
                  f"{'the' if lost_equal[m][r] else 'not the'} flat answer "
                  f"over the other rows")
        launches = res["build_tournament"]["launches"]
        check(launches.get("gathered_topk", 0) > 0
              and launches.get("gathered_l2", 0) > 0,
              f"sharded_ranks rank {r} build: kernels 1 and 3 not launched "
              f"({launches})")
        for m in ("tournament", "all_gather"):
            check(res[f"build_{m}"]["missing_shards"] == [],
                  f"sharded_ranks rank {r} build {m}: shards "
                  f"{res[f'build_{m}']['missing_shards']} lost")
        check(build_equal["all_gather_every_rank"][r],
              f"sharded_ranks rank {r} build all_gather: ids differ from "
              f"the logical build's")
        check(res["serve"]["served"] == 24 and res["serve"]["non_empty"] == 24,
              f"sharded_ranks rank {r}: launch.serve served "
              f"{res['serve']['served']}, {res['serve']['non_empty']} "
              f"non-empty")
    check(build_equal["tournament_rank0"], "sharded_ranks build tournament: "
          "rank 0's ids differ from the logical build's")
    for layout in ("flat", "build"):
        check(all(served[layout]), f"sharded_ranks async {layout}: a query "
              f"was shed ({served[layout]})")
        check(all(async_equal[layout]), f"sharded_ranks async {layout}: "
              f"outcomes differ from rank 0's ({async_equal[layout]})")
    check(flat_ids_ok, "sharded_ranks async flat: ids differ from the flat "
          "route's, or the failed wave's from the sharded phase's "
          "shard-3-failed answer")
    check(degraded_ok, "sharded_ranks async flat: degraded answers outside "
          "the failed wave, or not in it")
    check(r0_flat.get("round_scan", {}).get("ok", False),
          f"sharded_ranks async flat: the flat route's scan differs from "
          f"its plain version at the round's shape "
          f"({r0_flat.get('round_scan')})")
    for r, res in enumerate(ranks):
        fl, bl = res["async_flat"], res["async_build"]
        check(fl["rounds"] == RANKS_ASYNC_WAVES
              and fl["launches"] == {scan: fl["rounds_shard_up"]},
              f"sharded_ranks rank {r} async flat: {fl['rounds']} rounds, "
              f"launches {fl['launches']}, expected one {scan} a round of "
              f"the {fl['rounds_shard_up']} its shard was up")
        check(fl["embeds"] == (fl["rounds"] if r == 0 else 0),
              f"sharded_ranks rank {r} async flat: {fl['embeds']} embeds")
        check(bl["launches"].get("gathered_topk", 0) > 0
              and bl["launches"].get("gathered_l2", 0) > 0,
              f"sharded_ranks rank {r} async build: kernels 1 and 3 not "
              f"launched ({bl['launches']})")
        check(build_ids_ok[r], f"sharded_ranks rank {r} async build: ids "
              f"differ from the batched rank answer")
        sa = res["serve_async"]["summary"]
        check(sa["mode"] == "async" and sa["served"] == 24
              and sa["non_empty"] == 24,
              f"sharded_ranks rank {r}: launch.serve --async served "
              f"{sa['served']}, {sa['non_empty']} non-empty")
    check(async_line["serve_summaries_equal"],
          f"sharded_ranks: launch.serve --async summaries differ: "
          f"{serve_async}")


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


def serving_backends(stream: dict, dep, ds, qlo, qhi, k: int) -> dict:
    """The serving front ends over the mutable and the sharded backend:
    ``RetrievalServer`` on the streaming phase's ``SegmentedIndex``
    (upserts, deletes and queries in one tick), and the async server on the
    sharded phase's 1M-row D = 4 deployment with shard 3 failed. Returns
    the async server's ``serving_snapshot``, which the ``sharded_ranks``
    line sets beside the ranks' async server."""
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
    snap = serving_snapshot(asrv, wall, len(qlo))
    emit({"phase": "serving_sharded", "shards": D, "failed": [D - 1],
          "Q": len(qlo), **snap,
          "launches": launches, "degraded_responses": degraded,
          "dists_bit_equal_batched": bool(np.array_equal(a_d, want.dists)),
          "id_agreement_batched": agree})
    check(degraded == len(qlo), f"serving sharded: {degraded} of "
                                f"{len(qlo)} responses degraded")
    check(launches.get(flat_route_kernel(k, ds.n // D), 0) > 0,
          f"serving sharded: no scan launched ({launches})")
    check(agree == 1.0, f"serving sharded: ids differ from the degraded "
                        f"batched request beyond ties ({agree})")
    return snap


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
    scan = flat_route_kernel(k, ds.n)
    with Capture(ops, scan) as cap_p:
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
    check(ids_equal, "serving flat: ids differ from the batched flat "
                     "route's")
    measure_kernel(scan, cap_p.best, launches.get(scan, 0),
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
# lm_rec_full / lm_encdec_full / lm_vlm_full with the depth their float64
# teacher forcing keeps, of the decoder and of an encoder (None: every
# layer; float64 copies of all layers would not fit the card, except
# seamless's, see F64_FULL_REPORT).
LM_SMOKE_ARCHS = ("olmo-1b", "gemma3-1b", "qwen3-moe-30b-a3b",
                  "recurrentgemma-2b", "rwkv6-7b", "deepseek-v3-671b",
                  "seamless-m4t-large-v2", "llava-next-mistral-7b")
LM_FULL = (("lm_moe_full", "qwen3-moe-30b-a3b", 2),
           ("lm_rec_full", "recurrentgemma-2b", None),
           ("lm_rec_full", "rwkv6-7b", 4),
           ("lm_encdec_full", "seamless-m4t-large-v2", 4),
           ("lm_vlm_full", "llava-next-mistral-7b", 4))
# Models whose float64 teacher forcing is also run, and reported, at full
# depth: seamless's 24 + 24 layers fit the card in float64, but under the
# reference's init they amplify float64 rounding to O(1) logits (its line's
# logits_moved_by_1e-12_weights), so its held check takes 4 + 4 layers.
F64_FULL_REPORT = ("seamless-m4t-large-v2",)
# an encoder-decoder's frames at full width (a smoke config takes 16)
FULL_ENC_LEN = 512
# Under the init as drawn, the front-end smoke configs' attention scores
# have a std of ~16, and float32 rounding in another summation order alone
# moves their logits past 1e-4 (tests/test_torch_frontends.py): their
# smoke checks take every wq leaf times this, as the tests do.
SMOKE_FRONT_WQ_SCALE = 0.25


def scale_leaves(tree, scales: dict):
    """``tree`` with each leaf named in ``scales`` times its factor."""
    if isinstance(tree, dict):
        return {k: v * scales[k] if k in scales and not isinstance(
                    v, (dict, list)) else scale_leaves(v, scales)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [scale_leaves(v, scales) for v in tree]
    return tree


def front_inputs(cfg, rng, B: int, enc_len: int) -> dict:
    """The config's front-end inputs, float32 like the serving driver's:
    ``frames`` (B, enc_len, frontend_dim) for an encoder-decoder,
    ``patches`` (B, n_frontend_tokens, frontend_dim) for a vision front
    end, nothing otherwise."""
    import numpy as np
    if cfg.n_enc_layers:
        return {"frames": rng.normal(
            0, 1, (B, enc_len, cfg.frontend_dim)).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return {"patches": rng.normal(
            0, 1, (B, cfg.n_frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)}
    return {}


def n_patches(front: dict) -> int:
    """The positions the patches take before the tokens."""
    return front["patches"].shape[1] if "patches" in front else 0


def decode_read_bytes(lm, B: int, max_len: int, enc_len: int) -> dict:
    """The bytes one decode step must read: every parameter but the
    encoder's and the front end's projection (which only the prefill
    reads) and, where the head has weights of its own, the embedding
    table, of which a step reads its B tokens' rows; and every
    decode-cache leaf (self and cross) at its full capacity, which
    ``decode_attention`` reads whole."""
    import math
    from repro_torch.models.params import leaves, tree_bytes
    cfg = lm.cfg
    skip = {"encoder", "frontend_proj"}
    if not cfg.tie_embeddings:
        skip.add("embed")
    params = tree_bytes({k: v for k, v in lm.abstract_params().items()
                         if k not in skip})
    if not cfg.tie_embeddings:
        params += B * cfg.d_model * cfg.pdtype.itemsize
    caches = sum(math.prod(m.shape) * m.dtype.itemsize
                 for m in leaves(lm.decode_cache_meta(B, max_len, enc_len)))
    return {"params": params, "caches": caches, "total": params + caches}


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

    def recorded(p, x, *, cfg, capacity_factor=1.25, **on_mesh):
        records.append(moe.routing(p, x, cfg=cfg,
                                   capacity_factor=capacity_factor))
        return apply(p, x, cfg=cfg, capacity_factor=capacity_factor,
                     **on_mesh)

    moe.moe_apply = recorded
    try:
        yield records
    finally:
        moe.moe_apply = apply


def lm_timed_run(dev, lm, rng, B: int, P: int, n_new: int, max_len: int,
                 front=None):
    """One timed greedy run on the card: the prefill (CUDA events; an
    encoder-decoder's encoder alone too), the seeded caches, ``n_new``
    decode steps each timed with CUDA events; then
    ``ServeEngine.generate`` on the same prompt (untimed, under
    :func:`moe_routing_records`) must give the same tokens; then one
    profiled prefill and decode step. ``front`` holds the batch's frames
    or patches (:func:`front_inputs`); patches count toward the prompt, so
    decoding starts at P + their number. Returns (report, routing
    records, the prompt, ``generate``'s result)."""
    import numpy as np
    import torch
    from repro_torch.serving import ServeEngine, seed_caches
    cfg = lm.cfg
    front = front or {}
    n_front = n_patches(front)
    enc_len = front["frames"].shape[1] if "frames" in front else 0
    eng = ServeEngine(lm, device=dev)
    toks = rng.integers(0, cfg.vocab, (B, P))
    eng.generate({"tokens": toks[:, :16], **front}, n_new=2,
                 max_len=32 + n_front)                          # warm up
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             **{k: torch.as_tensor(v, device=dev) for k, v in front.items()}}
    prompt = P + n_front
    with torch.inference_mode():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        ev[0].record()
        logits, pc = lm.prefill(None, batch)
        ev[1].record()
        caches = seed_caches(lm, pc, B, max_len, prompt, enc_len)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        steps, out = [], []
        for i in range(n_new):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            out.append(cur)
            a.record()
            logits, caches = lm.decode_step(None, caches, cur, prompt + i)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            b.record()
            steps.append((a, b))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_all
        if enc_len:
            ev[2].record()
            lm._encode(lm.params, batch["frames"])
            ev[3].record()
            torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in steps]
    tokens = torch.cat(out, 1).cpu().numpy()
    del pc, logits
    with moe_routing_records() as routing:
        gen = eng.generate({"tokens": toks, **front}, n_new=n_new,
                           max_len=max_len)
    with torch.inference_mode():
        profiles = {
            "prefill": profile_call(lambda: lm.prefill(None, batch)),
            "decode_step": profile_call(
                lambda: lm.decode_step(None, caches, cur, prompt + n_new))}
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
    if front:
        report.update({"frames": enc_len, "patches": n_front,
                       "frontend_dim": cfg.frontend_dim})
    if enc_len:
        report["encode_ms"] = ev[2].elapsed_time(ev[3])
    return report, routing, toks, gen


def moe_routing_report(lm, routing, B: int, P: int, read_bytes: int) -> dict:
    """From one generation's routing records: the prefill's dropped
    assignments at the config's capacity factor, per sequence (token order
    is sequence-major, so a later sequence meets fuller experts) beside the
    distinct experts each sequence chose and the batch chose, a layer's
    busiest expert over its capacity; and each decode step's byte bound
    counting only the experts its router chose (the distinct experts of
    each MoE layer), beside the design's, which reads all E experts a layer
    (the capacity buffer's products run over every expert): ``read_bytes``
    is the design's step, all experts and the caches."""
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
    step_bytes = [read_bytes - n_moe * cfg.n_experts * per_expert
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
    (the same config at a smaller depth, of the decoder and of an
    encoder): each stacked segment keeps its first repeats."""
    from repro_torch.models.params import map_tree

    def cut(seg_params, layout_f, layout_t):
        segs = []
        for sp, seg_f, seg_t in zip(seg_params, layout_f, layout_t):
            check(seg_f.pattern == seg_t.pattern
                  and seg_t.repeats <= seg_f.repeats,
                  f"cut_params: {lm_to.cfg.name} at {lm_to.cfg.n_layers} "
                  f"layers is no cut of its {lm_from.cfg.n_layers}-layer "
                  f"layout")
            if seg_f.repeats == seg_t.repeats:
                segs.append(sp)
            elif seg_t.repeats == 1:
                segs.append(map_tree(lambda t: t[0], sp))
            else:
                segs.append(map_tree(lambda t, r=seg_t.repeats: t[:r], sp))
        return segs

    out = {**params, "segments": cut(params["segments"], lm_from.layout,
                                     lm_to.layout)}
    if lm_to.enc_layout is not None:
        out["encoder"] = {**params["encoder"], "segments": cut(
            params["encoder"]["segments"], lm_from.enc_layout,
            lm_to.enc_layout)}
    return out


def all_logits(lm, tokens, front=None):
    """Logits at every position of ``tokens`` (B, S) in one causal
    forward, which is teacher forcing: the prefill's layers (on the same
    frames through the encoder, or after the same patches), then the head
    on every position instead of the last. With patches, the first
    positions are theirs."""
    import torch
    from repro_torch.models.common import logits_fn, make_norm
    from repro_torch.models.transformer import segment_apply
    cfg, params = lm.cfg, lm.params
    front = front or {}
    with torch.inference_mode():
        x = lm._embed_tokens(params, tokens)
        cross = (lm._encode(params, front["frames"])
                 if lm.enc_cfg is not None else None)
        if "patches" in front:
            x = lm._frontend(params, front, x)
        pos = torch.arange(x.shape[1], device=tokens.device)
        for sp, seg in zip(params["segments"], lm.layout):
            x, _, _ = segment_apply(sp, x, seg, cfg=cfg, mode="prefill",
                                    caches=None, positions=pos,
                                    cur_pos=None, cross_memory=cross)
        _, norm = make_norm(cfg)
        return logits_fn(params.get("head", {}), params["embed"],
                         norm(params["final_norm"], x), cfg.tie_embeddings)


def layers_f32_vs_cpu(dev, lm_cut, params_cpu, toks, front=None):
    """Each distinct layer kind of ``lm_cut`` (mixer + MLP, ``+cross``
    with cross-attention; ``enc:`` for an encoder layer) and the front
    end's projection (``frontend_proj``), in float32, on the card and on
    the CPU from the same input, the CPU's: the first layer of that kind,
    fed the CPU's output of the kind before it (the projected frames for
    the first encoder layer; the embedded tokens, after the projected
    patches, for the first decoder layer); a cross layer reads the CPU's
    encoder output on both. Returns ({kind: max abs error}, {kind: share
    of the tolerance}, whether each is within 1e-3 of the CPU's, atol
    1e-4 of the output's magnitude)."""
    import torch
    from repro_torch.models import LM
    from repro_torch.models.params import map_tree
    from repro_torch.models.transformer import layer_apply
    cfg = lm_cut.cfg.scaled(param_dtype="float32", activ_dtype="float32")
    f32 = lambda t: t.to(torch.float32) if t.is_floating_point() else t
    front = {k: torch.as_tensor(v) for k, v in (front or {}).items()}
    errs, margins, ok_all = {}, {}, True

    def held(kind, fn, *args):
        nonlocal ok_all
        y_c = fn(*args)
        y_g = fn(*map_tree(lambda t: t.to(dev) if torch.is_tensor(t) else t,
                           list(args)))
        got, want = y_g.cpu().numpy(), y_c.numpy()
        errs[kind], ok = _close(got, want, 1e-3)
        margins[kind] = _margin(got, want, 1e-3)
        ok_all &= ok
        return y_c

    def walk(segments, layout, x, pos, cfg_, prefix, cross):
        kw = dict(cfg=cfg_, mode="prefill", cache=None, cur_pos=None)
        for sp, seg in zip(segments, layout):
            for j, desc in enumerate(seg.pattern):
                kind = (prefix + f"{desc.mixer}+{desc.mlp}"
                        + ("+cross" if desc.cross else ""))
                if kind in errs:
                    continue
                pick = (lambda t: t[0]) if seg.repeats > 1 else (lambda t: t)
                lc = map_tree(lambda t: f32(pick(t)), sp[f"L{j}"])
                x = held(kind, lambda p, xx, ps, cm: layer_apply(
                    p, xx, desc, positions=ps, cross_memory=cm, **kw)[0],
                    lc, x, pos, cross)
        return x

    with torch.inference_mode():
        proj = (f32(params_cpu["frontend_proj"]["w"])
                if "frontend_proj" in params_cpu else None)
        project = lambda w, a: a.to(torch.float32) @ w
        cross = None
        if lm_cut.enc_cfg is not None:
            # the CPU's encoder output: the float32 encoder on the CPU
            lm_c = LM(cfg)
            enc_p = map_tree(f32, params_cpu["encoder"])
            xe = held("frontend_proj", project, proj, front["frames"])
            walk(enc_p["segments"], lm_c.enc_layout, xe,
                 torch.arange(xe.shape[1]), lm_c.enc_cfg, "enc:", None)
            cross = lm_c._encode({"embed": params_cpu["embed"],
                                  "frontend_proj": {"w": proj},
                                  "encoder": enc_p}, front["frames"])
        x = f32(params_cpu["embed"]["table"])[torch.as_tensor(toks)]
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model)))
        if "patches" in front:
            x = torch.cat([held("frontend_proj", project, proj,
                                front["patches"]), x], dim=1)
        walk(params_cpu["segments"], lm_cut.layout, x,
             torch.arange(x.shape[1]), cfg, "", cross)
    return errs, margins, ok_all


def f64_teacher_forcing(dev, cfg64, params_cpu, toks, front,
                        n64: int = 16) -> dict:
    """``params_cpu`` in float64 (``cfg64``) on the card: greedy tokens
    from ``ServeEngine.generate`` (``n64`` new after ``toks``, on
    ``front``'s frames or after its patches) against teacher forcing over
    the prompt and the generated tokens in one causal forward
    (:func:`all_logits`). Reports where they differ (the generated
    token's forced logit below the forced maximum), how far the decode
    path's logits on the generated tokens lie from the forward's (both in
    float64), and how far the forward's logits move when every weight
    moves by 1e-12 relative: a control of how much the model amplifies
    rounding."""
    import numpy as np
    import torch
    from repro_torch.models import LM
    from repro_torch.models.params import map_tree
    from repro_torch.serving import ServeEngine, seed_caches
    to64 = lambda t: (t.to(dev, torch.float64) if t.is_floating_point()
                      else t.to(dev))
    lm64 = LM(cfg64)
    lm64.set_params(map_tree(to64, params_cpu))
    P64, n_front = toks.shape[1], n_patches(front)
    enc_len = front["frames"].shape[1] if "frames" in front else 0
    max_len = 64 + n_front
    gen = ServeEngine(lm64, device=dev).generate(
        {"tokens": toks, **front}, n_new=n64, max_len=max_len)
    seq = torch.as_tensor(np.concatenate([toks, gen.tokens], 1), device=dev)
    front_dev = {k: torch.as_tensor(v, device=dev) for k, v in front.items()}
    at = n_front + P64 - 1
    fl = all_logits(lm64, seq, front_dev)[:, at:at + n64]
    with torch.inference_mode():
        lg, pc = lm64.prefill(None, {"tokens": seq[:, :P64], **front_dev})
        caches = seed_caches(lm64, pc, 2, max_len, at + 1, enc_len)
        dl = [lg[:, -1]]
        for i in range(n64 - 1):
            lg, caches = lm64.decode_step(
                None, caches, seq[:, P64 + i:P64 + i + 1], at + 1 + i)
            dl.append(lg[:, -1])
        path_diff = float((torch.stack(dl, 1) - fl).abs().max())
    del pc, caches, dl, lg
    gen_ = torch.Generator(device=dev).manual_seed(0)
    lm64.set_params(map_tree(
        lambda t: t * (1 + 1e-12 * torch.randn(
            t.shape, generator=gen_, device=dev, dtype=t.dtype))
        if t.is_floating_point() else t, lm64.params))
    moved = float((all_logits(lm64, seq, front_dev)[:, at:at + n64]
                   - fl).abs().max())
    fl = fl.cpu().numpy()
    forced = fl.argmax(-1)
    mismatches = [{"seq": int(b), "step": int(i),
                   "forced_gap": float(fl[b, i, forced[b, i]]
                                       - fl[b, i, gen.tokens[b, i]])}
                  for b, i in zip(*np.nonzero(forced != gen.tokens))]
    del lm64, seq, front_dev
    free_device()
    return {"layers": cfg64.n_layers, "enc_layers": cfg64.n_enc_layers,
            "steps": n64,
            "teacher_forcing_equal": not mismatches,
            "mismatches": mismatches,
            "decode_vs_forward_logits_max_abs": path_diff,
            "logits_scale": float(np.abs(fl).max()),
            "logits_moved_by_1e-12_weights": moved}


def lm_full_phase(dev, phase: str, arch: str, depth, seed: int, rng,
                  with_mesh: bool = False):
    """``arch`` at its published widths and full depth in bfloat16 on the
    card, seeded random weights (:func:`lm_timed_run`; a MoE's routing
    with :func:`moe_routing_report`), with ``FULL_ENC_LEN`` frames for an
    encoder-decoder or the config's patches for a vision front end; then
    the held checks on the first ``depth`` layers of the same weights (all
    of them for ``None``): float64 greedy tokens equal teacher forcing, a
    MoE at a capacity factor that drops nothing (>= E / k: a prefill and a
    decode step drop differently at 1.25), and each distinct layer kind
    (the encoder's, the cross layers' and the front end's projection too)
    in float32 on the card within 1e-3 of the CPU's from the CPU's
    input. The decode bound counts what a decode step reads
    (:func:`decode_read_bytes`). With ``with_mesh``, the served model
    also runs on a one-rank NCCL mesh (:func:`mesh_world1`), and the
    return is (that check, the prompt, the mesh-less tokens) for
    :func:`mesh_world2`; ``None`` otherwise."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.models.params import map_tree, tree_bytes
    cfg = (moe_run_config(configs) if arch == MESH_ARCH
           else configs.get_config(arch))
    # the front-end inputs draw from their own generator, so the token
    # draws of every model are those of a run without front ends
    front_rng = np.random.default_rng(seed + 23)
    enc_len = FULL_ENC_LEN if cfg.n_enc_layers else 0
    B, P, n_new = 8, 128, 32
    front = front_inputs(cfg, front_rng, B, enc_len)
    n_front = n_patches(front)
    max_len = -(-(n_front + P + n_new) // 256) * 256       # 256 or 768
    before = free_device()
    lm = LM(cfg)
    pbytes = tree_bytes(lm.abstract_params())
    read = decode_read_bytes(lm, B, max_len, enc_len)
    t0 = time.perf_counter()
    lm.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    report, routing, prompt, gen = lm_timed_run(dev, lm, rng, B, P, n_new,
                                                max_len, front)
    world1 = mesh_world1(dev, lm, prompt, gen, n_new, max_len) \
        if with_mesh else None
    line = {"phase": phase, "arch": arch, "dtype": cfg.param_dtype,
            "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
            "reduced": MOE_REDUCED if arch == MESH_ARCH else [],
            "params": lm.param_count(),
            "active_params": lm.active_param_count(),
            "param_bytes": pbytes, "allocated_before": before,
            "init_s": init_s, **report,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "decode_bytes": read,
            "decode_bound_ms": read["total"] / PEAKS.hbm_bytes_per_s * 1e3,
            "decode_bound_by": "bytes"}
    if cfg.n_experts:
        line["moe"] = moe_routing_report(lm, routing, B, P, read["total"])
    del routing, front
    cut_cfg = cfg if depth is None else cfg.scaled(
        n_layers=depth, n_enc_layers=min(cfg.n_enc_layers, depth))
    lm_cut = LM(cut_cfg)
    full_cpu = map_tree(lambda t: t.cpu(), lm.params) \
        if arch in F64_FULL_REPORT else None
    params_cpu = (cut_params(full_cpu, LM(cfg), lm_cut) if full_cpu
                  else map_tree(lambda t: t.cpu(),
                                cut_params(lm.params, lm, lm_cut)))
    del lm
    free_device()
    # float64: greedy decoding against teacher forcing, a MoE at a
    # capacity factor that drops nothing
    cf = cfg.capacity_factor
    if cfg.n_experts:
        cf = max(cf, cfg.n_experts / cfg.top_k)
    as64 = lambda c: c.scaled(param_dtype="float64", activ_dtype="float64",
                              capacity_factor=cf)
    toks = rng.integers(0, cfg.vocab, (2, 32))
    front64 = front_inputs(cfg, front_rng, 2, 64)
    secs = {}
    t0 = time.perf_counter()
    f64 = f64_teacher_forcing(dev, as64(cut_cfg), params_cpu, toks, front64)
    secs["f64"] = time.perf_counter() - t0
    if full_cpu is not None:
        t0 = time.perf_counter()
        line["f64_full_depth_reported"] = f64_teacher_forcing(
            dev, as64(cfg), full_cpu, toks, front64)
        secs["f64_full_depth_reported"] = time.perf_counter() - t0
        del full_cpu
    t0 = time.perf_counter()
    layer_errs, margins, layers_ok = layers_f32_vs_cpu(dev, lm_cut,
                                                       params_cpu, toks,
                                                       front64)
    secs["f32_layers"] = time.perf_counter() - t0
    line.update({
        "f64_layers": cut_cfg.n_layers,
        "f64_enc_layers": cut_cfg.n_enc_layers,
        "f64_reduced": [] if depth is None else [
            f"n_layers {cfg.n_layers} -> {depth}"
            + (f", n_enc_layers {cfg.n_enc_layers} -> "
               f"{cut_cfg.n_enc_layers}" if cfg.n_enc_layers else "")
            + (" (float64 of every layer does not fit the card)"
               if arch not in F64_FULL_REPORT else
               " (at full depth float64 rounding decides the tokens: "
               "f64_full_depth_reported)")],
        "f64_capacity_factor": cf if cfg.n_experts else None,
        "f64_prompt": [2, 32],
        "f64_frames": front64["frames"].shape[1] if "frames" in front64
        else 0,
        "f64_patches": n_patches(front64),
        "teacher_forcing_equal_f64": f64["teacher_forcing_equal"],
        "f64": f64,
        "f32_layer_max_abs_err": layer_errs,
        "f32_layer_tolerance_share": margins,
        "f32_layers_within_1e-3_of_cpu": layers_ok,
        "check_seconds": secs})
    emit(line)
    check(f64["teacher_forcing_equal"],
          f"{arch} float64 ({cut_cfg.n_layers} layers): greedy tokens "
          f"differ from teacher forcing: {f64['mismatches']}")
    check(layers_ok, f"{arch} float32: a layer is off the CPU's: "
                     f"{layer_errs}")
    del params_cpu
    free_device()
    return (world1, prompt, gen.tokens) if with_mesh else None


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
                    y_c = layer_apply(lc, x, desc, positions=pos, **kw)[0]
                    y_g = layer_apply(lg_, x.to(dev), desc,
                                      positions=pos.to(dev), **kw)[0]
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


def lm_phase(dev, seed: int, with_mesh: bool = False,
             with_tools: bool = False) -> None:
    """The LM and ``ServeEngine`` on the card: smoke-size parity with the
    CPU (every ported family, front ends included), olmo-1b at full width
    in bfloat16 (init, prefill, decode per token against its byte bound,
    memory), float64 and float32 copies of the same weights (teacher
    forcing in float64, the CPU's layers in float32), then
    qwen3-moe-30b-a3b, recurrentgemma-2b, rwkv6-7b, seamless-m4t-large-v2
    and llava-next-mistral-7b the same way (:func:`lm_full_phase`), and
    ``launch.serve.main`` in its four modes and, with the MoE, the
    encoder-decoder and the vision front end, on the graph and flat
    routes. ``with_tools``: the ``tools_flops`` line on olmo-1b's decode
    step (:func:`tools_flops`)."""
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
    # the front-end configs draw their tokens and inputs from their own
    # generator, so every other draw is that of a run without them
    front_rng = np.random.default_rng(seed + 29)
    # 1. smoke size: one CPU init, generated on the CPU and on the card
    for arch in LM_SMOKE_ARCHS:
        cfg = configs.get_smoke_config(arch)
        lm = LM(cfg)
        lm.init(torch.Generator().manual_seed(seed), device="cpu")
        if cfg.frontend:
            lm.set_params(scale_leaves(lm.params,
                                       {"wq": SMOKE_FRONT_WQ_SCALE}))
        toks = (front_rng if cfg.frontend else rng).integers(
            0, cfg.vocab, (2, 16))
        batch = {"tokens": toks, **front_inputs(cfg, front_rng, 2, 16)}
        max_len = 32 + n_patches(batch)
        want = ServeEngine(lm, device="cpu").generate(batch, n_new=8,
                                                      max_len=max_len)
        got = ServeEngine(lm, device=dev).generate(batch, n_new=8,
                                                   max_len=max_len)
        err, ok = _close(got.logits_last, want.logits_last, 1e-4)
        same = bool(np.array_equal(got.tokens, want.tokens))
        emit({"phase": "lm_smoke", "arch": arch, "tokens_equal_cpu": same,
              "frames": batch["frames"].shape[1] if "frames" in batch
              else 0, "patches": n_patches(batch),
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
    read = decode_read_bytes(lm, B, max_len, 0)
    report, _, _, _ = lm_timed_run(dev, lm, rng, B, P, n_new, max_len)
    peak = torch.cuda.max_memory_allocated()
    if with_tools:
        tools_flops(dev, lm, B, P, max_len)
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
          "decode_bytes": read,
          "decode_bound_ms": read["total"] / PEAKS.hbm_bytes_per_s * 1e3,
          "decode_bound_by": "bytes", "flash_attention_ms": fa_ms,
          "sdpa_ms": sdpa_ms})

    # 3. the same weights in float64 and float32 (olmo_held_checks)
    params = lm.params
    del lm, qkv
    olmo_held_checks(dev, cfg, params, rng, seed)
    del params

    # 4. full width: the MoE, the hybrid recurrent model, RWKV-6, the
    # encoder-decoder and the vision front end
    for phase, arch, depth in LM_FULL:
        mesh_args = lm_full_phase(dev, phase, arch, depth, seed, rng,
                                  with_mesh=with_mesh and arch == MESH_ARCH)
        if mesh_args:
            lm_mesh_phase(dev, seed, *mesh_args)

    # 5. the serving driver, in-process, in each mode, and with the MoE,
    # the encoder-decoder and the vision front end. At the driver's 1,500
    # rows the work-model router sends both mask groups to the pruned
    # route (plain torch): the plain mode launches no kernel, the streaming
    # mode the flat route's scan on its delta. The other modes pin the
    # route, so QueryEngine launches kernels 1 and 3 (graph) and the flat
    # route's scan (flat) behind each model's LM endpoint; that scan is
    # kernel 7 at launch.serve's default k of 10 (:func:`flat_route_kernel`).
    scan = flat_route_kernel(10, 400)
    route_kernels = {"graph": ("gathered_topk", "gathered_l2"),
                     "flat": (scan,)}
    for mode in ([], ["--async"], ["--streaming", "--n", "400"],
                 ["--shards", "4", "--n", "1200"],
                 ["--arch", "qwen3-moe-30b-a3b", "--route", "graph"],
                 ["--arch", "qwen3-moe-30b-a3b", "--route", "flat"],
                 ["--arch", "seamless-m4t-large-v2", "--route", "graph"],
                 ["--arch", "llava-next-mistral-7b", "--route", "flat"]):
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
            check(launches.get(scan),
                  f"launch.serve --streaming: {scan} not launched on the "
                  f"delta")
        if "--route" in mode:
            route = mode[mode.index("--route") + 1]
            check(res["routes"][route] == 2
                  and all(launches.get(k) for k in route_kernels[route]),
                  f"launch.serve {mode}: routes {res['routes']}, launches "
                  f"{launches}; the {route} route must launch "
                  f"{route_kernels[route]}")

# ---- the LM on a mesh of ranks -----------------------------------------------


def spawn_ranks(target, world: int, extra: tuple, rank0_limit_s: float,
                grace_s: float, what: str):
    """Run ``target(rank, world, store, out_dir, *extra)`` on ``world``
    processes started with the ``spawn`` method (CUDA is initialised
    here), each writing ``rank<r>.json`` or ``rank<r>.err``: rank 0 is
    joined for ``rank0_limit_s``, each other rank ``grace_s`` more, and
    what is still alive is killed. A rank past its limit or one that
    raised fails the check ``what``. Returns (each rank's JSON, wall s)."""
    import tempfile
    from torch import multiprocessing as tmp
    out_dir = tempfile.mkdtemp()
    t0 = time.perf_counter()
    ctx = tmp.start_processes(
        target, args=(world, os.path.join(out_dir, "store"), out_dir)
        + tuple(extra), nprocs=world, join=False, start_method="spawn")
    ctx.processes[0].join(rank0_limit_s)
    for p in ctx.processes[1:]:
        p.join(grace_s)
    hung = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join()
    wall_s = time.perf_counter() - t0
    errs = [open(os.path.join(out_dir, f"rank{r}.err")).read()
            for r in range(world)
            if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    check(not hung and not errs,
          f"{what}: ranks {hung} passed their time limit; {errs}")
    return ([json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(world)], wall_s)


# the served model split over ranks, and its mesh-less run's shape
MESH_ARCH = "qwen3-moe-30b-a3b"
# MESH_ARCH runs at its published widths on its first MOE_FULL_LAYERS of
# 48 layers (lm_moe_full, both worlds of lm_mesh): the default run's time
# limit (PERF.md §6)
MOE_FULL_LAYERS = 24
MOE_REDUCED = [f"n_layers 48 -> {MOE_FULL_LAYERS} (the default run's time "
               f"limit)"]


def moe_run_config(configs):
    """MESH_ARCH's config as the LM phases run it (:data:`MOE_FULL_LAYERS`),
    from ``configs`` (the port's)."""
    return configs.get_config(MESH_ARCH).scaled(n_layers=MOE_FULL_LAYERS)

MESH_B, MESH_P, MESH_NEW, MESH_MAX_LEN = 8, 128, 32, 256
# world 2: a (data 1, model 2) mesh, two processes on the one card over
# gloo (NCCL refuses two ranks on one GPU), joined within these limits
MESH2_SHAPE = (1, 2)
# new tokens of the world-2 run: each decode step there gathers every
# layer's attention leaves through the host (gloo), so it runs the first
# MESH2_NEW of the mesh-less run's MESH_NEW
MESH2_NEW = 8
MESH2_RANK0_LIMIT_S, MESH2_GRACE_S = 600, 60
# each rank's parameters: at most this share of the whole model's bytes
MESH2_MAX_PARAM_SHARE = 0.55
# each rank's decode caches in the reference's layout: MESH_B rows and
# half of MESH_MAX_LEN positions of the 24 layers' bfloat16 k and v (4 kv
# heads of 128)
MESH2_CACHE_BYTES = 50_331_648


def layer0_fingerprints(layer0, metas0) -> list:
    """Order-free fingerprints of layer 0's leaves but the experts' (a
    leaf whose meta names the ``expert`` axis), in ``leaves`` order: the
    int64 sum, wrapping, of each element's float32 bits times its flat
    index mod 65521 plus one, so equal leaves give equal numbers on any
    rank. ``layer0``: the first repeat of the stacked segment's ``L0``."""
    import torch
    from repro_torch.models.params import leaves
    out = []
    for t, m in zip(leaves(layer0), leaves(metas0)):
        if "expert" in m.axes:
            continue
        bits = t.float().contiguous().view(-1).view(torch.int32)
        w = torch.arange(bits.numel(), device=t.device) % 65521 + 1
        out.append(int((bits.to(torch.int64) * w).sum()))
    return out


def mesh_world1(dev, lm, toks, want, n_new: int, max_len: int) -> dict:
    """(a): ``ServeEngine(lm, lm.params, mesh=)`` on a one-rank NCCL
    process group (a ``file://`` store) and a (data 1, model 1) mesh; the
    MoE must take ``_moe_full_ep`` (counted on the mesh) and the tokens
    must equal the mesh-less ``want`` bit for bit. The group is destroyed
    after."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import make_rank_mesh
    from repro_torch.models.params import map_tree
    from repro_torch.serving import ServeEngine
    store = os.path.join(tempfile.mkdtemp(), "store")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")    # one host
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_rank_mesh((1, 1), ("data", "model"), device=dev)
        init_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ServeEngine(lm, lm.params, mesh=mesh).generate(
            {"tokens": toks}, n_new=n_new, max_len=max_len)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = dict(mesh.counts)
    finally:
        dist.destroy_process_group()
    out = {"backend": "nccl", "mesh": {"data": 1, "model": 1},
           "process_group_s": init_s, "generate_s": wall_s,
           "tokens_bit_equal_meshless": bool(np.array_equal(got.tokens,
                                                            want.tokens)),
           "logits_bit_equal_meshless": bool(np.array_equal(
               got.logits_last, want.logits_last)),
           "counts": counts}
    check(out["tokens_bit_equal_meshless"],
          f"{lm.cfg.name} on a one-rank NCCL mesh: tokens differ from the "
          f"mesh-less run")
    check(counts.get("moe_full_ep", 0) > 0,
          f"{lm.cfg.name} on a one-rank mesh: _moe_full_ep not taken "
          f"({counts})")
    # what world 2's gathered layer 0 is held against (mesh_world2)
    out["layer0_fingerprints"] = layer0_fingerprints(
        map_tree(lambda t: t[0], lm.params["segments"][0]["L0"]),
        lm.abstract_params()["segments"][0]["L0"])
    return out


def _mesh_rank(rank: int, world: int, store: str, out_dir: str, seed: int,
               toks, device: str) -> None:
    """(b), one rank: its shard of the model under SERVE_RULES drawn by
    ``init_tree(..., mesh=)`` on the card, its resident bytes against the
    metas' reckoning, one float32 MoE layer and one float32 attention
    layer on the mesh against rank 0's mesh-less run from the gathered
    float32 weights, then ``ServeEngine(mesh=)``. Writes
    ``rank<r>.json``, or ``rank<r>.err`` with the traceback."""
    import datetime
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    try:
        # one host: gloo's sockets on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch import configs
        from repro_torch.distributed import collectives as coll
        from repro_torch.launch import make_rank_mesh
        from repro_torch.models import LM, moe
        B, P = np.shape(toks)
        from repro_torch.models.params import (SERVE_RULES, init_tree,
                                               leaves, map_tree,
                                               shard_metas, spec_for,
                                               tree_bytes)
        from repro_torch.distributed.sharding import batch_split, rank_box
        from repro_torch.models.transformer import (Segment, cache_unit_specs,
                                                    segment_apply)
        from repro_torch.serving import ServeEngine
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_rank_mesh(MESH2_SHAPE, ("data", "model"), device=dev)
        cfg = moe_run_config(configs)
        lm = LM(cfg)
        metas = lm.abstract_params()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shard = init_tree(metas, torch.Generator(device=dev).manual_seed(seed),
                          dev, mesh=mesh, rules=SERVE_RULES)
        torch.cuda.synchronize()
        res = {"rank": rank, "coord": mesh.coord,
               "init_s": time.perf_counter() - t0,
               "resident_param_bytes": sum(t.numel() * t.element_size()
                                           for t in leaves(shard)),
               "reckoned_param_bytes": tree_bytes(
                   shard_metas(metas, mesh, SERVE_RULES)),
               "whole_param_bytes": tree_bytes(metas),
               "allocated_after_init": torch.cuda.memory_allocated()}

        # float32 layers at full width: layer 0 of the one stacked segment,
        # (i) the MoE alone (full expert parallelism on the mesh), (ii) the
        # whole layer, attention and MoE, through segment_apply's per-unit
        # gather; rank 0 runs both mesh-less on the gathered weights
        cfg32 = cfg.scaled(param_dtype="float32", activ_dtype="float32")
        seg = Segment(lm.layout[0].pattern, 1)
        unit = {"L0": map_tree(lambda t: t[0].float(),
                               shard["segments"][0]["L0"])}
        umeta = {"L0": metas["segments"][0]["L0"]}
        whole = map_tree(lambda t, m: coll.unshard(
            t, spec_for(m, mesh, SERVE_RULES)[1:], mesh), unit, umeta)
        res["layer0_fingerprints"] = layer0_fingerprints(whole["L0"],
                                                         umeta["L0"])
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        x = torch.randn((2, 64, cfg.d_model), generator=g, device=dev)
        pos = torch.arange(x.shape[1], device=dev)
        moe_p = unit["L0"]["mlp"]
        layer = dict(positions=pos, cur_pos=None, mode="prefill",
                     caches=None, cfg=cfg32)
        with torch.inference_mode():
            m_mesh, aux_mesh = moe.moe_apply(
                moe_p, x, cfg=cfg32, mesh=mesh,
                capacity_factor=cfg.capacity_factor, mode="prefill")
            l_mesh, _, _ = segment_apply(
                unit, x, seg, mesh=mesh,
                unshard=lm._unit_unshard(seg, mesh, cfg32, "prefill"),
                **layer)
            if rank == 0:
                m_one, aux_one = moe.moe_apply(
                    whole["L0"]["mlp"], x, cfg=cfg32,
                    capacity_factor=cfg.capacity_factor)
                l_one, _, _ = segment_apply(whole, x, seg, **layer)
                res["f32_layer_rel_err"] = {
                    "moe": float((m_mesh - m_one).abs().max()
                                 / m_one.abs().max()),
                    "attn+moe": float((l_mesh - l_one).abs().max()
                                      / l_one.abs().max()),
                    "moe_aux": float(abs(aux_mesh - aux_one))}
            # (iii) a decode step of the layer at position P over (B,
            # MESH_MAX_LEN) caches whose sequence is split over model:
            # the rank holds its block of the same seeded caches
            ba = batch_split(mesh, B, ("data",))
            cspec = cache_unit_specs(cfg32, seg, mesh, ba, B, MESH_MAX_LEN)
            shape = (B, MESH_MAX_LEN, cfg.n_kv_heads, cfg.head_dim)
            kv = [torch.randn(shape, generator=g, device=dev)
                  for _ in range(2)]
            box = rank_box(mesh, cspec["L0"][0], shape)
            x1 = torch.randn((B, 1, cfg.d_model), generator=g, device=dev)
            step = dict(positions=torch.tensor([P], device=dev), cur_pos=P,
                        mode="decode", cfg=cfg32)
            d_mesh, _, _ = segment_apply(
                unit, x1, seg, mesh=mesh, batch_axes=ba,
                caches={"L0": tuple(t[box].clone() for t in kv)},
                cache_spec=cspec,
                unshard=lm._unit_unshard(seg, mesh, cfg32, "decode"), **step)
            res["decode_block_positions"] = box[1].stop - box[1].start
            if rank == 0:
                d_one, _, _ = segment_apply(
                    whole, x1, seg, caches={"L0": tuple(kv)}, **step)
                res["f32_layer_rel_err"]["decode_attn+moe"] = float(
                    (d_mesh - d_one).abs().max() / d_one.abs().max())
        del unit, whole, moe_p, x, kv, x1
        mesh.counts.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        # the entry point: generate on the mesh, then one timed prefill
        # and decode step
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        eng = ServeEngine(lm, shard, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = eng.generate(batch, n_new=MESH2_NEW, max_len=MESH_MAX_LEN)
        torch.cuda.synchronize()
        res["generate_s"] = time.perf_counter() - t0
        res["counts"] = dict(mesh.counts)
        res["tokens"] = gen.tokens.tolist()
        res["logits_finite"] = bool(np.isfinite(gen.logits_last).all())
        res.update(timed_mesh_step(lm, shard, batch, mesh, MESH_MAX_LEN))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def timed_mesh_step(lm, shard, batch, mesh, max_len: int) -> dict:
    """One timed prefill of ``batch`` and one decode step on ``mesh``
    (CUDA events), the seeded caches between: this rank's resident cache
    bytes beside the ``cache_specs`` reckoning, and its peak bytes since
    the caller's reset."""
    import torch
    from repro_torch.launch.dryrun import laid_out_bytes
    from repro_torch.models.params import leaves
    from repro_torch.serving import seed_caches
    B, P = batch["tokens"].shape
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        ev[0].record()
        logits, pc = lm.prefill(shard, batch, mesh=mesh)
        ev[1].record()
        caches = seed_caches(lm, pc, B, max_len, P, mesh=mesh)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        ev[2].record()
        lm.decode_step(shard, caches, cur, P, mesh=mesh, batch=B,
                       max_len=max_len)
        ev[3].record()
    torch.cuda.synchronize()
    return {"prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms": ev[2].elapsed_time(ev[3]),
            "resident_cache_bytes": sum(t.numel() * t.element_size()
                                        for t in leaves(caches)),
            "reckoned_cache_bytes": laid_out_bytes(
                lm.decode_cache_meta(B, max_len),
                lm.decode_cache_specs(mesh, B, max_len), mesh),
            "peak_allocated": torch.cuda.max_memory_allocated()}


def mesh_world2(dev, seed: int, toks, want_tokens, fingerprints) -> dict:
    """(b): two ranks on the one card over gloo, a (data 1, model 2) mesh:
    experts over model (64 a rank), the attention, vocabulary and head
    tensor-parallel. The caller has freed the model and the card's cache;
    the ranks start with the ``spawn`` method (CUDA is initialised here)
    and draw the same seeded weights as the mesh-less model. Held: each
    rank's resident parameter bytes equal the metas' reckoning under
    SERVE_RULES and are at most MESH2_MAX_PARAM_SHARE of the whole; the
    float32 layers within 1e-3 of the scale; equal tokens on both ranks;
    the fingerprints of rank 0's gathered layer 0 (all leaves but the
    experts') equal to the mesh-less model's, ``fingerprints``
    (:func:`layer0_fingerprints`), so a gather in the wrong rank order,
    which the float32 layer checks share with their mesh-less side, fails.
    Reported: the share of tokens equal to the mesh-less bfloat16 run's."""
    import numpy as np
    world = MESH2_SHAPE[0] * MESH2_SHAPE[1]
    ranks, wall_s = spawn_ranks(_mesh_rank, world, (seed, np.asarray(toks),
                                                    str(dev)),
                                MESH2_RANK0_LIMIT_S, MESH2_GRACE_S, "world 2")
    toks0 = np.asarray(ranks[0]["tokens"])
    out = {"backend": "gloo", "mesh": dict(zip(("data", "model"),
                                               MESH2_SHAPE)),
           "wall_s": wall_s,
           "tokens_equal_across_ranks": all(
               np.array_equal(np.asarray(r["tokens"]), toks0)
               for r in ranks),
           "new_tokens": MESH2_NEW,
           "tokens_agree_with_meshless_share": float(
               (toks0 == np.asarray(want_tokens)[:, :MESH2_NEW]).mean()),
           "f32_layer_rel_err": ranks[0]["f32_layer_rel_err"],
           "ranks": [{k: v for k, v in r.items()
                      if k not in ("tokens", "layer0_fingerprints")}
                     for r in ranks]}
    whole = ranks[0]["whole_param_bytes"]
    for r in ranks:
        check(r["resident_param_bytes"] == r["reckoned_param_bytes"],
              f"world 2 rank {r['rank']}: {r['resident_param_bytes']} "
              f"resident parameter bytes, the metas reckon "
              f"{r['reckoned_param_bytes']}")
        check(r["resident_param_bytes"] <= MESH2_MAX_PARAM_SHARE * whole,
              f"world 2 rank {r['rank']}: {r['resident_param_bytes']} "
              f"parameter bytes of {whole}")
        check(r["logits_finite"], f"world 2 rank {r['rank']}: non-finite "
                                  f"logits")
    out["layer0_gathered_equal_meshless"] = \
        ranks[0]["layer0_fingerprints"] == list(fingerprints)
    check(out["layer0_gathered_equal_meshless"],
          f"world 2: rank 0's gathered layer 0 differs from the mesh-less "
          f"model's: {ranks[0]['layer0_fingerprints']} against "
          f"{list(fingerprints)}")
    errs32 = ranks[0]["f32_layer_rel_err"]
    check(max(errs32["attn+moe"], errs32["moe"],
              errs32["decode_attn+moe"]) <= 1e-3,
          f"world 2: float32 layers off the mesh-less run: {errs32}")
    for r in ranks:
        check(r["resident_cache_bytes"] == r["reckoned_cache_bytes"]
              == MESH2_CACHE_BYTES and r["decode_block_positions"]
              == MESH_MAX_LEN // MESH2_SHAPE[1],
              f"world 2 rank {r['rank']}: {r['resident_cache_bytes']} "
              f"cache bytes ({r['decode_block_positions']} positions), "
              f"the cache_specs layout reckons "
              f"{r['reckoned_cache_bytes']}, expected {MESH2_CACHE_BYTES}")
    check(out["tokens_equal_across_ranks"], "world 2: ranks' tokens differ")
    return out


# (c): olmo-1b's batch split over data, two gloo ranks of the one card, a
# (data 2, model 1) mesh; MESH_B prompts of MESH_P tokens, MESH_NEW new
DATA2_ARCH, DATA2_SHAPE = "olmo-1b", (2, 1)
DATA2_RANK0_LIMIT_S, DATA2_GRACE_S = 300, 60
# each rank's decode caches: 4 of the 8 rows, every one of the 256
# positions of the 16 layers' bfloat16 k and v (16 kv heads of 128)
DATA2_CACHE_BYTES = 134_217_728


def _data2_rank(rank: int, world: int, store: str, out_dir: str, seed: int,
                toks, device: str) -> None:
    """(c), one rank: olmo-1b drawn by ``init_tree(..., mesh=)`` under
    SERVE_RULES (whole on a model axis of one), ``ServeEngine(mesh=)`` on
    the whole batch, the same engine without a mesh on this rank's rows
    (and, on rank 0, on the whole batch), then a timed prefill and decode
    step on the mesh with the resident cache bytes. Writes
    ``rank<r>.json``, or ``rank<r>.err`` with the traceback."""
    import datetime
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host
        from repro_torch import configs
        from repro_torch.launch import make_rank_mesh
        from repro_torch.models import LM
        from repro_torch.models.params import SERVE_RULES, init_tree
        from repro_torch.serving import ServeEngine
        dev = torch.device("cuda", torch.device(device).index or 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_rank_mesh(DATA2_SHAPE, ("data", "model"), device=dev)
        lm = LM(configs.get_config(DATA2_ARCH))
        shard = init_tree(lm.abstract_params(),
                          torch.Generator(device=dev).manual_seed(seed), dev,
                          mesh=mesh, rules=SERVE_RULES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        t0 = time.perf_counter()
        gen = ServeEngine(lm, shard, mesh=mesh).generate(
            batch, n_new=MESH_NEW, max_len=MESH_MAX_LEN)
        torch.cuda.synchronize()
        res = {"rank": rank, "coord": mesh.coord,
               "generate_s": time.perf_counter() - t0,
               "counts": dict(mesh.counts), "tokens": gen.tokens.tolist(),
               "logits_finite": bool(np.isfinite(gen.logits_last).all())}
        n = len(toks) // DATA2_SHAPE[0]
        rows = slice(rank * n, (rank + 1) * n)
        solo = ServeEngine(lm, shard, device=dev).generate(
            {"tokens": batch["tokens"][rows]}, n_new=MESH_NEW,
            max_len=MESH_MAX_LEN)
        res["rows_bit_equal_meshless"] = bool(np.array_equal(
            gen.tokens[rows], solo.tokens))
        if rank == 0:
            whole = ServeEngine(lm, shard, device=dev).generate(
                batch, n_new=MESH_NEW, max_len=MESH_MAX_LEN)
            res["tokens_agree_with_meshless_share"] = float(
                (gen.tokens == whole.tokens).mean())
        res.update(timed_mesh_step(lm, shard, batch, mesh, MESH_MAX_LEN))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def mesh_data2(dev, seed: int) -> dict:
    """(c): olmo-1b at full width in bfloat16 on two gloo ranks of the one
    card, a (data 2, model 1) mesh: each rank serves 4 of the 8 prompts
    over its rows' caches. Held: each rank's rows of the gathered tokens
    bit-equal to a mesh-less ``generate`` of the same 4 rows; the gathered
    tokens equal on both ranks; each rank's resident cache bytes
    DATA2_CACHE_BYTES, the ``cache_specs`` reckoning; finite logits.
    Reported: the share of tokens equal to the 8-row mesh-less run, peak
    bytes a rank, prefill and decode ms, wall time."""
    import numpy as np
    from repro_torch import configs
    free_device()
    toks = np.random.default_rng(seed + 43).integers(
        0, configs.get_config(DATA2_ARCH).vocab, (MESH_B, MESH_P))
    world = DATA2_SHAPE[0] * DATA2_SHAPE[1]
    ranks, wall_s = spawn_ranks(_data2_rank, world, (seed, toks, str(dev)),
                                DATA2_RANK0_LIMIT_S, DATA2_GRACE_S,
                                "lm_mesh (c)")
    toks0 = ranks[0]["tokens"]
    out = {"arch": DATA2_ARCH, "backend": "gloo",
           "mesh": dict(zip(("data", "model"), DATA2_SHAPE)),
           "batch": MESH_B, "prompt": MESH_P, "new_tokens": MESH_NEW,
           "wall_s": wall_s,
           "tokens_equal_across_ranks": all(r["tokens"] == toks0
                                            for r in ranks),
           "tokens_agree_with_meshless_share":
               ranks[0]["tokens_agree_with_meshless_share"],
           "ranks": [{k: v for k, v in r.items() if k != "tokens"}
                     for r in ranks]}
    for r in ranks:
        check(r["rows_bit_equal_meshless"],
              f"lm_mesh (c) rank {r['rank']}: its rows' tokens differ from "
              f"a mesh-less generate of the same rows")
        check(r["resident_cache_bytes"] == r["reckoned_cache_bytes"]
              == DATA2_CACHE_BYTES,
              f"lm_mesh (c) rank {r['rank']}: {r['resident_cache_bytes']} "
              f"cache bytes, the cache_specs layout reckons "
              f"{r['reckoned_cache_bytes']}, expected {DATA2_CACHE_BYTES}")
        check(r["logits_finite"], f"lm_mesh (c) rank {r['rank']}: "
                                  f"non-finite logits")
    check(out["tokens_equal_across_ranks"],
          "lm_mesh (c): the ranks' gathered tokens differ")
    return out


def lm_mesh_phase(dev, seed: int, world1=None, toks=None,
                  want_tokens=None) -> None:
    """The ``lm_mesh`` line: (a) :func:`mesh_world1` and (b)
    :func:`mesh_world2` on MESH_ARCH at full width, then (c)
    :func:`mesh_data2` on olmo-1b. Inside the ``lm``
    phase, (a) ran in ``lm_moe_full`` on its model (``world1``, ``toks``,
    ``want_tokens``); alone, this makes the model from the same seed,
    generates mesh-less, runs (a) and frees the model first."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.serving import ServeEngine
    if world1 is None:
        free_device()
        lm = LM(moe_run_config(configs))
        lm.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
        toks = np.random.default_rng(seed + 31).integers(
            0, lm.cfg.vocab, (MESH_B, MESH_P))
        want = ServeEngine(lm, device=dev).generate(
            {"tokens": toks}, n_new=MESH_NEW, max_len=MESH_MAX_LEN)
        world1 = mesh_world1(dev, lm, toks, want, MESH_NEW, MESH_MAX_LEN)
        want_tokens = want.tokens
        del lm, want
    fingerprints = world1.pop("layer0_fingerprints")
    free_device()
    world2 = mesh_world2(dev, seed, toks, want_tokens, fingerprints)
    data2 = mesh_data2(dev, seed)
    emit({"phase": "lm_mesh", "arch": MESH_ARCH, "reduced": MOE_REDUCED,
          "batch": int(np.shape(toks)[0]), "prompt": int(np.shape(toks)[1]),
          "new_tokens": int(np.shape(want_tokens)[1]), "world1": world1,
          "world2": world2, "data2": data2})


# ---- training ----------------------------------------------------------------

# Leaves scaled before a smoke config's card-against-CPU training check
# and the CPU parity tests (tests/test_torch_train_loss.py): under the
# init as drawn, a 1e-7 relative change of the weights moves the smoke
# models' float32 gradients past the tolerance in any implementation.
TRAIN_CONDITIONING = {"wq": 0.1, "w_uq": 0.1, "w_v": 0.25, "w_g": 0.25,
                      "w_o": 0.25}
# the full-width training run: olmo-1b, TRAIN_4K's sequence length, two
# sequences a step (TRAIN_4K's global batch of 256 cut to one card)
TRAIN_B, TRAIN_S = 2, 4096


def _on(dev, tree):
    from repro_torch.models.params import map_tree
    return map_tree(lambda t: t.detach().to(dev, copy=True), tree)


def _tree_margin(got, want, rtol: float):
    """(worst max abs error, worst share of :func:`_close`'s tolerance,
    all within it) over the leaves of two trees of tensors."""
    import torch
    from repro_torch.models.params import leaves
    err, margin, ok = 0.0, 0.0, True
    for a, b in zip(leaves(got), leaves(want)):
        a = a.detach().cpu().to(torch.float64).numpy()
        b = b.detach().cpu().to(torch.float64).numpy()
        e, o = _close(a, b, rtol)
        err, ok = max(err, e), ok and o
        margin = max(margin, _margin(a, b, rtol))
    return err, margin, ok


def train_step_card_vs_cpu(dev, arch: str, seed: int) -> dict:
    """One ``make_train_step`` of ``arch``'s smoke config on the card and
    on the CPU from one CPU init (leaves in ``TRAIN_CONDITIONING`` scaled)
    and one ``TokenLoader`` batch (B = 2, S = 32): the loss and
    ``grad_norm`` within 1e-4 relative, and every updated parameter, ``m``
    and ``v`` leaf within :func:`_close` at 1e-4 of the CPU's."""
    import torch
    from repro_torch import configs
    from repro_torch.data import TokenLoader
    from repro_torch.models import LM
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    cfg = configs.get_smoke_config(arch)
    lm = LM(cfg)
    init = scale_leaves(lm.init(torch.Generator().manual_seed(seed),
                                device="cpu"), TRAIN_CONDITIONING)
    batch = TokenLoader(vocab=cfg.vocab, batch=2, seq_len=32, seed=seed,
                        frontend=cfg.frontend,
                        n_frontend_tokens=cfg.n_frontend_tokens,
                        frontend_dim=cfg.frontend_dim).batch_at(0)
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=20))
    out = {}
    for where in ("cpu", dev):
        p = _on(where, init)
        o = adamw_init(p)
        p, o, m = step(p, o, _on(where, batch))
        out[str(where)] = ({"params": p, "m": o["m"], "v": o["v"]},
                           {k: float(v) for k, v in m.items()})
    (got, gm), (want, wm) = out[str(dev)], out["cpu"]
    rel = {k: abs(gm[k] - wm[k]) / max(abs(wm[k]), 1e-30)
           for k in ("loss", "grad_norm")}
    err, margin, ok = _tree_margin(got, want, 1e-4)
    return {"arch": arch, "loss": gm["loss"], "loss_cpu": wm["loss"],
            "grad_norm": gm["grad_norm"], "grad_norm_cpu": wm["grad_norm"],
            "rel_err": rel, "metrics_ok": max(rel.values()) <= 1e-4,
            "leaf_max_abs_err": err, "leaf_tolerance_share": margin,
            "leaves_ok": ok}


def _state_rel(got, want) -> float:
    """The worst |got - want| / (|want| + max |want|) over the leaves of
    two optimizer-state trees: within ``rtol`` passes ``assert_allclose``
    at rtol and atol = rtol x the leaf's largest magnitude (``m`` and
    ``v`` leaves are ~1e-2 to ~1e-8 after one step, so an absolute floor
    would hide them)."""
    import numpy as np
    import torch
    from repro_torch.models.params import leaves
    worst = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        a = a.detach().cpu().to(torch.float64).numpy()
        b = b.detach().cpu().to(torch.float64).numpy()
        den = np.abs(b) + np.abs(b).max()
        worst = max(worst, float((np.abs(a - b) / np.where(den > 0, den,
                                                             1.0)).max()))
    return worst


def train_microbatch_check(dev, seed: int) -> dict:
    """olmo-1b smoke, one ``TokenLoader`` batch of 4 from one CPU init
    (``TRAIN_CONDITIONING`` scaled): ``microbatches=2`` against 1 on
    ``dev``, the updated parameters at the reference test's rtol 2e-4,
    atol 2e-5, and what carries the accumulated gradient, ``grad_norm``
    before the clip and ``m`` / ``v``, within rtol 1e-5 (``_state_rel``);
    and ``microbatches=2`` on ``dev`` against the CPU's, ``grad_norm``
    within 1e-5 relative and every parameter, ``m`` and ``v`` leaf within
    :func:`_close` at 1e-4. A step that skipped the division by the count
    moves ``grad_norm`` 2x; one that kept a single microbatch moves
    ``m``."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import TokenLoader
    from repro_torch.models import LM
    from repro_torch.models.params import leaves
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    cfg = configs.get_smoke_config("olmo-1b")
    lm = LM(cfg)
    init = scale_leaves(lm.init(torch.Generator().manual_seed(seed),
                                device="cpu"), TRAIN_CONDITIONING)
    batch = TokenLoader(vocab=cfg.vocab, batch=4, seq_len=32,
                        seed=seed).batch_at(0)
    res = {}
    for where, n in ((dev, 1), (dev, 2), ("cpu", 2)):
        p = _on(where, init)
        step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3),
                               microbatches=n)
        p, o, m = step(p, adamw_init(p), _on(where, batch))
        res[(str(where), n)] = (p, o, float(m["loss"]),
                                float(m["grad_norm"]))
    one, two, cpu = res[(str(dev), 1)], res[(str(dev), 2)], res[("cpu", 2)]
    worst, params_ok = 0.0, True
    for a, b in zip(leaves(one[0]), leaves(two[0])):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        worst = max(worst, float(np.abs(a - b).max()))
        params_ok &= bool(np.allclose(b, a, rtol=2e-4, atol=2e-5))
    gn_rel = abs(two[3] - one[3]) / one[3]
    state_rel = {k: _state_rel(two[1][k], one[1][k]) for k in ("m", "v")}
    cpu_gn_rel = abs(two[3] - cpu[3]) / cpu[3]
    err, margin, cpu_ok = _tree_margin(
        {"params": two[0], "m": two[1]["m"], "v": two[1]["v"]},
        {"params": cpu[0], "m": cpu[1]["m"], "v": cpu[1]["v"]}, 1e-4)
    ok = (params_ok and gn_rel <= 1e-5 and max(state_rel.values()) <= 1e-5
          and cpu_gn_rel <= 1e-5 and cpu_ok)
    return {"arch": "olmo-1b", "batch": 4, "microbatches": [1, 2],
            "loss": [one[2], two[2]], "grad_norm": [one[3], two[3]],
            "params_max_abs_diff": worst,
            "within_rtol_2e-4_atol_2e-5": params_ok,
            "grad_norm_rel": gn_rel, "state_rel": state_rel,
            "vs_cpu": {"grad_norm": cpu[3], "grad_norm_rel": cpu_gn_rel,
                       "leaf_max_abs_err": err,
                       "leaf_tolerance_share": margin, "leaves_ok": cpu_ok},
            "ok": ok}


def train_resume_check(dev, ckpt_dir: str, seed: int) -> dict:
    """``TrainLoop`` on the card, olmo-1b smoke: 4 steps straight against
    2 steps, a ``Checkpointer`` save, a fresh restore onto the card and 2
    more; parameters and optimizer state must be bit-equal. Runs under
    ``torch.use_deterministic_algorithms(True)`` (the script sets
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before the card is touched), so
    no backward pass sums with atomics in a varying order."""
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import TokenLoader
    from repro_torch.models import LM
    from repro_torch.models.params import leaves
    from repro_torch.training import (AdamWConfig, TrainLoop, adamw_init,
                                      make_train_step)
    cfg = configs.get_smoke_config("olmo-1b")
    lm = LM(cfg)
    loader = TokenLoader(vocab=cfg.vocab, batch=2, seq_len=32, seed=seed,
                         device=dev)
    step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2))
    init = lm.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        p = _on(dev, init)
        p_a, o_a, h_a = TrainLoop(lm, loader, step).run(p, adamw_init(p), 0,
                                                        4, log_every=0)
        ck = Checkpointer(ckpt_dir)
        p = _on(dev, init)
        TrainLoop(lm, loader, step, checkpointer=ck, ckpt_every=2).run(
            p, adamw_init(p), 0, 2, log_every=0)
        ck.wait()
        fresh = _on(dev, init)
        state, start, _ = Checkpointer(ckpt_dir).restore(
            {"params": fresh, "opt": adamw_init(fresh)})
        p_c, o_c, h_2 = TrainLoop(lm, loader, step).run(
            state["params"], state["opt"], start, 2, log_every=0)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(
        leaves({"p": p_a, "o": o_a}), leaves({"p": p_c, "o": o_c})))
    return {"arch": "olmo-1b", "steps": 4, "resumed_at": start,
            "losses_straight": h_a, "losses_resumed": h_2,
            "deterministic_algorithms": True,
            "cublas_workspace_config": os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG"),
            "bit_equal": same}


def visited_pairs(S: int, q_chunk: int, kv_chunk: int, causal: bool) -> int:
    """(query, key) pairs in the kv blocks ``flash_attention`` visits for
    one sequence and head (``attention.kv_blocks`` of each q chunk),
    whole blocks."""
    from repro_torch.models.attention import kv_blocks
    qc, kc = min(q_chunk, S), min(kv_chunk, S)
    nk = -(-S // kc)
    return sum((hi - lo) * qc * kc for lo, hi in (
        kv_blocks(q_lo, qc, kc, nk, causal, None)
        for q_lo in range(0, S, qc)))


def train_step_work(lm, B: int, S: int) -> dict:
    """What one training step of ``lm`` on (B, S) tokens must do, counted
    from the shapes: the bfloat16 products (6 N T for the forward and the
    backward of every parameter's product, the tied head included, plus
    2 N_layers T for the per-unit recompute), the float32 attention
    products over the visited blocks (QK^T and PV, 2 x 2 Dh flops a pair;
    forward, recompute and a backward of twice the forward), the bytes
    that must move (the parameters and both moments read once and written
    once), and the model FLOPs of the MFU: 6 N T + 6 L S H Dh T (the
    attention products' forward and backward over the causal half)."""
    from repro_torch.models.params import count_params
    cfg = lm.cfg
    N = lm.param_count()
    layers = count_params(lm.abstract_params()["segments"])
    T = B * S
    H, Dh, L = cfg.n_heads, cfg.head_dim, cfg.n_layers
    pairs = visited_pairs(S, cfg.q_chunk, cfg.kv_chunk, cfg.causal)
    attn_fwd = B * H * L * pairs * 2 * 2 * Dh
    remat = 2 * layers * T if cfg.remat else 0
    p_bytes = N * cfg.pdtype.itemsize
    return {"params": N, "tokens": T,
            "bf16_product_flops": 6 * N * T + remat,
            "f32_attention_flops": 4 * attn_fwd,
            "visited_pairs_per_head": pairs,
            "bytes": 2 * (p_bytes + 2 * 4 * N),
            "model_flops": 6 * N * T + 6 * L * S * H * Dh * T}


def train_full_phase(dev, seed: int) -> None:
    """olmo-1b at its published widths in bfloat16 with per-unit remat,
    trained on ``TokenLoader`` batches of TRAIN_B x TRAIN_S tokens with
    ``AdamWConfig(lr=1e-3, warmup_steps=20)`` (``train_full``): step ms by
    CUDA events (the median of 4 after a warm-up step), tokens/s, the
    model-FLOP share of the bfloat16 peak, the step's bound, one step's
    kernels and device idle share (torch.profiler), the clip and AdamW
    update alone, peak bytes, each step's loss. Then the parameters and
    optimizer state through a ``Checkpointer`` round trip
    (``train_ckpt_full``), a float64 derivative check on the first 4
    layers (deeper cuts reported, ``train_f64_grad``) and float32 layers
    forward and backward against the CPU (``train_f32_layers``)."""
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import TokenLoader
    from repro_torch.models import LM
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training import (AdamWConfig, adamw_init, adamw_update,
                                      clip_by_global_norm, loss_and_grads,
                                      make_train_step)
    cfg = configs.get_config("olmo-1b")
    before = free_device()
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=20)
    step = make_train_step(lm, opt_cfg=ocfg)
    opt = adamw_init(params)
    loader = TokenLoader(vocab=cfg.vocab, batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=seed, device=dev)
    n_timed = 4
    batches = [loader.batch_at(i) for i in range(n_timed + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batches[0])
    losses = [float(m["loss"])]
    warm_s = time.perf_counter() - t0
    ev, mets = [], []
    for b in batches[1:]:
        a_ev = torch.cuda.Event(enable_timing=True)
        b_ev = torch.cuda.Event(enable_timing=True)
        a_ev.record()
        params, opt, m = step(params, opt, b)
        b_ev.record()
        ev.append((a_ev, b_ev))
        mets.append(m)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in ev]
    losses += [float(m["loss"]) for m in mets]
    grad_norms = [float(m["grad_norm"]) for m in mets]
    peak = torch.cuda.max_memory_allocated()
    # the clip and the update alone, on one step's gradients
    _, _, grads = loss_and_grads(lm, params, batches[0])
    upd_ms = time_ms(lambda: adamw_update(
        ocfg, params, clip_by_global_norm(grads, ocfg.grad_clip)[0], opt),
        reps=5, warmup=1)
    del grads
    prof = profile_call(lambda: step(params, opt, batches[1]))
    prof.pop("port_kernel_ms")
    work = train_step_work(lm, TRAIN_B, TRAIN_S)
    med = statistics.median(step_ms)
    t_ops = (work["bf16_product_flops"] / PEAKS.bf16_flop_per_s
             + work["f32_attention_flops"] / PEAKS.fp32_flop_per_s) * 1e3
    t_bytes = work["bytes"] / PEAKS.hbm_bytes_per_s * 1e3
    finite = all(math.isfinite(x) for x in losses)
    emit({"phase": "train_full", "arch": cfg.name, "dtype": cfg.param_dtype,
          "remat": cfg.remat, "batch": TRAIN_B, "seq": TRAIN_S,
          "reduced": [f"global batch 256 -> {TRAIN_B} sequences a step "
                      f"(TRAIN_4K on one card)"],
          "params": work["params"], "allocated_before": before,
          "init_s": init_s, "warmup_step_s": warm_s,
          "step_ms": step_ms, "step_ms_median": med,
          "tokens_per_s": work["tokens"] / (med / 1e3),
          "mfu": work["model_flops"] / (med / 1e3) / PEAKS.bf16_flop_per_s,
          "bound_ms": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "work": work, "update_ms": upd_ms,
          "max_memory_allocated": peak, "losses": losses,
          "grad_norms": grad_norms, "profile": prof})
    check(finite, f"olmo-1b training: non-finite loss {losses}")

    # (f) parameters and optimizer state through a checkpoint
    state = {"params": params, "opt": opt}
    nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
    ckpt_dir = os.path.join(ROOT, "build", "train_ckpt_full")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    free_disk = shutil.disk_usage(ckpt_dir).free
    check(free_disk > 2 * nbytes, f"checkpoint round trip: {free_disk} "
                                  f"bytes free for {nbytes}")
    ck = Checkpointer(ckpt_dir, keep=1)
    t0 = time.perf_counter()
    ck.save(len(losses), state)
    saved_s = time.perf_counter() - t0
    ck.wait()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, bstep, _ = Checkpointer(ckpt_dir).restore(state)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    same = all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
               and a.dtype == b.dtype
               for a, b in zip(leaves(back), leaves(state)))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del back
    emit({"phase": "train_ckpt_full", "arch": cfg.name, "bytes": nbytes,
          "leaves": len(leaves(state)), "step": bstep,
          "save_returned_s": saved_s, "write_s": write_s, "read_s": read_s,
          "bit_equal": same})
    check(same, "olmo-1b checkpoint round trip: a leaf changed")
    del state, opt
    params_cpu = map_tree(lambda t: t.cpu(), params)
    del params, lm
    free_device()
    train_f64_grad_check(dev, cfg, params_cpu, seed)
    train_f32_layer_checks(dev, cfg, params_cpu, seed)


# Depths below the full 16 and step sizes at which the float64 directional
# derivative of olmo-1b is reported beside the held 4-layer check.
F64_GRAD_REPORT_LAYERS = (8, 12)
F64_GRAD_REPORT_STEPS = (1e-4, 1e-5, 1e-6, 1e-7, 1e-8, 1e-9, 1e-10)


def train_f64_grad_check(dev, cfg, params_cpu, seed: int) -> None:
    """Float64 ``train_loss`` of the first 4 layers of full-width
    olmo-1b (``cut_params``; B = 2, S = 128): autograd's <g, d> for a
    seeded unit direction d (a normal draw over every leaf, scaled to norm
    1) against the fourth-order central difference (8 (L(h) - L(-h)) -
    (L(2h) - L(-2h))) / 12h at h = 1e-5, L(t) = L(p + t d), held within
    1e-6 relative. The two-point central difference (L(h) - L(-h)) / 2h
    is reported at h = 1e-3 to 1e-6: under the reference's init the loss
    is strongly curved, its truncation error is ~6e5 h^2 relative (5e-5
    at h = 1e-5) while its rounding error is ~3e-13 / h, so no two-point
    step clears 1e-6 with room, while the fourth-order one's truncation is
    O(h^4). Depths 8, 12 and the full 16 are reported with the central,
    forward and backward differences at h = 1e-4 to 1e-10
    (``F64_GRAD_REPORT_STEPS``), beside the loss's rounding floor: its
    move between two evaluations at one point and under a step of 1e-12
    (about one float64 ulp of the weights)."""
    import torch
    from repro_torch.data import TokenLoader
    from repro_torch.models import LM
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training import loss_and_grads
    batch = TokenLoader(vocab=cfg.vocab, batch=2, seq_len=128, seed=seed,
                        device=dev).batch_at(0)

    def directional(n_layers, hs):
        t0 = time.perf_counter()
        c64 = cfg.scaled(n_layers=n_layers, param_dtype="float64",
                         activ_dtype="float64")
        lm64 = LM(c64)
        p = map_tree(lambda t: t.to(dev, torch.float64),
                     cut_params(params_cpu, LM(cfg), lm64)
                     if n_layers < cfg.n_layers else params_cpu)
        gen = torch.Generator(device=dev).manual_seed(seed + 3)
        d = map_tree(lambda t: torch.randn(t.shape, generator=gen,
                                           device=dev, dtype=t.dtype), p)
        norm = torch.sqrt(sum(torch.sum(x * x) for x in leaves(d)))
        d = map_tree(lambda x: x / norm, d)
        loss, _, g = loss_and_grads(lm64, p, batch)
        gd = float(sum(torch.sum(a * b) for a, b in zip(leaves(g),
                                                         leaves(d))))
        del g
        with torch.no_grad():
            at = lambda t: float(lm64.train_loss(
                map_tree(lambda a, b: a + t * b, p, d), batch)[0])
            two, l0 = {}, at(0.0)
            # the loss's move under a change of about one float64 ulp in
            # the weights, and between two evaluations at one point
            noise = {"repeat": abs(at(0.0) - l0),
                     "t_1e-12": max(abs(at(t) - l0) for t in (1e-12, -1e-12))}
            for h in hs:
                up, down = at(h), at(-h)
                fd = (up - down) / (2 * h)
                two[str(h)] = {"central_difference": fd,
                               "rel_err": abs(fd - gd) / abs(gd),
                               "forward": (up - l0) / h,
                               "backward": (l0 - down) / h}
            h = 1e-5
            fd4 = (8 * (at(h) - at(-h)) - (at(2 * h) - at(-2 * h))) / (12 * h)
        del p, d
        free_device()
        return {"layers": n_layers, "loss": float(loss),
                "autograd_directional": gd, "loss_noise": noise,
                "two_point_by_step": two,
                "fourth_order_h": h, "fourth_order": fd4,
                "rel_err": abs(fd4 - gd) / abs(gd),
                "seconds": time.perf_counter() - t0}

    held = directional(4, (1e-3, 1e-4, 1e-5, 1e-6))
    deeper = [directional(n, F64_GRAD_REPORT_STEPS)
              for n in F64_GRAD_REPORT_LAYERS + (cfg.n_layers,)]
    rel = held["rel_err"]
    emit({"phase": "train_f64_grad", "arch": cfg.name, "batch": [2, 128],
          "held": held, "rel_err": rel, "within_1e-6": rel <= 1e-6,
          "deeper_reported": deeper,
          "reduced": [f"n_layers {cfg.n_layers} -> 4 (held; 8, 12 and "
                      f"{cfg.n_layers} reported)"]})
    check(rel <= 1e-6, f"olmo-1b float64: autograd's directional "
                       f"derivative {held['autograd_directional']} off the "
                       f"fourth-order central difference by {rel} "
                       f"relative")


def layer_fwd_bwd(lp, x, cot, desc, cfg):
    """(output, aux, gradients of sum(output * cot) + aux with respect to
    x and every leaf of ``lp``, in :func:`repro_torch.models.params.leaves`
    order) of one layer in ``mode="train"``."""
    import torch
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.models.transformer import layer_apply
    lp = map_tree(lambda t: t.detach().requires_grad_(True), lp)
    x = x.detach().requires_grad_(True)
    pos = torch.arange(x.shape[1], device=x.device)
    with torch.enable_grad():
        y, _, aux = layer_apply(lp, x, desc, cfg=cfg, mode="train",
                                cache=None, positions=pos, cur_pos=None)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        grads = torch.autograd.grad(torch.sum(y * cot) + aux,
                                    [x] + leaves(lp), allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip([x] + leaves(lp), grads)]
    return y.detach(), aux.detach(), grads


def train_f32_layer_checks(dev, cfg, params_cpu, seed: int) -> None:
    """At full width in float32, one layer forward and backward on the
    card and on the CPU from the same input and cotangent: olmo-1b's
    ``attn+dense`` (its first layer, on the embedded tokens) and
    qwen3-moe-30b-a3b's ``attn+moe`` (a seeded layer on a normal input, at
    a capacity factor that drops nothing, aux included). The output, the
    aux and the gradients of the input and of every parameter within
    :func:`_close` at 1e-3 of the CPU's."""
    import torch
    from repro_torch import configs
    from repro_torch.models.params import init_tree, map_tree
    from repro_torch.models.transformer import LayerDesc, layer_meta
    gen = torch.Generator().manual_seed(seed + 5)
    lines = {}

    def held(kind, cfg_, lp, x):
        t0 = time.perf_counter()
        cot = torch.randn(x.shape, generator=gen)
        want = layer_fwd_bwd(lp, x, cot, LayerDesc(*kind.split("+")), cfg_)
        got = layer_fwd_bwd(_on(dev, lp), x.to(dev), cot.to(dev),
                            LayerDesc(*kind.split("+")), cfg_)
        rows = {}
        for name, a, b in (("out", got[0], want[0]),
                           ("aux", got[1], want[1])):
            err, ok = _close(a.cpu().numpy(), b.numpy(), 1e-3)
            rows[name] = {"max_abs_err": err, "ok": ok,
                          "share": _margin(a.cpu().numpy(), b.numpy(), 1e-3)}
        err, margin, ok = _tree_margin(got[2], want[2], 1e-3)
        rows["grads"] = {"max_abs_err": err, "ok": ok, "share": margin,
                         "count": len(want[2])}
        rows["seconds"] = time.perf_counter() - t0
        lines[kind] = rows

    f32 = cfg.scaled(param_dtype="float32", activ_dtype="float32")
    lp = map_tree(lambda t: t[0].to(torch.float32),
                  params_cpu["segments"][0])["L0"]
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    x = params_cpu["embed"]["table"].to(torch.float32)[toks]
    held("attn+dense", f32, lp, x)
    del lp, x
    moe = configs.get_config("qwen3-moe-30b-a3b")
    moe32 = moe.scaled(param_dtype="float32", activ_dtype="float32",
                       capacity_factor=moe.n_experts / moe.top_k)
    lp = init_tree(layer_meta(moe32, LayerDesc("attn", "moe")),
                   torch.Generator(device=dev).manual_seed(seed + 7), dev)
    lp = map_tree(lambda t: t.cpu(), lp)
    free_device()
    x = torch.randn(2, 32, moe.d_model, generator=gen)
    held("attn+moe", moe32, lp, x)
    del lp
    free_device()
    ok = all(r["ok"] for rows in lines.values() for r in rows.values()
             if isinstance(r, dict))
    emit({"phase": "train_f32_layers", "layers": lines,
          "moe_capacity_factor": moe32.capacity_factor,
          "inputs": {"attn+dense": [2, 64], "attn+moe": [2, 32]},
          "within_1e-3_of_cpu": ok})
    check(ok, f"float32 training layers off the CPU's: {lines}")


# (g)'s runs of the training driver, (argv, whether the loss must fall).
# TokenLoader's documents are random walks over the vocabulary (4
# successors a token, no skew in the tokens' frequencies), so at the
# 100m preset's 32,768 tokens 30 steps of 8 x 256 fresh tokens see each
# bigram about 0.5 times and the loss does not fall (reported). With
# --batch 512 (the loader's n_docs) every step takes the same 512
# documents, which the model learns within 30 steps, as the reference's
# own loss test repeats its 4 batches (held).
TRAIN_DRIVER_RUNS = ((["--preset", "100m", "--steps", "30"], False),
                     (["--preset", "100m", "--steps", "30", "--batch",
                       "512", "--seq", "16"], True),
                     (["--preset", "smoke", "--steps", "5", "--seq", "64"],
                      False))


def train_driver_checks(dev) -> None:
    """``launch.train.main`` on the card (``TRAIN_DRIVER_RUNS``): each run
    to its end with finite losses; where held, the mean loss of the last
    5 steps below that of the first 5."""
    import shutil
    import numpy as np
    from repro_torch.launch import train
    ckpt = os.path.join(ROOT, "build", "train_driver_ckpt")
    for argv, held in TRAIN_DRIVER_RUNS:
        shutil.rmtree(ckpt, ignore_errors=True)
        t0 = time.perf_counter()
        res = train.main(argv + ["--ckpt-dir", ckpt])
        sec = time.perf_counter() - t0
        losses = res.pop("losses")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        emit({"phase": "train_driver", "argv": argv, "main_s": sec,
              "first5_mean": first, "last5_mean": last, "falls": last < first,
              "held": held, "losses": losses, **res})
        steps = int(argv[argv.index("--steps") + 1])
        check(res["steps"] == steps and all(np.isfinite(losses)),
              f"launch.train {argv}: {res['steps']} steps, losses {losses}")
        check(not held or last < first,
              f"launch.train {argv}: the last 5 losses' mean {last} is not "
              f"below the first 5's {first}")
    shutil.rmtree(ckpt, ignore_errors=True)


def train_phase(dev, seed: int) -> None:
    """Training on the card: (a) one train step card = CPU on every smoke
    config, (b) microbatches, (c) a bit-equal resume, then olmo-1b at full
    width (:func:`train_full_phase`: the timed run, (f) the checkpoint
    round trip, (d) the float64 derivative check, (e) float32 layers
    forward and backward), then (g) the training driver."""
    from repro_torch import configs
    for arch in configs.ARCH_NAMES:
        rep = train_step_card_vs_cpu(dev, arch, seed)
        emit({"phase": "train_smoke", **rep})
        check(rep["metrics_ok"] and rep["leaves_ok"],
              f"{arch} train step: card off the CPU: {rep}")
    rep = train_microbatch_check(dev, seed)
    emit({"phase": "train_microbatch", **rep})
    check(rep["ok"], f"microbatches=2 off microbatches=1 or off the "
                     f"CPU: {rep}")
    rep = train_resume_check(dev, os.path.join(ROOT, "build",
                                               "train_resume_ckpt"), seed)
    emit({"phase": "train_resume", **rep})
    check(rep["bit_equal"], "TrainLoop resumed from a checkpoint differs "
                            "from the unbroken run")
    free_device()
    train_full_phase(dev, seed)
    train_driver_checks(dev)


# ---- training on a mesh of ranks ----------------------------------------------

# olmo-1b's train_full step split over two ranks on the one card: a (data 2,
# model 1) mesh over gloo (NCCL refuses two ranks on one GPU), one of the
# TRAIN_B sequences a rank, every collective staged through the host
TRAIN_MESH_SHAPE = (2, 1)
# timed steps after the first (the first is held against the one-rank step)
TRAIN_MESH_TIMED = 1
TRAIN_MESH_RANK0_LIMIT_S, TRAIN_MESH_GRACE_S = 600, 60
# the first mesh step's loss and grad_norm against the one-rank step's on
# the same batch and weights (bfloat16; the prediction is in PERF.md §6)
TRAIN_MESH_LOSS_RTOL, TRAIN_MESH_GNORM_RTOL = 1e-3, 1e-2
# the float32 unit-0 and embedding checks' global batch (B, S)
TRAIN_MESH_F32_BS = (2, 64)


def _rank_slices(mesh_shape, spec, shape):
    """Each rank's box of a leaf of ``shape`` laid out by ``spec`` on a
    (data, model) mesh of ``mesh_shape``, rank r at the row-major
    coordinate of r."""
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.mesh import Mesh
    import torch
    out = []
    for r in range(mesh_shape[0] * mesh_shape[1]):
        coord = {"data": r // mesh_shape[1], "model": r % mesh_shape[1]}
        m = Mesh(dict(zip(("data", "model"), mesh_shape)),
                 torch.device("cpu"), coord=coord)
        out.append(NamedSharding(m, spec).index(shape))
    return out


def _train_mesh_f32(dev, mesh, lm, shard, metas, seed: int, rank: int):
    """Float32 unit 0 (``attn+dense``) and the embedding lookup, forward
    and backward on the mesh from this rank's shards (its rows of a
    seeded global batch), the gradients gathered whole; rank 0 runs the
    same mesh-less on the gathered float32 weights and returns each rank's
    slice's error over the slice's scale, against the whole batch and
    against the same run taken one row at a time (each product then has
    a rank's row count), and the row-wise run's against the whole
    batch's."""
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import batch_rows
    from repro_torch.models import LM
    from repro_torch.models.params import (DEFAULT_RULES, leaves, map_tree,
                                           spec_for)
    from repro_torch.models.transformer import Segment, segment_apply
    cfg32 = lm.cfg.scaled(param_dtype="float32", activ_dtype="float32")
    lm32 = LM(cfg32)
    seg = Segment(lm.layout[0].pattern, 1)
    unit = {"L0": map_tree(lambda t: t[0].float(),
                           shard["segments"][0]["L0"])}
    specs = [spec_for(metas["embed"]["table"], mesh, DEFAULT_RULES)] + [
        spec_for(m, mesh, DEFAULT_RULES)[1:]
        for m in leaves(metas["segments"][0]["L0"])]
    table = shard["embed"]["table"].float()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    B, S = TRAIN_MESH_F32_BS
    D = lm.cfg.d_model
    glob = {"tokens": torch.randint(0, lm.cfg.vocab, (B, S), generator=g,
                                    device=dev),
            "cot_x": torch.randn((B, S, D), generator=g, device=dev),
            "cot_y": torch.randn((B, S, D), generator=g, device=dev)}
    pos = torch.arange(S, device=dev)

    def run(table_, unit_, rows, on_mesh):
        m = mesh if on_mesh else None
        ba = ("data",) if on_mesh else ()
        table_ = table_.detach().requires_grad_(True)
        unit_ = map_tree(lambda t: t.detach().requires_grad_(True), unit_)
        with torch.enable_grad():
            vocab = {"embed": lm32._table({"embed": {"table": table_}}, m,
                                          "train", ba)}
            x = lm32._embed_tokens(None, rows["tokens"], m, "train", vocab)
            y, _, _ = segment_apply(
                unit_, x, seg, cfg=cfg32, mode="train", caches=None,
                positions=pos, cur_pos=None, mesh=m, batch_axes=ba,
                unshard=lm32._unit_unshard(seg, m, cfg32, "train"))
            loss = torch.sum(x * rows["cot_x"]) + torch.sum(y * rows["cot_y"])
            loss = coll.psum(loss, m, ba) if on_mesh else loss
            grads = torch.autograd.grad(loss, [table_] + leaves(unit_))
        return [t.detach() for t in grads]

    t0 = time.perf_counter()
    got = run(table, unit, batch_rows(glob, mesh, ("data",)), True)
    with torch.no_grad():
        got = [coll.unshard(t, sp, mesh) for t, sp in zip(got, specs)]
        whole_t = coll.unshard(table, specs[0], mesh)
        whole_u = map_tree(lambda t, m: coll.unshard(
            t, spec_for(m, mesh, DEFAULT_RULES)[1:], mesh), unit,
            {"L0": metas["segments"][0]["L0"]})
    mesh_s = time.perf_counter() - t0
    if rank != 0:
        return {"mesh_s": mesh_s}
    want = run(whole_t, whole_u, glob, False)
    # the same mesh-less, one row at a time, the rows' gradients summed in
    # row order: the products then have a rank's M (S rows, not B x S),
    # which sets how the card's float32 products round
    rowwise = None
    for i in range(B):
        g_i = run(whole_t, whole_u, {k: v[i:i + 1] for k, v in glob.items()},
                  False)
        rowwise = g_i if rowwise is None else [
            a + b for a, b in zip(rowwise, g_i)]
    names = ["embed.table"] + [f"L0.{i}" for i in range(len(want) - 1)]

    def rel(have, ref):
        return {name: [float((a[box] - b[box]).abs().max()
                             / b[box].abs().max().clamp(min=1e-30))
                       for box in _rank_slices(TRAIN_MESH_SHAPE, sp,
                                               tuple(b.shape))]
                for name, a, b, sp in zip(names, have, ref, specs)}

    def worst(errs):
        return max(max(v) for v in errs.values())

    errs = rel(got, want)
    by_row = rel(got, rowwise)
    rows_whole = rel(rowwise, want)
    return {"mesh_s": mesh_s, "grad_rel_err_by_rank": errs,
            "worst": worst(errs),
            "rowwise_grad_rel_err_by_rank": by_row,
            "rowwise_worst": worst(by_row),
            "rowwise_vs_whole_worst": worst(rows_whole)}


def _train_mesh_adamw(dev, mesh, metas, seed: int) -> dict:
    """Leaf by leaf at olmo-1b's shapes: one AdamW update (the step's
    config, step 3) of this rank's shards of seeded whole parameters,
    gradients and moments, against the slice of the whole leaves'
    update; bit-equal expected (elementwise)."""
    import torch
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.models.params import DEFAULT_RULES, leaves, spec_for
    from repro_torch.training import AdamWConfig, adamw_update
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=20)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    equal, n = True, 0
    for m in leaves(metas):
        box = NamedSharding(mesh, spec_for(m, mesh, DEFAULT_RULES)).index(
            m.shape)
        rnd = lambda s: torch.randn(m.shape, generator=g, device=dev) * s
        p, gr = rnd(1.0).to(m.dtype), rnd(1e-3).to(m.dtype)
        mo, v = rnd(1e-3), rnd(1e-3).square()
        shards = [t[box].clone() for t in (p, gr, mo, v)]
        for pp, gg, mm, vv in ((p, gr, mo, v), shards):
            adamw_update(ocfg, {"w": pp}, {"w": gg},
                         {"m": {"w": mm}, "v": {"w": vv},
                          "step": torch.tensor(3, dtype=torch.int32,
                                               device=dev)})
        equal = equal and all(torch.equal(a[box], b) for a, b in zip(
            (p, mo, v), (shards[0], shards[2], shards[3])))
        n += 1
        del p, gr, mo, v, shards
    torch.cuda.empty_cache()
    return {"leaves": n, "bit_equal": bool(equal)}


def _train_mesh_rank(rank: int, world: int, store: str, out_dir: str,
                     seed: int, device: str) -> None:
    """One rank of the ``train_mesh`` phase: its shard of olmo-1b under
    DEFAULT_RULES drawn by ``init_tree(..., mesh=)``, the float32 unit-0
    and embedding checks, the AdamW shard check, then
    ``make_train_step(lm, mesh=mesh)`` on ``TokenLoader``'s global batches:
    the first step (held against the one-rank step), then
    TRAIN_MESH_TIMED timed ones. Writes ``rank<r>.json``, or ``rank<r>.err``
    with the traceback."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch import configs
        from repro_torch.data import TokenLoader
        from repro_torch.launch import make_rank_mesh
        from repro_torch.models import LM
        from repro_torch.models.params import (DEFAULT_RULES, init_tree,
                                               leaves, shard_metas,
                                               tree_bytes)
        from repro_torch.training import (AdamWConfig, adamw_init,
                                          make_train_step)
        dev = torch.device(device)
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_rank_mesh(TRAIN_MESH_SHAPE, ("data", "model"),
                              device=dev)
        cfg = configs.get_config("olmo-1b")
        lm = LM(cfg)
        metas = lm.abstract_params()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shard = init_tree(metas, torch.Generator(device=dev).manual_seed(seed),
                          dev, mesh=mesh, rules=DEFAULT_RULES)
        torch.cuda.synchronize()
        lm.check_params(shard, mesh, mode="train")
        res = {"rank": rank, "coord": mesh.coord,
               "init_s": time.perf_counter() - t0,
               "resident_param_bytes": sum(t.numel() * t.element_size()
                                           for t in leaves(shard)),
               "reckoned_param_bytes": tree_bytes(
                   shard_metas(metas, mesh, DEFAULT_RULES)),
               "whole_param_bytes": tree_bytes(metas)}
        res["f32"] = _train_mesh_f32(dev, mesh, lm, shard, metas, seed, rank)
        res["adamw"] = _train_mesh_adamw(dev, mesh, metas, seed)
        mesh.counts.clear()
        torch.cuda.empty_cache()

        opt = adamw_init(shard)
        step = make_train_step(lm, opt_cfg=AdamWConfig(lr=1e-3,
                                                       warmup_steps=20),
                               mesh=mesh)
        loader = TokenLoader(vocab=cfg.vocab, batch=TRAIN_B, seq_len=TRAIN_S,
                             seed=seed, device=dev)
        batches = [loader.batch_at(i) for i in range(1 + TRAIN_MESH_TIMED)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res["state_bytes"] = tree_bytes(shard_metas(metas, mesh,
                                                    DEFAULT_RULES)) + sum(
            t.numel() * t.element_size() for t in leaves(opt))
        t0 = time.perf_counter()
        shard, opt, m = step(shard, opt, batches[0])
        res["first"] = {"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "s": time.perf_counter() - t0,
                        "counts": dict(mesh.counts)}
        res["step_ms"], res["losses"], res["counts"] = [], [], []
        for b in batches[1:]:
            mesh.counts.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            shard, opt, m = step(shard, opt, b)
            ev[1].record()
            torch.cuda.synchronize()
            res["step_ms"].append(ev[0].elapsed_time(ev[1]))
            res["losses"].append(float(m["loss"]))
            res["counts"].append(dict(mesh.counts))
        res["peak_allocated"] = torch.cuda.max_memory_allocated()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def train_mesh_phase(dev, seed: int) -> None:
    """The ``train_mesh`` line: olmo-1b at full width in bfloat16 (remat
    on, TRAIN_B x TRAIN_S tokens a step, an 11.77 GB state) trained on two
    gloo ranks of the one card, a (data 2, model 1) mesh: FSDP over data,
    one sequence a rank, every collective staged through the host. First
    the one-rank step here (``make_train_step`` without a mesh, the same
    seed, batch and config), freed before the ranks start (``spawn``).
    Held: each rank's parameter bytes equal the metas' reckoning under
    DEFAULT_RULES (half the whole); the first mesh step's loss and
    grad_norm within TRAIN_MESH_LOSS_RTOL / TRAIN_MESH_GNORM_RTOL of the
    one-rank step's and equal on both ranks; float32 unit 0 and the
    embedding forward and backward on the mesh, each rank's gradient
    slice within 1e-3 of the scale of rank 0's mesh-less gradient's, and
    within 1e-6 of the same run's taken one row at a time; the AdamW
    update of the shards bit-equal to the whole update's slice;
    finite losses. Reported: step ms (CUDA events, each timed step after
    the first), the collectives' calls and staged bytes a step, each
    rank's peak bytes and the world-2 wall time."""
    import torch
    from repro_torch import configs
    from repro_torch.data import TokenLoader
    from repro_torch.models import LM
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    free_device()
    cfg = configs.get_config("olmo-1b")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
    batch = TokenLoader(vocab=cfg.vocab, batch=TRAIN_B, seq_len=TRAIN_S,
                        seed=seed, device=dev).batch_at(0)
    t0 = time.perf_counter()
    _, _, m = make_train_step(lm, opt_cfg=AdamWConfig(
        lr=1e-3, warmup_steps=20))(params, adamw_init(params), batch)
    one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "s": time.perf_counter() - t0,
           "peak_allocated": torch.cuda.max_memory_allocated()}
    del lm, params, batch, m
    free_device()

    world = TRAIN_MESH_SHAPE[0] * TRAIN_MESH_SHAPE[1]
    ranks, wall_s = spawn_ranks(_train_mesh_rank, world, (seed, str(dev)),
                                TRAIN_MESH_RANK0_LIMIT_S, TRAIN_MESH_GRACE_S,
                                "train_mesh")
    first = ranks[0]["first"]
    rel = {k: abs(first[k] - one[k]) / abs(one[k])
           for k in ("loss", "grad_norm")}
    step_ms = [ms for r in ranks for ms in r["step_ms"]]
    emit({"phase": "train_mesh", "arch": cfg.name, "dtype": cfg.param_dtype,
          "remat": cfg.remat, "batch": TRAIN_B, "seq": TRAIN_S,
          "backend": "gloo", "mesh": dict(zip(("data", "model"),
                                              TRAIN_MESH_SHAPE)),
          "reduced": [f"global batch 256 -> {TRAIN_B} sequences a step "
                      f"(TRAIN_4K on one card), one a rank"],
          "one_rank": one, "first_rel_diff": rel,
          "tolerance": {"loss": TRAIN_MESH_LOSS_RTOL,
                        "grad_norm": TRAIN_MESH_GNORM_RTOL},
          "step_ms_median": statistics.median(step_ms), "wall_s": wall_s,
          "f32_worst_rel_err": ranks[0]["f32"]["worst"],
          "f32_rowwise_worst_rel_err": ranks[0]["f32"]["rowwise_worst"],
          "f32_rowwise_vs_whole_worst_rel_err":
              ranks[0]["f32"]["rowwise_vs_whole_worst"],
          "ranks": ranks})
    for r in ranks:
        check(r["resident_param_bytes"] == r["reckoned_param_bytes"]
              == r["whole_param_bytes"] // world,
              f"train_mesh rank {r['rank']}: {r['resident_param_bytes']} "
              f"parameter bytes, reckoned {r['reckoned_param_bytes']}, "
              f"whole {r['whole_param_bytes']}")
        check(r["adamw"]["bit_equal"],
              f"train_mesh rank {r['rank']}: AdamW on the shards differs "
              f"from the whole update's slice")
        check(r["first"]["loss"] == first["loss"]
              and r["first"]["grad_norm"] == first["grad_norm"],
              f"train_mesh: the ranks' first step differs: "
              f"{[x['first'] for x in ranks]}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"train_mesh rank {r['rank']}: losses {r['losses']}")
    check(ranks[0]["f32"]["worst"] <= 1e-3,
          f"train_mesh: float32 unit 0 / embedding gradients off rank 0's "
          f"mesh-less run: {ranks[0]['f32']}")
    check(ranks[0]["f32"]["rowwise_worst"] <= 1e-6,
          f"train_mesh: float32 unit 0 / embedding gradients off rank 0's "
          f"mesh-less run taken one row at a time: {ranks[0]['f32']}")
    check(rel["loss"] <= TRAIN_MESH_LOSS_RTOL
          and rel["grad_norm"] <= TRAIN_MESH_GNORM_RTOL,
          f"train_mesh: the first step off the one-rank step: {rel} "
          f"(mesh {first}, one rank {one})")


# ---- the launch tools ----------------------------------------------------------

TOOLS_DIR = os.path.join(ROOT, "build", "tools")
# the blocked scan's block (flat_search_blocked's default)
TOOLS_BLOCK = 4096
# the dry-run tools, run one after another in the background (the
# roofline reads the dry-run's record): (name, module and arguments, time
# limit in seconds). They need no card and are not shown one.
TOOLS_RUNS = (
    ("dryrun", ["repro_torch.launch.dryrun", "--arch", "olmo-1b",
                "--shape", "decode_32k", "--mesh", "single_pod",
                "--force"], 300),
    ("roofline", ["repro_torch.launch.roofline", "--arch", "olmo-1b",
                  "--shape", "decode_32k", "--force"], 120),
    ("dryrun_mstg", ["repro_torch.launch.dryrun_mstg", "--force"], 300),
)


def keep_in_background() -> None:
    """Move the calling thread, and so the processes it starts, off two of
    the CPUs (where there are four or more) and to the lowest priority
    (Linux keeps both per thread): the phases it runs beside, whose host
    dispatch is timed, keep CPUs of their own."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 4:
        os.sched_setaffinity(0, cpus[2:])
    os.nice(19)


def tools_dryrun_job() -> list:
    """Run :data:`TOOLS_RUNS` as subprocesses from a background thread,
    each within its time limit (killed past it), writing under
    ``build/tools/``: [{run, rc ("timeout" past the limit), seconds,
    the output's tail}]."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="",
               DRYRUN_TORCH_ARTIFACTS=os.path.join(TOOLS_DIR, "dryrun"),
               ROOFLINE_TORCH_ARTIFACTS=os.path.join(TOOLS_DIR, "roofline"))
    runs = []
    for name, argv, limit in TOOLS_RUNS:
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, "-m"] + argv, cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=limit)
            rc, out = r.returncode, r.stdout + r.stderr
        except subprocess.TimeoutExpired as e:
            rc, out = "timeout", str(e.output or "")
        runs.append({"run": name, "rc": rc,
                     "seconds": time.perf_counter() - t0,
                     "tail": out[-1500:]})
    return runs


def tools_blocked(args, flat_ids, flat_d, Qn: int, k: int, bf_d,
                  check_rows, flat_ms: float) -> None:
    """The ``tools_blocked`` line: ``flat_search_blocked`` on the flat
    route's scan arguments (``args``, ``pairwise_l2_masked``'s, from the
    route's ``fused_topk_l2`` call) with blocks of :data:`TOOLS_BLOCK` rows.
    Held: one kernel-5 launch a block, distances bit-equal to the flat
    route's, ids equal wherever a row's distances are distinct, and within
    1e-4 of the float64 brute force on its check rows."""
    import numpy as np
    import torch
    from repro_torch.core.flat import flat_search, flat_search_blocked
    from repro_torch.kernels import ops
    q, c, lo, hi, ql, qh, mask = args
    N = c.shape[0]

    def run():
        return flat_search_blocked(c, lo, hi, q, ql, qh, mask=mask, k=k,
                                   block=TOOLS_BLOCK)

    ops.reset_launches()
    ids, d = run()
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["pairwise_l2_masked"]
    ids = ids[:Qn].cpu().numpy()
    d = d[:Qn].cpu().numpy()
    blocked_ms = time_ms(run, reps=5)
    flat_search_ms = time_ms(lambda: flat_search(c, lo, hi, q, ql, qh,
                                                 mask=mask, k=k), reps=5)
    bit_equal = bool(np.array_equal(d, flat_d))
    # a position whose distance no other position of its row shares and
    # which lies below the row's k-th (which may tie past the list)
    same = (d[:, :, None] == d[:, None, :]).sum(2) == 1
    distinct = same & (d < d[:, -1:]) & np.isfinite(d)
    ids_equal = bool(np.array_equal(ids[distinct], flat_ids[distinct]))
    fin = np.isfinite(bf_d)
    got = d[check_rows]
    rel = float((np.abs(got[fin] - bf_d[fin])
                 / np.maximum(bf_d[fin], 1e-30)).max())
    want_launches = -(-N // TOOLS_BLOCK)
    emit({"phase": "tools_blocked", "N": N, "Q": Qn, "k": k,
          "block": TOOLS_BLOCK, "launches": launches,
          "launches_expected": want_launches,
          "dists_bit_equal_vs_flat": bit_equal,
          "ids_equal_where_distinct": ids_equal,
          "distinct_positions": int(distinct.sum()),
          "max_rel_err_vs_f64": rel, "blocked_ms": blocked_ms,
          "flat_search_ms": flat_search_ms, "flat_request_ms": flat_ms,
          "nvidia_smi": nvidia_smi_line()})
    check(launches == want_launches, f"flat_search_blocked launched "
          f"pairwise_l2_masked {launches} times, not {want_launches}")
    check(bit_equal, "flat_search_blocked: distances differ from the flat "
                     "route's")
    check(ids_equal, "flat_search_blocked: ids differ from the flat route's "
                     "at distinct distances")
    check(rel <= 1e-4, f"flat_search_blocked: dists off by {rel}")


def tools_flops(dev, lm, B: int, P: int, max_len: int) -> None:
    """The ``tools_flops`` line: one decode step of ``lm`` (B sequences,
    at position P of caches of ``max_len``) counted by ``FlopCounterMode``
    on the card and by the dry-run's ``count_step`` on fake tensors of
    the same shapes; held equal. ``model_flops`` (2·N_active·B) beside."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models.params import map_tree
    from repro_torch.models.transformer import ShapeDtype, zeros_like_meta
    meta = lm.decode_cache_meta(B, max_len)
    caches = zeros_like_meta(meta, dev)
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    with FlopCounterMode(display=False) as fc:
        lm.decode_step(None, caches, tokens, P)
    torch.cuda.synchronize()
    card = fc.get_total_flops()
    del caches
    t0 = time.perf_counter()
    params = map_tree(lambda m: ShapeDtype(m.shape, m.dtype),
                      lm.abstract_params())
    fake = count_step(lambda p, c, t: lm.decode_step(p, c, t, P),
                      (params, meta, ShapeDtype((B, 1), torch.int32)))
    fake_s = time.perf_counter() - t0
    mf = model_flops(lm.cfg, lm, ShapeConfig("decode", max_len, B,
                                             "decode"), 1)
    emit({"phase": "tools_flops", "arch": lm.cfg.name, "batch": B,
          "position": P, "max_len": max_len, "flops_card": card,
          "flops_fake": fake["flops"], "model_flops": mf,
          "fake_bytes": fake["bytes"], "fake_count_s": fake_s})
    check(card == fake["flops"], f"tools_flops: the card counted {card} "
          f"FLOPs, the fake tensors {fake['flops']}")


def tools_dryrun(job) -> None:
    """The ``tools_dryrun`` line from :func:`tools_dryrun_job`'s runs and
    records: each run exits with 0, every status is ``ok``, the cells
    have 256 (single pod) and 512 (multi pod) ranks. Reported: each
    cell's per-rank bytes, FLOPs, collective bytes and roofline terms
    against the card's peaks."""
    t0 = time.perf_counter()
    runs = job.result()
    waited = time.perf_counter() - t0

    def load(*parts):
        with open(os.path.join(TOOLS_DIR, *parts)) as f:
            return json.load(f)

    cells = {}
    for name in (["dryrun", "olmo-1b__decode_32k__single_pod.json"],
                 ["roofline", "olmo-1b__decode_32k.json"],
                 *[["dryrun", f"mstg-flat-serve__{m}__{mk}.json"]
                   for mk in ("single_pod", "multi_pod")
                   for m in ("all_gather", "tournament", "fullmesh_v2")]):
        path = os.path.join(TOOLS_DIR, *name)
        rec = load(*name) if os.path.exists(path) else {"status": "missing"}
        rec.pop("traceback", None)
        cells["/".join(name)] = {
            k: rec.get(k) for k in (
                "status", "error", "devices", "memory", "flops_per_device",
                "bytes_per_device", "collective_bytes", "collective_counts",
                "cache_bytes_reference_layout", "terms", "dominant",
                "model_flops_per_device", "flops_equal_model", "run_s",
                "card") if k in rec}
    emit({"phase": "tools_dryrun", "waited_s": waited,
          "runs": [{k: r[k] for k in ("run", "rc", "seconds")}
                   for r in runs], "cells": cells})
    for r in runs:
        check(r["rc"] == 0, f"tools_dryrun: {r['run']} exited {r['rc']}: "
                            f"{r['tail']}")
    for name, rec in cells.items():
        check(rec.get("status") == "ok", f"tools_dryrun: {name} is "
              f"{rec.get('status')}: {rec.get('error')}")
        if "devices" in rec or "multi_pod" in name:
            want = 512 if "multi_pod" in name else 256
            check(rec.get("devices") == want, f"tools_dryrun: {name} has "
                  f"{rec.get('devices')} ranks, not {want}")


def graph_index_build(args, Qn: int):
    """graph-50k's dataset and MSTG index, built on the host (numpy, in
    ``args.workers`` spawn workers): (dataset, index, wall seconds). It
    runs on the background builder thread beside the card's phases
    (:func:`keep_in_background`)."""
    from repro_torch.core import IndexSpec, MSTGIndex, Overlaps
    from repro_torch.data import make_range_dataset
    t0 = time.perf_counter()
    ds = make_range_dataset(n=args.graph_n, d=128, n_queries=Qn,
                            quantize=1024, seed=args.seed)
    spec = IndexSpec(predicate=Overlaps(), m=16, ef_con=64,
                     candidate_stage="coarse")
    idx = MSTGIndex.build(spec, ds.vectors, ds.lo, ds.hi,
                          workers=args.workers)
    return ds, idx, time.perf_counter() - t0


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
    # the train phase's resume check runs cuBLAS under
    # torch.use_deterministic_algorithms, which needs this set before
    # the card's first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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

    if "trace" in phases:
        phases.update(("flat", "graph"))
    if "quant_flat" in phases:
        phases.add("flat")                     # its dataset, index and result
    if "quant_graph" in phases or "quant_routes" in phases:
        phases.add("graph")
    if "serving" in phases:     # the graph index, the streaming index and
        phases.update(("graph", "sharded"))        # the sharded deployment
    if "sharded_ranks" in phases:    # the logical deployment's answers
        phases.add("sharded")
    if "sharded" in phases:          # the flat corpus, the streaming index
        phases.update(("flat", "streaming"))
    if "tools" in phases:            # the blocked scan on the flat corpus
        phases.add("flat")
    k = 10
    Qn = 256
    # The host builds (graph-50k's index, the run's longest host step; the
    # streaming index's three flushes; the sharded_ranks phase's logical
    # build) share nothing with the phases before the ones that read them:
    # one background thread, kept off two CPUs at the lowest priority, runs
    # them in turn while the card runs those phases; each phase waits for
    # its own. Graph-50k's starts at once, beside the baselines and the LM;
    # the other two start once the LM phases are done, beside training:
    # host builds slow the host-bound decode loops beside them, and a
    # second build there cost more than it saved (PERF.md §6)
    builder = concurrent.futures.ThreadPoolExecutor(
        1, initializer=keep_in_background)
    stream_job = graph_job = ranks_job = None
    if "graph" in phases or "routes" in phases:
        graph_job = builder.submit(graph_index_build, args, Qn)

    def submit_late_builds():
        nonlocal stream_job, ranks_job
        if "streaming" in phases:
            stream_job = builder.submit(streaming_build, dev, args, Qn)
        if "sharded_ranks" in phases:
            ranks_job = builder.submit(ranks_logical_build, dev, args)
        builder.shutdown(wait=False)

    # the dry-run tools need no card: they run in the background too, as
    # subprocesses from a thread of their own
    tools_job = None
    if "tools" in phases:
        tools_pool = concurrent.futures.ThreadPoolExecutor(
            1, initializer=keep_in_background)
        tools_job = tools_pool.submit(tools_dryrun_job)
        tools_pool.shutdown(wait=False)

    rows = {}
    if "kernels" in phases:
        cases = kernel_edge_checks(dev, S_wide=767)
        emit({"phase": "kernel_edges_done", "cases": sum(cases.values()),
              "cases_by_kernel": dict(cases)})
    if "scan_sweep" in phases:
        scan_sweep(dev, 256, args.flat_n, args.seed)
    if "gathered_sweep" in phases:
        gathered_sweep(dev, 256, 128, args.seed)

    if "baselines" in phases:
        baselines_phase(dev, args.baselines_n, Qn, k, args.seed)
    if "lm" in phases:
        lm_phase(dev, args.seed, with_mesh="lm_mesh" in phases,
                 with_tools="tools" in phases)
    elif "lm_mesh" in phases:
        lm_mesh_phase(dev, args.seed)
    submit_late_builds()
    if "train" in phases:
        train_phase(dev, args.seed)
        free_device()
    if "train_mesh" in phases:
        train_mesh_phase(dev, args.seed)
        free_device()
    if "streaming" in phases:
        stream = streaming_phase(dev, args, Qn, k, stream_job)
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
        with Capture(ops, "fused_topk_l2") as cap:
            res = eng.execute(req)
        launches = dict(ops.LAUNCHES)
        check(launched(launches) == {"fused_topk_l2": 1},
              f"flat route: expected one fused_topk_l2 launch and no other, "
              f"got {launched(launches)}")
        fused_args = cap.best
        scan_args = fused_args[:7]
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
        # kernel 5 on the route's inputs: the path k > 32 takes
        rows["pairwise_l2_masked"] = measure_kernel(
            "pairwise_l2_masked", scan_args, launches["pairwise_l2_masked"])
        # the route (kernel 7) against its unfused path on the same inputs
        Qp, Np = fused_args[0].shape[0], fused_args[1].shape[0]
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.fused_topk_l2(*fused_args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - mem0
        u_ids, u_d = (t[:Qn].cpu().numpy() for t in unfused_flat(scan_args,
                                                                 k))
        fin_u = np.isfinite(u_d)
        u_rel = float((np.abs(res.dists[fin_u] - u_d[fin_u])
                       / np.maximum(u_d[fin_u], 1e-30)).max())
        # the unfused path timed beside the fused kernel; the kernel's
        # launches' device split over the float32 and the float16 corpus
        unfused_ms = time_ms(lambda: unfused_flat(scan_args, k))
        fused16_args = (fused_args[0], fused_args[1].half(), *fused_args[2:])
        split = {row: device_split(lambda a=a: ops.fused_topk_l2(*a))
                 for row, a in (("fused_topk_l2", fused_args),
                                ("fused_topk_l2_f16", fused16_args))}
        emit({"phase": "flat_fused", "Q": Qp, "N": Np, "k": k,
              "unfused_ms": unfused_ms, "device_split_ms": split,
              "max_rel_err_vs_unfused": u_rel,
              "dists_bit_equal_vs_unfused": bool(np.array_equal(
                  res.dists[fin_u], u_d[fin_u])),
              "ids_equal_vs_unfused": bool(np.array_equal(res.ids, u_ids)),
              "extra_device_bytes": extra, "qn_matrix_bytes": 4 * Qp * Np,
              "route_launches": launches["fused_topk_l2"]})
        check(bool(np.array_equal(np.isfinite(res.dists), fin_u)),
              "flat route: +inf pattern differs from the unfused path's")
        check(bool(np.array_equal(res.ids, u_ids)),
              "flat route: ids differ from the unfused path's")
        check(bool(np.array_equal(res.dists[fin_u], u_d[fin_u])),
              f"flat route: dists differ from the unfused path's (by "
              f"{u_rel} relative)")
        check(extra < Qp * Np, f"fused_topk_l2 allocated {extra} bytes, a "
                               f"(Q, N)-sized buffer")
        rows["fused_topk_l2"] = measure_kernel(
            "fused_topk_l2", fused_args, launches["fused_topk_l2"])
        rows["fused_topk_l2_f16"] = measure_kernel("fused_topk_l2_f16",
                                                   fused16_args, 0)
        if "tools" in phases:
            tools_blocked(scan_args, res.ids, res.dists, Qn, k, bf_d,
                          check_rows, f32_ms)
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
        sharded = sharded_phase(dev, ds, qlo, qhi, k, res.ids, f32_ms, stream)
        logical_async = None
        if "serving" in phases:
            t0 = time.perf_counter()
            logical_async = serving_backends(stream, sharded["dep"], ds, qlo,
                                             qhi, k)
            serving_s["backends"] = time.perf_counter() - t0
        del sharded["dep"]
        if "sharded_ranks" in phases:
            free_device()
            sharded_ranks_phase(dev, ds, qlo, qhi, k, res, f32_ms, sharded,
                                ranks_job, logical_async)
        del sharded
    if "streaming" in phases:
        del stream
        torch.cuda.empty_cache()
    if "flat" in phases:
        del idx, ds, res
        if "trace" not in phases:
            del fused_args, fused16_args

    if "graph" in phases or "routes" in phases:
        t0 = time.perf_counter()
        ds, idx, build_total = graph_job.result()
        emit({"phase": "graph_build", "n": ds.n, "d": ds.d,
              "variants": sorted(idx.variants), "workers": idx.build_workers,
              "build_s": build_total, "built_in_background": True,
              "waited_s": time.perf_counter() - t0,
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

    if "tools" in phases:
        if "lm" not in phases:
            from repro_torch import configs
            from repro_torch.models import LM
            free_device()
            lm = LM(configs.get_config("olmo-1b"))
            lm.init(torch.Generator(device=dev).manual_seed(args.seed),
                    device=dev)
            tools_flops(dev, lm, 8, 128, 256)
            del lm
            free_device()
        tools_dryrun(tools_job)

    name = torch.cuda.get_device_name(0)
    if rows:
        emit({"kernels": [rows[key] for key in KERNELS if key in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
