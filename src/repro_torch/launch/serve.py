"""End-to-end serving driver of the port — the paper's deployment scenario.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --requests 24
  PYTHONPATH=src python -m repro_torch.launch.serve --streaming   # live corpus
  PYTHONPATH=src python -m repro_torch.launch.serve --async       # SLO front end
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4    # sharded corpus
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --shards 4 --device cpu   # one a rank
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --shards 4 --async --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --route graph # pin a route

Builds an MSTG index over a synthetic corpus, stands up the LM endpoint
(:class:`repro_torch.serving.ServeEngine` on a smoke-scale model) and the
batched :class:`repro_torch.serving.RetrievalServer`, and serves RR-filtered
ANN requests end to end (generate + retrieve). ``--streaming`` backs the
server with a :class:`repro_torch.streaming.SegmentedIndex` and interleaves
upserts / deletes with the query traffic. ``--shards N`` serves from a
:class:`repro_torch.distributed.ShardedDeployment`: one shard a rank over
a mesh of ranks (:func:`repro_torch.launch.make_rank_mesh`) when the
process is one of a default ``torch.distributed`` group of world size N
(as under ``torch.distributed.run``), else N logical shards of one device
(:func:`repro_torch.launch.make_mesh`). On ranks every rank runs the same
program, each builds and scans only its own shard, and rank 0 prints.
``--async`` routes the traffic through the continuous-batching
:class:`repro_torch.serving.AsyncRetrievalServer` and prints its metrics
snapshot; on ranks rank 0's scheduler, clock and embedder decide each
round and every rank executes it. ``--route`` pins the engine's route
(``auto``, the work-model router, by default; at the default corpus size
it picks ``pruned``).
Everything runs on ``--device`` (the card by default; ``cpu``
runs the plain versions).

:func:`main` takes an argument list and returns a summary dict (on every
rank), so a program can drive it in-process.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core import (EngineConfig, IndexSpec, MSTGIndex, Overlaps,
                    QueryContained, QueryEngine)
from ..core.engine import resolve_device
from ..data import make_queries, make_range_dataset
from ..models import LM
from ..serving import RetrievalServer, ServeEngine


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--n", type=int, default=1500)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--streaming", action="store_true",
                    help="serve from a mutable SegmentedIndex and interleave "
                         "upserts/deletes with query traffic")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="serve from an N-shard ShardedDeployment: one shard "
                         "a rank of a default process group of world size "
                         "N, else N logical shards of the device")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the continuous-batching async front "
                         "end (SLO admission + wavefront slot refill) and "
                         "print its metrics snapshot")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for --async traffic (late "
                         "queued requests are shed as Rejected)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the process metrics registry over HTTP: "
                         "Prometheus text at /metrics, the typed JSON "
                         "snapshot at /metrics.json (0 = ephemeral port)")
    ap.add_argument("--route", default="auto",
                    choices=("auto", "graph", "pruned", "flat"),
                    help="the route every search takes (auto: the engine's "
                         "work-model router)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.shards and args.streaming:
        ap.error("--shards and --streaming are mutually exclusive (shard a "
                 "SegmentedIndex via ShardedDeployment.from_segmented)")
    ranks = _ranks()
    if args.shards and ranks > 1:
        if ranks != args.shards:
            ap.error(f"--shards {args.shards} on a process group of "
                     f"{ranks} ranks: one shard a rank needs as many")
    dev = resolve_device(args.device)

    http = None
    if args.metrics_port is not None:
        from .. import obs
        http = obs.start_metrics_server(args.metrics_port)
        print(f"metrics: http://{http.server_address[0]}:"
              f"{http.server_address[1]}/metrics (+ /metrics.json)")
    try:
        return _serve(args, dev, ranks)
    finally:
        if http is not None:
            http.shutdown()
            http.server_close()


def _ranks() -> int:
    """The default process group's world size; 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _serve(args, dev, ranks: int) -> dict:
    """Serve as :func:`main` says. ``ranks`` > 1: the process is one of
    that many ranks, ``--shards`` serves one shard a rank, and only rank 0
    prints."""
    say = _printer(ranks)
    # 1) corpus + index (the paper's contribution)
    ds = make_range_dataset(n=args.n, d=args.dim, n_queries=args.requests,
                            quantize=128, seed=0)
    spec = IndexSpec(variants=("T", "Tp"), m=12, ef_con=64)
    config = EngineConfig(route=args.route)
    t0 = time.time()
    if args.shards:
        from ..distributed import DeploymentSpec, ShardedDeployment
        from .mesh import make_mesh, make_rank_mesh
        if ranks > 1:
            mesh = make_rank_mesh((args.shards,), ("data",), device=dev)
            where = f"ranks, one a rank, on {mesh.device}"
        else:
            mesh = make_mesh((args.shards,), ("data",), device=dev)
            where = f"logical shards on {dev}"
        qengine = ShardedDeployment.build(
            ds.vectors, ds.lo, ds.hi, mesh=mesh,
            spec=DeploymentSpec(n_shards=args.shards, index=spec,
                                engine=config))
        say(f"sharded MSTG built: n={args.n} shards={args.shards} "
              f"{where} in {time.time()-t0:.1f}s")
    elif args.streaming:
        from ..streaming import SegmentedIndex
        qengine = SegmentedIndex(spec, flush_threshold=args.n,
                                 engine_config=config, device=dev)
        qengine.add(np.arange(args.n), ds.vectors, ds.lo, ds.hi)
        qengine.flush()
        say(f"segmented MSTG built: n={args.n} "
              f"segments={len(qengine.segments)} in {time.time()-t0:.1f}s")
    else:
        idx = MSTGIndex.build(spec, ds.vectors, ds.lo, ds.hi)
        qengine = QueryEngine(idx, config=config, device=dev)
        say(f"MSTG built: n={args.n} K={idx.domain.K} "
              f"bytes={idx.index_bytes()/1e6:.1f}MB in {time.time()-t0:.1f}s")

    # 2) LM endpoint (smoke-scale) — generates for the requests
    cfg = get_smoke_config(args.arch)
    lm = LM(cfg)
    lm.init(torch.Generator().manual_seed(0), device=dev)
    engine = ServeEngine(lm, device=dev)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16))}
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.normal(
            0, 1, (4, cfg.n_frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(
            0, 1, (4, 16, cfg.frontend_dim)).astype(np.float32)
    gen = engine.generate(batch, n_new=8, max_len=64)
    say(f"LM generate ok: {gen.tokens.shape} tokens")
    summary = {"arch": args.arch, "device": str(dev), "route": args.route,
               "generated": list(gen.tokens.shape),
               "requests": args.requests, "ranks": ranks}

    # 3) batched retrieval serving: Predicate submits, one embed call per tick
    embed_fn = lambda items: ds.queries[np.asarray(items)]  # stub embedding
    qlo, qhi = make_queries(ds, Overlaps().mask, 0.15, seed=2)
    rng = np.random.default_rng(7)

    if args.use_async:
        from ..serving import AsyncRetrievalServer, SLOPolicy
        server = AsyncRetrievalServer(
            qengine, embed_fn, k=args.k, ef=64,
            policy=SLOPolicy(max_wait_ms=1.0, max_batch=32))
        n_mut = 0
        t0 = time.time()
        for i in range(args.requests):
            if args.streaming and i % 4 == 1:
                j = i % args.n
                server.submit_upsert(args.n + i, i, ds.lo[j], ds.hi[j])
                server.submit_delete(int(rng.integers(0, args.n)))
                n_mut += 2
            pred = Overlaps() if i % 2 == 0 else QueryContained()
            server.submit(i, qlo[i], qhi[i], pred,
                          deadline_ms=args.deadline_ms)
        results = server.run_until_idle()
        dt = time.time() - t0
        served = {t: r for t, r in results.items() if r and r.hit is not None}
        ok = sum(1 for r in served.values() if r.hit.valid.any())
        say(f"async served {len(served)} requests (+{n_mut} mutations) in "
              f"{dt*1e3:.1f} ms ({len(served)/dt:.1f} qps); {ok} non-empty")
        snap = server.snapshot()
        say(f"  metrics: served={snap['served']} shed={snap['shed']} "
              f"deadline_missed={snap['deadline_missed']} "
              f"degraded={snap['degraded']}")
        say(f"  queue-wait ms p50/p95/p99: "
              f"{snap['queue_wait_ms']['p50']:.2f}/"
              f"{snap['queue_wait_ms']['p95']:.2f}/"
              f"{snap['queue_wait_ms']['p99']:.2f}")
        say(f"  e2e ms p50/p95/p99: {snap['e2e_ms']['p50']:.2f}/"
              f"{snap['e2e_ms']['p95']:.2f}/{snap['e2e_ms']['p99']:.2f}")
        if "batch_occupancy" in snap:
            say(f"  occupancy={snap['batch_occupancy']:.2f} "
                  f"refill_eff={snap['refill_efficiency']:.2f} "
                  f"refills={snap['refills']}")
        for t in list(served)[:3]:
            say(f"  ticket {t}: top ids "
                  f"{served[t].hit.ids[:5].tolist()}")
        return {**summary, "mode": "async", "served": len(served),
                "non_empty": ok, "mutations": n_mut, "seconds": dt}

    server = RetrievalServer(qengine, embed_fn, k=args.k, ef=64)
    n_mut = 0
    for i in range(args.requests):
        if args.streaming and i % 4 == 1:  # live traffic: mutate mid-stream
            j = i % args.n
            server.submit_upsert(args.n + i, i, ds.lo[j], ds.hi[j])
            server.submit_delete(int(rng.integers(0, args.n)))
            n_mut += 2
        pred = Overlaps() if i % 2 == 0 else QueryContained()
        server.submit(i, qlo[i], qhi[i], pred)
    t0 = time.time()
    results = server.tick()
    dt = time.time() - t0
    ok = sum(1 for hit in results.values() if hit.valid.any())
    say(f"served {len(results)} requests (+{n_mut} mutations) in "
          f"{dt*1e3:.1f} ms ({len(results)/dt:.1f} qps); "
          f"embed/mutate/search s="
          f"{server.tick_stats['embed_s']:.3f}/"
          f"{server.tick_stats['mutate_s']:.3f}/"
          f"{server.tick_stats['search_s']:.3f}; {ok} non-empty")
    mode = "sync"
    if args.streaming:
        mode = "streaming"
        say(f"  streaming stats: {qengine.stats()}")
        rep = qengine.compact(full=True)
        say(f"  compacted: merged={rep['merged']} -> {rep['new_segment']} "
              f"(dropped {rep['dropped']} tombstoned rows)")
    elif args.shards:
        mode = "sharded"
        summary["degraded_queries"] = server.tick_stats["degraded_queries"]
        say(f"  shards={args.shards} "
              f"degraded_queries={server.tick_stats['degraded_queries']}")
    else:
        summary["routes"] = dict(qengine.route_counts)
        say(f"  routes={qengine.route_counts}; "
              f"sel_cache={qengine.sel_cache_hits}h/"
              f"{qengine.sel_cache_misses}m")
    for i in list(results)[:3]:
        say(f"  req {i}: top ids {results[i].ids[:5].tolist()}")
    return {**summary, "mode": mode, "served": len(results),
            "non_empty": ok, "mutations": n_mut, "seconds": dt}


def _printer(ranks: int):
    """``print`` on rank 0 (or without ranks), a no-op on the others."""
    import builtins
    import torch.distributed as dist
    if ranks > 1 and dist.get_rank() != 0:
        return lambda *a, **k: None
    return builtins.print


def _launched() -> None:
    """The ``python -m`` entry point. Under ``torch.distributed.run``
    (``WORLD_SIZE`` > 1 in the environment) it joins the launcher's group
    first, NCCL on the card ``LOCAL_RANK`` or gloo on the CPU, and leaves
    it after."""
    import torch.distributed as dist
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        main()
        return
    dev = resolve_device(_parser().parse_known_args()[0].device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        main()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _launched()
