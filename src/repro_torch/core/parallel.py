"""Spawn-context process pools for CPU-bound index construction.

One helper shared by every parallel build site — variant-parallel
:class:`repro_torch.core.mstg.MSTGIndex` builds, shard-parallel
:meth:`repro.distributed.ShardedDeployment.build`, and streaming segment
freezes. Uses the ``spawn`` start method only: the parent process usually
has JAX/XLA threads live by build time, and forking a threaded process is
deadlock-prone. Workers re-import the repro build modules (numpy-only on
the build path, so startup stays sub-second) and stream their own
rate-limited :mod:`repro_torch.obs` progress lines to stderr; the parent
aggregates completion into one ``<label>_pool`` progress line per finished
task plus a per-task wall-clock report for bench attribution.

``run_build_pool`` degrades, never errors, on *pool* problems: if the
platform cannot spawn workers (sandboxes without process semaphores, broken
pools) it returns ``None`` and the caller runs its serial path. Exceptions
raised by the task function itself propagate unchanged.
"""
from __future__ import annotations

import multiprocessing
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.obs.log import get_logger

logger = get_logger(__name__)


def pool_size(workers: int, n_tasks: int) -> int:
    """Actual worker count a pool would use: capped by tasks, floor 0 when
    pooling is off (``workers <= 1`` means serial — one worker is never
    worth a process round-trip)."""
    return 0 if workers <= 1 or n_tasks <= 1 else min(int(workers), n_tasks)


def run_build_pool(fn: Callable[[Any], Any], tasks: Sequence[Any], *,
                   workers: int, label: str = "build",
                   timings: Optional[List[float]] = None
                   ) -> Optional[List[Any]]:
    """Run ``fn`` over ``tasks`` in a spawn process pool.

    Returns results in task order, or ``None`` when pooling is off/
    unavailable (the caller falls back to its serial loop). ``timings``,
    when given a list, receives each task's wall-clock seconds (task
    order) so callers can report per-worker build time.
    """
    n_pool = pool_size(workers, len(tasks))
    if n_pool == 0:
        return None
    try:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=n_pool, mp_context=ctx) as ex:
            t_start = time.perf_counter()
            futs = {ex.submit(fn, t): i for i, t in enumerate(tasks)}
            out: List[Any] = [None] * len(tasks)
            secs: List[float] = [0.0] * len(tasks)
            pending = set(futs)
            done_n = 0
            while pending:
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                now = time.perf_counter() - t_start
                for f in done:
                    out[futs[f]] = f.result()
                    secs[futs[f]] = now  # queue wait + run, per completion
                    done_n += 1
                logger.progress(f"{label}_pool", done=done_n,
                                total=len(tasks), workers=n_pool,
                                elapsed_s=round(now, 3),
                                final=done_n == len(tasks))
    except (BrokenProcessPool, OSError, ImportError) as exc:
        # pool-level failure (no semaphores / spawn unavailable / worker
        # bootstrap died): degrade to the caller's serial path
        logger.warning(f"{label}_pool_unavailable", error=repr(exc),
                       workers=n_pool)
        return None
    if timings is not None:
        timings[:] = secs
    return out
