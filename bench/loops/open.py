"""Open loop: independent users send single queries to
``AsyncRetrievalServer`` at Poisson arrival times fixed by the seed and the
mix's ``rate_per_s``, whatever the server's backlog.

One thread submits every query that is due and then steps the server, in
turn. A query's latency runs from when it was due, not from when it was
submitted, so a stall delays the queries behind it too. The loop keeps
its bookkeeping in arrays and takes each step's outcomes as they come
(``collect``), so that the harness adds no garbage a query. After the window
closes no more queries are submitted, and the server is stepped until every
query submitted in the window has its answer (at most ``drain_s``).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np


class Loop:
    def __init__(self, engine, traffic, mix: dict):
        from bench.system import predicate
        self.engine = engine
        self.traffic = traffic
        self.mix = mix
        self._pred = {r.predicate: predicate(r.predicate)
                      for r in traffic.pool}
        self._stream = 10

    def _server(self):
        from repro_torch.serving.async_engine import AsyncRetrievalServer
        from repro_torch.serving.scheduler import SLOPolicy
        m = self.mix
        return AsyncRetrievalServer(
            self.engine, lambda items: np.stack(items), k=int(m["k"]),
            ef=int(m.get("ef", 64)), policy=SLOPolicy(**m.get("policy", {})),
            route=m["route"])

    def warm(self) -> None:
        """``warm_seconds`` of the same load on a server of its own."""
        self._serve(float(self.mix["warm_seconds"]), stream=3)

    def run(self, seconds: float) -> dict:
        self._stream += 1
        return self._serve(seconds, stream=self._stream)

    def _serve(self, seconds: float, stream: int) -> dict:
        pool = self.traffic.pool
        rate = float(self.mix["rate_per_s"])
        due, which = self.traffic.arrivals(rate, seconds, stream)
        m = due.shape[0]
        # the compared answers: drawn from the seed before the window, so
        # that only they are kept
        keep = set(self.traffic.rng(4 + stream).choice(
            m, size=min(int(self.mix["check"]["queries"]), m),
            replace=False).tolist())
        srv = self._server()
        clock = time.perf_counter
        # per arrival, in arrays: no Python object a query in the window
        t_sub = np.full(m, np.nan)
        lat = np.full(m, np.nan)
        queue = np.full(m, np.nan)
        arrival_of = np.full(m, -1, np.int64)        # ticket -> arrival
        answers = []
        dispatched: List[int] = []

        def absorb(resolved) -> None:
            for tk, o in resolved.items():
                i = int(arrival_of[tk])
                if not o:                  # shed: counted as failed below
                    continue
                lat[i] = (t_sub[i] - t_due[i]) * 1e3 + o.e2e_ms
                queue[i] = o.queue_ms
                if i in keep:
                    answers.append((int(which[i]), o.hit.ids, o.hit.dists))

        t0 = clock()
        t_due = t0 + due
        nxt = 0
        while True:
            now = clock()
            if now - t0 >= seconds:
                break
            while nxt < m and t_due[nxt] <= now:
                r = pool[int(which[nxt])]
                t_sub[nxt] = clock()
                tk = srv.submit(r.vectors[0], float(r.qlo[0]),
                                float(r.qhi[0]), self._pred[r.predicate])
                if isinstance(tk, int):       # else shed: no answer, failed
                    arrival_of[tk] = nxt
                nxt += 1
            srv.step()
            if srv.step_stats.get("dispatched"):
                dispatched.append(int(srv.step_stats["dispatched"]))
            absorb(srv.collect())
        window_s = clock() - t0
        backlog = srv.scheduler.depth + srv.inflight
        t_close = clock()
        stop = t_close + float(self.mix["drain_s"])
        while not srv.idle and clock() < stop:
            srv.step()
            if srv.step_stats.get("dispatched"):
                dispatched.append(int(srv.step_stats["dispatched"]))
            absorb(srv.collect())
        absorb(srv.collect())
        drain_s = clock() - t_close
        done = ~np.isnan(lat[:nxt])
        return {"window_s": window_s, "latency_ms": lat[:nxt][done],
                "requests": nxt, "attempted": nxt,
                "failed": int(nxt - done.sum()),
                "queries_answered": int(done.sum()), "answers": answers,
                "queue_ms": queue[:nxt][done], "dispatched": dispatched,
                "max_batch": srv.scheduler.policy.max_batch,
                "backlog_at_close": backlog, "drain_s": drain_s,
                "late_ms": (t_sub[:nxt] - t_due[:nxt]) * 1e3}

    def spans(self, count: int) -> List[list]:
        return []

    def sample(self, out: dict) -> list:
        """The answers of ``check.queries`` arrivals of the window, drawn
        from the seed (a query that got none is counted in ``failed``)."""
        pool = self.traffic.pool
        items = []
        for pi, ids, dists in out["answers"]:
            r = pool[pi]
            items.append((r.predicate, r.vectors, r.qlo, r.qhi,
                          np.asarray(ids)[None, :],
                          np.asarray(dists)[None, :]))
        return items
