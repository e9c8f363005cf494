"""Closed loop: one client sends its next batch request only when the last
one has returned, back to back, through ``QueryEngine.execute``.

The window cycles over the pool, the predicates in turn
(:func:`round_robin`). Each request is timed by the host clock around
``execute``, which returns the answers on the host and so waits for the
card.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np


def round_robin(traffic, predicates) -> np.ndarray:
    """The pool's order in the window: the mix's predicates in turn, each
    predicate's requests in a seeded order. Every window then holds the
    predicates in the same proportions whatever the seed."""
    rng = traffic.rng(1)
    by_pred = [rng.permutation([i for i, r in enumerate(traffic.pool)
                                if r.predicate == p]) for p in predicates]
    return np.stack(by_pred, axis=1).reshape(-1)


class Loop:
    def __init__(self, engine, traffic, mix: dict):
        from repro_torch.core import SearchRequest
        from bench.system import predicate
        self.engine = engine
        self.traffic = traffic
        self.mix = mix
        self._request = SearchRequest
        self._pred = {r.predicate: predicate(r.predicate)
                      for r in traffic.pool}
        self.order = round_robin(traffic, mix["predicates"])

    def _call(self, r, trace: bool = False):
        m = self.mix
        req = self._request(r.vectors, (r.qlo, r.qhi), self._pred[r.predicate],
                            k=int(m["k"]), ef=int(m.get("ef", 64)),
                            route=m["route"], trace=trace)
        return self.engine.execute(req)

    def warm(self) -> None:
        """The first ``warm_requests`` of the window's order (the whole pool
        without it): every shape the window uses."""
        n = int(self.mix.get("warm_requests") or len(self.order))
        for i in range(n):
            self._call(self.traffic.pool[int(self.order[i % len(self.order)])])

    def run(self, seconds: float) -> dict:
        pool = self.traffic.pool
        lat: List[float] = []
        answers = []
        routes: Dict[str, int] = {}
        by_pred: Dict[str, List[float]] = {}
        t0 = time.perf_counter()
        t1 = t0
        i = 0
        while t1 - t0 < seconds:
            pi = int(self.order[i % len(pool)])
            ts = time.perf_counter()
            res = self._call(pool[pi])
            t1 = time.perf_counter()
            lat.append((t1 - ts) * 1e3)
            by_pred.setdefault(pool[pi].predicate, []).append(lat[-1])
            answers.append((pi, res.ids, res.dists))
            route = res.report.route if res.report is not None else "?"
            routes[route] = routes.get(route, 0) + 1
            i += 1
        b = pool[0].vectors.shape[0]
        return {"window_s": t1 - t0, "latency_ms": lat, "requests": i,
                "attempted": i, "failed": 0, "queries_answered": i * b,
                "answers": answers, "routes": routes,
                "ms_by_predicate": {p: round(sum(v) / len(v), 3)
                                    for p, v in by_pred.items()}}

    def spans(self, count: int) -> List[list]:
        """``count`` traced requests over the pool (after the window): the
        spans of each as (name, ms, args)."""
        out = []
        pool = self.traffic.pool
        for i in range(count):
            res = self._call(pool[int(self.order[i % len(pool)])], trace=True)
            out.append([(sp.name, sp.duration_ms, dict(sp.args))
                        for sp, _ in res.trace.walk()])
        return out

    def sample(self, out: dict) -> list:
        """The compared answers: ``check.per_predicate`` requests of each
        predicate among the window's, drawn from the seed."""
        rng = self.traffic.rng(2)
        pool = self.traffic.pool
        by_pred: Dict[str, list] = {}
        for pos, (pi, _, _) in enumerate(out["answers"]):
            by_pred.setdefault(pool[pi].predicate, []).append(pos)
        items = []
        per = int(self.mix["check"]["per_predicate"])
        for pred in sorted(by_pred):
            cand = by_pred[pred]
            for pos in rng.choice(cand, size=min(per, len(cand)),
                                  replace=False):
                pi, ids, dists = out["answers"][int(pos)]
                r = pool[pi]
                items.append((r.predicate, r.vectors, r.qlo, r.qhi,
                              np.asarray(ids), np.asarray(dists)))
        return items
