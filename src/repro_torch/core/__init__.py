"""MSTG core of the port: the index, the planner and the search engines.

* predicate algebra  — :mod:`repro_torch.core.predicates`
* typed requests     — :class:`SearchRequest` -> :class:`SearchResult` with
  :class:`RouteReport` diagnostics (:mod:`repro_torch.core.api`)
* index lifecycle    — :class:`IndexSpec`, ``MSTGIndex.build/save/load``
  (host NumPy; the same ``mstg-index`` v1 ``.npz`` as the reference)
* execution          — :class:`QueryEngine` with an :class:`EngineConfig`,
  on an explicit device (auto-routed graph / pruned / flat)
* continuous batching — :class:`WavefrontStream` admits queries into the
  slots converged rows free between wavefront chunks
"""
from . import build, intervals, segment_tree
from .intervals import (LEFT_OVERLAP, QUERY_CONTAINED, RIGHT_OVERLAP,
                        QUERY_CONTAINING, BEFORE, AFTER, ANY_OVERLAP,
                        RFANN_MASK, IFANN_MASK, TSANN_MASK,
                        AttributeDomain, SearchTask, PlanSlot, plan_searches,
                        plan_batch_ranked, eval_predicate, mask_name,
                        parse_mask, SelectivityIndex)
from .predicates import (Predicate, LeftOverlap, RightOverlap, QueryContained,
                         QueryContaining, Contains, ContainedBy, Overlaps,
                         Before, After, as_predicate, as_mask)
from .api import (IndexSpec, QueryHit, Rejected, RouteReport, SearchRequest,
                  SearchResult, SegmentReport, Served, ShardReport)
from .mstg import MSTGIndex, FrozenVariant, build_variant
from .quant import STORAGE_DTYPES, QuantizedStore, maybe_quantize
from .compressed import exact_rerank
from .search import (WavefrontStream, device_variant, mstg_graph_search,
                     mstg_graph_search_chunked, merge_topk)
from .flat import flat_search
from .engine import EngineConfig, QueryEngine, resolve_device

__all__ = [
    "Predicate", "LeftOverlap", "RightOverlap", "QueryContained",
    "QueryContaining", "Contains", "ContainedBy", "Overlaps", "Before",
    "After", "as_predicate", "as_mask",
    "SearchRequest", "SearchResult", "QueryHit", "RouteReport",
    "SegmentReport", "ShardReport", "IndexSpec", "Rejected", "Served",
    "MSTGIndex", "QueryEngine", "EngineConfig", "FrozenVariant",
    "build_variant", "AttributeDomain", "device_variant", "resolve_device",
    "mstg_graph_search", "mstg_graph_search_chunked", "merge_topk",
    "WavefrontStream", "flat_search",
    "STORAGE_DTYPES", "QuantizedStore", "maybe_quantize", "exact_rerank",
    "SearchTask", "PlanSlot", "plan_searches", "plan_batch_ranked",
    "eval_predicate", "mask_name", "parse_mask", "SelectivityIndex",
    "LEFT_OVERLAP", "QUERY_CONTAINED", "RIGHT_OVERLAP", "QUERY_CONTAINING",
    "BEFORE", "AFTER", "ANY_OVERLAP", "RFANN_MASK", "IFANN_MASK", "TSANN_MASK",
    "build", "intervals", "segment_tree",
]
