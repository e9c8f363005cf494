from .datasets import (RangeDataset, make_range_dataset, make_queries,
                       relative_distance_error, brute_force_topk,
                       recall_at_k)
from .loader import TokenLoader

__all__ = ["RangeDataset", "make_range_dataset", "make_queries",
           "relative_distance_error", "brute_force_topk", "recall_at_k",
           "TokenLoader"]
