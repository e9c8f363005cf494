"""Streaming MSTG — LSM-style segmented index with upserts, deletes, flush,
and compaction over the frozen per-segment graphs of
:mod:`repro_torch.core`, served on one device.

    from repro_torch.streaming import SegmentedIndex

    sidx = SegmentedIndex(IndexSpec(predicate=Overlaps()), device="cuda")
    sidx.add(ids, vectors, lo, hi)      # upsert into the mutable delta
    sidx.delete(ids[:5])                # tombstone / in-delta kill
    sidx.flush()                        # freeze delta -> immutable segment
    sidx.compact()                      # size-tiered merge, drops tombstones
    result = sidx.search(SearchRequest(...))   # fan-out + host top-k merge
    sidx.save("idx_dir/"); SegmentedIndex.load("idx_dir/")

The manifest directory is the reference's ``mstg-segmented`` v1 format, so
either package loads the other's saves.
"""
from .compaction import CompactionPolicy
from .delta import DeltaBuffer
from .segmented import Segment, SegmentedIndex

__all__ = ["CompactionPolicy", "DeltaBuffer", "Segment", "SegmentedIndex"]
