"""Size-tiered compaction policy for the segmented MSTG.

LSM-style: flushing the delta produces many small immutable segments; every
extra segment adds one more fan-out search per query, so the policy merges
segments of similar (small) size into one rebuilt segment, dropping
tombstoned rows. Victim selection is pure and separately testable —
:class:`repro_torch.streaming.SegmentedIndex` owns the actual rebuild.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Pick which segments a ``compact()`` call should merge.

    tier_ratio : segments whose live size is strictly under ``tier_ratio`` x
                 the smallest segment's live size form the smallest tier
    min_merge  : don't bother merging fewer than this many segments —
                 *unless* one of them is fully tombstoned (dead weight is
                 always worth dropping)
    max_merge  : cap on victims per compaction (bounds rebuild cost)
    """

    tier_ratio: float = 4.0
    min_merge: int = 2
    max_merge: int = 8

    def __post_init__(self):
        if self.tier_ratio < 1.0:
            raise ValueError("tier_ratio must be >= 1")
        if self.min_merge < 2:
            raise ValueError("min_merge must be >= 2")

    def pick(self, live_sizes: Sequence[int]) -> List[int]:
        """Indices of segments to merge, smallest live size first.

        ``live_sizes[i]`` is segment i's row count minus its tombstones.
        Empty (fully tombstoned) segments are always victims; otherwise the
        smallest tier is merged when it has >= ``min_merge`` members."""
        order = sorted(range(len(live_sizes)), key=lambda i: live_sizes[i])
        dead = [i for i in order if live_sizes[i] == 0]
        tier = []
        alive = [i for i in order if live_sizes[i] > 0]
        if alive:
            smallest = live_sizes[alive[0]]
            tier = [i for i in alive
                    if live_sizes[i] < smallest * self.tier_ratio]
        if len(tier) >= self.min_merge:
            return (dead + tier)[:self.max_merge]
        return dead  # dropping fully-dead segments costs no rebuild
