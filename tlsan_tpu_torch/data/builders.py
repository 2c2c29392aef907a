"""Time and category features of the offline example builders.

A numpy-only copy of the feature code in tlsan_tpu/data/builders.py that
online featurization shares with the builders, so online and offline
features cannot drift.  The builders themselves (which walk pandas
DataFrames) come with the data slice.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import numpy as np

# time-delta bucket boundaries in days (reference: ATRank/build_dataset.py:13,
# TLSAN/build_dataset.py:16)
TIME_GAPS = np.array([2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096])


def bucket_time(hist_t: Sequence[int], cur_t: int) -> List[int]:
    """Integer bucket index in 0..12 (reference: ATRank/build_dataset.py:15-18)."""
    return [int(np.sum((cur_t - t + 1) >= TIME_GAPS)) for t in hist_t]


def reciprocal_time(hist_t: Sequence[int], cur_t: int) -> List[float]:
    """TLSAN's reciprocal bucket 1/k in (0,1] (reference: TLSAN/build_dataset.py:18-21).

    Note: delta < 2 days gives k=0 and an inf weight, as in the reference;
    offline, cur_t is from a *later* session, and online featurization
    clamps same-day events (serve/featurize.py).
    """
    return [1.0 / np.sum((cur_t - t + 1) >= TIME_GAPS) for t in hist_t]


def raw_delta_time(hist_t: Sequence[int], cur_t: int) -> List[int]:
    """CSAN's raw day delta (reference: CSAN/build_dataset.py:13-15)."""
    return [cur_t - t + 1 for t in hist_t]


def _dominant_cate(cates: List[int]) -> int:
    """Most frequent category so far (reference: TLSAN/build_dataset.py:54
    `pd.value_counts(pre_cates).index[0]`).  Ties: value_counts keeps the
    first-encountered order within equal counts, matching Counter insertion
    order here."""
    return Counter(cates).most_common(1)[0][0]
