"""Static-shape padding shared by the packers and online featurization.

A numpy-only copy of the pieces of tlsan_tpu/data/batcher.py that serving
needs.  Padding semantics match the reference exactly: the long-term window
keeps the *last* k items when the history is longer and left-aligns
(TLSAN/input.py:40-49); the short-term session left-aligns with zeros
(TLSAN/input.py:50-51); pad id is 0.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _scatter_pad(
    seqs: List[Sequence], width: int, dtype, align: str = "left", window: str = "last"
) -> np.ndarray:
    """Pack ragged sequences into a zero-padded [N, width] array (vectorized).

    window="last" keeps the trailing `width` elements when a sequence is
    longer (the TLSAN long-term window); "first" keeps the leading ones.
    align="left" places elements at columns [0, len); "right" at
    [width-len, width) (LSPM).
    """
    n = len(seqs)
    out = np.zeros((n, width), dtype=dtype)
    if window == "last":
        clipped = [s[-width:] if len(s) > width else s for s in seqs]
    else:
        clipped = [s[:width] for s in seqs]
    lens = np.fromiter((len(s) for s in clipped), dtype=np.int64, count=n)
    total = int(lens.sum())
    if total == 0:
        return out
    flat = np.concatenate([np.asarray(s, dtype=dtype) for s in clipped if len(s)])
    rows = np.repeat(np.arange(n), lens)
    # per-row 0..len-1 column index, computed without a python loop
    ends = np.cumsum(lens)
    cols = np.arange(total) - np.repeat(ends - lens, lens)
    if align == "right":
        cols = cols + np.repeat(width - lens, lens)
    out[rows, cols] = flat
    return out


def round8(n: int) -> int:
    """Pad a ragged max dim to a multiple of 8 — the shape rule the JAX
    package's packers and CLI share, so config sidecars agree."""
    return max(8, ((n + 7) // 8) * 8)
