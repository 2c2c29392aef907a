"""Static-shape packing of ragged example tuples into dense arrays.

A numpy-only copy of the pieces of tlsan_tpu/data/batcher.py that serving
and training need: the whole dataset is packed once into dense,
statically-shaped arrays, moved to the device, and batches are gathered
there by an index; shuffling is an index permutation.  Padding semantics
match the reference exactly: the long-term window keeps the *last* k items
when the history is longer and left-aligns (TLSAN/input.py:40-49); the
short-term session left-aligns with zeros (TLSAN/input.py:50-51); pad id
is 0; LSPM's window right-aligns (LSPM/input.py:30-37).  Every packer of
the JAX package is here: the session packers' tlsan, shan and paca
variants, the prefix packers of the five prefix families, and BPR-MF's
triples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

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


@dataclass
class Batches:
    """A packed dataset: dict of dense arrays, all with leading dim n."""

    arrays: Dict[str, np.ndarray]
    n: int

    def __getitem__(self, key: str) -> np.ndarray:
        return self.arrays[key]


def pack_session_train(
    train_set: list, Ls: int, Ts: int, variant: str = "tlsan"
) -> Batches:
    """Pack session-scheme train tuples into static shapes.

    tlsan tuples: (uid, pre, new, time_emb, item, label, now_cate)
                  → u, i, y, c, hist_i[N,Ls], hist_t[N,Ls], hist_i_new[N,Ts],
                    sl, sl_new  (feed semantics of TLSAN/input.py:17-54)
    shan tuples:  (uid, pre, new, item, label) — long history padded to Ls
                  full width (SHAN/input.py pads to the batch max, which
                  the model restores with a mask), no time.
    paca tuples:  (pre, item, label) — single history (PACA/input.py).
    """
    n = len(train_set)
    if variant == "tlsan":
        u = np.fromiter((t[0] for t in train_set), np.int32, n)
        i = np.fromiter((t[4] for t in train_set), np.int32, n)
        y = np.fromiter((t[5] for t in train_set), np.float32, n)
        c = np.fromiter((t[6] for t in train_set), np.int32, n)
        sl = np.fromiter((min(len(t[1]), Ls) for t in train_set), np.int32, n)
        sl_new = np.fromiter((len(t[2]) for t in train_set), np.int32, n)
        hist_i = _scatter_pad([t[1] for t in train_set], Ls, np.int32)
        hist_t = _scatter_pad([t[3] for t in train_set], Ls, np.float32)
        hist_i_new = _scatter_pad([t[2] for t in train_set], Ts, np.int32, window="first")
        return Batches(
            dict(u=u, i=i, y=y, c=c, hist_i=hist_i, hist_t=hist_t,
                 hist_i_new=hist_i_new, sl=sl, sl_new=sl_new), n)
    if variant == "shan":
        u = np.fromiter((t[0] for t in train_set), np.int32, n)
        i = np.fromiter((t[3] for t in train_set), np.int32, n)
        y = np.fromiter((t[4] for t in train_set), np.float32, n)
        sl = np.fromiter((min(len(t[1]), Ls) for t in train_set), np.int32, n)
        sl_new = np.fromiter((len(t[2]) for t in train_set), np.int32, n)
        hist_i = _scatter_pad([t[1] for t in train_set], Ls, np.int32)
        hist_i_new = _scatter_pad([t[2] for t in train_set], Ts, np.int32, window="first")
        return Batches(
            dict(u=u, i=i, y=y, hist_i=hist_i, hist_i_new=hist_i_new,
                 sl=sl, sl_new=sl_new), n)
    if variant == "paca":
        i = np.fromiter((t[1] for t in train_set), np.int32, n)
        y = np.fromiter((t[2] for t in train_set), np.float32, n)
        sl = np.fromiter((min(len(t[0]), Ls) for t in train_set), np.int32, n)
        hist_i = _scatter_pad([t[0] for t in train_set], Ls, np.int32)
        return Batches(dict(i=i, y=y, hist_i=hist_i, sl=sl), n)
    raise ValueError(variant)


def pack_session_test(test_set: list, Ls: int, Ts: int,
                      variant: str = "tlsan") -> Batches:
    """Pack session-scheme test tuples; the target is the (pos, neg) pair
    (TLSAN/input.py:78-84)."""
    n = len(test_set)
    if variant == "tlsan":
        u = np.fromiter((t[0] for t in test_set), np.int32, n)
        pos = np.fromiter((t[4][0] for t in test_set), np.int32, n)
        neg = np.fromiter((t[4][1] for t in test_set), np.int32, n)
        c = np.fromiter((t[5] for t in test_set), np.int32, n)
        sl = np.fromiter((min(len(t[1]), Ls) for t in test_set), np.int32, n)
        sl_new = np.fromiter((len(t[2]) for t in test_set), np.int32, n)
        hist_i = _scatter_pad([t[1] for t in test_set], Ls, np.int32)
        hist_t = _scatter_pad([t[3] for t in test_set], Ls, np.float32)
        hist_i_new = _scatter_pad([t[2] for t in test_set], Ts, np.int32, window="first")
        return Batches(
            dict(u=u, i=pos, j=neg, c=c, hist_i=hist_i, hist_t=hist_t,
                 hist_i_new=hist_i_new, sl=sl, sl_new=sl_new), n)
    if variant == "shan":
        u = np.fromiter((t[0] for t in test_set), np.int32, n)
        pos = np.fromiter((t[3][0] for t in test_set), np.int32, n)
        neg = np.fromiter((t[3][1] for t in test_set), np.int32, n)
        sl = np.fromiter((min(len(t[1]), Ls) for t in test_set), np.int32, n)
        sl_new = np.fromiter((len(t[2]) for t in test_set), np.int32, n)
        hist_i = _scatter_pad([t[1] for t in test_set], Ls, np.int32)
        hist_i_new = _scatter_pad([t[2] for t in test_set], Ts, np.int32, window="first")
        return Batches(
            dict(u=u, i=pos, j=neg, hist_i=hist_i, hist_i_new=hist_i_new,
                 sl=sl, sl_new=sl_new), n)
    if variant == "paca":
        pos = np.fromiter((t[1][0] for t in test_set), np.int32, n)
        neg = np.fromiter((t[1][1] for t in test_set), np.int32, n)
        sl = np.fromiter((min(len(t[0]), Ls) for t in test_set), np.int32, n)
        hist_i = _scatter_pad([t[0] for t in test_set], Ls, np.int32)
        return Batches(dict(i=pos, j=neg, hist_i=hist_i, sl=sl), n)
    raise ValueError(variant)


def pack_prefix_train(
    train_set: list,
    max_len: int,
    with_time: bool = False,
    pack_pos_neg: bool = False,
    align: str = "left",
    time_dtype=np.float32,
) -> Batches:
    """Pack prefix-scheme train tuples (ATRank/CNN/CSAN/Bi-LSTM/LSPM).

    ATRank feed (ATRank/input.py:3-42): u, i, y, hist_i[N,T], hist_t, sl;
    ATRank and CNN take int32 time buckets, CSAN float day deltas, Bi-LSTM
    no time.  LSPM packs (pos, neg) per tuple and right-aligns a fixed
    k-window (LSPM/input.py:30-37).
    """
    n = len(train_set)
    u = np.fromiter((t[0] for t in train_set), np.int32, n)
    sl = np.fromiter((min(len(t[1]), max_len) for t in train_set), np.int32, n)
    hist_i = _scatter_pad([t[1] for t in train_set], max_len, np.int32, align=align)
    arrays = dict(u=u, hist_i=hist_i, sl=sl)
    if pack_pos_neg:
        arrays["i"] = np.fromiter((t[2][0] for t in train_set), np.int32, n)
        arrays["j"] = np.fromiter((t[2][1] for t in train_set), np.int32, n)
    elif with_time:
        arrays["hist_t"] = _scatter_pad([t[2] for t in train_set], max_len,
                                        time_dtype, align=align)
        arrays["i"] = np.fromiter((t[3] for t in train_set), np.int32, n)
        arrays["y"] = np.fromiter((t[4] for t in train_set), np.float32, n)
    else:
        arrays["i"] = np.fromiter((t[2] for t in train_set), np.int32, n)
        arrays["y"] = np.fromiter((t[3] for t in train_set), np.float32, n)
    return Batches(arrays, n)


def pack_prefix_test(
    test_set: list,
    max_len: int,
    with_time: bool = False,
    align: str = "left",
    time_dtype=np.float32,
) -> Batches:
    """Pack prefix-scheme test tuples: the last element is the (pos, neg)
    pair."""
    n = len(test_set)
    u = np.fromiter((t[0] for t in test_set), np.int32, n)
    sl = np.fromiter((min(len(t[1]), max_len) for t in test_set), np.int32, n)
    hist_i = _scatter_pad([t[1] for t in test_set], max_len, np.int32, align=align)
    arrays = dict(u=u, hist_i=hist_i, sl=sl)
    if with_time:
        arrays["hist_t"] = _scatter_pad([t[2] for t in test_set], max_len,
                                        time_dtype, align=align)
        pair = [t[3] for t in test_set]
    else:
        pair = [t[2] for t in test_set]
    arrays["i"] = np.fromiter((p[0] for p in pair), np.int32, n)
    arrays["j"] = np.fromiter((p[1] for p in pair), np.int32, n)
    return Batches(arrays, n)


def pack_pairwise(triples: np.ndarray) -> Batches:
    """BPR-MF's (uid, pos, neg) int32[N, 3] triples as u, i, j — the
    arrays the JAX package's CLI slices out of them
    (tlsan_tpu/train/cli.py:178-189)."""
    triples = np.asarray(triples)
    return Batches(dict(u=triples[:, 0], i=triples[:, 1], j=triples[:, 2]),
                   len(triples))


def epoch_permutation(n: int, epoch: int, seed: int = 1234) -> np.ndarray:
    """Deterministic per-epoch shuffle (replaces random.shuffle at
    TLSAN/train.py:191)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n).astype(np.int32)


def epoch_index(n: int, batch_size: int, steps_per_call: int, epoch: int,
                seed: int = 1234) -> np.ndarray:
    """Shuffled [n_chunks, K, B] batch-index tensor for one epoch; the tail
    wraps to the permutation head so every chunk keeps the static shape (the
    reference instead runs a ragged final batch — TLSAN/input.py:10-11).
    Byte-identical to the JAX package's, so both see the same batches."""
    B, K = batch_size, steps_per_call
    perm = epoch_permutation(n, epoch, seed)
    steps = max(1, (n + B - 1) // B)
    n_chunks = max(1, (steps + K - 1) // K)
    total = n_chunks * K * B
    reps = int(np.ceil(total / n))
    return np.tile(perm, reps)[:total].reshape(n_chunks, K, B)


def pad_to_multiple(b: Batches, multiple: int) -> Batches:
    """Pad the leading dim so it divides evenly into batches; adds a `valid`
    mask so padded rows can be excluded from metrics."""
    n = b.n
    target = ((n + multiple - 1) // multiple) * multiple
    valid = np.zeros(target, dtype=bool)
    valid[:n] = True
    arrays = {}
    for k, v in b.arrays.items():
        pad_width = [(0, target - n)] + [(0, 0)] * (v.ndim - 1)
        arrays[k] = np.pad(v, pad_width)
    arrays["valid"] = valid
    return Batches(arrays, target)
