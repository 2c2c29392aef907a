"""Offline example generation — the three windowing schemes of the reference.

Ported from tlsan_tpu/data/builders.py in numpy: the builders walk the
per-user runs of the category file's columns (data/remap.py) where the JAX
package's walk a pandas ``groupby("reviewerID")``; users come in id order
and each user's rows in file order, as the groupby gives them.  Online
featurization (serve/featurize.py) shares the time and category features,
so online and offline features cannot drift.

Each of the reference's nine `<MODEL>/build_dataset.py` scripts is one of
three schemes (SURVEY.md §2.2):

  session   — TLSAN (TLSAN/build_dataset.py:23-73), SHAN (SHAN/build_dataset.py:27-54),
              PACA (PACA/build_dataset.py:27-55): group items by identical
              review day; long-term = all prior sessions, short-term = current
              session; target = first item of the next session; the final
              session is the test example.
  prefix    — ATRank/CNN/CSAN/Bi-LSTM/LSPM (e.g. ATRank/build_dataset.py:32-41):
              for each position i, history = first i items; last position is
              the test example.
  pairwise  — BPR (BPR/build_dataset.py:12-26): every interaction becomes a
              (uid, pos, neg) triple; the last one per user is the test.

The builders reproduce the reference's `random.seed(1234)` call sequence
*exactly* (same `random.randint` rejection sampling, `random.choice` test-item
pick, and final `random.shuffle`s), so given the same input they emit
bit-identical train/test sets.  The one deviation: the reference looks up each
item's category with an O(n) DataFrame scan per item
(TLSAN/build_dataset.py:47) — this uses the O(1) `item_cate_list` array, which
holds the same values by construction (utils/2_remap_id.py:94-95), consuming
no randomness.
"""

from __future__ import annotations

import random
from collections import Counter
from typing import Iterator, List, Mapping, Sequence, Tuple

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


def _gen_neg_list(rng: random.Random, pos_list: List[int], item_count: int) -> List[int]:
    """Uniform rejection sampling over the catalog, one neg per position
    (reference: TLSAN/build_dataset.py:28-33 — identical in all 9 builders)."""
    negs = []
    pos_set = set(pos_list)
    for _ in range(len(pos_list)):
        # first candidate is pos_list[0], which always rejects — reproducing
        # the reference's `neg = pos_list[0]; while neg in pos_list: ...`
        neg = pos_list[0]
        while neg in pos_set:
            neg = rng.randint(0, item_count - 1)
        negs.append(neg)
    return negs


def _dominant_cate(cates: List[int]) -> int:
    """Most frequent category so far (reference: TLSAN/build_dataset.py:54
    `pd.value_counts(pre_cates).index[0]`).  Ties: value_counts keeps the
    first-encountered order within equal counts, matching Counter insertion
    order here."""
    return Counter(cates).most_common(1)[0][0]


def user_runs(reviews: Mapping[str, np.ndarray]
              ) -> Iterator[Tuple[int, List[int], List[int]]]:
    """(user id, items, days) of each user, users in id order, each user's
    rows in their order in `reviews` — what ``groupby("reviewerID")``
    yields.  `reviews` maps column names to arrays (a DataFrame works too)."""
    uid = np.asarray(reviews["reviewerID"])
    order = np.argsort(uid, kind="stable")
    uid = uid[order]
    items = np.asarray(reviews["asin"])[order].tolist()
    days = np.asarray(reviews["unixReviewTime"])[order].tolist()
    starts = np.flatnonzero(np.r_[True, uid[1:] != uid[:-1]]) if len(uid) else []
    bounds = np.r_[starts, len(uid)].astype(np.int64).tolist()
    for s, e in zip(bounds[:-1], bounds[1:]):
        yield int(uid[s]), items[s:e], days[s:e]


def build_session_examples(
    reviews: Mapping[str, np.ndarray],
    item_cate_list: np.ndarray,
    item_count: int,
    variant: str = "tlsan",
    max_length: int = 90,
    seed: int = 1234,
) -> Tuple[list, list]:
    """Session-grouped builder for TLSAN / SHAN / PACA.

    Tuple formats (matching the reference pickles exactly):
      tlsan train: (uid, pre_session, new_session, pre_time_emb, item, label, now_cate)
      tlsan test:  (uid, pre_session, new_session, pre_time_emb, (pos, neg), now_cate)
      shan  train: (uid, pre_session, new_session, item, label)     test: (uid, pre, new, (pos, neg))
      paca  train: (pre_session, item, label)                       test: (pre_session, (pos, neg))
    """
    assert variant in ("tlsan", "shan", "paca")
    rng = random.Random(seed)
    train_set: list = []
    test_set: list = []

    for reviewerID, pos_list, tim_list in user_runs(reviews):
        neg_list = _gen_neg_list(rng, pos_list, item_count)

        valid_length = min(len(pos_list), max_length)
        i = 0
        session_days = sorted(set(tim_list))
        pre_session: List[int] = []
        pre_time: List[int] = []
        pre_cates: List[int] = []
        for t in session_days:
            count = tim_list.count(t)
            new_session = pos_list[i : i + count]
            new_time = tim_list[i : i + count]

            if t == session_days[0]:
                pre_session.extend(new_session)
                pre_time.extend(new_time)
                if variant == "tlsan":
                    pre_cates.extend(int(item_cate_list[it]) for it in new_session)
            elif i + count < valid_length - 1:
                pre_copy = list(pre_session)
                target_pos, target_neg = pos_list[i + count], neg_list[i + count]
                if variant == "tlsan":
                    now_cate = _dominant_cate(pre_cates)
                    emb = reciprocal_time(pre_time, tim_list[i])
                    train_set.append(
                        (reviewerID, pre_copy, new_session, emb, target_pos, 1, now_cate)
                    )
                    train_set.append(
                        (reviewerID, pre_copy, new_session, emb, target_neg, 0, now_cate)
                    )
                elif variant == "shan":
                    train_set.append((reviewerID, pre_copy, new_session, target_pos, 1))
                    train_set.append((reviewerID, pre_copy, new_session, target_neg, 0))
                else:  # paca — uid dropped (PACA/build_dataset.py:43-44)
                    train_set.append((pre_copy, target_pos, 1))
                    train_set.append((pre_copy, target_neg, 0))
                pre_session.extend(new_session)
                pre_time.extend(new_time)
                if variant == "tlsan":
                    pre_cates.extend(int(item_cate_list[it]) for it in new_session)
            else:
                # final session → test: random member is the target, the rest
                # stay as short-term context (TLSAN/build_dataset.py:64-71)
                pos_item = pos_list[i]
                if count > 1:
                    pos_item = rng.choice(new_session)
                    new_session.remove(pos_item)
                neg_index = pos_list.index(pos_item)
                pos_neg = (pos_item, neg_list[neg_index])
                if variant == "tlsan":
                    now_cate = _dominant_cate(pre_cates)
                    emb = reciprocal_time(pre_time, t)
                    test_set.append(
                        (reviewerID, pre_session, new_session, emb, pos_neg, now_cate)
                    )
                elif variant == "shan":
                    test_set.append((reviewerID, pre_session, new_session, pos_neg))
                else:
                    test_set.append((pre_session, pos_neg))
                break
            i += count

    rng.shuffle(train_set)
    rng.shuffle(test_set)
    return train_set, test_set


def build_prefix_examples(
    reviews: Mapping[str, np.ndarray],
    item_count: int,
    time_mode: str = "none",
    max_length: int = 90,
    pack_pos_neg: bool = False,
    seed: int = 1234,
) -> Tuple[list, list]:
    """Prefix sliding-window builder for ATRank/CNN (time_mode='bucket',
    max_length 90/80), CSAN ('raw'), Bi-LSTM ('none'), LSPM ('none',
    pack_pos_neg=True).

    Reference: ATRank/build_dataset.py:32-41 and clones.
    """
    assert time_mode in ("none", "bucket", "raw")
    rng = random.Random(seed)
    train_set: list = []
    test_set: list = []

    for reviewerID, pos_list, tim_list in user_runs(reviews):
        neg_list = _gen_neg_list(rng, pos_list, item_count)

        valid_length = min(len(pos_list), max_length)
        for i in range(1, valid_length):
            hist_i = pos_list[:i]
            if time_mode == "bucket":
                hist_t = bucket_time(tim_list[:i], tim_list[i])
            elif time_mode == "raw":
                hist_t = raw_delta_time(tim_list[:i], tim_list[i])
            else:
                hist_t = None

            if i != valid_length - 1:
                if pack_pos_neg:  # LSPM/build_dataset.py:29
                    train_set.append((reviewerID, hist_i, (pos_list[i], neg_list[i])))
                elif hist_t is None:
                    train_set.append((reviewerID, hist_i, pos_list[i], 1))
                    train_set.append((reviewerID, hist_i, neg_list[i], 0))
                else:
                    train_set.append((reviewerID, hist_i, hist_t, pos_list[i], 1))
                    train_set.append((reviewerID, hist_i, hist_t, neg_list[i], 0))
            else:
                label = (pos_list[i], neg_list[i])
                if hist_t is None:
                    test_set.append((reviewerID, hist_i, label))
                else:
                    test_set.append((reviewerID, hist_i, hist_t, label))

    rng.shuffle(train_set)
    rng.shuffle(test_set)
    return train_set, test_set


def build_pairwise_examples(
    reviews: Mapping[str, np.ndarray], item_count: int, seed: int = 1234
) -> Tuple[np.ndarray, np.ndarray]:
    """BPR builder: int32[N,3] (uid, pos, neg) triples, last-per-user holdout
    (reference: BPR/build_dataset.py:12-35)."""
    rng = random.Random(seed)
    train_set: list = []
    test_set: list = []
    for reviewerID, pos_list, _ in user_runs(reviews):
        neg_list = _gen_neg_list(rng, pos_list, item_count)
        triples = [(reviewerID, p, n) for p, n in zip(pos_list, neg_list)]
        train_set.extend(triples[:-1])
        test_set.append(triples[-1])
    rng.shuffle(train_set)
    rng.shuffle(test_set)
    return (
        np.array(train_set, dtype=np.int32),
        np.array(test_set, dtype=np.int32),
    )
