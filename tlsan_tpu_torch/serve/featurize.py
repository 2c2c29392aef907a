"""Online request featurization — raw user events → model batch.

A copy of tlsan_tpu/serve/featurize.py that reads the port's own ``data``
and ``core``; for every family it emits the same numpy batch, bit for bit
(tests/test_torch_serve.py, tests/test_torch_atrank.py,
tests/test_torch_family_paths.py).

The reference has no online inference path at all: its only featurization
lives inside the offline ``build_dataset.py`` scripts.  This module closes
the serving loop: a live request (a user's raw (item, day) event stream)
is converted into exactly the batch layout each family's iterator produces
(SURVEY.md §2.3), reusing the OFFLINE builders' feature code
(data/builders.py: reciprocal_time / bucket_time / raw_delta_time,
dominant-category; data/batcher.py: the same pad/window/align semantics) —
so online and offline features cannot drift.

Conventions:
  * ``events`` is a list of (item_id, day) sorted ascending by day —
    the unit is the dataset's session day (utils/2_remap_id.py divides
    unixReviewTime by 86400 at remap time).
  * ``now`` defaults to the last event's day (the user asks "what next?"
    right after their latest activity); pass the query time explicitly to
    re-featurize time deltas against a different moment.
  * Session families (tlsan/shan/paca) treat the items on the last day as
    the CURRENT session (short-term context) and everything before as the
    long-term history, mirroring the offline session grouping
    (TLSAN/build_dataset.py:23-73); PACA reads the long-term list only.
  * Prefix families take the last ``max_length`` events (LSPM its
    right-aligned last-k window): ATRank and CNN with int32 time buckets,
    CSAN with float day deltas, Bi-LSTM and LSPM with no time.
  * ATRank and CSAN condition the user tower on a query item: serving
    uses the most recent history item (SURVEY.md §2.4).
  * BPR-MF serves by user id alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.data.batcher import _scatter_pad
from tlsan_tpu_torch.data.builders import (
    _dominant_cate,
    bucket_time,
    raw_delta_time,
    reciprocal_time,
)

Event = Tuple[int, int]  # (item_id, day)

SESSION_FAMILIES = ("tlsan", "shan", "paca")
PREFIX_FAMILIES = ("atrank", "cnn", "csan", "bilstm", "lspm")
# families whose user tower is conditioned on a query item at eval
QUERY_CONDITIONED = ("atrank", "csan")


def _split_sessions(events: Sequence[Event]):
    """(pre_items, pre_days, new_items, last_day): items strictly before
    the final day vs the final-day session.  A single-session history has
    no 'before', so it doubles as both contexts (cold-ish start)."""
    days = [d for _, d in events]
    last_day = days[-1]
    pre = [(i, d) for i, d in events if d < last_day]
    new = [i for i, d in events if d == last_day]
    if not pre:  # single session: long-term = the session itself
        pre = list(events)
    return [i for i, _ in pre], [d for _, d in pre], new, last_day


def featurize(model_name: str, cfg: ModelConfig, events: Sequence[Event],
              user_id: Optional[int] = None, now: Optional[int] = None,
              cate_list: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """One request → a 1-row batch dict in the family's eval layout
    (history/length/time keys; no label fields).  See module docstring."""
    if model_name == "bpr":
        if user_id is None:
            raise ValueError("bpr serves by user id")
        return {"u": np.asarray([user_id], np.int32)}
    if model_name not in SESSION_FAMILIES + PREFIX_FAMILIES:
        raise ValueError(f"unknown model family {model_name}")
    if not events:
        raise ValueError("empty event history")
    events = sorted(events, key=lambda e: e[1])
    if now is None:
        now = events[-1][1]

    if model_name in SESSION_FAMILIES:
        pre_i, pre_t, new_i, _ = _split_sessions(events)
        Ls, Ts = cfg.Ls, cfg.Ts
        if model_name == "paca":
            # PACA consumes only the long-term list (PACA/build_dataset.py)
            return {"hist_i": _scatter_pad([pre_i], Ls, np.int32),
                    "sl": np.asarray([min(len(pre_i), Ls)], np.int32)}
        out = {
            "u": np.asarray([user_id], np.int32),
            "hist_i": _scatter_pad([pre_i], Ls, np.int32),
            "hist_i_new": _scatter_pad([new_i[:Ts]], Ts, np.int32, window="first"),
            "sl": np.asarray([min(len(pre_i), Ls)], np.int32),
            "sl_new": np.asarray([min(len(new_i), Ts)], np.int32),
        }
        if model_name == "tlsan":
            if cate_list is None:
                raise ValueError("tlsan needs cate_list")
            # the single-session fallback above can leave same-day events in
            # the long-term history; offline, cur_t is always from a LATER
            # session so delta+1 >= 2 (builders.reciprocal_time docstring).
            # Clamp those to yesterday: delta+1 = 2 -> the max-recency
            # bucket weight 1.0, instead of 1/0 = inf -> NaN scores.
            emb = reciprocal_time([min(t, now - 1) for t in pre_t], now)
            out["hist_t"] = _scatter_pad([emb], Ls, np.float32)
            out["c"] = np.asarray(
                [_dominant_cate([int(cate_list[i]) for i in pre_i])], np.int32)
        return out

    items = [i for i, _ in events]
    days = [d for _, d in events]
    if model_name == "lspm":
        # fixed right-aligned last-k window (LSPM/input.py:30-37)
        k = cfg.lspm_k
        win = items[-k:]
        return {"u": np.asarray([user_id], np.int32),
                "hist_i": _scatter_pad([win], k, np.int32, align="right"),
                "sl": np.asarray([min(len(win), k)], np.int32)}
    T = cfg.max_length
    items, days = items[-T:], days[-T:]
    out = {
        "u": np.asarray([user_id], np.int32),
        "hist_i": _scatter_pad([items], T, np.int32),
        "sl": np.asarray([len(items)], np.int32),
    }
    if model_name in ("atrank", "cnn"):
        out["hist_t"] = _scatter_pad([bucket_time(days, now)], T, np.int32)
    elif model_name == "csan":
        out["hist_t"] = _scatter_pad([raw_delta_time(days, now)], T, np.float32)
    if model_name in QUERY_CONDITIONED:
        out["i"] = np.asarray([items[-1]], np.int32)
    return out


def featurize_many(model_name: str, cfg: ModelConfig,
                   requests: List[Dict], cate_list=None) -> Dict[str, np.ndarray]:
    """Batch of requests → concatenated batch dict.  Each request:
    {"user": int?, "events": [[item, day], ...], "now": int?}."""
    if not requests:
        raise ValueError("empty requests list")
    rows = [featurize(model_name, cfg,
                      [(int(i), int(d)) for i, d in r.get("events", [])],
                      user_id=r.get("user"), now=r.get("now"),
                      cate_list=cate_list)
            for r in requests]
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
