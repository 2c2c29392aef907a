"""Seeded Amazon-SNAP-format review and meta dumps with known remap counts.

  write_snap_fixture(out_dir, "Electronics", users=39_991, items=22_048,
                     cates=673, reviews=561_100)

writes ``reviews_<Category>_5.json.gz`` and ``meta_<Category>.json.gz``
(one python dict literal a line, as SNAP serves them) such that
`data.remap.remap_ids` with the default filters (an item needs 8 rows, a
user 10, and 4 to 90 distinct review days) keeps exactly `users` users,
`items` items, `cates` categories and `reviews` rows — by construction:
every kept user has at least 10 rows over 4 to `max_days` days, and every
kept item at least 8 rows among them.  Rows that each filter must drop
come on top:

  - users with 9 rows (the user filter);
  - items with 7 rows, one of them in a category of its own, given to kept
    users (the item filter, before the session count);
  - a user with 12 rows on 3 days and one with 91 rows on 91 days (the
    session filter);
  - an asin with 8 rows and no meta row, each on a day its user already
    has (dropped with a warning after the session count);
  - meta rows of asins nobody reviewed (dropped by convert).

Rows are written in a shuffled order, so same-day rows of a user come in
no particular order and the remap's stable sort decides it; one kept
user's final day holds the same item twice.  Users are split into
``min(16, cates)`` groups, each preferring the items of its own
categories (80% of its rows beyond the coverage rows), so a model learns
something within an epoch.  Used by the tests and chip_smoke.py; nothing
is downloaded.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict

import numpy as np

MIN_ITEM, MIN_USER, MIN_SESSIONS, MAX_SESSIONS = 8, 10, 4, 90
PREFERENCE = 0.8  # share of a user's free rows drawn from its group's items
DAY0 = 14_000     # days since 1970: 2008


def _ids(rng: np.random.Generator, prefix: str, n: int, width: int) -> np.ndarray:
    """n distinct fixed-width ids whose sorted order is a shuffle of 0..n-1."""
    return np.array([f"{prefix}{p:0{width}X}" for p in rng.permutation(n)])


def _days(rng: np.random.Generator, n_rows: int, n_days: int) -> np.ndarray:
    """Days of one user's rows: `n_days` distinct days, each used."""
    start = DAY0 + int(rng.integers(0, 2_000))
    distinct = start + np.cumsum(rng.integers(1, 60, n_days))
    which = np.r_[np.arange(n_days), rng.integers(0, n_days, n_rows - n_days)]
    return np.sort(distinct[which])


def write_snap_fixture(out_dir: str, category: str, users: int, items: int,
                       cates: int, reviews: int, seed: int = 0,
                       max_days: int = 8) -> Dict[str, int]:
    """Write the two dumps under `out_dir`; returns the counts the remap
    must give (user_count, item_count, cate_count, example_count)."""
    rng = np.random.default_rng(seed)
    per_user = reviews // users
    if per_user < MIN_USER or items < cates or reviews < items * MIN_ITEM:
        raise ValueError("counts cannot pass the default filters")
    n_rows = np.full(users, per_user)
    n_rows[rng.permutation(users)[:reviews - per_user * users]] += 1

    groups = min(16, cates)
    item_cate = np.r_[np.arange(cates), rng.integers(0, cates, items - cates)]
    item_cate = rng.permutation(item_cate)
    user_group = rng.permutation(np.arange(users) % groups)
    owner = np.repeat(np.arange(users), n_rows)
    row_item = np.empty(reviews, np.int64)
    for g in range(groups):  # per group: coverage rows, then preferences
        slots = rng.permutation(np.flatnonzero(user_group[owner] == g))
        own = np.flatnonzero(item_cate % groups == g)
        cover = np.repeat(own, MIN_ITEM)
        if len(cover) > len(slots):
            raise ValueError(f"group {g}: {len(own)} items need more rows")
        free = len(slots) - len(cover)
        prefer = rng.random(free) < PREFERENCE
        pick = np.where(prefer, own[rng.integers(0, len(own), free)],
                        rng.integers(0, items, free))
        row_item[slots] = np.r_[cover, pick]

    row_day = np.empty(reviews, np.int64)
    bounds = np.r_[0, np.cumsum(n_rows)]
    n_days = rng.integers(MIN_SESSIONS, np.minimum(max_days, n_rows) + 1)
    for u in range(users):
        row_day[bounds[u]:bounds[u + 1]] = _days(rng, n_rows[u], n_days[u])
    counts = np.bincount(row_item, minlength=items)
    for u in range(users):  # a final day holding one item twice
        last = np.flatnonzero(row_day[bounds[u]:bounds[u + 1]]
                              == row_day[bounds[u + 1] - 1]) + bounds[u]
        if len(last) >= 2 and counts[row_item[last[0]]] > MIN_ITEM:
            counts[row_item[last[0]]] -= 1
            row_item[last[0]] = row_item[last[1]]
            break

    # rows every filter must drop, appended as extra users and items
    extra_users = 4
    light = [(users + k, MIN_USER - 1, MIN_SESSIONS) for k in range(extra_users)]
    few_days = (users + extra_users, MIN_USER + 2, MIN_SESSIONS - 1)
    many_days = (users + extra_users + 1, MAX_SESSIONS + 1, MAX_SESSIONS + 1)
    ex_owner, ex_item, ex_day = [], [], []
    for u, n, d in light + [few_days, many_days]:
        ex_owner += [u] * n
        ex_item += rng.integers(0, items, n).tolist()
        ex_day += _days(rng, n, d).tolist()
    rare = 3  # items with MIN_ITEM - 1 rows; the last has a category of its own
    for r in range(rare):
        for u in rng.choice(users, MIN_ITEM - 1, replace=False):
            ex_owner.append(int(u))
            ex_item.append(items + r)
            ex_day.append(int(row_day[bounds[u]]))
    no_meta = items + rare
    for u in rng.choice(users, MIN_ITEM, replace=False):
        ex_owner.append(int(u))
        ex_item.append(no_meta)
        ex_day.append(int(row_day[bounds[u + 1] - 1]))

    owner = np.r_[owner, ex_owner]
    row_item = np.r_[row_item, ex_item]
    row_day = np.r_[row_day, ex_day]
    user_ids = _ids(rng, "A", users + extra_users + 2, 12)
    asins = _ids(rng, "B", items + rare + 1 + 5, 9)  # 5 asins nobody reviews
    seconds = row_day * 86_400 + rng.integers(0, 86_400, len(row_day))
    order = rng.permutation(len(owner))

    os.makedirs(out_dir, exist_ok=True)
    with gzip.open(os.path.join(out_dir, f"reviews_{category}_5.json.gz"),
                   "wt", compresslevel=1) as f:
        f.write("".join(
            f"{{'reviewerID': '{user_ids[u]}', 'asin': '{asins[i]}', "
            f"'unixReviewTime': {t}}}\n"
            for u, i, t in zip(owner[order].tolist(), row_item[order].tolist(),
                               seconds[order].tolist())))
    meta_cate = np.r_[item_cate, rng.integers(0, cates, rare - 1), cates,
                      rng.integers(0, cates, 6)]
    meta_rows = [i for i in rng.permutation(len(asins)) if i != no_meta]
    with gzip.open(os.path.join(out_dir, f"meta_{category}.json.gz"),
                   "wt", compresslevel=1) as f:
        f.write("".join(
            f"{{'asin': '{asins[i]}', 'categories': [['{category}'], "
            f"['{category}', 'Group {meta_cate[i] % groups}', "
            f"'Cate {meta_cate[i]:04d}']]}}\n" for i in meta_rows))
    return {"user_count": users, "item_count": items, "cate_count": cates,
            "example_count": reviews}
