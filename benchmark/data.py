"""The benchmark's traffic: a seeded Electronics-shaped review catalog, cut
into train rows and serving requests, in numpy and in memory.

Two frozen copies of the port's data code, vectorized:

  - the row generation of `tlsan_tpu_torch/tools/snap_fixture.py`: users
    in groups that prefer their own categories' items (80% of the rows
    beyond a coverage of 8 rows an item), review days as distinct days a
    few weeks apart; rows per user are the config's heavy-tailed
    distribution (at least 10, mean reviews/users) instead of the
    fixture's even split;
  - the windowing of `tlsan_tpu_torch/data/builders.py` and the packing of
    `data/batcher.py`: TLSAN's sessions (`build_session_examples` with
    `pack_session_train`) and ATRank's prefixes (`build_prefix_examples`
    with `pack_prefix_train`), a positive and a negative row each; the
    serving features as `serve/featurize.py` makes them from a user's
    whole history.

The *shape* of the catalog (rows, review days and the rows of each day,
per user) comes from the config's fixed `shape_seed`, so every seed has
the same set of history and session lengths, given to other users; the
run's seed draws everything else.  The session width Ts is set from that
shape as the port's pipeline sets it (`session_cap`).
Negatives are drawn uniformly outside the user's items, as the builders'
rejection sampling does, from numpy instead of `random`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# time-delta bucket edges in days (the builders' TIME_GAPS)
TIME_GAPS = np.array([2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
DAY0 = 14_000  # days since 1970: 2008

Arrays = Dict[str, np.ndarray]


def _starts(lengths: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lengths), np.int64)
    np.cumsum(lengths[:-1], out=out[1:])
    return out


def _bucket(delta: np.ndarray) -> np.ndarray:
    """How many TIME_GAPS edges `delta` (days + 1) reaches: 0..12."""
    return np.searchsorted(TIME_GAPS, delta, side="right")


def catalog_shape(cat: dict) -> tuple:
    """(rows, review days, day index of each row) of each user slot, from
    the fixed shape seed: rows = min_rows + a Lomax(tail_alpha) draw
    scaled to the mean, capped at max_rows and adjusted to sum to
    `reviews` exactly; days a share U(day_share) of the rows, within
    [min_days, max_days]; a slot's rows take its days once each, the rest
    a day at random (the day index, in slot order)."""
    rng = np.random.default_rng(cat["shape_seed"])
    users, reviews = cat["users"], cat["reviews"]
    lo, hi = cat["min_rows"], cat["max_rows"]
    extra_mean = reviews / users - lo
    alpha = cat["tail_alpha"]
    x = rng.pareto(alpha, users) * extra_mean * (alpha - 1.0)
    rows = np.minimum(lo + np.floor(x).astype(np.int64), hi)
    while True:  # to the exact total, a random user a row at a time
        diff = reviews - int(rows.sum())
        if diff == 0:
            break
        can = np.flatnonzero(rows < hi) if diff > 0 else np.flatnonzero(rows > lo)
        pick = rng.choice(can, min(abs(diff), len(can)), replace=False)
        rows[pick] += 1 if diff > 0 else -1
    share = rng.uniform(*cat["day_share"], users)
    days = np.clip(np.rint(rows * share).astype(np.int64), cat["min_days"],
                   np.minimum(rows, cat["max_days"]))
    pos = np.arange(reviews) - np.repeat(_starts(rows), rows)
    nd = np.repeat(days, rows)
    didx = np.where(pos < nd, pos, (rng.random(reviews) * nd).astype(np.int64))
    return rows, days, didx


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def session_cap(cat: dict, history_cap: int) -> int:
    """Ts as the port's pipeline sets it (`train/cli.py`, `data/native.py`):
    the longest new session of the builder's train rows and test rows (the
    session that ends a user's train rows, less its target), rounded up to
    a multiple of 8.
    The sessions are the shape's, so every seed gives the same Ts."""
    rows, _, didx = catalog_shape(cat)
    slot = np.repeat(np.arange(len(rows)), rows)
    keys, size = np.unique(slot * (int(didx.max()) + 1) + didx, return_counts=True)
    su = keys // (int(didx.max()) + 1)
    first = _starts(np.bincount(su, minlength=len(rows)))
    k = np.arange(len(su)) - first[su]
    rel = np.cumsum(size) - size - np.r_[0, np.cumsum(size)][first[su]]
    vl = np.minimum(rows[su], history_cap)
    train = (k >= 1) & (rel + size < vl - 1)
    after = np.flatnonzero((k >= 1) & ~train)
    test = after[np.r_[True, su[after][1:] != su[after][:-1]]]  # each user's first
    longest = max(int(size[train].max()), int(np.maximum(size[test] - 1, 1).max()))
    return _round8(longest)


def sized(config: dict) -> dict:
    """The configuration as it is run: a session model's Ts (model and
    shape) set by `session_cap`."""
    if config.get("scheme") != "session":
        return config
    Ts = session_cap(config["catalog"], config["shape"]["history_cap"])
    return {**config, "model": {**config["model"], "Ts": Ts},
            "shape": {**config["shape"], "Ts": Ts}}


def make_catalog(cat: dict, seed: int) -> Arrays:
    """Review rows sorted by (user, day): user, item, day, neg (a negative
    for each row), and the catalog's item_cate [items]."""
    rng = np.random.default_rng(seed)
    users, items, cates = cat["users"], cat["items"], cat["cates"]
    shape_rows, shape_days, shape_didx = catalog_shape(cat)
    slot = rng.permutation(users)  # user u takes shape slot[u]
    n_rows, n_days = shape_rows[slot], shape_days[slot]
    R = int(n_rows.sum())
    row_start = _starts(n_rows)
    pos = np.arange(R) - np.repeat(row_start, n_rows)
    didx = shape_didx[np.repeat(_starts(shape_rows)[slot], n_rows) + pos]

    groups = min(cat["groups"], cates)
    item_cate = np.r_[np.arange(cates), rng.integers(0, cates, items - cates)]
    item_cate = rng.permutation(item_cate)
    user_group = rng.permutation(np.arange(users) % groups)
    owner = np.repeat(np.arange(users), n_rows)
    item = np.empty(R, np.int64)
    for g in range(groups):  # coverage rows, then the group's preferences
        slots = rng.permutation(np.flatnonzero(user_group[owner] == g))
        own = np.flatnonzero(item_cate % groups == g)
        cover = np.repeat(own, cat["min_item_rows"])
        if len(cover) > len(slots):
            raise ValueError(f"group {g}: {len(own)} items need more rows")
        free = len(slots) - len(cover)
        prefer = rng.random(free) < cat["preference"]
        pick = np.where(prefer, own[rng.integers(0, len(own), free)],
                        rng.integers(0, items, free))
        item[slots] = np.r_[cover, pick]

    # distinct days a user, 1..59 days apart, taken by the shape's day index
    day_start = _starts(n_days)
    gaps = rng.integers(1, 60, int(n_days.sum()))
    cs = np.cumsum(gaps)
    before = cs[day_start] - gaps[day_start]
    first = DAY0 + rng.integers(0, 2_000, users)
    distinct = first[np.repeat(np.arange(users), n_days)] + cs - np.repeat(before, n_days)
    day = distinct[day_start[owner] + didx]
    order = np.lexsort((day, owner))  # items were dealt to random rows
    item, day = item[order], day[order]

    # a negative a row: uniform over the catalog, outside the user's items
    keys = np.unique(owner * items + item)
    neg = rng.integers(0, items, R)
    bad = np.arange(R)
    while len(bad):
        k = owner[bad] * items + neg[bad]
        hit = keys[np.minimum(np.searchsorted(keys, k), len(keys) - 1)] == k
        bad = bad[hit]
        neg[bad] = rng.integers(0, items, len(bad))
    return dict(user=owner, item=item, day=day, neg=neg,
                item_cate=item_cate.astype(np.int32), n_rows=n_rows,
                row_start=row_start)


def _dominant_before(c: Arrays) -> np.ndarray:
    """dom[r]: the most frequent category among the user's rows before r
    (ties to the one seen first, as `Counter.most_common` breaks them)."""
    user, cate = c["user"], c["item_cate"][c["item"]].astype(np.int64)
    R = len(user)
    pos = np.arange(R) - c["row_start"][user]
    order = np.lexsort((pos, cate, user))
    grp = np.r_[True, (user[order][1:] != user[order][:-1])
                | (cate[order][1:] != cate[order][:-1])]
    gstart = np.flatnonzero(grp)
    glen = np.diff(np.r_[gstart, R])
    run = np.empty(R, np.int64)
    run[order] = np.arange(R) - np.repeat(gstart, glen) + 1
    first = np.empty(R, np.int64)
    first[order] = np.repeat(pos[order][gstart], glen)
    width = int(pos.max()) + 2
    cpad = int(cate.max()) + 1
    key = (run * width + (width - 1 - first)) * cpad + cate
    span = int(key.max()) + 1
    best = np.maximum.accumulate(key + user * span) - user * span
    dom = np.zeros(R, np.int64)
    dom[1:] = best[:-1] % cpad  # rows before r; a user's first row has none
    return dom


def _sessions(c: Arrays):
    """Runs of equal (user, day): start row, size, user, index within user."""
    user, day = c["user"], c["day"]
    new = np.r_[True, (user[1:] != user[:-1]) | (day[1:] != day[:-1])]
    start = np.flatnonzero(new)
    size = np.diff(np.r_[start, len(user)])
    su = user[start]
    k = np.arange(len(start)) - _starts(np.bincount(su, minlength=len(c["n_rows"])))[su]
    return start, size, su, k


def _window(src_end: np.ndarray, length: np.ndarray, width: int, R: int):
    """Rows [src_end - length, src_end) left-aligned in `width` columns:
    (row index [N, width], valid [N, width])."""
    cols = np.arange(width)
    valid = cols[None, :] < length[:, None]
    src = np.clip(src_end[:, None] - length[:, None] + cols[None, :], 0, R - 1)
    return src, valid


def _long_window(c, end, users, Ls, now, R):
    """TLSAN's long-term window: the last Ls of `users`' rows before `end`,
    their ids and reciprocal time weights against day `now`."""
    L = np.minimum(end - c["row_start"][users], Ls)
    src, valid = _window(end, L, Ls, R)
    hist_i = np.where(valid, c["item"][src], 0).astype(np.int32)
    k = _bucket(now[:, None] - c["day"][src] + 1)
    hist_t = np.where(valid, 1.0 / np.maximum(k, 1), 0.0).astype(np.float32)
    return hist_i, hist_t, L.astype(np.int32)


def _session_rows(c: Arrays, shape: dict) -> Arrays:
    """TLSAN train rows: each session but the first whose next item lies
    inside the user's first `history_cap` rows less one."""
    Ls, Ts, cap = shape["Ls"], shape["Ts"], shape["history_cap"]
    R = len(c["user"])
    start, size, su, k = _sessions(c)
    rel = start - c["row_start"][su]
    vl = np.minimum(c["n_rows"][su], cap)
    train = (k >= 1) & (rel + size < vl - 1)
    start, size, su = start[train], size[train], su[train]
    hist_i, hist_t, sl = _long_window(c, start, su, Ls, c["day"][start], R)
    src, valid = _window(start + np.minimum(size, Ts), np.minimum(size, Ts), Ts, R)
    hist_i_new = np.where(valid, c["item"][src], 0).astype(np.int32)
    dom = _dominant_before(c)[start].astype(np.int32)
    target = start + size
    n = len(start)
    two = lambda a: np.concatenate([a, a])  # noqa: E731
    return dict(u=two(su.astype(np.int32)),
                i=np.concatenate([c["item"][target], c["neg"][target]]).astype(np.int32),
                y=np.r_[np.ones(n, np.float32), np.zeros(n, np.float32)],
                c=two(dom), hist_i=two(hist_i), hist_t=two(hist_t),
                hist_i_new=two(hist_i_new), sl=two(sl),
                sl_new=two(size.astype(np.int32)))


def _prefix_rows(c: Arrays, shape: dict) -> Arrays:
    """ATRank train rows: the prefixes of 1 .. vl-2 rows (vl the user's
    rows up to `history_cap`), each with the next row's item and a
    negative, buckets against the next row's day."""
    T, cap = shape["T"], shape["history_cap"]
    vl = np.minimum(c["n_rows"], cap)
    per = np.maximum(vl - 2, 0)
    pu = np.repeat(np.arange(len(vl)), per)
    pi = np.arange(int(per.sum())) - np.repeat(_starts(per), per) + 1
    nxt = c["row_start"][pu] + pi
    # only the valid entries: prefix p's columns 0 .. pi[p]-1
    prow = np.repeat(np.arange(len(pu)), pi)
    col = np.arange(len(prow)) - np.repeat(_starts(pi), pi)
    src = c["row_start"][pu][prow] + col
    hist_i = np.zeros((len(pu), T), np.int32)
    hist_i[prow, col] = c["item"][src]
    hist_t = np.zeros((len(pu), T), np.int32)
    hist_t[prow, col] = _bucket(c["day"][nxt][prow] - c["day"][src] + 1)
    n = len(pu)
    two = lambda a: np.concatenate([a, a])  # noqa: E731
    return dict(u=two(pu.astype(np.int32)),
                i=np.concatenate([c["item"][nxt], c["neg"][nxt]]).astype(np.int32),
                y=np.r_[np.ones(n, np.float32), np.zeros(n, np.float32)],
                hist_i=two(hist_i), hist_t=two(hist_t), sl=two(pi.astype(np.int32)))


def train_rows(c: Arrays, scheme: str, shape: dict) -> Arrays:
    return {"session": _session_rows, "prefix": _prefix_rows}[scheme](c, shape)


def user_features(c: Arrays, scheme: str, shape: dict) -> Arrays:
    """Each user's serving request (row u is user u), as `featurize` makes
    it from the whole history at the last review day: TLSAN the last day's
    session and the days before; ATRank the last `history_cap` reviews,
    the newest item its query."""
    R = len(c["user"])
    users = len(c["n_rows"])
    last = c["row_start"] + c["n_rows"]  # one past each user's last row
    now = c["day"][last - 1]
    u = np.arange(users, dtype=np.int32)
    if scheme == "session":
        Ls, Ts = shape["Ls"], shape["Ts"]
        start, size, su, _ = _sessions(c)
        last_sess = np.r_[np.flatnonzero(su[1:] != su[:-1]), len(su) - 1]
        s0, n_new = start[last_sess], size[last_sess]
        hist_i, hist_t, sl = _long_window(c, s0, np.arange(users), Ls, now, R)
        m = np.minimum(n_new, Ts)
        src, valid = _window(s0 + m, m, Ts, R)
        return dict(u=u, c=_dominant_before(c)[s0].astype(np.int32),
                    hist_i=hist_i, hist_t=hist_t,
                    hist_i_new=np.where(valid, c["item"][src], 0).astype(np.int32),
                    sl=sl, sl_new=m.astype(np.int32))
    T, cap = shape["T"], shape["history_cap"]
    m = np.minimum(c["n_rows"], cap)
    src, valid = _window(last, m, T, R)
    return dict(u=u, hist_i=np.where(valid, c["item"][src], 0).astype(np.int32),
                hist_t=np.where(valid, _bucket(now[:, None] - c["day"][src] + 1),
                                0).astype(np.int32),
                sl=m.astype(np.int32), i=c["item"][last - 1].astype(np.int32))


def request_users(n_users: int, size: int, count: int, seed: int) -> np.ndarray:
    """[count, size] user ids: a stream of seeded permutations of every
    user cut into requests, no user twice in one request."""
    rng = np.random.default_rng([seed, 1])
    out, cur = [], []
    while len(out) < count:
        perm = rng.permutation(n_users)
        if cur:  # the open request's users go to the end of the next pass
            held = np.isin(perm, cur)
            perm = np.r_[perm[~held], perm[held]]
        for x in np.split(perm, np.arange(size - len(cur), n_users, size)):
            cur = list(cur) + x.tolist()
            if len(cur) == size:
                out.append(np.asarray(cur))
                cur = []
                if len(out) == count:
                    break
    return np.stack(out)


def length_stats(lengths: np.ndarray, width: int) -> dict:
    """Mean, quartiles and max of valid lengths, and the padded share of
    `width` positions."""
    v = np.minimum(lengths, width)
    q = np.percentile(v, [50, 90, 99])
    return {"mean": float(v.mean()), "p50": float(q[0]), "p90": float(q[1]),
            "p99": float(q[2]), "max": int(v.max()),
            "padded_share": float(1.0 - v.mean() / width)}
