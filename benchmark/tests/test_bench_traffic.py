"""The traffic generator: deterministic for a seed, the same history
lengths for every seed, Electronics-shaped, and row for row what the
port's builders, packers and featurizer make of the same reviews."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import data
from benchmark.tests.tiny import TINY_CATALOG

REPO = Path(__file__).resolve().parents[2]
CONF = {n: json.loads((REPO / "benchmark" / "configs" / f"{n}-electronics.json").read_text())
        for n in ("tlsan", "atrank")}
SEEDS = (3, 2**31 + 7)


def _small():
    cat = dict(CONF["tlsan"]["catalog"])
    cat.update(users=600, items=400, cates=30, reviews=600 * 14 + 37)
    return cat


@pytest.mark.parametrize("scheme,family", [("session", "tlsan"), ("prefix", "atrank")])
def test_same_seed_same_traffic(scheme, family):
    shape = data.sized({**CONF[family], "catalog": TINY_CATALOG})["shape"]
    a = data.train_rows(data.make_catalog(TINY_CATALOG, 11), scheme, shape)
    b = data.train_rows(data.make_catalog(TINY_CATALOG, 11), scheme, shape)
    c = data.train_rows(data.make_catalog(TINY_CATALOG, 12), scheme, shape)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["hist_i"], c["hist_i"])


def test_seeds_share_the_history_lengths():
    c1, c2 = (data.make_catalog(TINY_CATALOG, s) for s in SEEDS)
    assert np.array_equal(np.sort(c1["n_rows"]), np.sort(c2["n_rows"]))
    assert not np.array_equal(c1["n_rows"], c2["n_rows"])
    r1, r2 = (data.train_rows(c, "prefix", CONF["atrank"]["shape"]) for c in (c1, c2))
    assert np.array_equal(np.sort(r1["sl"]), np.sort(r2["sl"]))
    shape = data.sized({**CONF["tlsan"], "catalog": TINY_CATALOG})["shape"]
    s1, s2 = (data.train_rows(c, "session", shape) for c in (c1, c2))
    for k in ("sl", "sl_new"):  # the sessions too, so Ts is the same for every seed
        assert np.array_equal(np.sort(s1[k]), np.sort(s2[k]))


def test_electronics_shape():
    cat = CONF["tlsan"]["catalog"]
    rows, days, didx = data.catalog_shape(cat)
    assert len(rows) == 39_991 and rows.sum() == 561_100
    assert rows.min() >= 10 and rows.max() <= cat["max_rows"]
    assert 14.0 < rows.mean() < 14.1 and np.percentile(rows, 99) > 40  # a heavy tail
    assert days.min() >= 4 and days.max() <= 90 and np.all(days <= rows)
    slot = np.repeat(np.arange(len(rows)), rows)
    assert np.all(didx < days[slot])  # every row on one of its user's days, each day used
    assert len(np.unique(slot * 90 + didx)) == days.sum()
    assert data.session_cap(cat, 90) == 16


def test_length_stats():
    s = data.length_stats(np.array([1, 2, 3, 100]), 10)
    assert s["max"] == 10 and s["mean"] == 4.0 and s["padded_share"] == 0.6


def test_requests_cover_users_without_repeats():
    req = data.request_users(1000, 96, 40, 5)
    assert req.shape == (40, 96)
    assert all(len(set(r.tolist())) == 96 for r in req)
    first = req.reshape(-1)[:960]
    assert len(set(first.tolist())) == 960  # one pass: each user once


@pytest.mark.parametrize("seed", SEEDS)
def test_rows_equal_the_ports_builders(seed):
    from tlsan_tpu_torch.data.batcher import pack_prefix_train, pack_session_train, round8
    from tlsan_tpu_torch.data.builders import build_prefix_examples, build_session_examples

    cat = _small()
    c = data.make_catalog(cat, seed)
    reviews = dict(reviewerID=c["user"], asin=c["item"], unixReviewTime=c["day"])

    def positives(a, keys):
        idx = np.flatnonzero(a["y"] == 1)
        return sorted(tuple(np.concatenate([np.atleast_1d(a[k][j]).ravel().astype(float)
                                            for k in keys]).tolist()) for j in idx)

    train, test = build_session_examples(reviews, c["item_cate"], cat["items"], "tlsan", 90)
    Ts = round8(max(len(t[2]) for t in train + test))  # as train/cli.py sets it
    assert Ts == data.session_cap(cat, 90)
    packed = pack_session_train(train, 10, Ts)
    mine = data.train_rows(c, "session", {**CONF["tlsan"]["shape"], "Ts": Ts})
    keys = ["u", "i", "c", "hist_i", "hist_t", "hist_i_new", "sl", "sl_new"]
    assert len(mine["y"]) == packed.n
    assert positives(mine, keys) == positives(packed.arrays, keys)

    train, _ = build_prefix_examples(reviews, cat["items"], time_mode="bucket", max_length=90)
    packed = pack_prefix_train(train, 96, with_time=True, time_dtype=np.int32)
    mine = data.train_rows(c, "prefix", CONF["atrank"]["shape"])
    keys = ["u", "i", "hist_i", "hist_t", "sl"]
    assert len(mine["y"]) == packed.n
    assert positives(mine, keys) == positives(packed.arrays, keys)

    own = set(zip(c["user"].tolist(), c["item"].tolist()))
    assert not any((u, n) in own for u, n in zip(c["user"].tolist(), c["neg"].tolist()))


@pytest.mark.parametrize("family", ["tlsan", "atrank"])
def test_features_equal_featurize(family):
    from tlsan_tpu_torch.core.config import ModelConfig
    from tlsan_tpu_torch.serve.featurize import featurize

    c = data.make_catalog(_small(), 21)
    conf = data.sized({**CONF[family], "catalog": _small()})
    feats = data.user_features(c, conf["scheme"], conf["shape"])
    cfg = ModelConfig(model=family, Ls=10, Ts=conf["shape"].get("Ts", 24), max_length=90)
    for u in range(0, len(c["n_rows"]), 23):
        s = c["row_start"][u]
        events = list(zip(c["item"][s:s + c["n_rows"][u]].tolist(),
                          c["day"][s:s + c["n_rows"][u]].tolist()))
        f = featurize(family, cfg, events, user_id=u, cate_list=c["item_cate"])
        for k, v in f.items():
            mine = feats[k][u][:90] if family == "atrank" and v.ndim == 2 else feats[k][u]
            assert np.array_equal(v[0], mine), (k, u)
