"""The port's data pipeline against the JAX package's, on a seeded fixture.

The fixture (tlsan_tpu_torch/tools/snap_fixture.py: 60 users, 40 items and
5 categories after the default filters) has same-day rows in shuffled
order, users and items each filter drops, a user with more than 90 days,
an asin without meta and one item twice in a final session.  The same raw
lines go through both packages: `convert_raw_lines` and `remap_ids` must
agree column for column and row for row (custom thresholds and the
missing-asin warning included), the category .npz must round-trip, a
JAX-written .pkl must read as the same columns, the builders must give
equal tuple lists in every variant at two seeds, the port's native
builder must equal its numpy builders and the JAX package's native
builder byte for byte, and the packed cache must keep the four
properties of tests/test_cache.py.
"""

import dataclasses
import gzip
import sys
import warnings

import numpy as np
import pytest

from tlsan_tpu.data import builders as jax_builders
from tlsan_tpu.data import native as jax_native
from tlsan_tpu.data import remap as jax_remap
from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.data import batcher, builders, native, remap
from tlsan_tpu_torch.data import cache as dcache
from tlsan_tpu_torch.tools.snap_fixture import write_snap_fixture
from tlsan_tpu_torch.train import cli

CATEGORY = "Digital_Music"
COUNTS = dict(users=60, items=40, cates=5, reviews=720)
SEEDS = (1234, 7)


@pytest.fixture(scope="module")
def raw_lines(tmp_path_factory):
    out = tmp_path_factory.mktemp("snap")
    write_snap_fixture(str(out), CATEGORY, **COUNTS, seed=3)
    with gzip.open(out / f"reviews_{CATEGORY}_5.json.gz", "rt") as f:
        reviews = f.readlines()
    with gzip.open(out / f"meta_{CATEGORY}.json.gz", "rt") as f:
        meta = f.readlines()
    return reviews, meta


def _remap_both(raw_lines, **thresholds):
    port_r, port_m = remap.convert_raw_lines(*raw_lines)
    jax_r, jax_m = jax_remap.convert_raw_lines(*raw_lines)
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        port = remap.remap_ids(port_r, port_m, **thresholds)
    with warnings.catch_warnings(record=True) as jax_w:
        warnings.simplefilter("always")
        jax = jax_remap.remap_ids(jax_r, jax_m, **thresholds)
    return port, jax, [str(w.message) for w in port_w], [str(w.message) for w in jax_w]


@pytest.fixture(scope="module")
def remapped(raw_lines):
    port, jax, _, _ = _remap_both(raw_lines)
    return port, jax


def test_convert_matches_jax(raw_lines):
    port_r, port_m = remap.convert_raw_lines(*raw_lines)
    jax_r, jax_m = jax_remap.convert_raw_lines(*raw_lines)
    for col in remap.REVIEW_COLUMNS:
        np.testing.assert_array_equal(port_r[col], jax_r[col].to_numpy(), err_msg=col)
    np.testing.assert_array_equal(port_m["asin"], jax_m["asin"].to_numpy())
    # the port keeps the one value of a meta row's categories the remap reads
    np.testing.assert_array_equal(
        port_m["categories"], [c[-1][-1] for c in jax_m["categories"]])
    assert len(port_m["asin"]) < len(raw_lines[1])  # unreviewed asins dropped


def test_convert_over_processes_keeps_the_file_order(raw_lines):
    one = remap.convert_raw_lines(*raw_lines)
    three = remap.convert_raw_lines(*raw_lines, workers=3)
    for a, b in zip(one, three):
        assert a.keys() == b.keys()
        for col in a:
            np.testing.assert_array_equal(a[col], b[col], err_msg=col)


@pytest.mark.parametrize("thresholds", [
    {},
    dict(min_item_interactions=2, min_user_interactions=4, min_sessions=2,
         max_sessions=6),
    dict(min_item_interactions=12, min_user_interactions=13, min_sessions=5,
         max_sessions=90),
], ids=["default", "loose", "strict"])
def test_remap_matches_jax(raw_lines, thresholds):
    (pr, pm, pcl, pc), (jr, jm, jcl, jc), port_w, jax_w = _remap_both(
        raw_lines, **thresholds)
    assert dataclasses.astuple(pc) == dataclasses.astuple(jc)
    for col in remap.REVIEW_COLUMNS:
        assert pr[col].dtype == jr[col].to_numpy().dtype == np.int64
        np.testing.assert_array_equal(pr[col], jr[col].to_numpy(), err_msg=col)
    for col in remap.META_COLUMNS:
        np.testing.assert_array_equal(pm[col], jm[col].to_numpy(), err_msg=col)
    assert pcl.dtype == jcl.dtype == np.int32
    np.testing.assert_array_equal(pcl, jcl)
    assert port_w == jax_w
    if not thresholds:  # the asin without meta is dropped loudly by both
        assert any("no metadata" in w for w in port_w)
        assert (pc.user_count, pc.item_count, pc.cate_count, pc.example_count) == (
            COUNTS["users"], COUNTS["items"], COUNTS["cates"], COUNTS["reviews"])


def test_category_npz_round_trip(remapped, tmp_path):
    reviews, meta, cate_list, counts = remapped[0]
    path = str(tmp_path / f"{CATEGORY}.npz")
    remap.save_category(path, reviews, meta, cate_list, counts)
    with np.load(path, allow_pickle=False) as z:  # no pickle inside
        assert set(z.files) == {"reviewerID", "asin", "unixReviewTime",
                                "meta_asin", "meta_categories",
                                "item_cate_list", "counts"}
    r2, m2, cl2, c2 = remap.load_category(path)
    assert c2 == counts
    for col in remap.REVIEW_COLUMNS:
        np.testing.assert_array_equal(r2[col], reviews[col])
    for col in remap.META_COLUMNS:
        np.testing.assert_array_equal(m2[col], meta[col])
    np.testing.assert_array_equal(cl2, cate_list)
    assert remap.category_path(str(tmp_path), CATEGORY) == path
    with pytest.raises(ValueError, match="npz"):
        remap.save_category(str(tmp_path / "x.pkl"), reviews, meta, cate_list, counts)


def test_reads_jax_pickle_and_refuses_it_without_pandas(remapped, tmp_path, monkeypatch):
    port, jax = remapped
    path = str(tmp_path / f"{CATEGORY}.pkl")
    jax_remap.save_category(path, *jax)
    r, m, cl, c = remap.load_category(path)
    assert c == port[3]
    for col in remap.REVIEW_COLUMNS:
        np.testing.assert_array_equal(r[col], port[0][col])
    for col in remap.META_COLUMNS:
        np.testing.assert_array_equal(m[col], port[1][col])
    np.testing.assert_array_equal(cl, port[2])
    assert remap.category_path(str(tmp_path), CATEGORY) == path
    monkeypatch.setitem(sys.modules, "pandas", None)  # as on the card's machine
    with pytest.raises(RuntimeError, match="convert it where pandas is"):
        remap.load_category(path)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant,max_length", [
    ("tlsan", 90), ("shan", 90), ("paca", 90), ("tlsan", 8), ("shan", 7)])
def test_session_builder_matches_jax(remapped, variant, max_length, seed):
    (pr, _, pcl, pc), (jr, _, jcl, _) = remapped
    got = builders.build_session_examples(pr, pcl, pc.item_count, variant,
                                          max_length=max_length, seed=seed)
    want = jax_builders.build_session_examples(jr, jcl, pc.item_count, variant,
                                               max_length=max_length, seed=seed)
    assert got == want and len(got[1]) == pc.user_count


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("time_mode,max_length,pack_pos_neg", [
    ("none", 90, False), ("bucket", 90, False), ("raw", 90, False),
    ("none", 90, True), ("bucket", 80, False), ("bucket", 6, False),
    ("none", 6, True)])
def test_prefix_builder_matches_jax(remapped, time_mode, max_length,
                                    pack_pos_neg, seed):
    (pr, _, _, pc), (jr, _, _, _) = remapped
    kw = dict(time_mode=time_mode, max_length=max_length,
              pack_pos_neg=pack_pos_neg, seed=seed)
    got = builders.build_prefix_examples(pr, pc.item_count, **kw)
    want = jax_builders.build_prefix_examples(jr, pc.item_count, **kw)
    assert got == want and len(got[1]) == pc.user_count


@pytest.mark.parametrize("seed", SEEDS)
def test_pairwise_builder_matches_jax(remapped, seed):
    (pr, _, _, pc), (jr, _, _, _) = remapped
    got = builders.build_pairwise_examples(pr, pc.item_count, seed=seed)
    want = jax_builders.build_pairwise_examples(jr, pc.item_count, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_user_runs_follow_groupby_on_unsorted_rows(remapped):
    """Rows in any order: users in id order, each user's rows in file order."""
    pr = remapped[0][0]
    order = np.random.default_rng(0).permutation(len(pr["asin"]))
    shuffled = {k: v[order] for k, v in pr.items()}
    jax_df = remapped[1][0].iloc[order]
    got = list(builders.user_runs(shuffled))
    want = [(u, h["asin"].tolist(), h["unixReviewTime"].tolist())
            for u, h in jax_df.groupby("reviewerID")]
    assert got == want


def _assert_same_batches(a, b):
    assert a.n == b.n and set(a.arrays) == set(b.arrays)
    for k in a.arrays:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def natives():
    if not native.available():
        pytest.skip("g++ is not available")
    assert native.library_path().startswith(native.BUILD_DIR)
    return native


@pytest.mark.parametrize("seed", SEEDS)
def test_native_tlsan_matches_numpy_and_jax(remapped, natives, seed):
    (pr, _, pcl, pc), (jr, _, jcl, _) = remapped
    tr, te, Ts = natives.build_tlsan_packed(pr, pcl, pc.item_count, seed=seed)
    train, test = builders.build_session_examples(pr, pcl, pc.item_count,
                                                  "tlsan", seed=seed)
    _assert_same_batches(tr, batcher.pack_session_train(train, 10, Ts, "tlsan"))
    _assert_same_batches(te, batcher.pack_session_test(test, 10, Ts, "tlsan"))
    jtr, jte, jTs = jax_native.build_tlsan_packed(jr, jcl, pc.item_count, seed=seed)
    assert jTs == Ts
    _assert_same_batches(tr, jtr)
    _assert_same_batches(te, jte)


@pytest.mark.parametrize("variant", ["shan", "paca"])
def test_native_session_basic_matches_numpy_and_jax(remapped, natives, variant):
    (pr, _, pcl, pc), (jr, _, jcl, _) = remapped
    cap = 90 if variant == "paca" else None
    tr, te, Ls, Ts = natives.build_session_basic_packed(
        pr, pcl, pc.item_count, variant, Ls_cap=cap)
    train, test = builders.build_session_examples(pr, pcl, pc.item_count, variant)
    _assert_same_batches(tr, batcher.pack_session_train(train, Ls, Ts, variant))
    _assert_same_batches(te, batcher.pack_session_test(test, Ls, Ts, variant))
    jtr, jte, jLs, jTs = jax_native.build_session_basic_packed(
        jr, jcl, pc.item_count, variant, Ls_cap=cap)
    assert (jLs, jTs) == (Ls, Ts)
    _assert_same_batches(tr, jtr)
    _assert_same_batches(te, jte)


@pytest.mark.parametrize("time_mode,max_length,pack_pair,align,T_fixed", [
    ("bucket", 90, False, "left", None),
    ("bucket", 80, False, "left", None),
    ("raw", 90, False, "left", None),
    ("none", 90, False, "left", None),
    ("none", 90, True, "right", 5),
])
def test_native_prefix_matches_numpy_and_jax(remapped, natives, time_mode,
                                             max_length, pack_pair, align, T_fixed):
    (pr, _, _, pc), (jr, _, _, _) = remapped
    kw = dict(time_mode=time_mode, max_length=max_length, pack_pos_neg=pack_pair)
    tr, te, T = natives.build_prefix_packed(pr, pc.item_count, align=align,
                                            T=T_fixed, **kw)
    train, test = builders.build_prefix_examples(pr, pc.item_count, **kw)
    with_time = time_mode != "none"
    tdt = np.float32 if time_mode == "raw" else np.int32
    _assert_same_batches(tr, batcher.pack_prefix_train(
        train, T, with_time=with_time, pack_pos_neg=pack_pair, align=align,
        time_dtype=tdt))
    _assert_same_batches(te, batcher.pack_prefix_test(
        test, T, with_time=with_time, align=align, time_dtype=tdt))
    jtr, jte, jT = jax_native.build_prefix_packed(jr, pc.item_count, align=align,
                                                  T=T_fixed, **kw)
    assert jT == T
    _assert_same_batches(tr, jtr)
    _assert_same_batches(te, jte)


def test_native_bpr_matches_numpy_and_jax(remapped, natives):
    (pr, _, _, pc), (jr, _, _, _) = remapped
    got = natives.build_bpr_packed(pr, pc.item_count)
    for want in (builders.build_pairwise_examples(pr, pc.item_count),
                 jax_native.build_bpr_packed(jr, pc.item_count)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------- the packed cache (test_cache.py)


@pytest.fixture()
def data_path(remapped, tmp_path, monkeypatch):
    monkeypatch.setenv("TLSAN_DATA_CACHE", str(tmp_path / "cache"))
    path = str(tmp_path / f"{CATEGORY}.npz")
    remap.save_category(path, *remapped[0])
    return path


@pytest.mark.parametrize("model_name", ["tlsan", "lspm", "bpr"])
def test_cached_equals_fresh(data_path, model_name):
    cfg = ModelConfig(model=model_name)
    fresh = cli.prepare(model_name, data_path, cfg, use_cache=False)
    miss = cli.prepare(model_name, data_path, cfg, use_cache=True)   # builds+stores
    hit = cli.prepare(model_name, data_path, cfg, use_cache=True)    # loads
    assert miss.builder == fresh.builder and hit.builder == "cache"
    for got in (miss, hit):
        _assert_same_batches(got.train, fresh.train)
        _assert_same_batches(got.test, fresh.test)
        np.testing.assert_array_equal(got.cate_list, fresh.cate_list)
        assert got.cfg == fresh.cfg


def test_cache_hit_skips_build(data_path, monkeypatch):
    cfg = ModelConfig(model="tlsan")
    cli.prepare("tlsan", data_path, cfg, use_cache=True)  # warm

    def boom(*a, **k):
        raise AssertionError("cache hit must not rebuild")

    monkeypatch.setattr(cli, "_prepare_uncached", boom)
    assert cli.prepare("tlsan", data_path, cfg, use_cache=True).train.n > 0
    monkeypatch.setenv("TLSAN_DATA_CACHE", "0")  # "0" disables the cache
    with pytest.raises(AssertionError, match="must not rebuild"):
        cli.prepare("tlsan", data_path, cfg)


def test_cache_hit_keeps_caller_hyperparams(data_path):
    """A hit merges only the build-derived fields (counts/Ls/Ts/max_length)
    into the CALLER's cfg."""
    cfg = ModelConfig(model="tlsan")
    cli.prepare("tlsan", data_path, cfg, use_cache=True)  # warm with defaults
    cfg2 = dataclasses.replace(cfg, dropout=0.3, hidden_units=128,
                               num_heads=4, regulation_rate=1e-3)
    got = cli.prepare("tlsan", data_path, cfg2, use_cache=True).cfg  # hit
    assert got.dropout == 0.3 and got.hidden_units == 128
    assert got.num_heads == 4 and got.regulation_rate == 1e-3
    assert got.item_count == COUNTS["items"] and got.user_count == COUNTS["users"]


def test_cache_key_sensitivity(data_path):
    cfg = ModelConfig(model="tlsan")
    p1 = dcache.cache_path("tlsan", data_path, cfg, 1234)
    assert p1 != dcache.cache_path("tlsan", data_path, cfg, 42)          # seed
    assert p1 != dcache.cache_path("shan", data_path, cfg, 1234)         # model
    cfg2 = dataclasses.replace(cfg, Ls=20)
    assert p1 != dcache.cache_path("tlsan", data_path, cfg2, 1234)       # shape
    assert p1 == dcache.cache_path("tlsan", data_path, cfg, 1234)        # stable
