"""The serve and train paths of the seven baseline families in the PyTorch
port against the JAX package, on the CPU: every packer variant and
`featurize_many` branch byte for byte, `Recommender.recommend` (LSPM's
right-aligned history exclusion included), the HTTP service, two epochs
of the Trainer against the JAX Trainer, and a resume bit for bit.  Inputs
are numpy-seeded; the port starts from the JAX initial parameters
(tools/params.py)."""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest

from tests.test_torch_train import _assert_trees_close
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.data import batcher as jax_batcher
from tlsan_tpu.models import get_model as jax_get_model
from tlsan_tpu.serve.featurize import featurize_many as jax_featurize_many
from tlsan_tpu.serve.recommender import Recommender as JaxRecommender
from tlsan_tpu.train.loop import Trainer as JaxTrainer
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data import batcher
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.serve import http as torch_http
from tlsan_tpu_torch.serve.featurize import featurize_many
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.tools.params import params_from_numpy, params_to_numpy
from tlsan_tpu_torch.train.loop import Trainer

USERS, ITEMS, CATES = 20, 30, 5
LS, TS, T, K = 10, 8, 12, 5  # session windows, prefix length, LSPM's k
FAMILIES = ["shan", "paca", "bpr", "lspm", "cnn", "bilstm", "csan"]
TOL = 1e-5  # tests/test_torch_train.py::test_trainer_matches_jax_trainer


def cfg_kw(name, **over):
    return dict(dict(model=name, user_count=USERS, item_count=ITEMS,
                     cate_count=CATES, Ls=LS if name != "paca" else T, Ts=TS,
                     max_length=T, lspm_k=K, cnn_pad_length=20, paca_max_len=T,
                     hidden_units=32 if name == "csan" else 64,
                     regulation_rate=1e-2 if name == "lspm" else 5e-5), **over)


# -------------------------------------------------------------------- data


def _tuples(name, n, test, rng, n_users, n_items):
    """n example tuples in the family's builder layout (the JAX package's
    data/builders.py): histories of 0 to beyond the window, labels or a
    (pos, neg) pair."""
    def items(lo, hi):
        return [int(x) for x in rng.integers(0, n_items, int(rng.integers(lo, hi)))]

    def target():
        if test:
            return (int(rng.integers(n_items)), int(rng.integers(n_items)))
        return None

    out = []
    for _ in range(n):
        u = int(rng.integers(n_users))
        item, label = int(rng.integers(n_items)), int(rng.integers(2))
        if name == "shan":
            pre, new = items(1, 2 * LS), items(1, 2 * TS)
            out.append((u, pre, new, target()) if test else (u, pre, new, item, label))
        elif name == "paca":
            pre = items(1, 2 * T)
            out.append((pre, target()) if test else (pre, item, label))
        elif name == "lspm":
            hist = items(0, 3 * K)
            out.append((u, hist, (int(rng.integers(n_items)), int(rng.integers(n_items)))))
        else:
            hist = items(0, T + 4)
            if name in ("cnn", "csan"):
                times = ([int(x) for x in rng.integers(0, 13, len(hist))] if name == "cnn"
                         else [float(x) for x in rng.uniform(1, 400, len(hist))])
                out.append((u, hist, times, target()) if test
                           else (u, hist, times, item, label))
            else:
                out.append((u, hist, target()) if test else (u, hist, item, label))
    return out


def _pack(mod, name, tuples, test):
    """Pack with `mod` (the port's batcher or the JAX package's) as the
    JAX CLI packs each family (tlsan_tpu/train/cli.py:112-189)."""
    if name == "bpr":
        if mod is batcher:
            return batcher.pack_pairwise(tuples)
        return jax_batcher.Batches(dict(u=tuples[:, 0], i=tuples[:, 1],
                                        j=tuples[:, 2]), len(tuples))
    if name in ("shan", "paca"):
        fn = mod.pack_session_test if test else mod.pack_session_train
        return fn(tuples, T if name == "paca" else LS, TS, name)
    kw = dict(with_time=name in ("cnn", "csan"),
              time_dtype=np.float32 if name == "csan" else np.int32)
    if name == "lspm":
        kw = dict(align="right")
        if not test:
            kw["pack_pos_neg"] = True
    width = K if name == "lspm" else T
    return (mod.pack_prefix_test if test else mod.pack_prefix_train)(tuples, width, **kw)


def family_data(name, n_train=64, n_test=40, seed=0, users=USERS, items=ITEMS,
                cates=CATES):
    """(JAX train, JAX test, port train, port test, cate_list)."""
    rng = np.random.default_rng(seed)
    if name == "bpr":
        train_t = np.stack([rng.integers(0, n, n_train) for n in (users, items, items)],
                           1).astype(np.int32)
        test_t = np.stack([rng.integers(0, n, n_test) for n in (users, items, items)],
                          1).astype(np.int32)
    else:
        train_t = _tuples(name, n_train, False, rng, users, items)
        test_t = _tuples(name, n_test, True, rng, users, items)
    cate_list = rng.integers(0, cates, items).astype(np.int32)
    return (_pack(jax_batcher, name, train_t, False), _pack(jax_batcher, name, test_t, True),
            _pack(batcher, name, train_t, False), _pack(batcher, name, test_t, True),
            cate_list)


def _assert_batches_identical(got, want):
    assert got.n == want.n and list(got.arrays) == list(want.arrays)
    for k, v in want.arrays.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("name", FAMILIES)
def test_packers_are_byte_identical(name):
    jtr, jte, tr, te, _ = family_data(name, 57, 23, seed=1)
    _assert_batches_identical(tr, jtr)
    _assert_batches_identical(te, jte)
    if name == "lspm":  # the window is right-aligned
        for b in (tr, te):
            cols = np.arange(K)[None, :] < K - b["sl"][:, None]
            assert (b["hist_i"][cols] == 0).all() and (b["sl"] < K).any()


def test_variants_raise_as_jax():
    with pytest.raises(ValueError):
        batcher.pack_session_train([], LS, TS, variant="nope")
    with pytest.raises(ValueError):
        batcher.pack_session_test([], LS, TS, variant="nope")


# ---------------------------------------------------------------- serving


def _requests(seed, n):
    """Raw event streams: single-day users, histories past every window,
    and an explicit `now` for some."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r in range(n):
        n_days = int(rng.integers(1, 6))
        days = np.sort(rng.choice(np.arange(100, 6000), n_days, replace=False))
        events = [[int(rng.integers(0, ITEMS)), int(d)]
                  for d in days for _ in range(int(rng.integers(1, 7)))]
        req = {"user": int(rng.integers(0, USERS)), "events": events}
        if r % 4 == 3:
            req["now"] = int(days[-1]) + int(rng.integers(1, 5000))
        reqs.append(req)
    return reqs


@pytest.mark.parametrize("name", FAMILIES)
def test_featurize_many_bitwise_equal_to_jax(name):
    reqs = _requests(2, 40)
    cate_list = np.random.default_rng(3).integers(0, CATES, ITEMS).astype(np.int32)
    want = jax_featurize_many(name, JaxModelConfig(**cfg_kw(name)), reqs, cate_list=cate_list)
    got = featurize_many(name, ModelConfig(**cfg_kw(name)), reqs, cate_list=cate_list)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_featurize_rejects_what_jax_rejects():
    cfg = ModelConfig(**cfg_kw("bpr"))
    with pytest.raises(ValueError):
        featurize_many("bpr", cfg, [{"events": [[1, 2]]}])  # no user id
    with pytest.raises(ValueError):
        featurize_many("cnn", cfg, [{"user": 1, "events": []}])


def _models(name, seed=0, **over):
    """(JAX model, JAX config, JAX params, the port's model with the same
    values, port config)."""
    jcfg = JaxModelConfig(**cfg_kw(name, **over))
    jmodel = jax_get_model(name)
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = ModelConfig(**cfg_kw(name, **over))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    return jmodel, jcfg, params, model, cfg


@pytest.mark.parametrize("name", FAMILIES)
def test_recommend_matches_jax(name):
    """21 featurized users through 8-wide batches (the last one padded
    with empty rows), catalog rows past 25 masked: scores within TOL of
    the JAX Recommender, ids equal up to ties."""
    jmodel, jcfg, params, model, cfg = _models(name, catalog_items=25)
    cate_list = np.random.default_rng(4).integers(0, CATES, ITEMS).astype(np.int32)
    batch = featurize_many(name, cfg, _requests(5, 21), cate_list=cate_list)
    k = 12
    want_ids, want_sc = JaxRecommender(jmodel, params, cate_list, jcfg, k=k,
                                       use_pallas=False, batch_size=8).recommend(batch)
    ids, sc = Recommender(model, cate_list, k=k, batch_size=8,
                          device="cpu").recommend(batch)
    assert ids.shape == (21, k) and ids.dtype == np.int32 and ids.max() < 25
    assert np.isfinite(sc).all()
    np.testing.assert_allclose(sc, want_sc, rtol=0, atol=TOL)
    for r in range(21):
        for j in np.flatnonzero(ids[r] != want_ids[r]):
            tied = np.isclose(want_sc[r], want_sc[r, j], rtol=0, atol=TOL)
            assert ids[r, j] in set(want_ids[r][tied]) or tied[-1], (r, j)


def test_lspm_exclude_history_is_right_aligned():
    """Twin of tests/test_serve.py:122: the real items of LSPM's window sit
    in its last sl columns; those are excluded, pad item 0 is not, and the
    answer equals the JAX Recommender's."""
    jmodel, jcfg, params, model, cfg = _models("lspm", catalog_items=ITEMS)
    rng = np.random.default_rng(1)
    B = 8
    sl = rng.integers(1, K + 1, B).astype(np.int32)
    hist = np.zeros((B, K), np.int32)
    for r in range(B):
        hist[r, K - sl[r]:] = rng.integers(1, ITEMS, sl[r])
    batch = {"u": rng.integers(0, USERS, B).astype(np.int32), "hist_i": hist, "sl": sl}
    cate_list = np.zeros(ITEMS, np.int32)
    ids, scores = Recommender(model, cate_list, k=20, exclude_history=True,
                              batch_size=B, device="cpu").recommend(batch)
    want_ids, want_sc = JaxRecommender(jmodel, params, cate_list, jcfg, k=20,
                                       use_pallas=False, exclude_history=True,
                                       batch_size=B).recommend(batch)
    np.testing.assert_allclose(scores, want_sc, rtol=0, atol=TOL)
    for r in range(B):
        real = set(hist[r, K - sl[r]:].tolist())
        ranked = [i for i, s in zip(ids[r], scores[r]) if np.isfinite(s)]
        assert not real.intersection(ranked)
        assert set(ranked) == set(i for i, s in zip(want_ids[r], want_sc[r])
                                  if np.isfinite(s))
        if sl[r] < K:  # pad id 0 is a real catalog item: never excluded
            assert 0 in ranked


@pytest.mark.parametrize("name", ["bpr", "csan", "paca"])
def test_http_serves_the_family(name):
    """The HTTP service featurizes and scores every family as a direct
    Recommender call does (BPR-MF by user id alone, CSAN with its query
    item, PACA with no user)."""
    _, _, _, model, cfg = _models(name)
    cate_list = np.random.default_rng(6).integers(0, CATES, ITEMS).astype(np.int32)
    reqs = _requests(7, 9)
    rec = Recommender(model, cate_list, k=5, batch_size=4, device="cpu")
    want_ids, want_sc = rec.recommend(featurize_many(name, cfg, reqs, cate_list=cate_list))
    service = torch_http.RecommendService(rec, name, cfg, cate_list)
    stop = threading.Event()
    worker = service.start_worker_thread(stop)
    httpd = torch_http.serve(service, port=0, host="127.0.0.1")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/recommend",
            data=json.dumps({"requests": reqs}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        stop.set()
        worker.join(timeout=30)
    assert [res["items"] for res in body["results"]] == want_ids.tolist()
    np.testing.assert_allclose([res["scores"] for res in body["results"]],
                               want_sc, rtol=0, atol=1e-4)


# ---------------------------------------------------------------- trainer


def _records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


TRAIN_KW = dict(max_epochs=2, train_batch_size=32, test_batch_size=16,
                steps_per_call=2, eval_freq=2, display_freq=2, summary_freq=2,
                best_after_step=0, learning_rate=0.5, save_auc_gate=0.0)


@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_matches_jax_trainer(tmp_path, name):
    """Two epochs of the port's Trainer against the JAX Trainer (dense
    updates) from the same initial parameters: chunk losses within 1e-5
    relative, the AUC within one test user, the final parameters within
    1e-4; the summaries carry the family's embedding/<table> tags."""
    jtr_b, jte_b, tr_b, te_b, cate_list = family_data(name)
    tc = TrainConfig(model_dir=str(tmp_path / "torch"), **TRAIN_KW)
    jtc = JaxTrainConfig(model_dir=str(tmp_path / "jax"), sparse_updates=False,
                         **TRAIN_KW)
    jtr = JaxTrainer(jax_get_model(name), JaxModelConfig(**cfg_kw(name)), jtc,
                     cate_list, jtr_b, jte_b, use_pallas=False)
    tr = Trainer(get_model(name), ModelConfig(**cfg_kw(name)), tc, cate_list, tr_b,
                 te_b, device="cpu")
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params),
                             ModelConfig(**cfg_kw(name)), "cpu")
    tr.model.load_state_dict(init.state_dict())
    jtr.train()
    tr.train()
    jtr.writer.close()
    tr.close()
    want, got = _records(jtc.model_dir), _records(tc.model_dir)
    assert [(r["kind"], r["step"]) for r in got] == [(r["kind"], r["step"]) for r in want]
    for g, w in zip(got, want):
        if g["kind"] == "train":
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=TOL)
        if g["kind"] in ("eval", "final"):
            assert abs(g["auc"] - w["auc"]) <= 1.0 / te_b.n + 1e-9
    assert tr.opt_state.count == tr.step == 4
    _assert_trees_close(params_to_numpy(tr.model),
                        jax.tree_util.tree_map(np.asarray, jtr.params),
                        1e-4, 1e-4, "param ")
    assert tr._summary_tags == jtr._summary_tags


def test_resume_is_bit_exact(tmp_path):
    """A second Bi-LSTM Trainer on the same model_dir restores the step,
    the schedule count and the parameters bit for bit, and evaluates as
    the last save did."""
    _, _, tr_b, te_b, cate_list = family_data("bilstm", seed=3)
    cfg = ModelConfig(**cfg_kw("bilstm"))
    tc = TrainConfig(model_dir=str(tmp_path / "r"), **dict(TRAIN_KW, max_epochs=1))
    tr = Trainer(get_model("bilstm"), cfg, tc, cate_list, tr_b, te_b, device="cpu")
    tr.train()
    tr.close()
    final = [r for r in _records(tc.model_dir) if r["kind"] == "final"][-1]
    tr2 = Trainer(get_model("bilstm"), cfg, dataclasses.replace(tc, from_scratch=False),
                  cate_list, tr_b, te_b, device="cpu")
    assert tr2.step == tr.step == 2 and tr2.opt_state.count == 2
    for (key, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert a.numpy().tobytes() == b.numpy().tobytes(), key
    assert tr2.evaluate() == {k: v for k, v in final.items()
                              if k not in ("kind", "step", "wall_s")}
    tr2.close()
