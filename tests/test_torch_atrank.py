"""ATRank in the PyTorch port against the JAX ATRank, from one JAX init
carried across by the weights bridge (tools/params.py): user_repr,
pair_logits, eval_logits, the loss and every gradient leaf with both time
paths; dropout; bucket_time and the prefix packers; the featurizer; the
Recommender and the HTTP service; and a 2-epoch Trainer run against the
JAX Trainer.  Inputs are numpy-seeded; time buckets include 12, which
jax.nn.one_hot maps to a zero row."""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.data import batcher as jax_batcher
from tlsan_tpu.data import builders as jax_builders
from tlsan_tpu.models.atrank import ATRank as JaxATRank
from tlsan_tpu.models.tlsan import TLSAN as JaxTLSAN
from tlsan_tpu.serve.featurize import featurize_many as jax_featurize_many
from tlsan_tpu.serve.recommender import Recommender as JaxRecommender
from tlsan_tpu.train.loop import Trainer as JaxTrainer
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data import batcher, builders
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.models.atrank import ATRank
from tlsan_tpu_torch.serve import http as torch_http
from tlsan_tpu_torch.serve.featurize import featurize_many
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.tools.params import (
    grads_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from tlsan_tpu_torch.train import checkpoint
from tlsan_tpu_torch.train.loop import Trainer

USERS, ITEMS, CATES, T, B = 21, 29, 5, 12, 7
TOL = 1e-5
CFG = dict(model="atrank", user_count=USERS, item_count=ITEMS,
           cate_count=CATES, max_length=T)


def _tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _assert_trees_close(got, want, rtol, atol, what=""):
    got, want = dict(_tree_items(got)), dict(_tree_items(want))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol,
                                   err_msg=f"{what}{name}")


def _setup(concat_time_emb=True, **over):
    jcfg = JaxModelConfig(**CFG, concat_time_emb=concat_time_emb, **over)
    jparams = JaxATRank.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.array, jparams)
    cfg = ModelConfig(**CFG, concat_time_emb=concat_time_emb, **over)
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, "cpu")


def _batch(seed=1, n=B):
    rng = np.random.default_rng(seed)
    hist_t = rng.integers(0, 13, (n, T)).astype(np.int32)
    hist_t[0, :4] = 12  # the oldest bucket: a zero one-hot row
    return {
        "u": rng.integers(0, USERS, n).astype(np.int32),
        "i": rng.integers(0, ITEMS, n).astype(np.int32),
        "j": rng.integers(0, ITEMS, n).astype(np.int32),
        "y": rng.integers(0, 2, n).astype(np.float32),
        "hist_i": rng.integers(0, ITEMS, (n, T)).astype(np.int32),
        "hist_t": hist_t,
        # 0-length rows: what a zero-padded partial serving batch sends
        "sl": np.array(([0, 1, T, 3, 7, 2, 9] * n)[:n], np.int32),
    }


def _cate_list(seed=2):
    return np.random.default_rng(seed).integers(0, CATES, ITEMS).astype(np.int32)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("family", ["atrank", "tlsan"])
def test_bridge_round_trip_is_exact(family):
    jmodel = {"atrank": JaxATRank, "tlsan": JaxTLSAN}[family]
    kw = dict(model=family, user_count=USERS, item_count=ITEMS,
              cate_count=CATES, num_blocks=2)
    tree = jax.tree_util.tree_map(
        np.array, jmodel.init_params(jax.random.PRNGKey(3), JaxModelConfig(**kw)))
    model = params_from_numpy(tree, ModelConfig(**kw), "cpu")
    assert isinstance(model, get_model(family))
    back = params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (na, a), (nb, b) in zip(_tree_items(tree), _tree_items(back)):
        assert na == nb and a.tobytes() == b.tobytes(), na
    if family == "atrank":
        assert "self_blocks.1.attn.wq" in model.state_dict()
    assert get_model("atrank") is ATRank


@pytest.mark.parametrize("concat_time_emb", [True, False])
@torch.no_grad()
def test_forward_matches_jax(concat_time_emb):
    jcfg, jparams, cfg, model = _setup(concat_time_emb)
    batch, cate_list = _batch(), _cate_list()
    jb, cl = _jax(batch), jnp.asarray(cate_list)
    tb, tcl = _torch(batch), torch.from_numpy(cate_list)
    want = JaxATRank.user_repr(jparams, jb, cl, jcfg, use_pallas=False)
    np.testing.assert_allclose(model.user_repr(tb, tcl).numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    want = JaxATRank.eval_logits(jparams, jb, cl, jcfg, use_pallas=False)
    got = model.eval_logits(tb, tcl)
    assert got.shape == (B, ITEMS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for g, w in zip(model.pair_logits(tb, tcl),
                    JaxATRank.pair_logits(jparams, jb, cl, jcfg, use_pallas=False)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("concat_time_emb,with_valid",
                         [(True, False), (True, True), (False, True)])
def test_loss_and_every_grad_leaf_match_jax(concat_time_emb, with_valid):
    jcfg, jparams, cfg, model = _setup(concat_time_emb)
    batch, cate_list = _batch(seed=4, n=16), _cate_list()
    if with_valid:
        batch["valid"] = np.arange(16) < 13
    want_loss, want_grads = jax.value_and_grad(JaxATRank.loss)(
        jparams, _jax(batch), jnp.asarray(cate_list), jcfg, False)
    loss = model.loss(_torch(batch), torch.from_numpy(cate_list))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    got = grads_to_numpy(model)
    _assert_trees_close(got, jax.tree_util.tree_map(np.asarray, want_grads),
                        TOL, TOL, "grad ")
    assert all(np.abs(g).max() > 0 for _, g in _tree_items(got))


def test_one_hot_of_bucket_12_is_a_zero_row():
    """hist_t = 12 contributes only the bias through the time projection,
    as jax.nn.one_hot(12, 12) is all zeros (torch's one_hot would raise)."""
    from tlsan_tpu_torch.nn.layers import one_hot
    got = one_hot(torch.tensor([[0, 11, 12]], dtype=torch.int32), 12, torch.float32)
    want = jax.nn.one_hot(jnp.asarray([[0, 11, 12]]), 12, dtype=jnp.float32)
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_dropout_engages_in_training_only():
    """Twin of tests/test_all_models.py:157: with a dropout rate, the loss
    with a generator (training) differs from the loss without one, which
    equals the loss at rate 0 (eval); the same seed draws the same masks."""
    _, _, _, plain = _setup()
    _, _, _, drop = _setup(dropout=0.3)
    batch, cl = _torch(_batch(seed=5)), torch.from_numpy(_cate_list())
    with torch.no_grad():
        want = plain.loss(batch, cl)
        assert torch.equal(drop.loss(batch, cl), want)
        a = drop.loss(batch, cl, torch.Generator().manual_seed(0))
        b = drop.loss(batch, cl, torch.Generator().manual_seed(0))
        c = drop.loss(batch, cl, torch.Generator().manual_seed(1))
        assert torch.isfinite(a) and torch.equal(a, b) and not torch.equal(a, want)
        assert not torch.equal(a, c)
        assert torch.equal(plain.loss(batch, cl, torch.Generator().manual_seed(0)), want)


# -------------------------------------------------------------- data layout


def _prefix_tuples(n, seed, test=False):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n):
        hist = [int(x) for x in rng.integers(0, ITEMS, int(rng.integers(1, 2 * T)))]
        times = [int(x) for x in rng.integers(0, 13, len(hist))]
        if test:
            out.append((r % USERS, hist, times,
                        (int(rng.integers(ITEMS)), int(rng.integers(ITEMS)))))
        else:
            out.append((r % USERS, hist, times, int(rng.integers(ITEMS)),
                        int(rng.integers(2))))
    return out


def _assert_batches_identical(got, want):
    assert got.n == want.n and got.arrays.keys() == want.arrays.keys()
    for k, v in want.arrays.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_bucket_time_and_prefix_packers_are_byte_identical():
    rng = np.random.default_rng(6)
    days = sorted(int(d) for d in rng.integers(0, 9000, 40))
    for now in (days[-1], days[-1] + 1, days[-1] + 5000):
        assert builders.bucket_time(days, now) == jax_builders.bucket_time(days, now)
    assert max(builders.bucket_time(days, days[-1] + 5000)) == 12
    train, test = _prefix_tuples(57, 7), _prefix_tuples(23, 8, test=True)
    _assert_batches_identical(
        batcher.pack_prefix_train(train, T, with_time=True, time_dtype=np.int32),
        jax_batcher.pack_prefix_train(train, T, with_time=True, time_dtype=np.int32))
    _assert_batches_identical(
        batcher.pack_prefix_test(test, T, with_time=True, time_dtype=np.int32),
        jax_batcher.pack_prefix_test(test, T, with_time=True, time_dtype=np.int32))


def _requests(seed, n):
    """Numpy-seeded raw event streams: histories longer than T, single-day
    users, events more than 4,096 days before `now` (bucket 12), and an
    explicit `now` for some."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r in range(n):
        n_days = int(rng.integers(1, 7))
        days = np.sort(rng.choice(np.arange(100, 6000), n_days, replace=False))
        events = [[int(rng.integers(0, ITEMS)), int(d)]
                  for d in days for _ in range(int(rng.integers(1, 6)))]
        req = {"user": int(rng.integers(0, USERS)), "events": events}
        if r % 4 == 3:
            req["now"] = int(days[-1]) + int(rng.integers(0, 5000))
        reqs.append(req)
    return reqs


def test_featurize_many_bitwise_equal_to_jax():
    jcfg, _, cfg, _ = _setup()
    reqs = _requests(9, 40)
    assert any(len(r["events"]) > T for r in reqs)
    assert any(len({d for _, d in r["events"]}) == 1 for r in reqs)
    want = jax_featurize_many("atrank", jcfg, reqs)
    got = featurize_many("atrank", cfg, reqs)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["hist_t"] == 12).any() and (got["sl"] == T).any()


@pytest.mark.parametrize("exclude", [False, True])
def test_recommend_matches_jax(exclude):
    jcfg, jparams, cfg, model = _setup(catalog_items=25)
    cate_list = _cate_list()
    # 21 users through 8-wide batches: the last batch is zero-padded, so
    # rows with sl = 0 run through the encoder
    batch = featurize_many("atrank", cfg, _requests(10, 21))
    k = 12
    want_ids, want_sc = JaxRecommender(
        JaxATRank, jparams, cate_list, jcfg, k=k, use_pallas=False,
        exclude_history=exclude, batch_size=8).recommend(batch)
    ids, sc = Recommender(model, cate_list, k=k, exclude_history=exclude,
                          batch_size=8, device="cpu").recommend(batch)
    assert ids.shape == (21, k) and ids.dtype == np.int32
    assert not np.isnan(sc).any() and ids.max() < 25
    np.testing.assert_allclose(sc, want_sc, rtol=0, atol=TOL)
    for r in range(21):  # ids agree except inside groups of tied scores
        for j in np.flatnonzero(ids[r] != want_ids[r]):
            tied = np.isclose(want_sc[r], want_sc[r, j], rtol=0, atol=TOL)
            assert ids[r, j] in set(want_ids[r][tied]) or tied[-1], (r, j)


def test_checkpoint_serves_over_http(tmp_path):
    """An ATRank checkpoint loads through Recommender.from_model_dir (the
    family from the sidecar, or named as `--model atrank` names it) and the
    HTTP service gives the direct Recommender's answers."""
    _, _, cfg, model = _setup()
    cate_list = _cate_list()
    checkpoint.save(str(tmp_path), "atrank", 7, model, None, cfg, best=True)
    reqs = _requests(11, 9)
    direct_ids, direct_sc = Recommender(model, cate_list, k=5, batch_size=4,
                                        device="cpu").recommend(
        featurize_many("atrank", cfg, reqs))
    recs = [Recommender.from_model_dir(str(tmp_path), cate_list, name,
                                       device="cpu", k=5, batch_size=4)
            for name in (None, "atrank")]
    for rec in recs:
        assert isinstance(rec.model, ATRank)
        ids, sc = rec.recommend(featurize_many("atrank", rec.cfg, reqs))
        np.testing.assert_array_equal(ids, direct_ids)
        np.testing.assert_array_equal(sc, direct_sc)
    service = torch_http.RecommendService(recs[1], "atrank", recs[1].cfg, cate_list)
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
    assert [res["items"] for res in body["results"]] == direct_ids.tolist()
    np.testing.assert_allclose([res["scores"] for res in body["results"]],
                               direct_sc, rtol=0, atol=1e-4)


# ------------------------------------------------------------------ trainer


def _train_data(n_train, n_test, seed):
    """Prefix tuples with a planted rule (a row's label says whether its
    item has the user's parity), packed by the JAX package's packers."""
    rng = np.random.default_rng(seed)

    def rows(n, test):
        out = []
        for _ in range(n):
            u = int(rng.integers(0, USERS))
            hist = [int(2 * rng.integers(0, ITEMS // 2) + u % 2)
                    for _ in range(int(rng.integers(0, T + 3)))]
            times = [int(x) for x in rng.integers(0, 13, len(hist))]
            if test:
                pair = (int(2 * rng.integers(0, ITEMS // 2) + u % 2),
                        int(2 * rng.integers(0, ITEMS // 2) + 1 - u % 2))
                out.append((u, hist, times, pair))
            else:
                y = int(rng.integers(0, 2))
                item = int(2 * rng.integers(0, ITEMS // 2) + (u + 1 - y) % 2)
                out.append((u, hist, times, item, y))
        return out

    return (jax_batcher.pack_prefix_train(rows(n_train, False), T, with_time=True,
                                          time_dtype=np.int32),
            jax_batcher.pack_prefix_test(rows(n_test, True), T, with_time=True,
                                         time_dtype=np.int32))


def _records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_matches_jax_trainer(tmp_path):
    """Two epochs of Trainer(ATRank) against the JAX Trainer (plain
    attention, dense updates) from the same initial parameters: chunk
    losses within 1e-5 relative, AUC within one test user, final
    parameters within 1e-4, and the JAX Trainer's summary tags."""
    train, test = _train_data(256, 100, seed=12)
    cate_list = _cate_list()
    # lr 0.1: at identical parameters the two agree to ~1e-6 relative
    # (losses and gradients), but at lr 0.5 a ReLU or two flips within
    # 8 steps and the f32 rounding difference grows past 1e-5
    kw = dict(max_epochs=2, train_batch_size=32, test_batch_size=64,
              steps_per_call=4, eval_freq=8, display_freq=4, summary_freq=4,
              best_after_step=0, learning_rate=0.1, save_auc_gate=0.0)
    jtc = JaxTrainConfig(model_dir=str(tmp_path / "jax"), sparse_updates=False, **kw)
    tc = TrainConfig(model_dir=str(tmp_path / "torch"), **kw)
    jtr = JaxTrainer(JaxATRank, JaxModelConfig(**CFG), jtc, cate_list, train,
                     test, use_pallas=False)
    tr = Trainer(ATRank, ModelConfig(**CFG), tc, cate_list,
                 batcher.Batches(dict(train.arrays), train.n),
                 batcher.Batches(dict(test.arrays), test.n), device="cpu")
    assert tr._summary_tags == jtr._summary_tags
    assert tr._summary_tags == ["embedding/item_emb", "embedding/cate_emb",
                                "embedding/item_b", "attention_output"]
    init = params_from_numpy(jax.tree_util.tree_map(np.array, jtr.params),
                             ModelConfig(**CFG), "cpu")
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
            assert abs(g["auc"] - w["auc"]) <= 1.0 / test.n + 1e-9
    _assert_trees_close(params_to_numpy(tr.model),
                        jax.tree_util.tree_map(np.asarray, jtr.params),
                        1e-4, 1e-4, "param ")
    assert tr.opt_state.count == tr.step == 16
    # a resumed Trainer evaluates as the last save did
    tr2 = Trainer(ATRank, ModelConfig(**CFG), dataclasses.replace(tc, from_scratch=False),
                  cate_list, batcher.Batches(dict(train.arrays), train.n),
                  batcher.Batches(dict(test.arrays), test.n), device="cpu")
    final = [r for r in got if r["kind"] == "final"][-1]
    assert tr2.step == 16 and tr2.evaluate() == {
        k: v for k, v in final.items() if k not in ("kind", "step", "wall_s")}
    tr2.close()
