"""The port's (dp, mp) mesh against the JAX package's, on the CPU.

Each world is four spawned ranks over Gloo (dp=2, mp=2), rendezvousing
through a file under the test's tmp_path, with a time limit of its own, so
a hang fails one world's tests and not the suite.  The ranks run the
port's rank programs (tlsan_tpu_torch/parallel/programs.py) on numpy
inputs made from a seed; the JAX side runs on make_mesh(dp=2, mp=2) over
four of the 8 virtual CPU devices of tests/conftest.py, or on one device
where the bar is the single-device step.  Several checks share a world.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tests.test_torch_atrank import _train_data as atrank_train_data
from tests.test_train import synthetic
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.models.atrank import ATRank as JaxATRank
from tlsan_tpu.models.tlsan import TLSAN as JaxTLSAN
from tlsan_tpu.parallel import api as jax_api
from tlsan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tlsan_tpu.parallel.sharded_embedding import sharded_lookup as jax_lookup
from tlsan_tpu.parallel.topk import sharded_topk_scores as jax_topk
from tlsan_tpu.train.loop import Trainer as JaxTrainer
from tlsan_tpu.train.state import make_optimizer as jax_make_optimizer
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.parallel import api, programs
from tlsan_tpu_torch.parallel.multihost import run_local
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.tools.params import params_from_numpy
from tlsan_tpu_torch.train import checkpoint
from tlsan_tpu_torch.train.loop import Trainer

DP, MP = 2, 2
# a world of this file runs for 3-15 s alone; the limit leaves room for
# a loaded machine and still fails a hang long before the suite's limit
WORLD_TIMEOUT_S = 120
USERS, ITEMS, CATES = 21, 29, 5  # none a multiple of mp: the tables pad
TLSAN_CFG = dict(model="tlsan", user_count=USERS, item_count=ITEMS,
                 cate_count=CATES, Ls=10, Ts=8)
ATRANK_CFG = dict(model="atrank", user_count=USERS, item_count=ITEMS,
                  cate_count=CATES, max_length=12)


def _world(tmp_path, fn, *args, **kwargs):
    """Run `fn` on a dp=2, mp=2 Gloo world of CPU ranks; results by rank."""
    init = "file://" + str(tmp_path / "rendezvous")
    return run_local(fn, DP, MP, "gloo", "cpu", WORLD_TIMEOUT_S, *args,
                     init_method=init, **kwargs)


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    return jax_make_mesh(dp=DP, mp=MP, devices=jax.devices()[:4])


def _by_dp(results, key_fn):
    """One rank's piece per dp index (mp index 0), stacked in row order;
    the other mp ranks of each dp index hold the same rows."""
    for d in range(DP):
        for m in range(1, MP):
            a, b = key_fn(results[d * MP]), key_fn(results[d * MP + m])
            assert a.tobytes() == b.tobytes()
    return np.concatenate([key_fn(results[d * MP]) for d in range(DP)])


# ------------------------------------------------------- lookups and top-k


def _lookup_cases():
    rng = np.random.default_rng(0)
    cases = {
        "ids_1d": (rng.normal(size=(24, 16)), rng.integers(0, 24, 8)),
        "ids_2d": (rng.normal(size=(16, 8)), rng.integers(0, 16, (8, 5))),
        "bias": (rng.normal(size=(24,)), rng.integers(0, 24, (8, 3))),
    }
    out = {}
    for name, (table, ids) in cases.items():
        ids.reshape(-1)[:3] = [0, len(table) - 1, 0]  # both ends, a repeat
        table = table.astype(np.float32)
        ct = rng.normal(size=ids.shape + table.shape[1:]).astype(np.float32)
        out[name] = dict(table=table, ids=ids.astype(np.int32), ct=ct)
    return out


LOOKUPS = _lookup_cases()


def _topk_cases():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(8, 16)).astype(np.float32)
    emb = rng.normal(size=(40, 16)).astype(np.float32)
    bias = rng.normal(size=40).astype(np.float32)
    return {"bias": dict(u=u, emb=emb, bias=bias, k=5, catalog=None),
            "no_bias": dict(u=u, emb=emb, bias=None, k=7, catalog=None),
            "catalog_mask": dict(u=u, emb=emb, bias=bias, k=12, catalog=31)}


TOPKS = _topk_cases()


@pytest.fixture(scope="module")
def ops_world(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("ops"), programs.check_ops,
                  lookups=list(LOOKUPS.values()), topks=list(TOPKS.values()))


@pytest.mark.parametrize("case", list(LOOKUPS))
def test_sharded_lookup_values_are_exact(ops_world, jmesh, case):
    c, i = LOOKUPS[case], list(LOOKUPS).index(case)
    got = _by_dp(ops_world, lambda r: r["lookups"][i]["out"])
    np.testing.assert_array_equal(got, c["table"][c["ids"]])
    want = jax_lookup(jmesh, jnp.asarray(c["table"]), jnp.asarray(c["ids"]))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("case", list(LOOKUPS))
def test_sharded_lookup_grads_are_the_scatter_add(ops_world, jmesh, case):
    """The gradient is the dense scatter-add of the cotangent, once: no
    mp-fold copy from an all_reduce in the backward."""
    c, i = LOOKUPS[case], list(LOOKUPS).index(case)
    for r in ops_world:  # every rank gathers the same whole gradient
        np.testing.assert_array_equal(r["lookups"][i]["grad"],
                                      ops_world[0]["lookups"][i]["grad"])
    got = ops_world[0]["lookups"][i]["grad"]
    dense = np.zeros_like(c["table"])
    np.add.at(dense, c["ids"], c["ct"])
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)
    jgrad = jax.grad(lambda t: jnp.sum(
        jax_lookup(jmesh, t, jnp.asarray(c["ids"])) * c["ct"]))(
            jnp.asarray(c["table"]))
    np.testing.assert_allclose(got, np.asarray(jgrad), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(TOPKS))
def test_sharded_topk_matches_jax_and_dense(ops_world, jmesh, case):
    c, i = TOPKS[case], list(TOPKS).index(case)
    vals = _by_dp(ops_world, lambda r: r["topks"][i]["vals"])
    idx = _by_dp(ops_world, lambda r: r["topks"][i]["idx"])
    jv, ji = jax_topk(jmesh, jnp.asarray(c["u"]), jnp.asarray(c["emb"]),
                      None if c["bias"] is None else jnp.asarray(c["bias"]),
                      c["k"], catalog_items=c["catalog"])
    np.testing.assert_allclose(vals, np.asarray(jv), rtol=1e-5)
    np.testing.assert_array_equal(idx, np.asarray(ji))
    dense = c["u"] @ c["emb"].T + (0 if c["bias"] is None else c["bias"])
    if c["catalog"] is not None:
        dense[:, c["catalog"]:] = -np.inf
        assert (idx < c["catalog"]).all()
    want = np.argsort(-dense, axis=1, kind="stable")[:, :c["k"]]
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(vals, np.take_along_axis(dense, want, 1), rtol=1e-5)


def test_a_failing_rank_fails_the_world(tmp_path):
    """A batch of 7 rows does not split over dp=2: every rank raises, and
    the launcher reports it instead of returning."""
    bad = dict(LOOKUPS["ids_1d"], ids=LOOKUPS["ids_1d"]["ids"][:7])
    with pytest.raises(RuntimeError, match="must divide evenly"):
        _world(tmp_path, programs.check_ops, lookups=[bad])


# ----------------------------------------------------------- pad / unpad


@pytest.mark.parametrize("family", ["tlsan", "atrank"])
def test_pad_and_unpad_match_jax_byte_for_byte(family):
    jmodel, kw = {"tlsan": (JaxTLSAN, TLSAN_CFG),
                  "atrank": (JaxATRank, ATRANK_CFG)}[family]
    jcfg = JaxModelConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(3), jcfg))
    padded_cfg = jax_api.pad_config_for_mp(jcfg, MP)
    cfg = api.pad_config_for_mp(ModelConfig(**kw), MP)
    assert (cfg.user_count, cfg.item_count, cfg.cate_count, cfg.catalog_items) == (
        padded_cfg.user_count, padded_cfg.item_count, padded_cfg.cate_count,
        padded_cfg.catalog_items) == (22, 30, 6, ITEMS)
    true, padded = (USERS, ITEMS, CATES), api.counts(cfg)
    state = {k: v.detach() for k, v in
             params_from_numpy(tree, ModelConfig(**kw), "cpu").state_dict().items()}
    got = api.pad_vocab_rows(state, true, padded)
    want = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_api.pad_vocab_rows(tree, true, padded)),
        cfg, "cpu").state_dict()
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].numpy().tobytes() == want[name].numpy().tobytes(), name
    back = api.unpad_vocab_rows(got, true)
    for name in state:
        assert back[name].numpy().tobytes() == state[name].numpy().tobytes(), name
    cl = np.arange(ITEMS, dtype=np.int32) % CATES
    np.testing.assert_array_equal(api.pad_cate_list(cl, cfg),
                                  jax_api.pad_cate_list(cl, padded_cfg))


# --------------------------------------------------------- one train step


def _tlsan_step_inputs():
    train, _, cate_list = synthetic(n=32, users=USERS, items=ITEMS, cates=CATES)
    batch = {k: v.copy() for k, v in train.arrays.items()}
    batch["sl"][:2] = 0
    # dp shard 0 holds 16 valid rows, shard 1 only 13
    batch["valid"] = np.arange(32) < 29
    return JaxTLSAN, TLSAN_CFG, batch, cate_list


def _atrank_step_inputs():
    rng = np.random.default_rng(5)
    T, n = ATRANK_CFG["max_length"], 32
    batch = {"u": rng.integers(0, USERS, n), "i": rng.integers(0, ITEMS, n),
             "y": rng.integers(0, 2, n).astype(np.float32),
             "hist_i": rng.integers(0, ITEMS, (n, T)),
             "hist_t": rng.integers(0, 13, (n, T)),
             "sl": rng.integers(0, T + 1, n)}
    batch = {k: (v if v.dtype == np.float32 else v.astype(np.int32))
             for k, v in batch.items()}
    batch["valid"] = np.arange(n) % 16 < np.where(np.arange(n) < 16, 16, 9)
    return JaxATRank, ATRANK_CFG, batch, rng.integers(0, CATES, ITEMS).astype(np.int32)


STEP_INPUTS = {"tlsan": _tlsan_step_inputs, "atrank": _atrank_step_inputs}
# below the initial gradients' global norm (0.39 for TLSAN), so the step's
# clip engages and a norm summed wrongly over the mesh shows
STEP_CLIP = 0.1


@pytest.fixture(scope="module")
def step_world(tmp_path_factory):
    jobs, wants = [], {}
    for family, make in STEP_INPUTS.items():
        jmodel, kw, batch, cate_list = make()
        jcfg = JaxModelConfig(**kw)
        params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
        loss, grads = jax.value_and_grad(jmodel.loss)(
            params, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(cate_list), jcfg, False)
        opt = jax_make_optimizer(JaxTrainConfig(max_gradient_norm=STEP_CLIP))
        updates, _ = opt.update(grads, opt.init(params), params)
        new = optax.apply_updates(params, updates)
        as_state = lambda tree: {  # noqa: E731
            k: v.detach().numpy() for k, v in params_from_numpy(
                jax.tree_util.tree_map(np.asarray, tree), ModelConfig(**kw),
                "cpu").state_dict().items()}
        wants[family] = (float(loss), as_state(new), float(optax.global_norm(grads)))
        jobs.append((programs.train_step, dict(
            cfg=ModelConfig(**kw), tc=TrainConfig(max_gradient_norm=STEP_CLIP),
            state=as_state(params),
            batch=batch, cate_list=cate_list)))
    got = _world(tmp_path_factory.mktemp("step"), programs.sequence, *jobs)
    return {family: ([r[i] for r in got], wants[family])
            for i, family in enumerate(STEP_INPUTS)}


@pytest.mark.parametrize("family", list(STEP_INPUTS))
def test_sharded_step_matches_jax_single_device(step_world, family):
    """One step at lr 1.0 with the clip engaged, on a batch whose dp
    shards hold different numbers of valid rows: the loss of the global
    batch, and every parameter after the update."""
    ranks, (want_loss, want_state, g_norm) = step_world[family]
    assert g_norm > 2 * STEP_CLIP
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-5)
    got = ranks[0]["state"]
    assert got.keys() == want_state.keys()
    for name in want_state:
        np.testing.assert_allclose(got[name], want_state[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)


# ----------------------------------------------- Trainer, checkpoints, serving


TRAIN_KW = dict(max_epochs=1, train_batch_size=32, test_batch_size=64,
                steps_per_call=4, eval_freq=8, display_freq=4, summary_freq=4,
                best_after_step=0, save_auc_gate=0.0)


def _records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _family_data(family):
    if family == "tlsan":
        train, test, cate_list = synthetic(n=256, users=USERS, items=ITEMS,
                                           cates=CATES)
        return JaxTLSAN, TLSAN_CFG, 0.5, train, test, cate_list
    train, test = atrank_train_data(256, 100, seed=12)
    cate_list = np.random.default_rng(2).integers(0, CATES, ITEMS).astype(np.int32)
    return JaxATRank, ATRANK_CFG, 0.1, train, test, cate_list


def _port(b):
    return Batches(dict(b.arrays), b.n)


def _requests(test, family):
    drop = ("j",) if family == "atrank" else ("i", "j")
    return {k: v[:90] for k, v in test.arrays.items() if k not in drop}


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    """In one world: Trainer(dp=2, mp=2) per family from the JAX mesh
    Trainer's initial weights; the middle of an mp=1 → mp=2 → mp=1
    checkpoint chain; and the meshed Recommender on the trained
    checkpoints."""
    tmp = tmp_path_factory.mktemp("trainer")
    jobs, runs = [], {}
    for family in ("tlsan", "atrank"):
        jmodel, kw, lr, train, test, cate_list = _family_data(family)
        jtc = JaxTrainConfig(model_dir=str(tmp / f"jax_{family}"), dp=DP, mp=MP,
                             learning_rate=lr, sparse_updates=False, **TRAIN_KW)
        jtr = JaxTrainer(jmodel, JaxModelConfig(**kw), jtc, cate_list, train,
                         test, use_pallas=False)
        # the port starts from the JAX init: a step-0 checkpoint it restores
        tc = TrainConfig(model_dir=str(tmp / f"torch_{family}"), dp=DP, mp=MP,
                         learning_rate=lr, from_scratch=False, **TRAIN_KW)
        init = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr._ckpt_params()),
                                 ModelConfig(**kw), "cpu")
        checkpoint.save(tc.model_dir, family, 0, init, {"count": 0}, ModelConfig(**kw))
        jtr.train()
        jtr.writer.close()
        runs[family] = (jtc, tc, test, cate_list)
        jobs.append((programs.train_program, dict(
            cfg=ModelConfig(**kw), tc=tc, cate_list=cate_list, train=_port(train),
            test=_port(test))))

    # the chain's first link: one process, mp=1
    train, test, cate_list = synthetic(n=128, users=USERS, items=ITEMS, cates=CATES)
    chain = dict(max_epochs=1, train_batch_size=32, test_batch_size=64,
                 steps_per_call=2, eval_freq=10**9, best_after_step=0)
    d = str(tmp / "chain")
    tr1 = Trainer(TLSAN, ModelConfig(**TLSAN_CFG), TrainConfig(model_dir=d, **chain),
                  cate_list, _port(train), _port(test), device="cpu")
    tr1.train()
    tr1.close()
    jobs.append((programs.train_program, dict(
        cfg=ModelConfig(**TLSAN_CFG),
        tc=TrainConfig(model_dir=d, from_scratch=False, dp=DP, mp=MP, **chain),
        cate_list=cate_list, train=_port(train), test=_port(test))))

    serves = []
    for family, exclude in (("tlsan", False), ("tlsan", True), ("atrank", False)):
        _, ftc, ftest, fcate_list = runs[family]
        serves.append((family, exclude))
        jobs.append((programs.serve_program, dict(
            model_dir=ftc.model_dir, cate_list=fcate_list,
            requests=_requests(ftest, family), k=10, batch_size=64,
            exclude_history=exclude)))
    got = _world(tmp, programs.sequence, *jobs)
    return {"runs": runs, "got": got, "chain": (d, tr1, chain, train, test, cate_list),
            "serves": serves}


@pytest.mark.parametrize("family", ["tlsan", "atrank"])
def test_mesh_trainer_matches_jax_mesh_trainer(trainer_world, family):
    """Chunk losses within rtol 1e-5 of the JAX Trainer at dp=2, mp=2 from
    the same weights, the AUC equal at every evaluation, the padding rows
    still zero."""
    jtc, tc, test, _ = trainer_world["runs"][family]
    r = trainer_world["got"][0][["tlsan", "atrank"].index(family)]
    assert r["start"]["step"] == 0 and r["step"] == r["count"] == 8
    assert r["start"]["shards"]["item_emb"] == (15, 32)  # 30 rows over mp=2
    assert r["pad_max"] == 0.0
    want, got = _records(jtc.model_dir), _records(tc.model_dir)
    assert [(g["kind"], g["step"]) for g in got] == [(w["kind"], w["step"]) for w in want]
    for g, w in zip(got, want):
        if g["kind"] == "train":
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        if g["kind"] in ("eval", "final"):
            assert g["auc"] == w["auc"]
            for k in ("R@1", "R@10", "R@20"):  # hits = R@k · users
                assert round(g[k] * test.n) == round(w[k] * test.n), k
    assert r["metrics"]["auc"] == got[-1]["auc"]
    # every rank read the same metrics
    assert all(x[0 if family == "tlsan" else 1]["metrics"] == r["metrics"]
               for x in trainer_world["got"])


def test_cross_topology_checkpoint_chain(trainer_world):
    """mp=1 → mp=2 → mp=1: the mesh restores the single-process save bit
    for bit and resumes its step; its save restores in one process bit for
    bit (checkpoints are unpadded)."""
    d, tr1, chain, train, test, cate_list = trainer_world["chain"]
    r = trainer_world["got"][0][2]
    assert r["start"]["step"] == tr1.step == 4
    for name, v in tr1.model.state_dict().items():
        assert r["start"]["state"][name].tobytes() == v.numpy().tobytes(), name
    assert r["step"] == r["count"] == 8
    tr3 = Trainer(TLSAN, ModelConfig(**TLSAN_CFG),
                  TrainConfig(model_dir=d, from_scratch=False, **chain),
                  cate_list, _port(train), _port(test), device="cpu")
    assert tr3.step == 8 and tr3.opt_state.count == 8
    for name, v in tr3.model.state_dict().items():
        assert r["final_state"][name].tobytes() == v.numpy().tobytes(), name
    # one process evaluates the mesh's save as the mesh did
    assert tr3.evaluate() == r["metrics"]
    tr3.close()


@pytest.mark.parametrize("which", [0, 1, 2], ids=["tlsan", "tlsan_exclude", "atrank"])
def test_meshed_recommender_matches_one_device(trainer_world, which):
    """Every rank returns the whole answer; its hits of the test label, and
    its scores, equal the single-device Recommender's on the same save."""
    family, exclude = trainer_world["serves"][which]
    _, tc, test, cate_list = trainer_world["runs"][family]
    ranks = [x[3 + which] for x in trainer_world["got"]]
    for r in ranks[1:]:
        assert r["ids"].tobytes() == ranks[0]["ids"].tobytes()
        assert r["scores"].tobytes() == ranks[0]["scores"].tobytes()
    rec = Recommender.from_model_dir(tc.model_dir, cate_list, device="cpu", k=10,
                                     batch_size=64, exclude_history=exclude)
    requests = _requests(test, family)
    want_ids, want_scores = rec.recommend(requests)
    ids, scores = ranks[0]["ids"], ranks[0]["scores"]
    assert ids.shape == want_ids.shape == (90, 10)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-6)
    label = test.arrays["i"][:90, None]
    np.testing.assert_array_equal((ids == label).any(1), (want_ids == label).any(1))
    if exclude:
        for r in range(90):
            hist = set(requests["hist_i"][r][:requests["sl"][r]]) | set(
                requests["hist_i_new"][r][:requests["sl_new"][r]])
            assert not hist & set(ids[r])
    assert (ids < ITEMS).all()
