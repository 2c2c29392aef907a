"""The port reads the JAX package's checkpoints (train/checkpoint.py,
train/msgpack.py), on the CPU.

  - Restore: for all nine families under SGD, Adam, Adadelta and RMSProp,
    a checkpoint written by ``tlsan_tpu.train.checkpoint.save`` whose slots
    are non-zero (a few updates of the JAX ``make_optimizer`` on seeded
    gradients) restores in the port with every parameter and every slot
    bit for bit, the schedule count kept.
  - Continuation: the port's Trainer resumes a JAX Trainer's --model_dir
    and its next 5 steps equal the JAX Trainer's: TLSAN and ATRank under
    Adam (to tests/test_torch_optim.py's tolerances, FWA's b2 to the walk
    bound), TLSAN under SGD within 1e-5.
  - The decoder: every msgpack type flax writes, its three ext types, a
    chunked array; the UnpicklingError that torch.load gave on a JAX file
    is now a clean restore, and an unknown or corrupt file raises naming
    both formats.
  - The committed migration fixture (tlsan_tpu_torch/tools/fixtures/
    jax_tlsan/, which chip_smoke.py's `migrate` phase reads on the card,
    where there is no JAX) is what `write_migrate_fixture` writes with the
    JAX package today, tree for tree; and the port resumes and serves it
    on the CPU as the JAX package did.

Regenerate the fixture with ``python tests/test_torch_checkpoint_jax.py``.
"""

import dataclasses
import gzip
import json
import os
import pathlib
import pickle
import shutil
import sys
import warnings

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if __name__ == "__main__":  # run as a script: the repository's root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tests.test_torch_atrank import CFG as ATRANK_CFG  # noqa: E402
from tests.test_torch_atrank import _train_data as atrank_train_data  # noqa: E402
from tests.test_torch_families import cfg_kw  # noqa: E402
from tests.test_torch_optim import _optax_slots  # noqa: E402
from tests.test_torch_sparse import ADAM_NOISE_LEAVES, ADAM_WALK_BOUND  # noqa: E402
from tests.test_torch_train import CFG as TLSAN_CFG  # noqa: E402
from tests.test_torch_train import _tree_items  # noqa: E402
from tests.test_train import synthetic  # noqa: E402
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig  # noqa: E402
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tlsan_tpu.data.batcher import Batches as JaxBatches  # noqa: E402
from tlsan_tpu.models import get_model as jax_get_model  # noqa: E402
from tlsan_tpu.serve.recommender import Recommender as JaxRecommender  # noqa: E402
from tlsan_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from tlsan_tpu.train.loop import Trainer as JaxTrainer  # noqa: E402
from tlsan_tpu.train.state import make_optimizer as jax_make_optimizer  # noqa: E402
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from tlsan_tpu_torch.data import remap  # noqa: E402
from tlsan_tpu_torch.data.batcher import Batches  # noqa: E402
from tlsan_tpu_torch.models import get_model  # noqa: E402
from tlsan_tpu_torch.serve import cli as serve_cli  # noqa: E402
from tlsan_tpu_torch.serve.recommender import Recommender  # noqa: E402
from tlsan_tpu_torch.tools.params import _flatten, params_to_numpy  # noqa: E402
from tlsan_tpu_torch.tools.snap_fixture import write_snap_fixture  # noqa: E402
from tlsan_tpu_torch.train import checkpoint, msgpack  # noqa: E402
from tlsan_tpu_torch.train.cli import prepare  # noqa: E402
from tlsan_tpu_torch.train.loop import Trainer  # noqa: E402

FAMILIES = ["tlsan", "atrank", "shan", "bpr", "lspm", "paca", "cnn", "bilstm", "csan"]
OPTIMIZERS = ["sgd", "adam", "adadelta", "rmsprop"]
STEP, UPDATES = 7, 3


def _jax_cfg(name):
    if name == "tlsan":
        return dict(TLSAN_CFG)
    if name == "atrank":
        return dict(ATRANK_CFG)
    return cfg_kw(name)


def _nonzero_state(name, optimizer, seed):
    """(JAX params, optax state after UPDATES updates on seeded gradients,
    its optimizer) of the family at tiny sizes."""
    jcfg = JaxModelConfig(**_jax_cfg(name))
    params = jax_get_model(name).init_params(jax.random.PRNGKey(seed), jcfg)
    opt = jax_make_optimizer(JaxTrainConfig(optimizer=optimizer, learning_rate=0.1))
    state = opt.init(params)
    rng = np.random.default_rng(seed)
    for _ in range(UPDATES):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
        _, state = opt.update(grads, state, params)
    return params, state


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("name", FAMILIES)
def test_restore_is_bit_for_bit(tmp_path, name, optimizer):
    """A JAX checkpoint with non-zero slots: every parameter, every slot and
    the count restore bit for bit, by the port's parameter names."""
    params, state = _nonzero_state(name, optimizer, seed=FAMILIES.index(name))
    jax_checkpoint.save(str(tmp_path), name, STEP, params, state,
                        JaxModelConfig(**_jax_cfg(name)))
    path = checkpoint.latest_checkpoint(str(tmp_path))
    assert checkpoint.checkpoint_format(path) == "jax"
    model = get_model(name)(ModelConfig(**_jax_cfg(name)), "cpu")
    step, _, opt_state = checkpoint.restore(path, model, optimizer)
    assert step == STEP and opt_state["count"] == UPDATES
    want = _flatten(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert torch.equal(got[k], torch.from_numpy(np.array(w))), k
    slots = _optax_slots(optimizer, state)
    assert set(opt_state.get("slots", {})) == set(slots)
    for slot, tree in slots.items():
        flat = _flatten(jax.tree_util.tree_map(np.asarray, tree))
        assert opt_state["slots"][slot].keys() == flat.keys()
        assert any(np.abs(v).max() > 0 for v in flat.values())  # non-zero slots
        for k, w in flat.items():
            assert torch.equal(opt_state["slots"][slot][k], torch.from_numpy(np.array(w))), \
                (slot, k)


def test_restore_refuses_what_it_cannot_read(tmp_path):
    """Another optimizer than the run's raises naming both; an Adam count
    that differs from the schedule's raises; a parameter the model lacks,
    or of another shape, raises."""
    params, state = _nonzero_state("shan", "adam", seed=1)
    cfg = JaxModelConfig(**_jax_cfg("shan"))
    path = jax_checkpoint.save(str(tmp_path / "a"), "shan", 3, params, state, cfg)
    model = get_model("shan")(ModelConfig(**_jax_cfg("shan")), "cpu")
    with pytest.raises(ValueError, match="adam optimizer; this run trains with rmsprop"):
        checkpoint.restore(path, model, "rmsprop")
    raw = fser.msgpack_restore(open(path, "rb").read())
    raw["opt_state"]["1"]["0"]["count"] = np.int32(99)
    bad = tmp_path / "count.ckpt"
    bad.write_bytes(fser.msgpack_serialize(raw))
    with pytest.raises(ValueError, match="count 99 differs from its schedule count"):
        checkpoint.restore(str(bad), model)
    other = get_model("shan")(ModelConfig(**dict(_jax_cfg("shan"), item_count=31)), "cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, other)
    bpr = get_model("bpr")(ModelConfig(**_jax_cfg("bpr")), "cpu")
    with pytest.raises(KeyError, match="parameter names differ"):
        checkpoint.restore(path, bpr)


# ------------------------------------------------------------- continuation

CONTINUE_STEPS, PRE_STEPS = 5, 3


@pytest.mark.parametrize("name,optimizer", [("tlsan", "adam"), ("atrank", "adam"),
                                            ("tlsan", "sgd")])
def test_port_trainer_continues_a_jax_trainer(tmp_path, name, optimizer):
    """The JAX Trainer takes 3 steps and saves; the port's Trainer resumes
    its --model_dir (step, schedule count and moments) and takes the next 5
    steps as the JAX Trainer does: losses within 1e-5 relative, parameters
    within 1e-4 under Adam (FWA's b2, whose exact gradient is 0, to the
    walk bound of tests/test_torch_sparse.py) and 1e-5 under SGD."""
    if name == "tlsan":
        train, test, cate_list = synthetic()
        jmodel_cfg = dict(TLSAN_CFG)
    else:
        train, test = atrank_train_data(256, 64, seed=3)
        jmodel_cfg = dict(ATRANK_CFG)
        cate_list = np.random.default_rng(4).integers(
            0, jmodel_cfg["cate_count"], jmodel_cfg["item_count"]).astype(np.int32)
    kw = dict(max_epochs=1, train_batch_size=32, test_batch_size=64,
              steps_per_call=PRE_STEPS, eval_freq=10**9, best_after_step=0,
              optimizer=optimizer, learning_rate=0.5 if optimizer == "sgd" else 0.01,
              lr_drop_step=6, tb_histograms=False, sparse_updates=False)
    model_dir = str(tmp_path / "model")
    jtr = JaxTrainer(jax_get_model(name), JaxModelConfig(**jmodel_cfg),
                     JaxTrainConfig(model_dir=model_dir, **kw), cate_list, train, test,
                     use_pallas=False)
    idx = np.random.default_rng(5).integers(0, train.n, (PRE_STEPS + CONTINUE_STEPS, 32))
    jtr.params, jtr.opt_state, _ = jtr._train_chunk(jtr.params, jtr.opt_state,
                                                    idx[:PRE_STEPS])
    jtr.step = PRE_STEPS
    jtr._save()
    jtr.writer.close()
    jparams, jopt, jloss = jtr._train_chunk(jtr.params, jtr.opt_state, idx[PRE_STEPS:])

    tr = Trainer(get_model(name), ModelConfig(**jmodel_cfg),
                 TrainConfig(model_dir=model_dir, from_scratch=False, **kw), cate_list,
                 Batches(dict(train.arrays), train.n), Batches(dict(test.arrays), test.n),
                 device="cpu")
    assert tr.step == PRE_STEPS and tr.opt_state.count == PRE_STEPS
    losses = tr._train_chunk(torch.from_numpy(idx[PRE_STEPS:]))
    np.testing.assert_allclose(float(losses.mean()), float(jloss), rtol=1e-5)
    got = dict(_tree_items(params_to_numpy(tr.model)))
    want = dict(_tree_items(jax.tree_util.tree_map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    noise = ADAM_NOISE_LEAVES.get(name, ()) if optimizer == "adam" else ()
    tol = 1e-4 if optimizer == "adam" else 1e-5
    for leaf, w in want.items():
        if leaf in noise:
            assert np.abs(got[leaf] - w).max() < ADAM_WALK_BOUND, leaf
        else:
            np.testing.assert_allclose(got[leaf], w, rtol=tol, atol=tol, err_msg=leaf)
    assert tr.opt_state.count == PRE_STEPS + CONTINUE_STEPS
    tr.close()


# ------------------------------------------------------------------ decoder


def test_decoder_reads_every_type_flax_writes(monkeypatch):
    """Integers of every width and sign, floats, str (fix, 8 and 16-bit
    lengths), bin, nil, bools, arrays and maps of 16 or more entries, and
    flax's ext types (ndarray of several dtypes, bfloat16 included;
    complex; numpy scalars), with one array chunked: the port's tree equals
    flax's msgpack_restore's, value and dtype."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    tree = {
        "ints": [0, 127, -1, -32, -33, 200, -200, 70000, -70000, 2 ** 33, -(2 ** 33),
                 2 ** 63 + 5],
        "floats": [1.5, -2.25e300], "none": None, "flags": [True, False],
        "strs": ["x", "é" * 20, "y" * 300, "z" * 70000], "bin": [b"\x00\x01", b"b" * 300],
        "long": list(range(20)), "wide": {f"k{i}": i for i in range(20)},
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "big": np.linspace(0, 1, 100, dtype=np.float32),  # 400 bytes: chunked
        "f64": np.array([1e-310, np.pi]), "i32": np.array([-5, 6], np.int32),
        "u8": np.arange(4, dtype=np.uint8), "bool": np.array([True, False]),
        "bf16": jnp.asarray([1.5, -2.0, 3.0], jnp.bfloat16),
        "scalars": [np.float32(3.5), np.int64(-9), np.bool_(True)],
        "complex": 1.5 - 2j, "empty": {}, "zero_d": np.array(4.0, np.float32),
    }
    raw = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in raw
    got, want = msgpack.loads(raw), fser.msgpack_restore(raw)

    def same(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (list, tuple)):
            assert list(a) == list(a) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        elif isinstance(b, np.ndarray) and b.dtype == jnp.bfloat16:
            assert a.dtype == np.float32 and np.array_equal(a, b.astype(np.float32)), path
        elif isinstance(b, (np.ndarray, np.generic)):
            assert np.asarray(a).dtype == np.asarray(b).dtype, path
            assert np.array_equal(a, b) and np.shape(a) == np.shape(b), path
        else:
            assert type(a) is type(b) and a == b, path

    same(got, want, "")


def test_jax_model_dir_restores_where_torch_load_refused(tmp_path):
    """torch.load(weights_only=True), which the port's restore called
    before, refuses a JAX checkpoint with an UnpicklingError that advises
    weights_only=False; the port now restores it, and
    Recommender.from_model_dir serves it as the JAX Recommender does."""
    train, test, cate_list = synthetic()
    params = jax_get_model("tlsan").init_params(jax.random.PRNGKey(3),
                                                JaxModelConfig(**TLSAN_CFG))
    opt = jax_make_optimizer(JaxTrainConfig())
    d = str(tmp_path)
    path = jax_checkpoint.save(d, "tlsan", 5, params, opt.init(params),
                               JaxModelConfig(**TLSAN_CFG), JaxTrainConfig(), best=True)
    with pytest.raises(pickle.UnpicklingError, match="weights_only"):
        torch.load(path, map_location="cpu", weights_only=True)
    requests = {k: v[:40] for k, v in test.arrays.items() if k not in ("i", "j", "y")}
    want_ids, want_sc = JaxRecommender.from_model_dir(d, cate_list, k=10).recommend(requests)
    rec = Recommender.from_model_dir(d, cate_list, device="cpu", k=10)
    ids, sc = rec.recommend(requests)
    np.testing.assert_allclose(sc, want_sc, rtol=1e-5, atol=1e-6)
    assert (ids == want_ids).mean() > 0.99  # exact ties may order differently


def test_unknown_and_corrupt_files_raise_naming_both_formats(tmp_path):
    """A file that is neither format raises ValueError naming torch.save's
    zip and flax's msgpack; a cut JAX file and trailing bytes raise the
    decoder's error; an ext type flax does not write raises."""
    junk = tmp_path / "junk.ckpt"
    junk.write_text("not a checkpoint")
    model = get_model("tlsan")(ModelConfig(**TLSAN_CFG), "cpu")
    with pytest.raises(ValueError, match="torch.save .*flax msgpack"):
        checkpoint.restore(str(junk), model)
    params = jax_get_model("tlsan").init_params(jax.random.PRNGKey(0),
                                                JaxModelConfig(**TLSAN_CFG))
    path = jax_checkpoint.save(str(tmp_path), "tlsan", 1, params, None)
    data = open(path, "rb").read()
    cut = tmp_path / "cut.ckpt"
    cut.write_bytes(data[:len(data) // 2])
    with pytest.raises(msgpack.MsgpackError, match="ends early"):
        checkpoint.restore(str(cut), model)
    with pytest.raises(msgpack.MsgpackError, match="bytes after"):
        msgpack.loads(data + b"\x00")
    with pytest.raises(msgpack.MsgpackError, match="ext type 9"):
        msgpack.loads(b"\xd4\x09\x00")
    with pytest.raises(msgpack.MsgpackError, match="0xc1"):
        msgpack.loads(b"\xc1")
    # a serving-only JAX save (opt_state None) restores with no optimizer state
    assert checkpoint.restore(path, model)[2] is None


# ------------------------------------------------------------------ fixture

FIXTURE = (pathlib.Path(__file__).resolve().parents[1] / "tlsan_tpu_torch" / "tools"
           / "fixtures" / "jax_tlsan")
DATASET = "Tiny"
FIXTURE_TC = dict(optimizer="adam", learning_rate=0.01, train_batch_size=32,
                  test_batch_size=32, max_epochs=1, steps_per_call=PRE_STEPS,
                  eval_freq=10**9, best_after_step=0, tb_histograms=False,
                  sparse_updates=False)
FIXTURE_K = 10
FIXTURE_BYTES = 200_000


def write_migrate_fixture(out: pathlib.Path) -> None:
    """The migration fixture under `out`: Data/Tiny.npz (seeded SNAP dumps
    through the port's remap: 40 users, 30 items, 5 categories); a JAX
    TLSAN Trainer's --model_dir after PRE_STEPS Adam steps (model_dir/,
    relative paths in the sidecar); continue.npz, the next CONTINUE_STEPS
    batches' indices ("idx") into the packed train set, the JAX Trainer's
    parameters after them (dotted names) and its mean loss; topk.npz, the
    JAX Recommender's top-FIXTURE_K ("ids", "scores") for every test user
    of the category, as serve.cli forms them."""
    out.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(out)
    try:
        write_snap_fixture("snap", DATASET, users=40, items=30, cates=5, reviews=480,
                           seed=21)
        with gzip.open(f"snap/reviews_{DATASET}_5.json.gz", "rt") as f:
            reviews = f.readlines()
        with gzip.open(f"snap/meta_{DATASET}.json.gz", "rt") as f:
            meta = f.readlines()
        shutil.rmtree("snap")
        os.makedirs("Data", exist_ok=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the asin without meta
            remap.save_category(f"Data/{DATASET}.npz",
                                *remap.remap_ids(*remap.convert_raw_lines(reviews, meta)))
        prep = prepare("tlsan", f"Data/{DATASET}.npz", ModelConfig(model="tlsan"),
                       use_cache=False)
        jfields = {f.name for f in dataclasses.fields(JaxModelConfig)}
        jcfg = JaxModelConfig(**{k: v for k, v in dataclasses.asdict(prep.cfg).items()
                                 if k in jfields})
        jtr = JaxTrainer(jax_get_model("tlsan"), jcfg,
                         JaxTrainConfig(model_dir="model_dir", **FIXTURE_TC),
                         prep.cate_list, JaxBatches(dict(prep.train.arrays), prep.train.n),
                         JaxBatches(dict(prep.test.arrays), prep.test.n), use_pallas=False)
        idx = np.random.default_rng(22).integers(
            0, prep.train.n, (PRE_STEPS + CONTINUE_STEPS, 32)).astype(np.int64)
        jtr.params, jtr.opt_state, _ = jtr._train_chunk(jtr.params, jtr.opt_state,
                                                        idx[:PRE_STEPS])
        jtr.step = PRE_STEPS
        jtr._save(best=True)
        jtr.writer.close()
        for name in os.listdir("model_dir"):  # keep the checkpoint and its pointers
            if not name.startswith(("tlsan-", "latest", "best")):
                os.remove(os.path.join("model_dir", name))
        after, _, loss = jtr._train_chunk(jtr.params, jtr.opt_state, idx[PRE_STEPS:])
        np.savez("continue.npz", idx=idx[PRE_STEPS:], loss=np.float32(loss),
                 **{f"param.{k}": v for k, v in
                    _flatten(jax.tree_util.tree_map(np.asarray, after)).items()})
        batch = {k: v for k, v in prep.test.arrays.items() if k not in ("i", "j", "y")}
        ids, scores = JaxRecommender.from_model_dir(
            "model_dir", prep.cate_list, k=FIXTURE_K).recommend(batch)
        np.savez("topk.npz", ids=ids, scores=scores)
    finally:
        os.chdir(cwd)


def _files(root: pathlib.Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_migrate_fixture_is_current(tmp_path):
    """The committed fixture equals what write_migrate_fixture writes now:
    the same files; the category file and the indices exactly; the
    checkpoint's tree (step, parameters, optimizer state), the continued
    parameters and the top-k scores within 1e-6 (XLA's CPU sums may split
    otherwise on another host), the top-k ids exactly; the sidecar and
    pointers as text.  Under FIXTURE_BYTES in all."""
    write_migrate_fixture(tmp_path)
    assert _files(tmp_path) == _files(FIXTURE)
    assert sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file()) < FIXTURE_BYTES
    for rel in _files(FIXTURE):
        got, want = tmp_path / rel, FIXTURE / rel
        if rel.endswith(".ckpt"):
            a = _flatten(msgpack.loads(got.read_bytes()))
            b = _flatten(msgpack.loads(want.read_bytes()))
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7, err_msg=k)
        elif rel.endswith(".npz"):
            with np.load(got) as a, np.load(want) as b:
                assert sorted(a.files) == sorted(b.files), rel
                for k in b.files:
                    if np.issubdtype(b[k].dtype, np.floating) and rel != f"Data/{DATASET}.npz":
                        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7,
                                                   err_msg=f"{rel} {k}")
                    else:
                        assert np.array_equal(a[k], b[k]), f"{rel} {k}"
        else:
            assert got.read_text() == want.read_text(), rel


def test_migrate_fixture_resumes_and_serves_on_the_cpu(tmp_path, monkeypatch, capsys):
    """What the `migrate` phase of chip_smoke.py does on the card, on the
    CPU: the port's Trainer resumes a copy of the fixture's JAX --model_dir
    and its CONTINUE_STEPS steps give the JAX Trainer's parameters (Adam:
    1e-4, FWA's b2 to the walk bound); serve.cli on the fixture gives the
    JAX Recommender's top-k (scores printed to 4 decimals)."""
    monkeypatch.setenv("TLSAN_DATA_CACHE", "0")
    model_dir = tmp_path / "model_dir"
    shutil.copytree(FIXTURE / "model_dir", model_dir)
    prep = prepare("tlsan", str(FIXTURE / "Data" / f"{DATASET}.npz"),
                   ModelConfig(model="tlsan"))
    tr = Trainer(get_model("tlsan"), prep.cfg,
                 TrainConfig(model_dir=str(model_dir), from_scratch=False, **FIXTURE_TC),
                 prep.cate_list, prep.train, prep.test, device="cpu")
    assert tr.step == PRE_STEPS and tr.opt_state.count == PRE_STEPS
    with np.load(FIXTURE / "continue.npz") as c:
        loss = tr._train_chunk(torch.from_numpy(c["idx"])).mean()
        np.testing.assert_allclose(float(loss), float(c["loss"]), rtol=1e-5)
        got = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
        for k, v in got.items():
            want = c[f"param.{k}"]
            if k in ("long.0.b2", "short.0.b2"):
                assert np.abs(v - want).max() < ADAM_WALK_BOUND, k
            else:
                np.testing.assert_allclose(v, want, rtol=1e-4, atol=1e-4, err_msg=k)
    tr.close()
    out = tmp_path / "recs.jsonl"
    serve_cli.main(["--model_dir", str(FIXTURE / "model_dir"), "--dataset", DATASET,
                    "--data_dir", str(FIXTURE / "Data"), "--k", str(FIXTURE_K),
                    "--out", str(out), "--device", "cpu"])
    capsys.readouterr()
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    with np.load(FIXTURE / "topk.npz") as t:
        assert len(rows) == len(t["ids"])
        scores = np.array([r["scores"] for r in rows])
        np.testing.assert_allclose(scores, t["scores"], atol=1.5e-4)
        ids = np.array([r["items"] for r in rows])
        assert (ids == t["ids"]).mean() > 0.99  # exact ties may order differently


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    shutil.rmtree(FIXTURE, ignore_errors=True)
    write_migrate_fixture(FIXTURE)
    print(f"wrote {FIXTURE}: {_files(FIXTURE)}")
