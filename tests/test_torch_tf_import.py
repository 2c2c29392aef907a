"""The port's TF migration tools (tlsan_tpu_torch/tools/tf_import.py and
tf_export.py) against the JAX package's (tlsan_tpu/tools/), on the CPU.

For all nine families at tiny sizes (tests/test_tf_import.py's), with the
same parameters carried across: the port's `to_tf_vars` equals the JAX
one bit for bit, and the port's `to_params` of the JAX variables gives
the JAX tree back.  Through real ``tf.train.Saver`` checkpoints written
here: the JAX tool's checkpoint imports in the port, and the port's in the
JAX tool, to the identical tree.  The strictness cases raise as the JAX
tool's do.  The command lines: the port's `tf_import.main` writes a port
checkpoint that `Recommender.from_model_dir` serves as the JAX import
serves; `tf_export.main` exports from a port --model_dir and from a JAX
one.  TensorFlow is installed here and not on the card's machine, so the
TF-backed tests call ``pytest.importorskip("tensorflow")``.  No reference
checkpoint is in the repository: every checkpoint is written in the test.
"""

import jax
import numpy as np
import pytest

from tests.test_train import synthetic
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.models import get_model as jax_get_model
from tlsan_tpu.serve.recommender import Recommender as JaxRecommender
from tlsan_tpu.tools import tf_import as jax_tf
from tlsan_tpu.train import checkpoint as jax_checkpoint
from tlsan_tpu.train.state import make_optimizer as jax_make_optimizer
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.tools import tf_export, tf_import
from tlsan_tpu_torch.tools.params import _flatten, params_from_numpy
from tlsan_tpu_torch.train import checkpoint
from tlsan_tpu_torch.train.state import make_optimizer

FAMILIES = ["tlsan", "atrank", "shan", "bpr", "lspm", "paca", "cnn", "bilstm", "csan"]


def _tiny(model_name, seed=0):
    """tests/test_tf_import.py's tiny configuration and the JAX init."""
    kw = dict(model=model_name, user_count=5, item_count=7, cate_count=3)
    params = jax_get_model(model_name).init_params(jax.random.PRNGKey(seed),
                                                   JaxModelConfig(**kw))
    return jax.tree_util.tree_map(np.asarray, params), kw


def _same_tree(got, want):
    a, b = _flatten(got), _flatten(want)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("model_name", FAMILIES)
def test_maps_equal_the_jax_tools(model_name):
    """to_tf_vars bit for bit (names, dtypes, values), to_params both ways
    to the JAX tree, the same config hints, and validate_tree against the
    port model accepts it."""
    params, _ = _tiny(model_name, seed=FAMILIES.index(model_name))
    want = jax_tf.to_tf_vars(model_name, params)
    got = tf_import.to_tf_vars(model_name, params)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    back, hints = tf_import.to_params(model_name, want)
    jback, jhints = jax_tf.to_params(model_name, want)
    assert hints == jhints
    _same_tree(back, jback)
    _same_tree(back, params)
    tf_import.validate_tree(model_name, back, hints)
    # the port's model holds the tree (its state_dict's names and shapes)
    model = params_from_numpy(back, tf_import._model_config(model_name, hints), "cpu")
    assert set(model.state_dict()) == set(_flatten(back))


def test_strictness_matches_the_jax_tool():
    """An unconsumed variable, a missing one and a wrong family raise as in
    tests/test_tf_import.py; a transposed map fails validate_tree."""
    params, _ = _tiny("shan")
    tf_vars = tf_import.to_tf_vars("shan", params)
    extra = dict(tf_vars, **{"mystery_tower/W": np.zeros((2, 2), np.float32)})
    with pytest.raises(SystemExit, match="NOT.*consumed"):
        tf_import.to_params("shan", extra)
    missing = dict(tf_vars)
    del missing["layer2_w"]
    with pytest.raises(KeyError, match="layer2_w"):
        tf_import.to_params("shan", missing)
    lspm, _ = _tiny("lspm")
    with pytest.raises(KeyError):
        tf_import.to_params("shan", tf_import.to_tf_vars("lspm", lspm))
    back, hints = tf_import.to_params("shan", tf_vars)
    back["layer1_w"] = back["layer1_w"][:, :-1]
    with pytest.raises(SystemExit, match="shape mismatch at layer1_w"):
        tf_import.validate_tree("shan", back, hints)
    with pytest.raises(KeyError, match="unknown model"):
        tf_import.to_tf_vars("gru", params)


@pytest.mark.parametrize("model_name", ["tlsan", "atrank", "cnn"])
def test_saver_round_trips_both_ways(tmp_path, model_name):
    """The JAX tool's Saver checkpoint (with an Adam slot variable, as a
    reference checkpoint carries) read by the port gives the JAX tree and
    step; the port's Saver checkpoint read by the JAX tool gives the same."""
    pytest.importorskip("tensorflow")
    params, _ = _tiny(model_name, seed=3)
    tf_vars = jax_tf.to_tf_vars(model_name, params)
    with_slots = dict(tf_vars, **{"item_emb_w/Adam" if model_name != "tlsan"
                                  else "item_emb/Adam": np.zeros((7, 32), np.float32)})
    prefix = jax_tf.write_tf_checkpoint(str(tmp_path / "jax" / model_name), with_slots,
                                        step=41, epoch=2)
    got, step = tf_import.read_tf_checkpoint(prefix)
    assert step == 41 and set(got) == set(tf_vars)
    _same_tree(tf_import.to_params(model_name, got)[0], params)
    prefix = tf_import.write_tf_checkpoint(str(tmp_path / "port" / model_name),
                                           tf_import.to_tf_vars(model_name, params),
                                           step=17)
    got, step = jax_tf.read_tf_checkpoint(prefix)
    assert step == 17
    _same_tree(jax_tf.to_params(model_name, got)[0], params)


def test_import_cli_serves_as_the_jax_import(tmp_path):
    """tf_import.main of a TLSAN Saver checkpoint (both tools' commands on
    the same file): the port's model_dir holds a torch.save checkpoint and
    sidecar with a fresh Adam state at the checkpoint's step, and its
    Recommender gives the JAX import's top-k and scores within 1e-5."""
    pytest.importorskip("tensorflow")
    train, test, cate_list = synthetic(users=20, items=30, cates=5)
    kw = dict(model="tlsan", user_count=20, item_count=30, cate_count=5, Ts=8)
    params = jax.tree_util.tree_map(np.asarray, jax_get_model("tlsan").init_params(
        jax.random.PRNGKey(9), JaxModelConfig(**kw)))
    prefix = jax_tf.write_tf_checkpoint(str(tmp_path / "tf" / "tlsan"),
                                        jax_tf.to_tf_vars("tlsan", params), step=23)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_tf.main(["--model", "tlsan", "--ckpt", prefix, "--out", jax_dir])
    path = tf_import.main(["--model", "tlsan", "--ckpt", prefix, "--out", port_dir,
                           "--optimizer", "adam"])
    assert path.endswith("tlsan-23.ckpt") and checkpoint.checkpoint_format(path) == "torch"
    model = get_model("tlsan")(ModelConfig(**kw), "cpu")
    step, _, opt_state = checkpoint.restore(path, model)
    assert step == 23 and opt_state["count"] == 0
    assert set(opt_state["slots"]) == {"mu", "nu"}
    requests = {k: v[:50] for k, v in test.arrays.items() if k not in ("i", "j", "y")}
    want_ids, want_sc = JaxRecommender.from_model_dir(jax_dir, cate_list, k=10).recommend(
        requests)
    ids, sc = Recommender.from_model_dir(port_dir, cate_list, device="cpu",
                                         k=10).recommend(requests)
    np.testing.assert_allclose(sc, want_sc, rtol=1e-5, atol=1e-5)
    assert (ids == want_ids).mean() > 0.99  # exact ties may order differently


@pytest.mark.parametrize("source", ["port", "jax"])
def test_export_cli_from_a_port_or_jax_model_dir(tmp_path, source):
    """tf_export.main from a port --model_dir (torch.save) and from a JAX
    one (flax msgpack, read by the port's own decoder): the TF checkpoint
    holds the model's variables and step, as the JAX tool reads them."""
    pytest.importorskip("tensorflow")
    params, kw = _tiny("tlsan", seed=11)
    mdir = str(tmp_path / "mdir")
    if source == "jax":
        jax_checkpoint.save(mdir, "tlsan", 29, params,
                            jax_make_optimizer(JaxTrainConfig()).init(params),
                            JaxModelConfig(**kw), best=True)
    else:
        model = params_from_numpy(params, ModelConfig(**kw), "cpu")
        names = [n for n, _ in model.named_parameters()]
        state = make_optimizer(TrainConfig()).init(list(model.parameters())).to_dict(names)
        checkpoint.save(mdir, "tlsan", 29, model, state, ModelConfig(**kw), best=True)
    assert checkpoint.checkpoint_format(checkpoint.best_checkpoint(mdir)) == source.replace(
        "port", "torch")
    prefix = tf_export.main(["--model", "tlsan", "--ckpt", mdir,
                             "--out", str(tmp_path / "tf" / "tlsan")])
    got, step = jax_tf.read_tf_checkpoint(prefix)
    assert step == 29
    back, hints = jax_tf.to_params("tlsan", got)
    _same_tree(back, params)
    assert hints["Ls"] == kw.get("Ls", 10) and hints["num_blocks"] == 1
