"""Touched-row (sparse) updates in the PyTorch port, on the CPU: the
sparse step against the port's dense step for all nine families with SGD
and Adam (the bounds of tests/test_sparse.py:101-106, :136-140), against
the JAX package's sparse Trainer for TLSAN, ATRank and LSPM, with the
clip active, the auto gate, the unique buffer, `profile_trace`, and
checkpoints that resume bit for bit and cross between the sparse and the
dense step.  Data is numpy-seeded (tests/test_train.py's synthetic(),
tests/test_torch_atrank.py's and tests/test_torch_family_paths.py's
packed sets); parameters cross over through tools/params.py."""


import jax
import numpy as np
import pytest
import torch

from tests.test_torch_atrank import CFG as ATRANK_CFG
from tests.test_torch_atrank import _cate_list as atrank_cate_list
from tests.test_torch_atrank import _train_data as atrank_train_data
from tests.test_torch_family_paths import cfg_kw, family_data
from tests.test_torch_train import CFG as TLSAN_CFG
from tests.test_train import synthetic
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.models import get_model as jax_get_model
from tlsan_tpu.train import sparse as jax_sparse
from tlsan_tpu.train.loop import Trainer as JaxTrainer
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.tools.params import params_from_numpy
from tlsan_tpu_torch.train import sparse
from tlsan_tpu_torch.train.loop import Trainer

ALL_MODELS = ["tlsan", "atrank", "shan", "csan", "lspm", "paca", "cnn",
              "bilstm", "bpr"]
B, STEPS = 8, 30
# Leaves whose gradient is exactly 0 in exact arithmetic: FWA's b2 shifts
# every time step's score of a (row, head, feature) alike, and the
# softmax over time cancels it.  Their computed gradient is f32 rounding
# noise (~1e-10, far below Adam's eps), so Adam's update there is
# sign-like and walks apart between any two programs that round
# differently (tests/test_sparse.py:124-128 describes the same leaves).
# Their moments are held as tightly as every leaf's; the parameters to
# the walk bound of tests/test_sparse.py:305-307.
ADAM_NOISE_LEAVES = {"tlsan": ("long.0.b2", "short.0.b2")}
ADAM_WALK_BOUND = 1e-1


@pytest.fixture(autouse=True)
def single_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's default of one thread a core oversubscribes them
    (a 30-step chunk then takes minutes instead of a second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family(name, n_train=128, n_test=40):
    """(port config kwargs, JAX train, JAX test, port train, port test,
    cate_list) of one family's seeded packed set."""
    if name == "tlsan":
        train, test, cate_list = synthetic(n=n_train)
        return dict(TLSAN_CFG), train, test, train, test, cate_list
    if name == "atrank":
        jtrain, jtest = atrank_train_data(n_train, n_test, seed=12)
        return (dict(ATRANK_CFG), jtrain, jtest,
                Batches(dict(jtrain.arrays), jtrain.n),
                Batches(dict(jtest.arrays), jtest.n), atrank_cate_list())
    jtrain, jtest, train, test, cate_list = family_data(name, n_train, n_test)
    return cfg_kw(name), jtrain, jtest, train, test, cate_list


def _tc(tmp_path, tag, **over):
    kw = dict(model_dir=str(tmp_path / tag), max_epochs=1, train_batch_size=B,
              test_batch_size=16, steps_per_call=STEPS, eval_freq=10**9,
              best_after_step=0, lr_drop_step=20, save_auc_gate=0.0,
              tb_histograms=False)
    kw.update(over)
    return TrainConfig(**kw)


def _one_chunk(name, tc, seed=3, init=None, steps=STEPS):
    """A Trainer of the family on `tc` from `init` (a state dict) or its
    seed takes one chunk of `steps` seeded batches on the CPU: (trainer,
    the chunk's losses)."""
    kw, _, _, train, test, cate_list = family(name)
    tr = Trainer(get_model(name), ModelConfig(**kw), tc, cate_list, train, test,
                 device="cpu")
    if init is not None:
        tr.model.load_state_dict(init)
    idx = np.random.default_rng(seed).integers(0, train.n, (steps, B))
    return tr, tr._train_chunk(torch.from_numpy(idx))


def _assert_close(got, want, rtol, atol, what=""):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {name}")


def _slots(tr, slot):
    return dict(zip(tr._names, tr.opt_state.slots[slot]))


def _assert_adam_params_close(name, got, want):
    """Adam's parameters to the bounds of tests/test_sparse.py:130-134
    (rtol 2e-3, atol 2e-3), the noise leaves to the walk bound."""
    noise = ADAM_NOISE_LEAVES.get(name, ())
    _assert_close(got, {k: v for k, v in want.items() if k not in noise},
                  2e-3, 2e-3, f"{name} params")
    for k in noise:
        assert float((got[k] - want[k]).abs().max()) < ADAM_WALK_BOUND, k


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("name", ALL_MODELS)
def test_sparse_matches_dense(tmp_path, name, optimizer):
    """The touched-row step against the port's dense step over 30 steps
    across the lr drop: SGD params within rtol 2e-3 / atol 2e-5 and the
    mean loss (with the untouched rows' L2 mass) within 1e-3; Adam params
    within atol 2e-3 (near-zero-grad biases walk), its moments mu within
    2e-6 and nu within 2e-8 (tests/test_sparse.py:136-140)."""
    lr = 1.0 if optimizer == "sgd" else 0.01
    dense, l_dense = _one_chunk(name, _tc(tmp_path, "d", optimizer=optimizer,
                                          learning_rate=lr, sparse_updates=False))
    sp, l_sparse = _one_chunk(name, _tc(tmp_path, "s", optimizer=optimizer,
                                        learning_rate=lr, sparse_updates=True))
    assert sp._use_sparse and not dense._use_sparse
    assert sp.opt_state.count == dense.opt_state.count == STEPS
    want = dict(dense.model.named_parameters())
    got = dict(sp.model.named_parameters())
    if optimizer == "sgd":
        _assert_close(got, want, 2e-3, 2e-5, name)
    else:
        _assert_adam_params_close(name, got, want)
        _assert_close(_slots(sp, "mu"), _slots(dense, "mu"), 2e-3, 2e-6, f"{name} mu")
        _assert_close(_slots(sp, "nu"), _slots(dense, "nu"), 2e-3, 2e-8, f"{name} nu")
    np.testing.assert_allclose(float(l_sparse.mean()), float(l_dense.mean()),
                               rtol=1e-3)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("name", ["tlsan", "atrank", "lspm"])
def test_sparse_matches_jax_sparse_trainer(tmp_path, name, optimizer):
    """The port's touched-row chunk against the JAX package's
    Trainer(sparse_updates=True, use_pallas=False) from the same initial
    parameters, to the bounds of test_sparse_matches_dense."""
    kw, jtrain, jtest, _, _, cate_list = family(name)
    lr = 1.0 if optimizer == "sgd" else 0.01
    common = dict(max_epochs=1, train_batch_size=B, test_batch_size=16,
                  steps_per_call=STEPS, eval_freq=10**9, best_after_step=0,
                  lr_drop_step=20, optimizer=optimizer, learning_rate=lr,
                  sparse_updates=True, tb_histograms=False)
    jtr = JaxTrainer(jax_get_model(name), JaxModelConfig(**kw),
                     JaxTrainConfig(model_dir=str(tmp_path / "jax"), **common),
                     cate_list, jtrain, jtest, use_pallas=False)
    assert jtr._use_sparse
    idx = np.random.default_rng(3).integers(0, jtrain.n, (STEPS, B)).astype(np.int32)
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params),
                             ModelConfig(**kw), "cpu").state_dict()
    jparams, jstate, jloss = jtr._train_chunk(jtr.params, jtr.opt_state, idx)
    tr, losses = _one_chunk(name, _tc(tmp_path, "torch", **{
        k: v for k, v in common.items() if k != "max_epochs"}), init=init)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             ModelConfig(**kw), "cpu")
    got = dict(tr.model.named_parameters())
    if optimizer == "sgd":
        _assert_close(got, dict(want.named_parameters()), 2e-3, 2e-5, name)
    else:
        _assert_adam_params_close(name, got, dict(want.named_parameters()))
        adam = jax_sparse.find_adam_state(jstate)
        for slot, st, atol in (("mu", adam.mu, 2e-6), ("nu", adam.nu, 2e-8)):
            moment = params_from_numpy(jax.tree_util.tree_map(np.asarray, st),
                                       ModelConfig(**kw), "cpu")
            _assert_close(_slots(tr, slot), dict(moment.named_parameters()),
                          2e-3, atol, f"{name} {slot}")
    np.testing.assert_allclose(float(losses.mean()), float(jloss), rtol=1e-3)


def test_sparse_clip_active(tmp_path):
    """The global-norm clip fires on every step of both paths alike: the
    untouched rows' analytic L2 part enters the norm
    (tests/test_sparse.py:146-158)."""
    over = dict(max_gradient_norm=0.05, steps_per_call=5)
    dense, _ = _one_chunk("tlsan", _tc(tmp_path, "d", sparse_updates=False, **over),
                          steps=5)
    sp, _ = _one_chunk("tlsan", _tc(tmp_path, "s", sparse_updates=True, **over),
                       steps=5)
    _assert_close(dict(sp.model.named_parameters()),
                  dict(dense.model.named_parameters()), 2e-4, 2e-6)


@pytest.mark.parametrize("optimizer,batch,forced,rows_gate,engaged", [
    ("sgd", 32, None, 1, True),
    ("sgd", 512, None, 1, True),
    ("adam", 32, None, 1, True),
    ("adam", 512, None, 1, False),        # the measured Adam exception
    ("adam", 512, True, 1, True),         # forcing wins over the gate
    ("sgd", 32, None, 10**9, False),      # below the row threshold
    ("sgd", 32, False, 1, False),
    ("adadelta", 32, True, 1, False),     # only sgd and adam have a sparse step
])
def test_auto_gate_engages_where_jax_does(tmp_path, optimizer, batch, forced,
                                          rows_gate, engaged):
    """With sparse_updates None the port engages the sparse step exactly
    where the JAX Trainer does: at sparse_auto_rows vocab rows or more,
    not for Adam at batch > 128 (tests/test_sparse.py:318-348)."""
    train, test, cate_list = synthetic()
    kw = dict(optimizer=optimizer, learning_rate=0.01, train_batch_size=batch,
              test_batch_size=64, sparse_updates=forced, sparse_auto_rows=rows_gate,
              steps_per_call=2, max_epochs=1, eval_freq=10**9)
    jtr = JaxTrainer(jax_get_model("tlsan"), JaxModelConfig(**TLSAN_CFG),
                     JaxTrainConfig(model_dir=str(tmp_path / "j"), **kw),
                     cate_list, train, test, use_pallas=False)
    tr = Trainer(get_model("tlsan"), ModelConfig(**TLSAN_CFG),
                 TrainConfig(model_dir=str(tmp_path / "t"), **kw), cate_list,
                 train, test, device="cpu")
    assert tr._use_sparse == bool(jtr._use_sparse) == engaged


def test_unique_padded_is_sorted_unique_with_sentinels():
    rng = np.random.default_rng(0)
    for n, high, size in ((50, 7, 60), (64, 1000, 64), (1, 3, 4)):
        ids = rng.integers(0, high, n)
        got = sparse.unique_padded(torch.from_numpy(ids), size, high).numpy()
        u = np.unique(ids)
        assert got.shape == (size,)
        np.testing.assert_array_equal(got[:len(u)], u)
        assert (got[len(u):] == high).all()


@pytest.mark.parametrize("use_sparse", [False, True])
def test_profile_trace_leaves_train_unchanged(tmp_path, use_sparse):
    """profile_trace runs on copies and puts the dropout generator back:
    a train() after it equals one without it bit for bit (dropout on, so
    the generator matters), and it writes its trace."""
    train, test, cate_list = synthetic()
    cfg = ModelConfig(**TLSAN_CFG, dropout=0.3)
    runs = []
    for tag in ("plain", "profiled"):
        tc = TrainConfig(model_dir=str(tmp_path / tag), max_epochs=1,
                         train_batch_size=32, test_batch_size=64,
                         steps_per_call=4, eval_freq=10**9, best_after_step=0,
                         learning_rate=0.5, save_auc_gate=0.0,
                         sparse_updates=use_sparse, tb_histograms=False)
        tr = Trainer(get_model("tlsan"), cfg, tc, cate_list, train, test,
                     device="cpu")
        if tag == "profiled":
            out = tr.profile_trace(n_chunks=2)
            assert (tmp_path / tag / "profile" / "trace.json").exists()
            assert out == str(tmp_path / tag / "profile")
            assert tr.opt_state.count == 0
        best = tr.train()
        runs.append((best, {k: v.clone() for k, v in tr.model.state_dict().items()}))
        tr.close()
    assert runs[0][0] == runs[1][0]
    for name, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][name]), name


def _trainer(tmp_path, tag, **over):
    train, test, cate_list = synthetic()
    kw = dict(model_dir=str(tmp_path / tag), max_epochs=1, train_batch_size=32,
              test_batch_size=64, steps_per_call=4, eval_freq=10**9,
              best_after_step=0, learning_rate=0.5, save_auc_gate=0.0,
              tb_histograms=False)
    kw.update(over)
    return Trainer(get_model("tlsan"), ModelConfig(**TLSAN_CFG), TrainConfig(**kw),
                   cate_list, train, test, device="cpu")


@pytest.mark.parametrize("optimizer,use_sparse", [("adam", False), ("adam", True),
                                                  ("sgd", True), ("rmsprop", False),
                                                  ("adadelta", False)])
def test_resume_is_bit_exact(tmp_path, optimizer, use_sparse):
    """A save restores step, count, parameters and every slot bit for bit,
    and the next chunk from the restore equals the next chunk of the
    Trainer that saved."""
    over = dict(optimizer=optimizer, sparse_updates=use_sparse,
                learning_rate=0.01 if optimizer != "sgd" else 0.5)
    tr = _trainer(tmp_path, "r", **over)
    tr.train()
    tr2 = _trainer(tmp_path, "r", from_scratch=False, **over)
    assert tr2.step == tr.step == tr2.opt_state.count == tr.opt_state.count == 8
    for a, b in zip(tr.model.state_dict().values(), tr2.model.state_dict().values()):
        assert torch.equal(a, b)
    for slot in tr.opt_state.slots:
        for a, b in zip(tr.opt_state.slots[slot], tr2.opt_state.slots[slot]):
            assert torch.equal(a, b), slot
    idx = torch.from_numpy(tr._epoch_index(1)[0])
    assert torch.equal(tr._train_chunk(idx), tr2._train_chunk(idx))
    for a, b in zip(tr.model.state_dict().values(), tr2.model.state_dict().values()):
        assert torch.equal(a, b)
    tr.close()
    tr2.close()


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_sparse_save_restores_into_the_dense_step_and_back(tmp_path, optimizer):
    """A sparse run's save (count = step; Adam's moments as the dense step
    keeps them) restores into a dense Trainer, whose next chunk agrees with
    the sparse Trainer's own next chunk to the parity bounds; a dense save
    restores into the sparse step likewise."""
    lr = 0.5 if optimizer == "sgd" else 0.01
    for first, second in ((True, False), (False, True)):
        tag = f"{first}"
        a = _trainer(tmp_path, tag, optimizer=optimizer, learning_rate=lr,
                     sparse_updates=first)
        a.train()
        b = _trainer(tmp_path, tag, optimizer=optimizer, learning_rate=lr,
                     sparse_updates=second, from_scratch=False)
        assert b._use_sparse == second and b.opt_state.count == b.step == a.step
        idx = torch.from_numpy(a._epoch_index(1)[0])
        la, lb = a._train_chunk(idx), b._train_chunk(idx)
        np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=1e-3)
        _assert_close(dict(b.model.named_parameters()),
                      dict(a.model.named_parameters()), 2e-3,
                      2e-5 if optimizer == "sgd" else 2e-3)
        a.close()
        b.close()


def test_sparse_step_refuses_other_optimizers(tmp_path):
    tr = _trainer(tmp_path, "x", optimizer="rmsprop", sparse_updates=True)
    assert not tr._use_sparse  # the gate keeps rmsprop dense, as JAX's does
    with pytest.raises(ValueError, match="sgd or adam"):
        sparse.SparseStep(tr.model, tr.tc, tr.train_data, tr.opt)


def test_build_spaces_matches_jax():
    """The id spaces, their keys, tables, K and sentinels, as the JAX
    package builds them, for every family."""
    for name in ALL_MODELS:
        kw, jtrain, _, train, _, _ = family(name)
        jparams = jax_get_model(name).init_params(jax.random.PRNGKey(0),
                                                  JaxModelConfig(**kw))
        model = get_model(name)(ModelConfig(**kw), "cpu")
        want = jax_sparse.build_spaces(jparams, jtrain.arrays, B)
        got = sparse.build_spaces(dict(model.named_parameters()), train.arrays, B)
        assert [(s.keys, s.tables, s.size, s.vocab) for s in got] == \
            [(s.keys, s.tables, s.size, s.vocab) for s in want], name
