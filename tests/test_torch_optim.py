"""The optimizers of the PyTorch port (train/state.py) against optax, on
the CPU: SGD, Adam, Adadelta and RMSProp, each chained after the global-norm
clip on the piecewise lr schedule, over 30 updates across lr_drop_step
with the clip active and inactive — parameters and every slot within rtol
1e-5, atol 1e-6 — and a Trainer chunk of each against the JAX Trainer's
from the same initial parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_sparse import ADAM_NOISE_LEAVES, ADAM_WALK_BOUND
from tests.test_torch_sparse import single_thread  # noqa: F401 (autouse)
from tests.test_torch_train import CFG, _tree_items
from tests.test_train import synthetic
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.models.tlsan import TLSAN as JaxTLSAN
from tlsan_tpu.train.loop import Trainer as JaxTrainer
from tlsan_tpu.train.state import make_optimizer as jax_make_optimizer
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.tools.params import params_from_numpy, params_to_numpy
from tlsan_tpu_torch.train import state
from tlsan_tpu_torch.train.loop import Trainer

OPTIMIZERS = ["sgd", "adam", "adadelta", "rmsprop"]
SHAPES = {"table": (30, 8), "w": (8, 8), "b": (8,), "gamma": ()}


def _optax_slots(name, jstate):
    """The optax state's per-parameter slots by the port's slot names."""
    inner = jstate[1]  # chain(clip, opt): opt's own chain state
    if name == "adam":
        return {"mu": inner[0].mu, "nu": inner[0].nu}
    if name == "adadelta":  # chain(add_decayed_weights, adadelta, schedule)
        return {"e_g": inner[1].e_g, "e_x": inner[1].e_x}
    if name == "rmsprop":
        return {"nu": inner[0].nu}
    return {}


@pytest.mark.parametrize("max_norm", [5.0, 1e4])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, max_norm):
    """30 updates across lr_drop_step (15) of gradients whose global norm
    spans ~0.5 to ~25: with max_norm 5 the clip fires on some steps, with
    1e4 on none; parameters and slots stay within rtol 1e-5, atol 1e-6."""
    kw = dict(optimizer=name, learning_rate=0.05, max_gradient_norm=max_norm,
              lr_drop_step=15)
    jopt, opt = jax_make_optimizer(JaxTrainConfig(**kw)), state.make_optimizer(TrainConfig(**kw))
    assert opt.name == name
    rng = np.random.default_rng(7)
    init = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in SHAPES.items()}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in SHAPES]
    st = opt.init(params)
    assert set(st.slots) == set(_optax_slots(name, jstate))
    clipped = 0
    for step in range(30):
        scale = 0.02 * np.exp(rng.uniform(0.0, 4.0))
        grads = {k: np.asarray(rng.normal(size=s) * scale, np.float32)
                 for k, s in SHAPES.items()}
        clipped += np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                               for g in grads.values())) > max_norm
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(params, SHAPES):
            p.grad = torch.from_numpy(grads[k])
        st = opt.step(params, st)
        assert st.count == step + 1
        for i, k in enumerate(SHAPES):
            np.testing.assert_allclose(params[i].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{step} {k}")
            for slot, tree in _optax_slots(name, jstate).items():
                np.testing.assert_allclose(st.slots[slot][i].numpy(), np.asarray(tree[k]),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{step} {slot} {k}")
    assert (clipped > 3) == (max_norm == 5.0), clipped


def test_optimizer_schedule_and_defaults():
    """optax's defaults and the differences from torch's optimizers that
    ROADMAP item 24 lists: the clip's divisor, rmsprop's decay 0.9 with eps
    inside the root, the lr drop at count == lr_drop_step."""
    tc = TrainConfig(learning_rate=2.0, lr_drop_step=10)
    sched = state.lr_schedule(tc)
    assert sched(9) == 2.0 and sched(10) == float(np.float32(0.1) * np.float32(2.0))
    assert (state.Adam.b1, state.Adam.b2, state.Adam.eps) == (0.9, 0.999, 1e-8)
    assert (state.Adadelta.rho, state.Adadelta.eps) == (0.9, 1e-6)
    assert (state.RMSProp.decay, state.RMSProp.eps) == (0.9, 1e-8)
    p = torch.nn.Parameter(torch.tensor([1.0]))
    p.grad = torch.tensor([0.5])
    opt = state.make_optimizer(TrainConfig(optimizer="rmsprop", learning_rate=1.0))
    opt.step([p], opt.init([p]))
    # ν = 0.1·0.25; step = g / √(ν + eps)
    want = 1.0 - 0.5 / np.sqrt(np.float32(0.1) * np.float32(0.25) + np.float32(1e-8))
    np.testing.assert_allclose(float(p), want, rtol=1e-6)
    with pytest.raises(ValueError, match="optimizer"):
        state.make_optimizer(TrainConfig(optimizer="lamb"))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_trainer_chunk_matches_jax_trainer(tmp_path, name):
    """One 8-step chunk of the port's Trainer (dense step) with each
    optimizer against the JAX Trainer's from the same initial parameters:
    losses within 1e-5 relative, parameters within 1e-4 (under Adam,
    FWA's b2, whose exact gradient is 0, to the walk bound: see
    tests/test_torch_sparse.py)."""
    train, test, cate_list = synthetic()
    kw = dict(max_epochs=1, train_batch_size=32, test_batch_size=64,
              steps_per_call=8, eval_freq=10**9, best_after_step=0,
              optimizer=name, learning_rate=0.5 if name == "sgd" else 0.01,
              lr_drop_step=4, tb_histograms=False, sparse_updates=False)
    jtr = JaxTrainer(JaxTLSAN, JaxModelConfig(**CFG),
                     JaxTrainConfig(model_dir=str(tmp_path / "jax"), **kw),
                     cate_list, train, test, use_pallas=False)
    tr = Trainer(TLSAN, ModelConfig(**CFG), TrainConfig(model_dir=str(tmp_path / "t"), **kw),
                 cate_list, train, test, device="cpu")
    tr.model.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.params), ModelConfig(**CFG), "cpu").state_dict())
    idx = tr._epoch_index(0)[0]
    jparams, _, jloss = jtr._train_chunk(jtr.params, jtr.opt_state, idx)
    losses = tr._train_chunk(torch.from_numpy(idx))
    np.testing.assert_allclose(float(losses.mean()), float(jloss), rtol=1e-5)
    got = dict(_tree_items(params_to_numpy(tr.model)))
    want = dict(_tree_items(jax.tree_util.tree_map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    noise = ADAM_NOISE_LEAVES["tlsan"] if name == "adam" else ()
    for leaf, w in want.items():
        if leaf in noise:
            assert np.abs(got[leaf] - w).max() < ADAM_WALK_BOUND, leaf
        else:
            np.testing.assert_allclose(got[leaf], w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} {leaf}")
    assert tr.opt_state.count == 8
