"""The replica fan-out (train/ensemble.py) of the seven baseline families
(SHAN, PACA, BPR-MF, LSPM, CNN, Bi-LSTM, CSAN) against the JAX package's
fan-out, on the CPU: one chunk of `_fan_chunk` at R = 2 from the same
stacked init, at the sizes of tests/test_torch_families.py, with the data
of tests/test_torch_family_paths.py.  A file of its own, so that
``--dist loadfile`` spreads the JAX compiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_family_paths import FAMILIES, cfg_kw, family_data
from tests.test_torch_sparse import single_thread  # noqa: F401 (autouse)
from tests.test_torch_train import _tree_items
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.models import get_model as jax_get_model
from tlsan_tpu.train.ensemble import ReplicaFanout as JaxReplicaFanout
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.tools.params import stacked_from_numpy, stacked_to_numpy
from tlsan_tpu_torch.train.ensemble import ReplicaFanout
from tlsan_tpu_torch.train.loop import Trainer

TOL = 1e-5  # tests/test_torch_families.py
# lr 0.1, as the baselines' parity runs take it (chip_smoke.py's
# MESH_BASE_LR): at 0.5 a unit of CNN's that sits within f32 rounding of its
# kink flips within four steps between the JAX CNN and the port's, and the
# two trajectories part by 3.5e-4 (the port's fan-out and its Trainer stay
# equal there)
TRAIN_KW = dict(max_epochs=1, train_batch_size=32, test_batch_size=16,
                steps_per_call=4, eval_freq=4, best_after_step=0,
                learning_rate=0.1)


@pytest.mark.parametrize("name", FAMILIES)
def test_fan_chunk_matches_jax(tmp_path, name):
    """One 4-step chunk of the port's fan-out at R = 2 (seeds 1234 and 42,
    each with its own shuffle stream) against the JAX fan-out's from the
    same stacked init: the per-replica chunk losses and every leaf of both
    replicas within 1e-5; the per-replica AUC within one test user; and
    each replica against a port Trainer at its seed from its slice of the
    init, within 1e-5."""
    jtrain, jtest, train, test, cate_list = family_data(name, n_train=128)
    seeds = [1234, 42]
    jfan = JaxReplicaFanout(jax_get_model(name), JaxModelConfig(**cfg_kw(name)),
                            JaxTrainConfig(**TRAIN_KW), cate_list, jtrain, jtest, seeds)
    fan = ReplicaFanout(get_model(name), ModelConfig(**cfg_kw(name)),
                        TrainConfig(**TRAIN_KW), cate_list, train, test, seeds,
                        device="cpu")
    stacked = stacked_from_numpy(jax.tree_util.tree_map(np.asarray, jfan.params),
                                 ModelConfig(**cfg_kw(name)), 2, "cpu")
    with torch.no_grad():
        for n, t in stacked.items():
            fan.params[n].copy_(t)
    (chunk_idx,) = fan._epoch_index(0)
    assert chunk_idx.shape == (2, 4, 32)
    inits = {n: p.detach().clone() for n, p in fan.params.items()}
    jfan.params, jfan.opt_state, jfan._rngs, want = jfan._fan_chunk(
        jfan.params, jfan.opt_state, jnp.asarray(chunk_idx), jfan._rngs,
        jfan.lr_scales, jfan.data)
    got = fan._fan_chunk(torch.from_numpy(chunk_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert not np.allclose(got[0].item(), got[1].item())  # two replicas
    got_tree = dict(_tree_items(stacked_to_numpy(fan.params)))
    want_tree = dict(_tree_items(jax.tree_util.tree_map(np.asarray, jfan.params)))
    assert got_tree.keys() == want_tree.keys()
    for leaf, w in want_tree.items():
        assert got_tree[leaf].shape[0] == 2
        np.testing.assert_allclose(got_tree[leaf], w, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {leaf}")
    np.testing.assert_allclose(fan.auc(), np.asarray(jfan.auc()),
                               atol=1.0 / test.n + 1e-9)
    for r, seed in enumerate(seeds):
        tr = Trainer(get_model(name), ModelConfig(**cfg_kw(name)), TrainConfig(
            **TRAIN_KW, seed=seed, tb_histograms=False, model_dir=str(tmp_path / str(seed))),
            cate_list, train, test, device="cpu")
        tr.model.load_state_dict({n: p[r] for n, p in inits.items()})
        loss = tr._train_chunk(torch.from_numpy(chunk_idx[r])).mean()
        np.testing.assert_allclose(got[r].item(), loss.item(), rtol=TOL, atol=TOL)
        for n, p in tr.model.named_parameters():
            np.testing.assert_allclose(fan.params[n][r].detach().numpy(),
                                       p.detach().numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} seed {seed} {n}")
        tr.close()
