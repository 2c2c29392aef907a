"""Touched-row updates on the port's (dp, mp) mesh against one process, on
the CPU.

One world of four spawned ranks over Gloo (dp=2, mp=2) runs the JAX
package's three production legs (`parallel/programs.py::PRODUCTION_LEGS`,
after __graft_entry__.py:253-256): TLSAN with sparse SGD in bf16, ATRank
with sparse Adam in bf16, LSPM with sparse SGD in f32 — each a fresh
Trainer from the seed taking one chunk, evaluating and saving — and the
same families' sparse legs in f32, and TLSAN's dense Adam, whose slots
are row-sharded with the tables.  Catalog sizes are not multiples of mp,
so the tables pad.  One process runs each on the CPU; the mesh must equal
it as tests/test_sparse.py:200-206 holds the JAX mesh: loss within rtol
1e-3, every unpadded parameter within rtol 2e-3 and atol 2e-5 (SGD) or
2e-3 (Adam; FWA's b2 to the walk bound), Adam's moments as tightly as
tests/test_torch_sparse.py holds them.  A bf16 leg runs its dense maps on
half the rows a rank, and bf16 rounds a product that differs in its last
f32 bit to another value now and then, so the bf16 legs are held to the
bf16 bounds of tests/test_sparse.py:271-274 (rtol 2e-2, atol 2e-3, loss
rtol 1e-2), Adam's parameters in bf16 to the walk bound of
tests/test_sparse.py:305-307 and its moment trees to a quarter of their
norm (see below); their f32 twins to the f32 bounds."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_sparse import ADAM_NOISE_LEAVES, ADAM_WALK_BOUND
from tests.test_torch_sparse import family
from tests.test_torch_sparse import single_thread  # noqa: F401 (autouse)
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import epoch_index
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.parallel import programs
from tlsan_tpu_torch.parallel.multihost import run_local
from tlsan_tpu_torch.train.loop import Trainer

DP, MP = 2, 2
MESH_BF16_MOMENT_NORM = 0.25
WORLD_TIMEOUT_S = 240  # the world runs for some 20 s alone
N_TRAIN, STEPS, BATCH = 128, 4, 32
KW = dict(max_epochs=1, train_batch_size=BATCH, test_batch_size=16,
          steps_per_call=STEPS, eval_freq=10**9, best_after_step=0,
          lr_drop_step=2, save_auc_gate=0.0, tb_histograms=False)
IDX = epoch_index(N_TRAIN, BATCH, STEPS, 0, 1234)[0]
# (family, optimizer, dtype, sparse): the production legs, their f32
# twins, and the dense Adam step with sharded slots
LEGS = [(*leg, True) for leg in programs.PRODUCTION_LEGS] + [
    ("tlsan", "sgd", "float32", True), ("atrank", "adam", "float32", True),
    ("tlsan", "adam", "float32", False)]


def _leg_id(leg):
    return "-".join(str(x) for x in leg)


def _tc(model_dir, leg, **over):
    name, optimizer, dtype, use_sparse = leg
    tc = programs.leg_config(TrainConfig(model_dir=model_dir, **KW, **over),
                             optimizer, dtype)
    return dataclasses.replace(tc, sparse_updates=use_sparse)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sparse_mesh")
    jobs = []
    for leg in LEGS:
        kw, _, _, train, test, cate_list = family(leg[0], N_TRAIN)
        jobs.append((programs.chunk_program, dict(
            cfg=ModelConfig(**kw), tc=_tc(str(tmp / _leg_id(leg)), leg, dp=DP, mp=MP),
            cate_list=cate_list, train=train, test=test, idx=IDX)))
    got = run_local(programs.sequence, DP, MP, "gloo", "cpu", WORLD_TIMEOUT_S, *jobs,
                    init_method="file://" + str(tmp / "rendezvous"))
    return tmp, got


def test_production_legs_are_the_dry_runs():
    assert programs.PRODUCTION_LEGS == (("tlsan", "sgd", "bfloat16"),
                                        ("atrank", "adam", "bfloat16"),
                                        ("lspm", "sgd", "float32"))
    tc = programs.leg_config(TrainConfig(), "adam", "bfloat16")
    assert (tc.sparse_updates, tc.optimizer, tc.compute_dtype, tc.learning_rate) == \
        (True, "adam", "bfloat16", 0.01)


@pytest.mark.parametrize("leg", LEGS, ids=_leg_id)
def test_leg_on_the_mesh_equals_one_process(world, leg):
    tmp, got = world
    name, optimizer, dtype, use_sparse = leg
    ranks = [r[LEGS.index(leg)] for r in got]
    kw, _, _, train, test, cate_list = family(name, N_TRAIN)
    one = Trainer(get_model(name), ModelConfig(**kw),
                  _tc(str(tmp / f"{_leg_id(leg)}_one"), leg), cate_list, train, test,
                  device="cpu")
    assert one._use_sparse == use_sparse
    losses = one._train_chunk(torch.from_numpy(IDX)).numpy()
    state = {k: v.detach().numpy() for k, v in one.model.state_dict().items()}
    slots = {s: dict(zip(one._names, (t.numpy() for t in ts)))
             for s, ts in one.opt_state.slots.items()}
    one.close()

    bf16 = dtype == "bfloat16"
    for r in ranks:
        assert r["sparse"] == use_sparse
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-2 if bf16 else 1e-3)
        assert r["launches"]["chunk"] == {"fwa_fwd": 0, "fwa_bwd": 0, "mha_fwd": 0,
                                          "mha_bwd": 0}
    assert ranks[0]["pad_max"] == 0.0
    mesh_state = ranks[0]["state"]
    assert mesh_state.keys() == state.keys()
    noise = ADAM_NOISE_LEAVES.get(name, ()) if optimizer == "adam" else ()
    if bf16 and optimizer == "adam":
        # Adam under bf16: every near-zero-grad element walks
        # (tests/test_sparse.py:298-307); the moments below bind
        noise = tuple(state)
    for k in state:
        if k in noise:
            assert np.abs(mesh_state[k] - state[k]).max() < ADAM_WALK_BOUND, k
        else:
            np.testing.assert_allclose(
                mesh_state[k], state[k], rtol=2e-2 if bf16 else 2e-3,
                atol=2e-3 if bf16 or optimizer == "adam" else 2e-5, err_msg=k)
    saved = ranks[0]["opt_state"]
    assert saved["count"] == STEPS
    assert set(saved["slots"]) == set(slots)
    # the moments: tests/test_torch_sparse.py's bounds in f32.  In bf16 a
    # rank's backward rounds each weight gradient's sum over its half of
    # the rows to bf16 before the dp sum, one process the sum over all of
    # them; where the rows' terms cancel (ATRank's key biases, whose exact
    # gradient the softmax over keys nearly cancels) that moves a leaf's
    # moments by a good share of themselves.  So each moment tree is held
    # to a quarter of its norm: a lost or doubled dp share is off by half
    for s, atol in (("mu", 2e-6), ("nu", 2e-8)):
        want = slots.get(s, {})
        if bf16 and want:
            diff = sum(np.sum(np.square(saved["slots"][s][k] - v, dtype=np.float64))
                       for k, v in want.items())
            norm = sum(np.sum(np.square(v, dtype=np.float64)) for v in want.values())
            assert np.sqrt(diff / norm) <= MESH_BF16_MOMENT_NORM, (s, np.sqrt(diff / norm))
        for k, v in ({} if bf16 else want).items():
            np.testing.assert_allclose(saved["slots"][s][k], v, rtol=2e-3, atol=atol,
                                       err_msg=f"{s} {k}")
