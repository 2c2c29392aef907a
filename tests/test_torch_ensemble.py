"""The replica fan-out of the PyTorch port (train/ensemble.py) against the
JAX package's (tlsan_tpu/train/ensemble.py) and against R sequential port
Trainers, on the CPU, for TLSAN and ATRank: one epoch of `_fan_chunk` from
the same stacked init (SGD and Adam), lr_scales, the per-replica AUC, bf16,
the errors it raises, the epoch index, `main`; and the pieces it brought:
the replica launch plan of K1/K2, the vmap rules of FWAFunction and
MHAFunction (the replica entry points swapped for the plain version under
vmap, since the kernels run only on the card) and OneHotGather under vmap.
Inputs are numpy-seeded; stacked parameters cross over through
tools/params.py."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_atrank import CFG as ATRANK_CFG
from tests.test_torch_atrank import _train_data as atrank_data
from tests.test_torch_cli import CATEGORY, data_dir, snap  # noqa: F401 (fixtures)
from tests.test_torch_sparse import ADAM_WALK_BOUND
from tests.test_torch_sparse import single_thread  # noqa: F401 (autouse)
from tests.test_torch_train import CFG as TLSAN_CFG
from tests.test_torch_train import _tree_items
from tests.test_train import synthetic
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.models import get_model as jax_get_model
from tlsan_tpu.train.ensemble import ReplicaFanout as JaxReplicaFanout
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.nn.embedding import OneHotGather, gather_bwd, lookup
from tlsan_tpu_torch.ops.cuda import fwa, mha
from tlsan_tpu_torch.ops.feature_attention import (
    feature_wise_attention_reference,
    fwa_backward_reference,
)
from tlsan_tpu_torch.ops.multihead_attention import multihead_attention_reference
from tlsan_tpu_torch.tools.params import (
    params_from_numpy,
    stacked_from_numpy,
    stacked_to_numpy,
)
from tlsan_tpu_torch.train import ensemble
from tlsan_tpu_torch.train.ensemble import ReplicaFanout
from tlsan_tpu_torch.train.evaluate import device_data, make_auc_fn
from tlsan_tpu_torch.train.loop import Trainer

TOL = 1e-5  # tests/test_torch_train.py's SGD trajectory
SEEDS = [1234, 42]
TRAIN_KW = dict(max_epochs=1, train_batch_size=32, test_batch_size=64,
                steps_per_call=4, eval_freq=8, best_after_step=0,
                learning_rate=0.5)
# Adam's step is m / √ν: where a gradient is near 0 (FWA's b2 exactly, some
# of ATRank's readout projections nearly), √ν is of its f32 noise and two
# programs that sum in other orders walk apart by up to lr a step there
# (tests/test_torch_sparse.py's walk bound); every other entry holds 1e-5
ADAM_NOISE_RMS = 1e-4
# the keys of tlsan_tpu/train/ensemble.py::ReplicaFanout.train's result
JAX_RESULT_KEYS = {"seeds", "lr_scales", "best_auc", "best_step", "mean_best",
                   "range", "wall_s", "compile_s", "post_compile_wall_s",
                   "replica_examples_per_s",
                   "post_compile_replica_examples_per_s", "curves"}


def _family(name):
    """(model config kwargs, train, test, cate_list) of tests/test_train.py's
    synthetic set (TLSAN) or tests/test_torch_atrank.py's planted prefix
    rows (ATRank), 256 train rows each."""
    if name == "tlsan":
        return (TLSAN_CFG,) + synthetic()
    train, test = atrank_data(256, 64, seed=3)
    cate_list = np.random.default_rng(4).integers(0, ATRANK_CFG["cate_count"],
                                                  ATRANK_CFG["item_count"]).astype(np.int32)
    return ATRANK_CFG, train, test, cate_list


def _fanouts(name, seeds=SEEDS, lr_scales=None, **tc_kw):
    """The JAX fan-out and the port's (on the CPU) from the JAX one's
    stacked init."""
    cfg, train, test, cate_list = _family(name)
    kw = dict(TRAIN_KW, **tc_kw)
    jfan = JaxReplicaFanout(jax_get_model(name), JaxModelConfig(**cfg),
                            JaxTrainConfig(**kw), cate_list, train, test, seeds,
                            lr_scales)
    fan = ReplicaFanout(get_model(name), ModelConfig(**cfg), TrainConfig(**kw),
                        cate_list, train, test, seeds, lr_scales, device="cpu")
    stacked = stacked_from_numpy(jax.tree_util.tree_map(np.asarray, jfan.params),
                                 ModelConfig(**cfg), len(seeds), "cpu")
    with torch.no_grad():
        for n, t in stacked.items():
            fan.params[n].copy_(t)
    return jfan, fan


def _jax_chunk(jfan, chunk_idx):
    jfan.params, jfan.opt_state, jfan._rngs, losses = jfan._fan_chunk(
        jfan.params, jfan.opt_state, jnp.asarray(chunk_idx), jfan._rngs,
        jfan.lr_scales, jfan.data)
    return np.asarray(losses)


def _assert_replica_trees_close(got, want, rtol, atol, noise=None):
    """Leaf by leaf within rtol/atol; where `noise` (by leaf, a mask) is
    set, within the Adam walk bound instead."""
    got, want = dict(_tree_items(got)), dict(_tree_items(want))
    assert got.keys() == want.keys()
    for leaf, w in want.items():
        walk = np.zeros(w.shape, bool) if noise is None else noise[leaf]
        assert np.abs(got[leaf] - w)[walk].max(initial=0.0) < ADAM_WALK_BOUND, leaf
        np.testing.assert_allclose(got[leaf][~walk], w[~walk], rtol=rtol, atol=atol,
                                   err_msg=leaf)


# ------------------------------------------------------------ against JAX


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("name", ["tlsan", "atrank"])
def test_fan_chunk_matches_jax(name, optimizer):
    """One epoch of `_fan_chunk` at R = 2 against the JAX fan-out's from the
    same stacked init: every chunk's per-replica loss and every final
    leaf within 1e-5 (under Adam, the entries whose √ν is below
    ADAM_NOISE_RMS, near-zero gradients, to the walk bound)."""
    lr = 0.5 if optimizer == "sgd" else 0.01
    jfan, fan = _fanouts(name, optimizer=optimizer, learning_rate=lr)
    chunks = fan._epoch_index(0)
    assert len(chunks) == 2
    for c, chunk_idx in enumerate(chunks):
        want = _jax_chunk(jfan, chunk_idx)
        got = fan._fan_chunk(torch.from_numpy(chunk_idx)).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"chunk {c}")
    noise = None
    if optimizer == "adam":
        noise = dict(_tree_items(stacked_to_numpy({
            n: nu.sqrt() < ADAM_NOISE_RMS
            for n, nu in zip(fan.params, fan.opt_state.slots["nu"])})))
    _assert_replica_trees_close(stacked_to_numpy(fan.params),
                                jax.tree_util.tree_map(np.asarray, jfan.params),
                                TOL, TOL, noise)
    assert fan.opt_state.count == 8
    if optimizer == "adam":
        for slot in ("mu", "nu"):
            assert all(t.shape[0] == 2 for t in fan.opt_state.slots[slot])


@pytest.mark.parametrize("name", ["tlsan", "atrank"])
def test_replica_auc_matches_unvmapped_and_jax(name):
    """The per-replica AUC (one vmapped pass, the test data shared) against
    the port's unvmapped evaluator on each replica's weights, and against
    the JAX fan-out's `auc()`, from the same stacked init and after one
    chunk."""
    jfan, fan = _fanouts(name, seeds=[1234, 42, 7])
    cfg, _, test, cate_list = _family(name)
    data, _ = device_data(test, TRAIN_KW["test_batch_size"], "cpu")
    auc_one = make_auc_fn(torch.from_numpy(cate_list))
    for step in range(2):
        aucs = fan.auc()
        assert aucs.shape == (3,)
        for r in range(3):
            model = get_model(name)(ModelConfig(**cfg), "cpu")
            model.load_state_dict({n: p[r] for n, p in fan.params.items()})
            np.testing.assert_allclose(aucs[r], float(auc_one(model, data)), atol=1e-7)
        np.testing.assert_allclose(aucs, np.asarray(jfan.auc()), atol=1.0 / test.n + 1e-9)
        chunk = fan._epoch_index(0)[0]
        _jax_chunk(jfan, chunk)
        fan._fan_chunk(torch.from_numpy(chunk))


# ---------------------------------------------- against sequential Trainers


@pytest.mark.parametrize("name", ["tlsan", "atrank"])
def test_fanout_matches_sequential_trainers(tmp_path, name):
    """The mirror of tests/test_ensemble.py::test_fanout_matches_sequential_
    trainer: replica r draws the init of a port Trainer at seed r, takes
    its shuffle stream, and after one epoch its chunk losses and every
    parameter equal that Trainer's within 1e-5."""
    cfg, train, test, cate_list = _family(name)
    tc = TrainConfig(**TRAIN_KW, tb_histograms=False)
    fan = ReplicaFanout(get_model(name), ModelConfig(**cfg), tc, cate_list, train,
                        test, SEEDS, device="cpu")
    inits = {n: p.detach().clone() for n, p in fan.params.items()}
    fan_losses = [fan._fan_chunk(torch.from_numpy(c)).numpy()
                  for c in fan._epoch_index(0)]
    for r, seed in enumerate(SEEDS):
        tr = Trainer(get_model(name), ModelConfig(**cfg), dataclasses.replace(
            tc, seed=seed, model_dir=str(tmp_path / f"single{seed}")),
            cate_list, train, test, device="cpu")
        for n, p in tr.model.named_parameters():
            assert torch.equal(inits[n][r], p.detach()), n
        for c, idx in enumerate(tr._epoch_index(0)):
            loss = tr._train_chunk(torch.from_numpy(idx)).mean()
            np.testing.assert_allclose(fan_losses[c][r], float(loss), rtol=TOL,
                                       atol=TOL, err_msg=f"seed {seed} chunk {c}")
        for n, p in tr.model.named_parameters():
            np.testing.assert_allclose(fan.params[n][r].detach().numpy(),
                                       p.detach().numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"seed {seed} {n}")
        tr.close()


def test_lr_scales_match_a_trainer_at_scaled_lr(tmp_path):
    """Replicas of one seed at lr_scales [1, 2] track single Trainers at lr
    and 2·lr (SGD's update is linear in lr; the scale applies after the
    clip and the schedule), and the JAX fan-out's scaled replica."""
    cfg, train, test, cate_list = _family("tlsan")
    jfan, fan = _fanouts("tlsan", seeds=[7, 7], lr_scales=[1.0, 2.0])
    for chunk_idx in fan._epoch_index(0):
        _jax_chunk(jfan, chunk_idx)
        fan._fan_chunk(torch.from_numpy(chunk_idx))
    _assert_replica_trees_close(stacked_to_numpy(fan.params),
                                jax.tree_util.tree_map(np.asarray, jfan.params),
                                TOL, TOL)
    # a Trainer from the same init at lr and 2·lr
    init = {n: p[0] for n, p in stacked_from_numpy(
        jax.tree_util.tree_map(np.asarray, JaxReplicaFanout(
            jax_get_model("tlsan"), JaxModelConfig(**cfg), JaxTrainConfig(**TRAIN_KW),
            cate_list, train, test, [7]).params), ModelConfig(**cfg), 1, "cpu").items()}
    for r, lr in enumerate((0.5, 1.0)):
        tc = TrainConfig(**dict(TRAIN_KW, learning_rate=lr), seed=7,
                         tb_histograms=False, model_dir=str(tmp_path / f"lr{lr}"))
        tr = Trainer(get_model("tlsan"), ModelConfig(**cfg), tc, cate_list, train, test,
                     device="cpu")
        tr.model.load_state_dict(init)
        for idx in tr._epoch_index(0):
            tr._train_chunk(torch.from_numpy(idx))
        for n, p in tr.model.named_parameters():
            np.testing.assert_allclose(fan.params[n][r].detach().numpy(),
                                       p.detach().numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"lr {lr} {n}")
        tr.close()


def test_fanout_train_end_to_end_bf16():
    """The mirror of tests/test_ensemble.py::test_fanout_train_end_to_end_
    bf16: the bf16 fan-out trains end to end and tracks the f32 fan-out's
    per-replica AUC (the synthetic task's pairwise-AUC ceiling is low, so
    the assertion is agreement, not quality); its result has JAX's keys."""
    cfg, train, test, cate_list = _family("tlsan")
    out = {}
    for dtype in ("bfloat16", "float32"):
        tc = TrainConfig(**dict(TRAIN_KW, max_epochs=6), compute_dtype=dtype)
        fan = ReplicaFanout(get_model("tlsan"), ModelConfig(**cfg), tc, cate_list,
                            train, test, SEEDS, device="cpu")
        out[dtype] = fan.train(log=lambda *_: None)
        assert all(p.dtype == torch.float32 for p in fan.params.values())
    assert set(out["bfloat16"]) == JAX_RESULT_KEYS
    assert all(np.isfinite(a) for a in out["bfloat16"]["best_auc"])
    np.testing.assert_allclose(out["bfloat16"]["best_auc"], out["float32"]["best_auc"],
                               atol=0.05)
    assert len(out["float32"]["curves"]) == 6


def test_bf16_fanout_matches_jax_bf16_and_trainers(tmp_path):
    """bf16 (bf16_cast of parameters and batch, f32 masters): a chunk of
    the port's fan-out against the JAX bf16 fan-out's from the same stacked
    init, per-replica losses within tests/test_torch_bf16.py's bound
    against JAX bf16 (rtol 2e-2, atol 1e-2: the port's attention runs f32
    between casts, JAX's in bf16); each replica against a port bf16 Trainer
    at its seed within 1e-5."""
    cfg, train, test, cate_list = _family("tlsan")
    jfan, fan = _fanouts("tlsan", compute_dtype="bfloat16")
    inits = {n: p.detach().clone() for n, p in fan.params.items()}
    chunk_idx = fan._epoch_index(0)[0]
    want = _jax_chunk(jfan, chunk_idx)
    got = fan._fan_chunk(torch.from_numpy(chunk_idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-2)
    for r, seed in enumerate(SEEDS):
        tr = Trainer(get_model("tlsan"), ModelConfig(**cfg), TrainConfig(
            **TRAIN_KW, seed=seed, compute_dtype="bfloat16", tb_histograms=False,
            model_dir=str(tmp_path / str(seed))), cate_list, train, test, device="cpu")
        tr.model.load_state_dict({n: p[r] for n, p in inits.items()})
        loss = tr._train_chunk(torch.from_numpy(chunk_idx[r])).mean()
        np.testing.assert_allclose(got[r].item(), loss.item(), rtol=TOL, atol=TOL)
        for n, p in tr.model.named_parameters():
            assert fan.params[n].dtype == p.dtype == torch.float32
            np.testing.assert_allclose(fan.params[n][r].detach().numpy(),
                                       p.detach().numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"seed {seed} {n}")
        tr.close()


def test_fanout_raises_what_it_does_not_run():
    """lr_scales with another optimizer than SGD, a mesh and dropout raise
    ValueError at construction, as the JAX fan-out refuses them (dropout:
    the kernels draw no masks, ROADMAP item 25)."""
    cfg, train, test, cate_list = _family("tlsan")

    def make(cfg_over=None, lr_scales=None, **tc_kw):
        return ReplicaFanout(get_model("tlsan"), ModelConfig(**dict(cfg, **(cfg_over or {}))),
                             TrainConfig(**dict(TRAIN_KW, **tc_kw)), cate_list, train,
                             test, SEEDS, lr_scales, device="cpu")

    with pytest.raises(ValueError, match="SGD"):
        make(optimizer="adam", lr_scales=[1.0, 2.0])
    with pytest.raises(ValueError, match="one device"):
        make(dp=2)
    with pytest.raises(ValueError, match="item 25"):
        make(cfg_over={"dropout": 0.1})
    with pytest.raises(ValueError, match="lr_scales"):
        make(lr_scales=[1.0])
    make(optimizer="adam")  # a shared LR runs


@pytest.mark.parametrize("name", ["tlsan", "atrank"])
def test_epoch_index_is_byte_identical(name):
    """[n_chunks, R, K, B], each replica its own seed's stream, byte for
    byte as the JAX fan-out gives it, over two epochs."""
    jfan, fan = _fanouts(name, seeds=[1234, 42, 7], steps_per_call=3)
    for epoch in range(2):
        got, want = fan._epoch_index(epoch), jfan._epoch_index(epoch)
        assert got.shape == want.shape and got.shape[1:3] == (3, 3)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_main_prints_one_line_with_the_jax_keys(data_dir, capsys, monkeypatch,
                                                tmp_path):
    """`python -m tlsan_tpu_torch.train.ensemble` on the seeded fixture, 2
    seeds, 1 epoch, on the CPU: a header and one JSON line with the JAX
    result's keys (less the curves), the curves in --out."""
    monkeypatch.setenv("TLSAN_DATA_CACHE", "0")
    out_path = tmp_path / "fan.json"
    result = ensemble.main(["--model", "tlsan", "--dataset", CATEGORY,
                            "--data_dir", data_dir, "--seeds", "3", "4",
                            "--max_epochs", "1", "--eval_freq", "4",
                            "--steps_per_call", "4", "--device", "cpu",
                            "--out", str(out_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("fanout model=tlsan dataset=Digital_Music replicas=2")
    printed = json.loads(lines[-1])
    assert set(printed) == JAX_RESULT_KEYS - {"curves"}
    assert printed["seeds"] == [3, 4] and len(printed["best_auc"]) == 2
    assert json.loads(out_path.read_text())["curves"] == result["curves"]
    assert result["curves"]


# ------------------------------------------------------ the kernels' plans


@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("B,S,D,H", [(32, 10, 64, 8), (128, 25, 64, 8),
                                     (37, 33, 128, 4), (8192, 25, 64, 8)])
def test_fwa_launch_plan_takes_replicas(B, S, D, H, R):
    """A replica launch is R copies of one replica's plan on the grid's y
    axis: the same blocks, threads and shared memory a replica, and K2's
    scratch one tree a replica (R × its slots and tickets)."""
    for backward in (False, True):
        one = fwa.launch_plan(B, S, D, H, backward)
        plan = fwa.launch_plan(B, S, D, H, backward, R)
        assert plan.replicas == R
        assert dataclasses.replace(plan, replicas=1) == one
    with pytest.raises(ValueError, match="replicas"):
        fwa.launch_plan(B, S, D, H, False, 0)
    plan = fwa.launch_plan(B, S, D, H, True, R)
    saved = dict(fwa._scratch)
    try:
        fwa._scratch.clear()
        slots, tickets = fwa._bwd_scratch(torch.empty(1), plan)
        assert slots.numel() == max(R * plan.slots, 1)
        assert tickets.numel() == max(R * plan.tickets, 1)
        assert not tickets.any()
    finally:
        fwa._scratch.clear()
        fwa._scratch.update(saved)


@pytest.mark.parametrize("B,Tq,Tk", [(32, 96, 96), (32, 1, 96), (128, 96, 96),
                                     (128, 1, 96), (37, 17, 17)])
def test_mha_replica_plan_folds_rows(B, Tq, Tk):
    """K3's R replicas are R·B rows of one plan: the cluster size is that of
    R·B rows, which equals one replica's where B and R·B fit the same
    cluster in one wave (then replica r is bit for bit a single launch)."""
    for R in (1, 3, 8):
        plan = mha.launch_plan(R * B, Tq, Tk, 64, 8, Tq == Tk)
        assert plan.grid == R * B * plan.cs
        assert plan.cs <= mha.launch_plan(B, Tq, Tk, 64, 8, Tq == Tk).cs


# ------------------------------------------------------- the vmap rules


def _plain_replicas(fn):
    """`fn` on a leading replica axis (under vmap) when its first argument
    has one: the plain stand-in for a replica kernel."""
    def call(*args):
        if args[0].dim() == 4:
            dims = tuple(None if isinstance(a, int) else 0 for a in args)
            return torch.func.vmap(fn, in_dims=dims)(*args)
        return fn(*args)
    return call


def _f32(rng, shape, scale=1.0, grad=True):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                        requires_grad=grad)


@pytest.mark.parametrize("shared_lengths", [False, True])
@pytest.mark.parametrize("batched_weights", ["all", "some"])
def test_fwa_function_vmap_rule(monkeypatch, shared_lengths, batched_weights):
    """FWAFunction under vmap calls the replica entry points once each
    (one K1 and one K2 launch for all replicas on the card) with the
    replica axis first and what is shared expanded; values and gradients
    equal vmap of the plain version under autograd."""
    calls = []

    def forward(*args):
        calls.append(("fwd", tuple(args[0].shape), tuple(args[1].shape)))
        return _plain_replicas(feature_wise_attention_reference)(*args)

    def backward(*args):
        calls.append(("bwd", tuple(args[0].shape), tuple(args[1].shape)))
        return _plain_replicas(fwa_backward_reference)(*args)

    monkeypatch.setattr(fwa, "fwa_forward", forward)
    monkeypatch.setattr(fwa, "fwa_backward", backward)
    rng = np.random.default_rng(0)
    R, B, S, D, H = 3, 5, 7, 16, 2
    dh = D // H
    # x's replica axis second, as vmap may hand it over
    x = _f32(rng, (B, R, S, D))
    lengths = torch.tensor(rng.integers(0, S + 1, (R, B)), dtype=torch.int32)
    lengths[:, 0] = 0
    if shared_lengths:
        lengths = lengths[0]
    w1, w2 = _f32(rng, (R, dh, dh), 0.3), _f32(rng, (R, dh, dh), 0.3)
    some = batched_weights == "some"
    b1 = _f32(rng, (dh,) if some else (R, dh), 0.1)
    b2 = _f32(rng, (R, dh), 0.1)
    g = torch.tensor(rng.normal(size=(R, B, D)), dtype=torch.float32)
    dims = (1, None if shared_lengths else 0, 0, None if some else 0, 0, 0)
    leaves = [x, w1, b1, w2, b2]

    def run(fn):
        out = torch.func.vmap(lambda x, ln, w1, b1, w2, b2: fn(x, ln, H, w1, b1, w2, b2),
                              in_dims=dims)(x, lengths, w1, b1, w2, b2)
        return out, torch.autograd.grad(out, leaves, g)

    got, got_grads = run(fwa.FWAFunction.apply)
    want, want_grads = run(feature_wise_attention_reference)
    assert calls == [("fwd", (R, B, S, D), (R, B)), ("bwd", (R, B, S, D), (R, B))]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=TOL, atol=TOL)
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), got_grads, want_grads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("self_attention", [True, False])
def test_mha_function_vmap_rule(monkeypatch, self_attention):
    """MHAFunction under vmap calls the replica entry point once, with the
    replica axis first; self-attention keeps queries and keys one tensor
    (the kernel's plan reads that from the pointers); values and
    gradients (the plain recompute under vmap) equal vmap of the plain
    version under autograd, the weights unbatched in part."""
    calls = []

    def forward(queries, keys, q_len, k_len, num_heads, *weights):
        calls.append((tuple(queries.shape), queries.data_ptr() == keys.data_ptr()))

        def one(q, k, ql, kl, *ws):
            return multihead_attention_reference(q, ql, k, kl, num_heads,
                                                 dict(zip(mha.WEIGHTS, ws)))[0]
        return torch.func.vmap(one)(queries, keys, q_len, k_len, *weights)

    monkeypatch.setattr(mha, "mha_forward", forward)
    rng = np.random.default_rng(1)
    R, B, Tq, D, H = 3, 4, 6, 16, 2
    Tk = Tq if self_attention else 9
    q = _f32(rng, (R, B, Tq, D))
    k = q if self_attention else _f32(rng, (R, B, Tk, D))
    q_len = torch.tensor(rng.integers(0, Tq + 1, (R, B)), dtype=torch.int32)
    k_len = q_len if self_attention else torch.tensor(
        rng.integers(0, Tk + 1, B), dtype=torch.int32)  # shared by the replicas
    ws = [_f32(rng, ((R,) if n != "bv" else ()) + ((D, D) if n.startswith("w") else (D,)),
               0.2) for n in mha.WEIGHTS]
    w_dims = tuple(None if n == "bv" else 0 for n in mha.WEIGHTS)
    g = torch.tensor(rng.normal(size=(R, B, Tq, D)), dtype=torch.float32)
    leaves = [q, *ws] if self_attention else [q, k, *ws]
    k_dim = None if not self_attention else 0

    def run(fn):
        if self_attention:
            out = torch.func.vmap(lambda q, ql, *w: fn(q, q, ql, ql, *w),
                                  in_dims=(0, 0) + w_dims)(q, q_len, *ws)
        else:
            out = torch.func.vmap(fn, in_dims=(0, 0, 0, k_dim) + w_dims)(
                q, k, q_len, k_len, *ws)
        return out, torch.autograd.grad(out, leaves, g)

    got, got_grads = run(lambda q, k, ql, kl, *w: mha.MHAFunction.apply(q, k, ql, kl, H, *w))
    want, want_grads = run(lambda q, k, ql, kl, *w: multihead_attention_reference(
        q, ql, k, kl, H, dict(zip(mha.WEIGHTS, w)))[0])
    assert calls == [((R, B, Tq, D), self_attention)]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=TOL, atol=TOL)
    for a, b in zip(got_grads, want_grads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_vmap_rules_do_not_fall_back():
    """Under vmap a tensor the kernels do not take (here a CPU one, which
    the dispatchers never hand them) reaches the replica entry point and
    raises; nothing loops over replicas or takes the plain version."""
    rng = np.random.default_rng(2)
    x = _f32(rng, (2, 3, 4, 16), grad=False)
    lengths = torch.ones((2, 3), dtype=torch.int32)
    w, b = _f32(rng, (2, 8, 8), grad=False), _f32(rng, (2, 8), grad=False)
    with pytest.raises(ValueError, match="CUDA"):
        torch.func.vmap(lambda *a: fwa.FWAFunction.apply(a[0], a[1], 2, *a[2:]))(
            x, lengths, w, b, w, b)
    ws = [_f32(rng, (2, 16, 16) if n.startswith("w") else (2, 16), grad=False)
          for n in mha.WEIGHTS]
    with pytest.raises(ValueError, match="CUDA"):
        torch.func.vmap(lambda q, ln, *w: mha.MHAFunction.apply(q, q, ln, ln, 2, *w))(
            x, lengths, *ws)


@pytest.mark.parametrize("shared_ids", [False, True])
def test_one_hot_gather_under_vmap_matches_take(shared_ids):
    """`gather_bwd('onehot')` under vmap (per-replica tables, ids per
    replica or shared) gives the rows and the table gradients of a plain
    take under vmap."""
    rng = np.random.default_rng(3)
    R, V, D = 3, 11, 4
    table = _f32(rng, (R, V, D))
    ids = torch.tensor(rng.integers(0, V, (R, 5, 2)), dtype=torch.int32)
    ct = torch.tensor(rng.normal(size=(R, 5, 2, D)), dtype=torch.float32)
    dims = (0, None) if shared_ids else (0, 0)
    ids = ids[0] if shared_ids else ids
    with gather_bwd("onehot"):
        got = torch.func.vmap(lookup, in_dims=dims)(table, ids)
    (got_grad,) = torch.autograd.grad(got, [table], ct)
    want = torch.func.vmap(lambda t, i: t[i], in_dims=dims)(table, ids)
    (want_grad,) = torch.autograd.grad(want, [table], ct)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got_grad.numpy(), want_grad.numpy(), rtol=1e-6, atol=1e-6)
    assert OneHotGather.generate_vmap_rule


def test_fanout_with_onehot_gather_matches_take():
    """The fan-out under gather_bwd('onehot') takes the same chunk as with
    the take backward (f32 summation order apart)."""
    runs = []
    for mode in ("take", "onehot"):
        cfg, train, test, cate_list = _family("tlsan")
        fan = ReplicaFanout(get_model("tlsan"), ModelConfig(**cfg), TrainConfig(**TRAIN_KW),
                            cate_list, train, test, SEEDS, device="cpu")
        with gather_bwd(mode):
            losses = fan._fan_chunk(torch.from_numpy(fan._epoch_index(0)[0]))
        runs.append((losses, {n: p.detach() for n, p in fan.params.items()}))
    (l1, p1), (l2, p2) = runs
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=TOL, atol=TOL)
    for n in p1:
        np.testing.assert_allclose(p1[n].numpy(), p2[n].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=n)


def test_stacking_round_trips_the_jax_tree():
    """The JAX fan-out's stacked tree → the port's stacked parameters → the
    JAX layout again, exactly; replica r's slice is the tree of replica r
    (params_from_numpy of the sliced tree)."""
    cfg, *_ = _family("atrank")
    tree = jax.tree_util.tree_map(
        np.asarray, JaxReplicaFanout(
            jax_get_model("atrank"), JaxModelConfig(**cfg), JaxTrainConfig(**TRAIN_KW),
            _family("atrank")[3], *_family("atrank")[1:3], [5, 6, 7]).params)
    stacked = stacked_from_numpy(tree, ModelConfig(**cfg), 3, "cpu")
    back = dict(_tree_items(stacked_to_numpy(stacked)))
    for name, arr in _tree_items(tree):
        assert back[name].tobytes() == arr.tobytes(), name
    one = params_from_numpy(jax.tree_util.tree_map(lambda a: a[1], tree),
                            ModelConfig(**cfg), "cpu")
    for n, p in one.named_parameters():
        assert torch.equal(stacked[n][1], p.detach()), n
    with pytest.raises(ValueError, match="expected"):
        stacked_from_numpy(tree, ModelConfig(**cfg), 2, "cpu")
