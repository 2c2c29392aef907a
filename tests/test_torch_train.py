"""Training in the PyTorch port against the JAX package, on the CPU: the
TLSAN loss and every gradient leaf, the loss helpers, the optimizer (optax's
clip and lr step written by hand), the packers and the epoch index, the
evaluator, the Trainer itself and its checkpoints, and the tfevents copy.
Inputs are numpy-seeded; parameters cross over through tools/params.py."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

import tlsan_tpu.ops.pallas.fwa as F
from tests.test_train import synthetic
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.data import batcher as jax_batcher
from tlsan_tpu.models import base as jax_base
from tlsan_tpu.models.tlsan import TLSAN as JaxTLSAN
from tlsan_tpu.train import tensorboard as jax_tb
from tlsan_tpu.train.evaluate import Evaluator as JaxEvaluator
from tlsan_tpu.train.loop import Trainer as JaxTrainer
from tlsan_tpu.train.state import lr_schedule as jax_lr_schedule
from tlsan_tpu.train.state import make_optimizer as jax_make_optimizer
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data import batcher
from tlsan_tpu_torch.models import base
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.tools.params import (
    grads_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from tlsan_tpu_torch.train import checkpoint, state
from tlsan_tpu_torch.train import tensorboard as tb
from tlsan_tpu_torch.train.evaluate import Evaluator
from tlsan_tpu_torch.train.loop import Trainer

USERS, ITEMS, CATES, LS, TS = 20, 30, 5, 10, 8
CFG = dict(model="tlsan", user_count=USERS, item_count=ITEMS,
           cate_count=CATES, Ls=LS, Ts=TS)
TOL = 1e-5


def _tree_items(tree, prefix=""):
    """(name, leaf) pairs of a JAX-layout parameter tree, in a fixed order."""
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


def _batch(n=32, seed=0):
    """The first n rows of tests/test_train.py's synthetic() set, with two
    empty long histories and a valid mask that drops the last three rows."""
    train, _, cate_list = synthetic(seed=seed)
    arrays = {k: v[:n].copy() for k, v in train.arrays.items()}
    arrays["sl"][:2] = 0
    arrays["valid"] = np.arange(n) < n - 3
    return arrays, cate_list


def _init_tree(cfg=None, seed=0):
    params = JaxTLSAN.init_params(jax.random.PRNGKey(seed), cfg or JaxModelConfig(**CFG))
    return params, jax.tree_util.tree_map(np.asarray, params)


# --------------------------------------------------------------- model loss


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_every_grad_leaf_match_jax(use_pallas, monkeypatch):
    """TLSAN.loss and its gradients against jax.value_and_grad of the JAX
    loss, through the plain FWA or the Pallas kernel in interpret mode."""
    if use_pallas:  # the JAX dispatcher takes the kernel only on a TPU
        monkeypatch.setattr(F.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jparams, tree = _init_tree()
    batch, cate_list = _batch()
    want_loss, want_grads = jax.value_and_grad(JaxTLSAN.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(cate_list), JaxModelConfig(**CFG), use_pallas)

    model = params_from_numpy(tree, ModelConfig(**CFG), "cpu")
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                      torch.from_numpy(cate_list))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    got = grads_to_numpy(model)
    _assert_trees_close(got, jax.tree_util.tree_map(np.asarray, want_grads),
                        TOL, TOL, "grad ")
    # every leaf that has a gradient got one
    assert all(np.abs(g).max() > 0 for _, g in _tree_items(got))


def test_dropout_engages_in_training_only():
    """Twin of tests/test_all_models.py:157: with a dropout rate, the loss
    with a generator (training) differs from the loss without one, which
    equals the loss at rate 0 (eval); the same seed draws the same masks."""
    _, tree = _init_tree()
    batch, cate_list = _batch()
    tb_, cl = ({k: torch.from_numpy(v) for k, v in batch.items()},
               torch.from_numpy(cate_list))
    plain = params_from_numpy(tree, ModelConfig(**CFG), "cpu")
    drop = params_from_numpy(tree, ModelConfig(**CFG, dropout=0.5), "cpu")
    with torch.no_grad():
        want = plain.loss(tb_, cl)
        assert torch.equal(drop.loss(tb_, cl), want)
        a = drop.loss(tb_, cl, torch.Generator().manual_seed(0))
        b = drop.loss(tb_, cl, torch.Generator().manual_seed(0))
        assert torch.isfinite(a) and torch.equal(a, b) and not torch.equal(a, want)
        assert torch.equal(plain.loss(tb_, cl, torch.Generator().manual_seed(0)), want)


def test_loss_helpers_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=40).astype(np.float32) * 4
    labels = rng.integers(0, 2, 40).astype(np.float32)
    neg = rng.normal(size=40).astype(np.float32) * 4
    valid = rng.random(40) < 0.7
    tables = [rng.normal(size=s).astype(np.float32) for s in [(7, 3), (5,), ()]]
    t = torch.from_numpy
    for v in (None, valid):
        jv, tv = (None, None) if v is None else (jnp.asarray(v), t(v))
        np.testing.assert_allclose(
            float(base.sigmoid_ce_loss(t(logits), t(labels), tv)),
            float(jax_base.sigmoid_ce_loss(jnp.asarray(logits), jnp.asarray(labels), jv)),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(base.auc_from_pair(t(logits), t(neg), tv)),
            float(jax_base.auc_from_pair(jnp.asarray(logits), jnp.asarray(neg), jv)),
            rtol=1e-6)
    # all rows padded: the mean is over max(0, 1) rows, not a division by 0
    none = np.zeros(40, bool)
    assert float(base.sigmoid_ce_loss(t(logits), t(labels), t(none))) == 0.0
    np.testing.assert_allclose(
        float(base.l2_tables(*map(t, tables))),
        float(jax_base.l2_tables(*map(jnp.asarray, tables))), rtol=1e-6)


# ---------------------------------------------------------------- optimizer


def test_sgd_matches_optax_for_50_steps():
    """The clipped SGD on its lr step against optax's make_optimizer, step by
    step: gradient norms on both sides of the clip, and lr_drop_step lowered
    to 25 so the drop lands inside the run."""
    kw = dict(learning_rate=1.0, max_gradient_norm=5.0, lr_drop_step=25)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    for count in (0, 1, 24, 25, 26, 10_000):
        assert state.lr_schedule(tc)(count) == float(jax_lr_schedule(jtc)(count))

    rng = np.random.default_rng(4)
    shapes = {"table": (30, 8), "w": (8, 8), "b": (8,), "gamma": ()}
    init = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jopt = jax_make_optimizer(jtc)
    jstate = jopt.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in shapes]
    opt = state.make_optimizer(tc)
    st = opt.init()
    clipped = 0
    for step in range(50):
        # global norms from ~0.5 to ~25, so the clip engages on some steps
        scale = 0.02 * np.exp(rng.uniform(0.0, 4.0))
        grads = {k: np.asarray(rng.normal(size=s) * scale, np.float32)
                 for k, s in shapes.items()}
        clipped += np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                               for g in grads.values())) > 5.0
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                        jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(grads[k])
        st = opt.step(params, st)
        assert st.count == step + 1
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=TOL, atol=TOL, err_msg=f"step {step} {k}")
    assert 5 <= clipped <= 45, clipped


def test_clip_is_optax_not_clip_grad_norm():
    """At a norm above the max, the direction is g / ‖g‖ · max exactly
    (clip_grad_norm_ divides by ‖g‖ + 1e-6); below it, g unchanged."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]  # ‖g‖ = 13
    out = state.clip_by_global_norm(g, 6.5)
    assert torch.equal(out[0], torch.tensor([1.5, 2.0]))
    assert torch.equal(out[1], torch.tensor([6.0]))
    assert all(torch.equal(a, b) for a, b in zip(state.clip_by_global_norm(g, 13.5), g))


@pytest.mark.parametrize("name", ["adam", "adadelta", "rmsprop"])
def test_other_optimizers_are_queued(name):
    """Once queued (ROADMAP item 24), now ported: each optimizer against
    optax's make_optimizer for 30 updates across lr_drop_step, with
    gradient norms on both sides of the clip (tests/test_torch_optim.py
    holds the slots too, and the clip off)."""
    kw = dict(optimizer=name, learning_rate=0.05, max_gradient_norm=5.0,
              lr_drop_step=15)
    jopt, opt = jax_make_optimizer(JaxTrainConfig(**kw)), state.make_optimizer(TrainConfig(**kw))
    rng = np.random.default_rng(5)
    shapes = {"table": (30, 8), "w": (8, 8), "b": (8,), "gamma": ()}
    init = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in shapes]
    st = opt.init(params)
    for step in range(30):
        scale = 0.02 * np.exp(rng.uniform(0.0, 4.0))
        grads = {k: np.asarray(rng.normal(size=s) * scale, np.float32)
                 for k, s in shapes.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(grads[k])
        st = opt.step(params, st)
        assert st.count == step + 1
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} {step} {k}")


# -------------------------------------------------------------- data layout


def _session_tuples(n, seed, test=False):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n):
        pre = list(rng.integers(0, ITEMS, int(rng.integers(0, 2 * LS))))
        new = list(rng.integers(0, ITEMS, int(rng.integers(1, 2 * TS))))
        times = list(rng.uniform(0.1, 1.0, len(pre)))
        if test:
            out.append((r % USERS, pre, new, times,
                        (int(rng.integers(ITEMS)), int(rng.integers(ITEMS))),
                        int(rng.integers(CATES))))
        else:
            out.append((r % USERS, pre, new, times, int(rng.integers(ITEMS)),
                        int(rng.integers(2)), int(rng.integers(CATES))))
    return out


def _assert_batches_identical(got, want):
    assert got.n == want.n and got.arrays.keys() == want.arrays.keys()
    for k, v in want.arrays.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_session_packers_are_byte_identical():
    train, test = _session_tuples(57, 5), _session_tuples(23, 6, test=True)
    _assert_batches_identical(batcher.pack_session_train(train, LS, TS),
                              jax_batcher.pack_session_train(train, LS, TS))
    _assert_batches_identical(batcher.pack_session_test(test, LS, TS),
                              jax_batcher.pack_session_test(test, LS, TS))
    # the shan variant: (uid, pre, new, item, label) and (uid, pre, new,
    # (pos, neg)) tuples, the TLSAN tuples without time and category
    shan_train = [(t[0], t[1], t[2], t[4], t[5]) for t in train]
    shan_test = [(t[0], t[1], t[2], t[4]) for t in test]
    _assert_batches_identical(
        batcher.pack_session_train(shan_train, LS, TS, variant="shan"),
        jax_batcher.pack_session_train(shan_train, LS, TS, variant="shan"))
    _assert_batches_identical(
        batcher.pack_session_test(shan_test, LS, TS, variant="shan"),
        jax_batcher.pack_session_test(shan_test, LS, TS, variant="shan"))


@pytest.mark.parametrize("n,b,k", [(256, 32, 4), (1000, 32, 100), (37, 8, 3)])
def test_epoch_index_and_padding_are_byte_identical(n, b, k):
    for epoch in (0, 1, 7):
        got = batcher.epoch_index(n, b, k, epoch, seed=11)
        want = jax_batcher.epoch_index(n, b, k, epoch, seed=11)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    train, _, _ = synthetic(n=n)
    _assert_batches_identical(batcher.pad_to_multiple(_port_batches(train), b),
                              jax_batcher.pad_to_multiple(train, b))


def _port_batches(jax_batches):
    """The port's Batches holding a JAX-package Batches' arrays."""
    return batcher.Batches(dict(jax_batches.arrays), jax_batches.n)


# --------------------------------------------------------------- evaluation


@pytest.mark.parametrize("catalog_items", [0, 25])
def test_evaluator_matches_jax(catalog_items):
    """AUC and top-k hit counts equal the JAX Evaluator's on the same
    parameters, with padded batches (n=100, batch 64) and, at
    catalog_items=25, the catalog rows past 25 masked out of the ranking."""
    jcfg = JaxModelConfig(**CFG, catalog_items=catalog_items)
    jparams, tree = _init_tree(jcfg, seed=2)
    _, test, cate_list = synthetic(n=100, seed=2)
    want_eval = JaxEvaluator(JaxTLSAN, jcfg, jnp.asarray(cate_list), test, 64,
                             use_pallas=False)
    cfg = ModelConfig(**CFG, catalog_items=catalog_items)
    model = params_from_numpy(tree, cfg, "cpu")
    ev = Evaluator(cfg, torch.from_numpy(cate_list), _port_batches(test), 64, "cpu")
    assert ev.auc(model) == want_eval.auc(jparams)
    got, want = ev.topk(model), want_eval.topk(jparams)
    assert got.keys() == want.keys()
    for key in want:
        if key.startswith("R@"):  # hits = R@k · n
            assert round(got[key] * 100) == round(want[key] * 100), key
    if catalog_items:  # no masked item ever ranks: P@50 counts 25 ranks
        assert got["R@50"] == got["R@30"]
    assert ev.topk(model) == got  # the counters restart every evaluation


# ------------------------------------------------------------------ trainer


def _tiny_configs(model_dir, **over):
    kw = dict(dict(model_dir=model_dir, max_epochs=2, train_batch_size=32,
                   test_batch_size=64, steps_per_call=4, eval_freq=8,
                   display_freq=4, summary_freq=4, best_after_step=0,
                   learning_rate=0.5, save_auc_gate=0.0), **over)
    return TrainConfig(**kw), kw


def _records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_matches_jax_trainer(tmp_path):
    """Two epochs of the port's Trainer on synthetic() against the JAX
    Trainer (plain FWA, dense updates) from the same initial parameters:
    chunk losses within 1e-5 relative, AUC within one test user, the final
    parameters within 1e-4."""
    train, test, cate_list = synthetic()
    tc, kw = _tiny_configs(str(tmp_path / "torch"))
    jtc = JaxTrainConfig(**dict(kw, model_dir=str(tmp_path / "jax"),
                                sparse_updates=False))
    jtr = JaxTrainer(JaxTLSAN, JaxModelConfig(**CFG), jtc, cate_list, train,
                     test, use_pallas=False)
    tr = Trainer(TLSAN, ModelConfig(**CFG), tc, cate_list, train, test,
                 device="cpu")
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params),
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
    assert len([r for r in got if r["kind"] == "train"]) == 4
    _assert_trees_close(params_to_numpy(tr.model),
                        jax.tree_util.tree_map(np.asarray, jtr.params),
                        1e-4, 1e-4, "param ")
    assert tr.opt_state.count == tr.step == 16
    # the train writer got the reference's histogram tags
    payloads = [p for f in os.listdir(os.path.join(tc.model_dir, "train"))
                for p in tb.read_records(os.path.join(tc.model_dir, "train", f))]
    assert any(b"embedding/1_item_emb" in p and b"attention_output" in p
               for p in payloads)


def test_histogram_digest_matches_host_digest(tmp_path):
    """The device-side digest of a table (sort + searchsorted) equals the
    host reference histo_digest_np: min, max, count, sums and bucket counts."""
    train, test, cate_list = synthetic()
    tc, _ = _tiny_configs(str(tmp_path / "d"))
    tr = Trainer(TLSAN, ModelConfig(**CFG), tc, cate_list, train, test,
                 device="cpu")
    x = tr.model.item_emb.detach()
    got = tr._digest(x).numpy().astype(np.float64)
    want = tb.histo_digest_np(x.numpy())
    np.testing.assert_allclose(got[:5], want[:5], rtol=1e-6)
    np.testing.assert_array_equal(got[5:], want[5])
    tr.close()


def test_resume_is_bit_exact(tmp_path):
    """A second Trainer on the same model_dir restores the step, the
    schedule count and the parameters bit for bit, and its evaluation
    equals the last saved one."""
    train, test, cate_list = synthetic()
    tc, _ = _tiny_configs(str(tmp_path / "r"), max_epochs=1, lr_drop_step=6)
    tr = Trainer(TLSAN, ModelConfig(**CFG), tc, cate_list, train, test,
                 device="cpu")
    tr.train()
    tr.close()
    final = [r for r in _records(tc.model_dir) if r["kind"] == "final"][-1]
    tr2 = Trainer(TLSAN, ModelConfig(**CFG),
                  dataclasses.replace(tc, from_scratch=False), cate_list,
                  train, test, device="cpu")
    assert tr2.step == tr.step == 8 and tr2.opt_state.count == 8
    for (name, a), b in zip(tr.model.state_dict().items(),
                            tr2.model.state_dict().values()):
        assert torch.equal(a, b), name
    again = tr2.evaluate()
    assert again == {k: v for k, v in final.items()
                     if k not in ("kind", "step", "wall_s")}
    # the resumed schedule is past the drop: lr × 0.1
    assert tr2.opt.schedule(tr2.opt_state.count) == state.lr_schedule(tc)(6)
    tr2.close()


def test_checkpoint_round_trip_keeps_opt_state(tmp_path):
    _, tree = _init_tree()
    model = params_from_numpy(tree, ModelConfig(**CFG), "cpu")
    path = checkpoint.save(str(tmp_path), "tlsan", 123, model, {"count": 123},
                           ModelConfig(**CFG))
    other = TLSAN(ModelConfig(**CFG), "cpu")
    step, _, opt_state = checkpoint.restore(path, other)
    assert step == 123 and opt_state == {"count": 123}
    for a, b in zip(_tree_items(params_to_numpy(other)), _tree_items(tree)):
        assert a[0] == b[0] and a[1].tobytes() == b[1].tobytes()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    train, test, cate_list = synthetic(n=64)
    # sparse updates and bf16 are ported (tests/test_torch_sparse.py,
    # tests/test_torch_bf16.py); a dtype the port does not know raises
    for over in (dict(sparse_updates=True), dict(compute_dtype="bfloat16")):
        tc, _ = _tiny_configs(str(tmp_path / "x"), **over)
        tr = Trainer(TLSAN, ModelConfig(**CFG), tc, cate_list, train, test,
                     device="cpu")
        assert tr._use_sparse == bool(tc.sparse_updates)
        assert tr.bf16 == (tc.compute_dtype == "bfloat16")
        tr.close()
    tc, _ = _tiny_configs(str(tmp_path / "x"), compute_dtype="fp16")
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(TLSAN, ModelConfig(**CFG), tc, cate_list, train, test,
                device="cpu")
    # the mesh is ported (tests/test_torch_mesh.py), and needs its world
    tc, _ = _tiny_configs(str(tmp_path / "x"), dp=2)
    with pytest.raises(RuntimeError, match="initialized process group"):
        Trainer(TLSAN, ModelConfig(**CFG), tc, cate_list, train, test,
                device="cpu")
    if not torch.cuda.is_available():  # the default device is cuda
        tc, _ = _tiny_configs(str(tmp_path / "y"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(TLSAN, ModelConfig(**CFG), tc, cate_list, train, test)


# -------------------------------------------------------------- tensorboard


def test_tfevents_copy_reads_back_and_matches_jax_bytes(tmp_path):
    w = tb.TBEventWriter(str(tmp_path))
    w.add_scalars(7, {"auc": 0.75, "loss": 1.5})
    w.add_histograms(7, {"t": tb.histo_digest_np(np.arange(10.0))})
    w.close()
    payloads = list(tb.read_records(w.path))
    assert len(payloads) == 3  # file version, scalars, histograms
    _, step, scalars = tb.decode_scalar_event(payloads[1])
    assert step == 7 and scalars == {"auc": 0.75, "loss": 1.5}
    assert tb.encode_scalar_event(7, 1.0, {"auc": 0.75}) == \
        jax_tb.encode_scalar_event(7, 1.0, {"auc": 0.75})
    digest = tb.histo_digest_np(np.linspace(-2, 3, 50))
    assert tb.encode_histo_event(3, 2.0, {"h": digest}) == \
        jax_tb.encode_histo_event(3, 2.0, {"h": digest})
