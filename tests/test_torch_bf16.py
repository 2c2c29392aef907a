"""bf16 mixed precision in the PyTorch port, on the CPU: for all nine
families the bf16 loss and global gradient norm against the port's own
f32 (the bounds of tests/test_bf16.py:55, :63) and the bf16 loss against
the JAX package's bf16 loss; f32 master parameters and gradients, the L2
accumulated in f32; the attention dispatchers' casts; the bf16 Trainer on
the dense and the sparse step; and the gather backward modes (`onehot`
against `take`).  Inputs come from tests/test_all_models.py's seeded
batches; parameters cross over through tools/params.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_all_models import ALL_MODELS, CATES, ITEMS, make_batch
from tests.test_bf16 import _cfg as jax_cfg
from tests.test_torch_sparse import single_thread  # noqa: F401 (autouse)
from tests.test_torch_train import CFG as TLSAN_CFG
from tests.test_train import synthetic
from tlsan_tpu.models import get_model as jax_get_model
from tlsan_tpu.train.state import bf16_cast as jax_bf16_cast
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.models import base, get_model
from tlsan_tpu_torch.nn import embedding
from tlsan_tpu_torch.ops.feature_attention import feature_wise_attention
from tlsan_tpu_torch.ops.multihead_attention import multihead_attention
from tlsan_tpu_torch.tools.params import params_from_numpy
from tlsan_tpu_torch.train import sparse, state
from tlsan_tpu_torch.train.loop import Trainer


def _setup(name, seed=0):
    """(JAX model, its config, its params, the port's model holding the
    same values, cate_list, JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    jcfg = jax_cfg(name)
    jmodel = jax_get_model(name)
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              ModelConfig(**{f: getattr(jcfg, f) for f in (
                                  "model", "user_count", "item_count", "cate_count",
                                  "Ls", "Ts", "max_length", "cnn_pad_length",
                                  "paca_max_len", "hidden_units")}), "cpu")
    cate_list = rng.integers(0, CATES, ITEMS).astype(np.int32)
    jbatch = make_batch(name, rng)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in jbatch.items()}
    return jmodel, jcfg, params, model, cate_list, jbatch, batch


def _loss_and_grads(model, batch, cate_list, bf16: bool):
    model.zero_grad(set_to_none=True)
    params = dict(model.named_parameters())
    if bf16:
        loss = sparse.call_with(model, "loss", state.bf16_cast(params),
                                state.bf16_cast(batch), torch.from_numpy(cate_list))
    else:
        loss = model.loss(batch, torch.from_numpy(cate_list))
    loss.backward()
    return loss.detach(), [p.grad for p in model.parameters() if p.grad is not None]


@pytest.mark.parametrize("name", ALL_MODELS)
def test_bf16_loss_and_grads_close_to_f32(name):
    """The network on bf16 copies: loss within bf16 rounding of the f32
    loss (rtol 0.05, atol 0.02), the global gradient norm within rtol
    0.15, atol 1e-3; the loss head, every gradient and the masters f32."""
    _, _, _, model, cate_list, _, batch = _setup(name)
    l32, g32 = _loss_and_grads(model, batch, cate_list, False)
    l16, g16 = _loss_and_grads(model, batch, cate_list, True)
    assert l16.dtype == torch.float32 and torch.isfinite(l16)
    np.testing.assert_allclose(float(l16), float(l32), rtol=0.05, atol=0.02)
    assert g16 and all(g.dtype == torch.float32 for g in g16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    gn32, gn16 = float(state.global_norm(g32)), float(state.global_norm(g16))
    assert np.isfinite(gn16)
    np.testing.assert_allclose(gn16, gn32, rtol=0.15, atol=1e-3)


@pytest.mark.parametrize("name", ALL_MODELS)
def test_bf16_loss_matches_jax_bf16(name):
    """The port's bf16 loss against the JAX package's bf16 loss (its
    bf16_cast of params and batch, the plain path) within rtol 2e-2,
    atol 1e-2: the port's attention runs f32 between casts, JAX's in
    bf16, so the two round differently."""
    jmodel, jcfg, params, model, cate_list, jbatch, batch = _setup(name, seed=1)
    want = jmodel.loss(jax_bf16_cast(params), jax_bf16_cast(jbatch),
                       jnp.asarray(cate_list), jcfg, False)
    got, _ = _loss_and_grads(model, batch, cate_list, True)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2, atol=1e-2)


def test_l2_tables_accumulates_in_f32():
    """A large bf16 table's sum of squares is accumulated in f32 (a bf16
    sum would lose the L2 term), as tests/test_bf16.py:66-76 pins."""
    x = np.random.default_rng(0).normal(0.1, 0.05, (200_000,)).astype(np.float32)
    want = 0.5 * float(np.sum(np.square(x.astype(np.float64))))
    got16 = base.l2_tables(torch.from_numpy(x).to(torch.bfloat16))
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(float(got16), want, rtol=2e-2)
    np.testing.assert_allclose(float(base.l2_tables(torch.from_numpy(x))), want,
                               rtol=1e-5)
    rows = torch.from_numpy(x.reshape(-1, 8)).to(torch.bfloat16)
    valid = torch.ones(rows.shape[0], dtype=torch.bool)
    assert base.batch_l2(valid, rows).dtype == torch.float32


def test_attention_dispatchers_run_bf16_as_f32():
    """A bf16 input runs the f32 plain version on the f32 copies and comes
    back bf16; its gradient reaches the bf16 leaves."""
    rng = np.random.default_rng(0)
    B, S, D, H = 3, 5, 16, 4
    x = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32))
    lens = torch.tensor([0, 2, 5], dtype=torch.int32)
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3)
         for s in ((4, 4), (4,), (4, 4), (4,))]
    got = feature_wise_attention(x.bfloat16(), lens, H, *(t.bfloat16() for t in w))
    want = feature_wise_attention(x.bfloat16().float(), lens, H,
                                  *(t.bfloat16().float() for t in w))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())
    p = {k: torch.from_numpy(rng.normal(size=(D, D) if k[0] == "w" else (D,))
                             .astype(np.float32) * 0.2)
         for k in ("wq", "bq", "wk", "bk", "wv", "bv", "ln_gamma", "ln_beta")}
    q = x.bfloat16().requires_grad_(True)
    out = multihead_attention(q, lens, q, lens, H, {k: v.bfloat16() for k, v in p.items()})
    ref = multihead_attention(q.detach().float(), lens, q.detach().float(), lens, H,
                              {k: v.bfloat16().float() for k, v in p.items()})
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref.bfloat16())
    out.float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and torch.isfinite(q.grad.float()).all()


@pytest.mark.parametrize("use_sparse", [False, True])
def test_bf16_trainer_keeps_f32_masters_and_learns(tmp_path, use_sparse):
    """A bf16 Trainer (dense and touched-row) keeps f32 masters, its loss
    falls over five epochs' chunks, and its first chunk stays within bf16
    noise of the f32 Trainer's (tests/test_bf16.py:103-131)."""
    train, test, cate_list = synthetic()
    cfg = ModelConfig(**TLSAN_CFG)

    def make(dtype, tag):
        tc = TrainConfig(model_dir=str(tmp_path / tag), max_epochs=2,
                         train_batch_size=32, test_batch_size=64, steps_per_call=4,
                         eval_freq=10**9, best_after_step=0, learning_rate=0.5,
                         compute_dtype=dtype, sparse_updates=use_sparse)
        return Trainer(get_model("tlsan"), cfg, tc, cate_list, train, test,
                       device="cpu")

    tr16, tr32 = make("bfloat16", "bf16"), make("float32", "f32")
    idx = torch.from_numpy(tr16._epoch_index(0)[0])
    l16, l32 = tr16._train_chunk(idx).mean(), tr32._train_chunk(idx).mean()
    np.testing.assert_allclose(float(l16), float(l32), rtol=0.05, atol=0.02)
    losses = [float(l16)]
    for epoch in range(5):
        for chunk in tr16._epoch_index(epoch):
            losses.append(float(tr16._train_chunk(torch.from_numpy(chunk)).mean()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in tr16.model.parameters())
    rows, l2 = tr16._summaries(idx[-1])  # the summary's forward runs bf16
    assert torch.isfinite(rows).all() and float(l2) > 0
    assert tr16._use_sparse == use_sparse


# ------------------------------------------------------------ gather backward


def _table_ids_cot(V=500, D=16, rows=2048, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, V, (rows // 32, 32)).astype(np.int32)),
            torch.from_numpy(rng.standard_normal((rows // 32, 32, D)).astype(np.float32)))


def _grad(table, ids, cot, mode):
    t = table.clone().requires_grad_(True)
    with embedding.gather_bwd(mode):
        rows = embedding.lookup(t, ids)
        fn = rows.grad_fn
        (rows * cot).sum().backward()
    return rows.detach(), t.grad, fn


def test_onehot_gather_backward_matches_take():
    """The one-hot product backward against the index backward within
    1e-6 relative to the gradient's scale (tests/test_gather_bwd.py:47-57);
    the forward is the same gather; auto is take off a TPU; the onehot
    mode runs the OneHotGather backward, take and auto do not."""
    table, ids, cot = _table_ids_cot()
    f_take, g_take, fn_take = _grad(table, ids, cot, "take")
    f_oh, g_oh, fn_oh = _grad(table, ids, cot, "onehot")
    f_auto, g_auto, fn_auto = _grad(table, ids, cot, "auto")
    assert torch.equal(f_take, f_oh) and torch.equal(f_take, f_auto)
    scale = float(g_take.abs().max())
    assert float((g_take - g_oh).abs().max()) <= 1e-6 * max(scale, 1.0)
    assert torch.equal(g_auto, g_take)
    assert "OneHotGather" in type(fn_oh).__name__
    assert "OneHotGather" not in type(fn_take).__name__
    assert "OneHotGather" not in type(fn_auto).__name__
    bias = table[:, 0].clone().requires_grad_(True)  # a [V] table keeps take
    with embedding.gather_bwd("onehot"):
        assert "OneHotGather" not in type(embedding.lookup(bias, ids).grad_fn).__name__
    with pytest.raises(ValueError, match="gather_bwd"):
        with embedding.gather_bwd("matmul"):
            pass


def test_onehot_gather_backward_bf16_dtype():
    """In bf16 the one-hot backward returns the table's dtype, accumulated
    in f32 (tests/test_bf16.py:79-97)."""
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32)).bfloat16()
    table.requires_grad_(True)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 32, 2048))
    with embedding.gather_bwd("onehot"):
        (embedding.lookup(table, ids) * 2.0).sum().backward()
    assert table.grad.dtype == torch.bfloat16
    counts = np.bincount(ids.numpy(), minlength=32).astype(np.float32)
    np.testing.assert_allclose(table.grad.float().numpy(),
                               2.0 * counts[:, None] @ np.ones((1, 8)), rtol=2e-2)


@pytest.mark.parametrize("name", ["tlsan", "atrank", "bpr"])
def test_family_grads_under_onehot_equal_take(name):
    """Every gradient leaf of a family's loss under gather_bwd('onehot')
    agrees with 'take' to f32 summation order."""
    _, _, _, model, cate_list, _, batch = _setup(name)
    got = {}
    for mode in ("take", "onehot"):
        model.zero_grad(set_to_none=True)
        with embedding.gather_bwd(mode):
            model.loss(batch, torch.from_numpy(cate_list)).backward()
        got[mode] = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
    for n, g in got["take"].items():
        np.testing.assert_allclose(got["onehot"][n].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
