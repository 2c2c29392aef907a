"""Dropout in the PyTorch port against the JAX package, on the CPU.

  - Op by op: the masks JAX draws (``k1, k2 = jax.random.split(rng)`` and
    ``jax.random.bernoulli(k, 1 - rate, shape)``, tlsan_tpu/nn/layers.py and
    ops/feature_attention.py; one draw of the probabilities' shape for
    MHA) handed to the port's plain versions: the outputs equal the JAX
    functions with that rng within 1e-6, every gradient leaf within 1e-5,
    and K2's plain version (fwa_backward_reference, the card's oracle)
    equals jax.vjp within 1e-5.
  - Statistics: the same generator state draws the same masks bit for bit;
    the keep share lies within 5 binomial deviations of 1 − rate; without
    a generator every dropout family (TLSAN, ATRank, CNN, CSAN, PACA)
    evaluates exactly as at rate 0 (tests/test_all_models.py:157).
  - The mask sources of nn/layers.py: a mesh rank's rows of the global
    masks, masks handed out in order, the recorded draw shapes.
  - The mesh: a dp = 2 Gloo world of CPU ranks with dropout 0.1 takes 20
    steps as one process does (TLSAN and ATRank), to the mesh tolerance of
    tests/test_torch_family_mesh.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_atrank import _train_data as atrank_train_data
from tests.test_torch_families import _setup as family_setup
from tests.test_torch_families import _torch
from tests.test_train import synthetic
from tlsan_tpu.ops import feature_attention as jax_fa
from tlsan_tpu.ops import multihead_attention as jax_mha
from tlsan_tpu.models.atrank import _attn_params
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.nn.layers import (
    GivenMasks,
    RecordedShapes,
    RowShardMasks,
    draw_keep,
    dropout,
)
from tlsan_tpu_torch.ops.feature_attention import (
    draw_masks,
    feature_wise_attention,
    feature_wise_attention_reference,
    fwa_backward_reference,
)
from tlsan_tpu_torch.ops.multihead_attention import (
    draw_mask,
    multihead_attention,
    multihead_attention_reference,
)
from tlsan_tpu_torch.parallel import programs
from tlsan_tpu_torch.parallel.multihost import run_local
from tlsan_tpu_torch.train.loop import Trainer

D, H = 64, 8
VALUE_TOL, GRAD_TOL = 1e-6, 1e-5
MESH_TOL = 1e-5  # tests/test_torch_family_mesh.py: losses; states rtol 1e-4
WORLD_TIMEOUT_S = 120
RATES = [0.1, 0.5]


def _fwa_inputs(B, S, seed):
    rng = np.random.default_rng(seed)
    dh = D // H
    lengths = rng.integers(0, S + 1, B).astype(np.int32)
    lengths[:3] = [0, 1, S]
    return [rng.normal(size=(B, S, D)).astype(np.float32), lengths,
            (rng.normal(size=(dh, dh)) * 0.3).astype(np.float32),
            (rng.normal(size=dh) * 0.1).astype(np.float32),
            (rng.normal(size=(dh, dh)) * 0.3).astype(np.float32),
            (rng.normal(size=dh) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("S", [10, 25])
def test_fwa_with_jax_masks_matches_jax(S, rate):
    """FWA at the towers' lengths: values, every gradient leaf, and K2's
    plain version against jax.vjp of the JAX reference with the same rng."""
    B = 6
    x, lengths, w1, b1, w2, b2 = _fwa_inputs(B, S, seed=S + int(10 * rate))
    g = np.random.default_rng(S).normal(size=(B, D)).astype(np.float32)
    rng = jax.random.PRNGKey(S + int(100 * rate))
    k1, k2 = jax.random.split(rng)
    shape = (B, S, H, D // H)
    masks = tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 1 - rate, shape)))
                  for k in (k1, k2))

    def jax_fn(x, w1, b1, w2, b2):
        return jax_fa.feature_wise_attention_reference(
            x, jnp.asarray(lengths), H, w1, b1, w2, b2, dropout_rate=rate, rng=rng)

    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (x, w1, b1, w2, b2)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w1, b1, w2, b2)]
    got = feature_wise_attention_reference(leaves[0], torch.from_numpy(lengths), H,
                                           *leaves[1:], dropout_rate=rate,
                                           keep_masks=masks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=VALUE_TOL, atol=VALUE_TOL)
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    closed = fwa_backward_reference(*(torch.from_numpy(a) for a in (x, lengths)), H,
                                    *(torch.from_numpy(a) for a in (w1, b1, w2, b2)),
                                    torch.from_numpy(g), keep_masks=masks,
                                    dropout_rate=rate)
    for name, a, c, w in zip(("x", "w1", "b1", "w2", "b2"), got_grads, closed, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"autograd {name}")
        np.testing.assert_allclose(c.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"closed form {name}")
    # the dropped path differs from the undropped one
    assert not np.allclose(np.asarray(want), np.asarray(jax_fa.feature_wise_attention_reference(
        jnp.asarray(x), jnp.asarray(lengths), H, *map(jnp.asarray, (w1, b1, w2, b2)))))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("Tq,Tk", [(96, 96), (1, 96)])
def test_mha_with_jax_mask_matches_jax(Tq, Tk, rate):
    """MHA at ATRank's self-attention (96, 96) and readout (1, 96): values
    and every gradient leaf against the JAX function with the same rng."""
    B = 4
    rs = np.random.default_rng(Tq + int(10 * rate))
    q = rs.normal(size=(B, Tq, D)).astype(np.float32)
    k = q if Tq == Tk else rs.normal(size=(B, Tk, D)).astype(np.float32)
    q_len = rs.integers(0, Tq + 1, B).astype(np.int32)
    k_len = q_len if Tq == Tk else rs.integers(0, Tk + 1, B).astype(np.int32)
    q_len[0] = Tq
    k_len[1] = 0
    p = {n: np.asarray(v) for n, v in _attn_params(jax.random.PRNGKey(Tq), D).items()}
    names = sorted(p)
    g = rs.normal(size=(B, Tq, D)).astype(np.float32)
    rng = jax.random.PRNGKey(Tq + int(100 * rate))
    mask = torch.from_numpy(np.array(
        jax.random.bernoulli(rng, 1 - rate, (B, H, Tq, Tk))))

    def jax_fn(q, k, *ws):
        return jax_mha.multihead_attention(q, jnp.asarray(q_len), k, jnp.asarray(k_len),
                                           H, dict(zip(names, ws)), dropout_rate=rate,
                                           rng=rng)[0]

    want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k),
                        *(jnp.asarray(p[n]) for n in names))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, *(p[n] for n in names))]
    got, _ = multihead_attention_reference(
        leaves[0], torch.from_numpy(q_len), leaves[1], torch.from_numpy(k_len), H,
        dict(zip(names, leaves[2:])), rate, keep_mask=mask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=VALUE_TOL, atol=VALUE_TOL)
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for name, a, w in zip(["q", "k", *names], got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------- statistics


@pytest.mark.parametrize("rate", RATES)
def test_same_state_same_masks_and_keep_share(rate):
    """Two draws from one generator state are equal bit for bit, for FWA's
    two masks and MHA's one, through the dispatchers as through the plain
    versions; each mask keeps 1 − rate of its entries within 5 binomial
    deviations; a fresh state draws other masks."""
    x = torch.randn(32, 25, D, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    first = draw_masks(x, H, rate, gen)
    gen.set_state(state)
    second = draw_masks(x, H, rate, gen)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert not torch.equal(first[0], first[1])
    gen.set_state(state)
    mha_first = draw_mask(x, x, H, rate, gen)
    assert mha_first.shape == (32, H, 25, 25)
    for mask in (*first, mha_first):
        n, keep = mask.numel(), 1.0 - rate
        share = float(mask.float().mean())
        assert abs(share - keep) <= 5 * (keep * (1 - keep) / n) ** 0.5, share
    # the dispatcher draws exactly what the plain version draws
    args = (x, torch.full((32,), 20, dtype=torch.int32), H,
            *(torch.randn(s, generator=torch.Generator().manual_seed(1)) * 0.3
              for s in ((8, 8), (8,), (8, 8), (8,))))
    gen.set_state(state)
    a = feature_wise_attention(*args, rate, gen)
    gen.set_state(state)
    b = feature_wise_attention_reference(*args, dropout_rate=rate, generator=gen)
    assert torch.equal(a, b)


def test_dropout_by_mask_equals_dropout_by_generator():
    """`dropout` with a generator is `apply_keep` of the mask that
    `draw_keep` draws from the same state, bit for bit; a mask given
    directly wins over the generator; rate 0 is the identity."""
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    a = dropout(x, 0.3, gen)
    gen.set_state(state)
    mask = draw_keep(gen, x.shape, 0.7, x.device)
    assert torch.equal(a, dropout(x, 0.3, None, mask))
    assert torch.equal(a, torch.where(mask, x / 0.7, torch.zeros_like(x)))
    assert torch.equal(dropout(x, 0.0, gen), x) and torch.equal(dropout(x, 0.3), x)


def test_mask_sources():
    """RowShardMasks: rank d of dp draws the global batch's mask and keeps
    its rows, so the ranks' rows together are one process's mask;
    GivenMasks hands masks out in order and refuses a wrong shape or an
    extra draw; RecordedShapes keeps all and records the shapes."""
    shape = (4, 3, 2)
    whole = draw_keep(torch.Generator().manual_seed(5), (8, 3, 2), 0.6, "cpu")
    parts = [RowShardMasks(torch.Generator().manual_seed(5), 2, d).draw(shape, 0.6, "cpu")
             for d in range(2)]
    assert torch.equal(torch.cat(parts), whole)
    m1, m2 = whole[:4], whole[4:]
    given = GivenMasks([m1, m2])
    assert given.draw(shape, 0.6, "cpu") is m1
    with pytest.raises(RuntimeError, match="asked for"):
        given.draw((4, 3), 0.6, "cpu")
    with pytest.raises(RuntimeError, match="no dropout mask left"):
        given.draw(shape, 0.6, "cpu")
    rec = RecordedShapes()
    assert rec.draw(shape, 0.6, "cpu").all() and rec.draw((2,), 0.6, "cpu").all()
    assert rec.shapes == [shape, (2,)]


DROPOUT_FAMILIES = ["tlsan", "atrank", "cnn", "csan", "paca"]


def _family_model(name, rate, seed=3):
    """(model at `rate`, cate_list, batch) of the family: the baselines at
    tests/test_torch_families.py's sizes, TLSAN and ATRank from the JAX
    init at theirs."""
    if name in ("cnn", "csan", "paca"):
        _, _, _, model, cate_list, batch = family_setup(name, seed=seed, dropout=rate)
        return model, torch.from_numpy(cate_list), _torch(batch)
    from tests.test_torch_atrank import CFG as ATRANK_CFG
    from tests.test_torch_train import CFG as TLSAN_CFG
    from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
    from tlsan_tpu.models import get_model as jax_get_model
    from tlsan_tpu_torch.tools.params import params_from_numpy

    kw = dict(TLSAN_CFG if name == "tlsan" else ATRANK_CFG, dropout=rate)
    tree = jax.tree_util.tree_map(np.asarray, jax_get_model(name).init_params(
        jax.random.PRNGKey(seed), JaxModelConfig(**kw)))
    model = params_from_numpy(tree, ModelConfig(**kw), "cpu")
    if name == "tlsan":
        train, _, cate_list = synthetic(n=64)
    else:
        train, _ = atrank_train_data(64, 8, seed=seed)
        cate_list = np.random.default_rng(seed).integers(
            0, kw["cate_count"], kw["item_count"]).astype(np.int32)
    batch = {k: torch.from_numpy(v[:16]) for k, v in train.arrays.items()}
    return model, torch.from_numpy(cate_list), batch


@pytest.mark.parametrize("name", DROPOUT_FAMILIES)
def test_eval_without_generator_equals_rate_zero(name):
    """Without a generator a model at dropout 0.3 computes exactly what it
    computes at rate 0 (eval logits and loss); with one the loss moves, and
    the same seed gives the same loss."""
    model, cl, batch = _family_model(name, 0.3)
    model0, _, _ = _family_model(name, 0.0)
    with torch.no_grad():
        assert torch.equal(model.eval_logits(batch, cl), model0.eval_logits(batch, cl))
        assert torch.equal(model.loss(batch, cl), model0.loss(batch, cl))
        l1 = model.loss(batch, cl, torch.Generator().manual_seed(1))
        again = model.loss(batch, cl, torch.Generator().manual_seed(1))
    assert torch.equal(l1, again) and not torch.equal(l1, model.loss(batch, cl))


# ---------------------------------------------------------------------- mesh

MESH_DP, MESH_STEPS = 2, 20


def _mesh_family(name):
    from tests.test_torch_atrank import CFG as ATRANK_CFG
    from tests.test_torch_train import CFG as TLSAN_CFG

    if name == "tlsan":
        train, test, cate_list = synthetic(n=256)
        kw = TLSAN_CFG
    else:
        kw = ATRANK_CFG
        train, test = atrank_train_data(256, 64, seed=12)
        cate_list = np.random.default_rng(2).integers(
            0, kw["cate_count"], kw["item_count"]).astype(np.int32)
    return (ModelConfig(**dict(kw, dropout=0.1)),
            Batches(dict(train.arrays), train.n), Batches(dict(test.arrays), test.n),
            cate_list)


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """One dp = 2 world: per family a Trainer from the seed takes the same
    20 global batches with dropout 0.1 (programs.chunk_program)."""
    tmp = tmp_path_factory.mktemp("dropout_mesh")
    jobs, idx = [], {}
    for name in ("tlsan", "atrank"):
        cfg, train, test, cate_list = _mesh_family(name)
        idx[name] = np.random.default_rng(4).integers(
            0, train.n, (MESH_STEPS, 32)).astype(np.int64)
        tc = TrainConfig(model_dir=str(tmp / name), dp=MESH_DP, mp=1,
                         learning_rate=0.1, train_batch_size=32, test_batch_size=32,
                         tb_histograms=False, sparse_updates=False)
        jobs.append((programs.chunk_program, dict(
            cfg=cfg, tc=tc, cate_list=cate_list, train=train, test=test,
            idx=idx[name])))
    init = "file://" + str(tmp / "rendezvous")
    got = run_local(programs.sequence, MESH_DP, 1, "gloo", "cpu", WORLD_TIMEOUT_S,
                    *jobs, init_method=init)
    return got, idx, tmp


@pytest.mark.parametrize("name", ["tlsan", "atrank"])
def test_mesh_dropout_equals_one_process(mesh_world, name, tmp_path):
    """Each rank draws the global batch's masks and keeps its rows, so the
    dp = 2 world's 20 losses and final weights equal one process's (which
    draws the same masks for the whole batch) with dropout 0.1."""
    got, idx, _ = mesh_world
    r = got[0][["tlsan", "atrank"].index(name)]
    cfg, train, test, cate_list = _mesh_family(name)
    tc = TrainConfig(model_dir=str(tmp_path / name), learning_rate=0.1,
                     train_batch_size=32, test_batch_size=32, tb_histograms=False,
                     sparse_updates=False)
    tr = Trainer(get_model(name), cfg, tc, cate_list, train, test, device="cpu")
    losses = tr._train_chunk(torch.from_numpy(idx[name])).numpy()
    np.testing.assert_allclose(r["losses"], losses, rtol=MESH_TOL, atol=MESH_TOL)
    state = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    for k, v in state.items():
        np.testing.assert_allclose(r["state"][k], v, rtol=1e-4, atol=MESH_TOL,
                                   err_msg=f"{name} {k}")
    tr.close()
