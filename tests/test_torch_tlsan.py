"""TLSAN in the PyTorch port against the JAX TLSAN, from one JAX init
carried across by the weights bridge (tools/params.py): user_repr,
eval_logits, pair_logits and attention_maps, against both branches of the
JAX item_cate_lookup (the port has one, the fused table), plus twins of the
tests/test_tlsan_model.py invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tlsan_tpu.nn.embedding as jax_embedding
import tlsan_tpu_torch.nn.embedding as torch_embedding
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.models.tlsan import TLSAN as JaxTLSAN
from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.tools.params import params_from_numpy, params_to_numpy

USERS, ITEMS, CATES, LS, TS, B = 21, 29, 5, 10, 8, 7
TOL = 1e-5
CFG = dict(model="tlsan", user_count=USERS, item_count=ITEMS,
           cate_count=CATES, Ls=LS, Ts=TS)
JCFG = JaxModelConfig(**CFG)


@pytest.fixture(scope="module")
def setup():
    jparams = JaxTLSAN.init_params(jax.random.PRNGKey(0), JCFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = ModelConfig(**CFG)
    model = params_from_numpy(tree, cfg, "cpu")
    rng = np.random.default_rng(1)
    batch = {
        "u": rng.integers(0, USERS, B).astype(np.int32),
        "c": rng.integers(0, CATES, B).astype(np.int32),
        "i": rng.integers(0, ITEMS, B).astype(np.int32),
        "j": rng.integers(0, ITEMS, B).astype(np.int32),
        "hist_i": rng.integers(0, ITEMS, (B, LS)).astype(np.int32),
        "hist_t": rng.uniform(0.1, 1.0, (B, LS)).astype(np.float32),
        "hist_i_new": rng.integers(0, ITEMS, (B, TS)).astype(np.int32),
        # 0-length rows: what a zero-padded partial serving batch sends
        "sl": np.array([0, 1, LS, 3, 7, 2, 9], np.int32),
        "sl_new": np.array([0, TS, 1, 4, 2, 6, 3], np.int32),
    }
    cate_list = rng.integers(0, CATES, ITEMS).astype(np.int32)
    return jparams, tree, cfg, model, batch, cate_list


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(params=["fused", "per_table"])
def lookup_branch(request, monkeypatch):
    """Both branches of the JAX item_cate_lookup, each against the port's
    one path."""
    if request.param == "per_table":
        monkeypatch.setattr(jax_embedding, "FUSED_ITEM_CATE_MAX_V", 0)
    return request.param


def test_bridge_round_trip_is_exact(setup):
    _, tree, cfg, model, _, _ = setup
    back = params_to_numpy(model)
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert get_model("tlsan") is TLSAN


def test_item_cate_lookup_branches_bitwise_equal(setup):
    """The fused-table gather equals the per-table gathers, bit for bit."""
    _, _, _, model, batch, cate_list = setup
    ids = torch.from_numpy(batch["hist_i"])
    cl = torch.from_numpy(cate_list)
    fused = torch_embedding.item_cate_lookup(model.item_emb, model.cate_emb,
                                             ids, cl)
    want = torch.cat([model.item_emb[ids.long()],
                      model.cate_emb[cl[ids.long()].long()]], dim=-1)
    assert torch.equal(fused, want)


@torch.no_grad()
def test_user_repr_matches_jax(setup, lookup_branch):
    jparams, _, cfg, model, batch, cate_list = setup
    want = JaxTLSAN.user_repr(jparams, _jax(batch), jnp.asarray(cate_list),
                              JCFG, use_pallas=False)
    got = model.user_repr(_torch(batch), torch.from_numpy(cate_list))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@torch.no_grad()
def test_eval_and_pair_logits_match_jax(setup, lookup_branch):
    jparams, _, cfg, model, batch, cate_list = setup
    jb, cl = _jax(batch), jnp.asarray(cate_list)
    tb, tcl = _torch(batch), torch.from_numpy(cate_list)
    want = JaxTLSAN.eval_logits(jparams, jb, cl, JCFG, False)
    got = model.eval_logits(tb, tcl)
    assert got.shape == (B, ITEMS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    pos_j, neg_j = JaxTLSAN.pair_logits(jparams, jb, cl, JCFG, False)
    pos_t, neg_t = model.pair_logits(tb, tcl)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(neg_t.numpy(), np.asarray(neg_j), rtol=TOL, atol=TOL)


@torch.no_grad()
def test_attention_maps_match_jax(setup):
    jparams, _, cfg, model, batch, cate_list = setup
    a0_j, a1_j = JaxTLSAN.attention_maps(jparams, _jax(batch),
                                         jnp.asarray(cate_list), JCFG)
    a0_t, a1_t = model.attention_maps(_torch(batch), torch.from_numpy(cate_list))
    np.testing.assert_allclose(a0_t.numpy(), np.asarray(a0_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(a1_t.numpy(), np.asarray(a1_j), rtol=TOL, atol=TOL)


@torch.no_grad()
def test_gamma_scales_long_term(setup):
    """Twin of test_tlsan_model.py::test_gamma_scales_long_term: gamma=0
    zeroes the long-term input, so the output ignores hist_i."""
    _, tree, cfg, _, batch, cate_list = setup
    model = params_from_numpy(dict(tree, gamma=np.float32(0.0)), cfg, "cpu")
    cl = torch.from_numpy(cate_list)
    u0 = model.user_repr(_torch(batch), cl)
    b2 = dict(batch, hist_i=np.zeros_like(batch["hist_i"]))
    u1 = model.user_repr(_torch(b2), cl)
    np.testing.assert_allclose(u0.numpy(), u1.numpy(), rtol=1e-5, atol=1e-6)


@torch.no_grad()
def test_padding_invariance_short_term(setup):
    """Twin of test_tlsan_model.py::test_padding_invariance_short_term:
    session positions at or beyond sl_new are masked out."""
    _, _, _, model, batch, cate_list = setup
    b1 = dict(batch, sl_new=np.full(B, 2, np.int32))
    hist2 = batch["hist_i_new"].copy()
    hist2[:, 2:] = ITEMS - 1
    b2 = dict(b1, hist_i_new=hist2)
    cl = torch.from_numpy(cate_list)
    u1 = model.user_repr(_torch(b1), cl)
    u2 = model.user_repr(_torch(b2), cl)
    np.testing.assert_allclose(u1.numpy(), u2.numpy(), rtol=1e-5, atol=1e-6)


@torch.no_grad()
def test_attention_maps_shapes_and_softmax():
    """Twin of test_tlsan_model.py::test_attention_maps_shapes_and_softmax,
    with a seeded port init."""
    cfg = ModelConfig(model="tlsan", user_count=16, item_count=32,
                      cate_count=4, Ls=10, Ts=8)
    model = TLSAN(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    n = 4
    batch = {
        "u": rng.integers(0, 16, n).astype(np.int32),
        "c": rng.integers(0, 4, n).astype(np.int32),
        "hist_i": rng.integers(0, 32, (n, 10)).astype(np.int32),
        "hist_t": rng.uniform(0.1, 1, (n, 10)).astype(np.float32),
        "hist_i_new": rng.integers(0, 32, (n, 8)).astype(np.int32),
        "sl": np.array([3, 10, 1, 7], np.int32),
        "sl_new": np.array([2, 8, 1, 4], np.int32),
    }
    cate_list = torch.from_numpy(rng.integers(0, 4, 32).astype(np.int32))
    att0, att1 = model.attention_maps(_torch(batch), cate_list)
    H, dh = cfg.num_heads, 64 // cfg.num_heads
    assert att0.shape == (n, 10, H, dh)
    assert att1.shape == (n, 8 + 1, H, dh)
    np.testing.assert_allclose(att0.sum(dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(att1.sum(dim=1).numpy(), 1.0, rtol=1e-5)
    assert float(att0[0, 3:].max()) < 1e-6


@torch.no_grad()
def test_init_params_distribution():
    """Port init: JAX's distributions (glorot bounds, constants), drawn from
    an explicit generator, reproducible from its seed."""
    cfg = ModelConfig(**CFG)
    a = TLSAN(cfg, "cpu").init_params(torch.Generator().manual_seed(3))
    b = TLSAN(cfg, "cpu").init_params(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    limit = np.sqrt(6.0 / (ITEMS + cfg.itemid_embedding_size))
    assert float(a.item_emb.abs().max()) <= limit
    assert float(a.gamma) == 1.0 and bool((a.usert_emb == -1.0).all())
    assert float(a.long[0]["proj_b"].abs().max()) == 0.0


def test_unported_family_names_its_roadmap_item():
    """All nine families resolve, each to the class of its name; an
    unknown name raises KeyError, as in the JAX package."""
    for name in ("tlsan", "shan", "atrank", "bpr", "lspm", "paca", "cnn",
                 "bilstm", "csan"):
        assert get_model(name).name == name
    with pytest.raises(KeyError):
        get_model("nope")
