"""The seven baseline families of the PyTorch port (SHAN, PACA, BPR-MF,
LSPM, CNN, Bi-LSTM, CSAN) against the JAX package, on the CPU, at the
sizes of tests/test_all_models.py: the weights bridge, the loss and every
gradient leaf, the pair and catalog logits, determinism and dropout; and
the shared pieces they brought: lstm_scan, reverse_valid, gather_time,
bpr_loss, CNN's short window and SHAN's per-batch width.  Inputs are
numpy-seeded; parameters cross over through tools/params.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _assert_trees_close, _tree_items
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.data.batcher import pack_session_train as jax_pack_session_train
from tlsan_tpu.models import base as jax_base
from tlsan_tpu.models import get_model as jax_get_model
from tlsan_tpu.nn import layers as jax_layers
from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.data.batcher import pack_session_train
from tlsan_tpu_torch.models import base, get_model
from tlsan_tpu_torch.nn import layers
from tlsan_tpu_torch.tools.params import (
    grads_to_numpy,
    params_from_numpy,
    params_to_numpy,
)

USERS, ITEMS, CATES, B, T = 20, 30, 5, 4, 12
FAMILIES = ["shan", "paca", "bpr", "lspm", "cnn", "bilstm", "csan"]
DROPOUT_FAMILIES = ["paca", "cnn", "csan"]
TOL = 1e-5


def cfg_kw(name, **over):
    """The model configuration of tests/test_all_models.py: CSAN at its
    flag table's hidden_units 32."""
    return dict(dict(model=name, user_count=USERS, item_count=ITEMS,
                     cate_count=CATES, Ls=10, Ts=8, max_length=T,
                     cnn_pad_length=20, paca_max_len=T,
                     hidden_units=32 if name == "csan" else 64), **over)


def _left(rng, sl, width, high=ITEMS):
    """Left-aligned ids: row r holds sl[r] ids, zeros after."""
    ids = rng.integers(1, high, (len(sl), width))
    ids[np.arange(width)[None, :] >= sl[:, None]] = 0
    return ids.astype(np.int32)


def make_batch(name, rng, n=B):
    """A numpy batch of the family's layout (tests/test_all_models.py's
    make_batch), with row 0's history empty (sl = 0), and a valid mask
    that drops the last row."""
    batch = {"u": rng.integers(0, USERS, n), "i": rng.integers(0, ITEMS, n),
             "j": rng.integers(0, ITEMS, n),
             "y": rng.integers(0, 2, n).astype(np.float32)}
    if name == "lspm":
        k = 5
        sl = rng.integers(1, k + 1, n)
        sl[0] = 0
        hist = _left(rng, sl, k)[:, ::-1]  # right-aligned window
        batch.update(hist_i=np.ascontiguousarray(hist), sl=sl)
    elif name != "bpr":
        width = 10 if name == "shan" else T
        sl = rng.integers(1, width + 1, n)
        sl[0] = 0
        batch.update(hist_i=_left(rng, sl, width), sl=sl)
        if name == "shan":
            sl_new = rng.integers(1, 9, n)
            batch.update(hist_i_new=_left(rng, sl_new, 8), sl_new=sl_new)
        elif name == "cnn":
            batch["hist_t"] = rng.integers(0, 13, (n, T))
        elif name == "csan":
            batch["hist_t"] = rng.uniform(1, 100, (n, T)).astype(np.float32)
    batch = {k: (v if v.dtype == np.float32 else v.astype(np.int32))
             for k, v in batch.items()}
    batch["valid"] = np.arange(n) < n - 1
    return batch


def _setup(name, seed=0, **over):
    """(JAX model, JAX config, JAX params, the port's model holding the
    same values, cate_list, numpy batch)."""
    rng = np.random.default_rng(seed)
    jcfg = JaxModelConfig(**cfg_kw(name, **over))
    jmodel = jax_get_model(name)
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_numpy(tree, ModelConfig(**cfg_kw(name, **over)), "cpu")
    cate_list = rng.integers(0, CATES, ITEMS).astype(np.int32)
    return jmodel, jcfg, params, model, cate_list, make_batch(name, rng)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ----------------------------------------------------------------- registry


def test_get_model_resolves_all_nine_families():
    names = ["tlsan", "shan", "atrank", "bpr", "lspm", "paca", "cnn", "bilstm", "csan"]
    for name in names:
        cls = get_model(name)
        assert cls.name == name
        assert cls.l2_full_tables == jax_get_model(name).l2_full_tables
    with pytest.raises(KeyError):
        get_model("nope")


# ---------------------------------------------------------- weights bridge


@pytest.mark.parametrize("name", FAMILIES)
def test_bridge_round_trips_the_jax_init_exactly(name):
    _, _, params, model, _, _ = _setup(name)
    want = dict(_tree_items(jax.tree_util.tree_map(np.asarray, params)))
    got = dict(_tree_items(params_to_numpy(model)))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key


# ---------------------------------------------------------- loss and grads


@pytest.mark.parametrize("with_valid", [False, True], ids=["all_rows", "valid"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name, with_valid):
    """The loss and every gradient leaf within 1e-5 of
    jax.value_and_grad(model.loss) from the copied init, on a batch with
    an empty history (sl = 0), with and without a valid mask."""
    jmodel, jcfg, params, model, cate_list, batch = _setup(name, seed=1)
    if not with_valid:
        del batch["valid"]
    want_loss, want_grads = jax.value_and_grad(jmodel.loss)(
        params, _jax(batch), jnp.asarray(cate_list), jcfg, False)
    if name == "paca":
        # JAX's f32 backward of PACA's renormalization att / max(Σatt, 1e-20)
        # at an empty row divides 0 by 1e-40, which XLA flushes to 0: NaN.
        # The port keeps the denormal (0, the true value), so its bar is the
        # JAX module in f64, where 1e-40 is a normal number
        assert np.isnan(np.asarray(want_grads["item_emb"])).any()
        want_loss, want_grads = _paca_f64(jmodel, jcfg, params, batch, cate_list)
    loss = model.loss(_torch(batch), torch.from_numpy(cate_list))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    got = grads_to_numpy(model)
    _assert_trees_close(got, jax.tree_util.tree_map(np.asarray, want_grads),
                        TOL, TOL, "grad ")
    # the gradient reaches the tables (a few rows each) and the dense maps
    assert any(np.abs(g).max() > 0 for _, g in _tree_items(got))


def _paca_f64(jmodel, jcfg, params, batch, cate_list):
    """jax.value_and_grad of PACA's loss with f64 parameters and inputs
    (the loss head still casts its logits to f32), grads cast to f32."""
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                     params)
        b64 = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
               for k, v in batch.items()}
        loss, grads = jax.value_and_grad(jmodel.loss)(
            p64, b64, jnp.asarray(cate_list), jcfg, False)
        return float(loss), jax.tree_util.tree_map(
            lambda g: np.asarray(g, np.float32), grads)


@pytest.mark.parametrize("name", FAMILIES)
def test_pair_and_eval_logits_match_jax(name):
    jmodel, jcfg, params, model, cate_list, batch = _setup(name, seed=2)
    jb, tb, cl = _jax(batch), _torch(batch), torch.from_numpy(cate_list)
    want_pos, want_neg = jmodel.pair_logits(params, jb, jnp.asarray(cate_list), jcfg, False)
    want_full = jmodel.eval_logits(params, jb, jnp.asarray(cate_list), jcfg, False)
    with torch.no_grad():
        pos, neg = model.pair_logits(tb, cl)
        full = model.eval_logits(tb, cl)
    for got, want in ((pos, want_pos), (neg, want_neg), (full, want_full)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert full.shape == (B, ITEMS)
    # the pointwise logit is the catalog row of the same item
    np.testing.assert_allclose(pos.numpy(), full.numpy()[np.arange(B), batch["i"]],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_determinism(name):
    """One seed, one init; one input, one output, bit for bit."""
    cfg = ModelConfig(**cfg_kw(name))
    a = get_model(name)(cfg, "cpu").init_params(torch.Generator().manual_seed(7))
    b = get_model(name)(cfg, "cpu").init_params(torch.Generator().manual_seed(7))
    for (key, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), key
    rng = np.random.default_rng(7)
    batch = _torch(make_batch(name, rng))
    cl = torch.from_numpy(rng.integers(0, CATES, ITEMS).astype(np.int32))
    with torch.no_grad():
        assert torch.equal(a.eval_logits(batch, cl), b.eval_logits(batch, cl))
        assert torch.equal(a.loss(batch, cl), a.loss(batch, cl))


@pytest.mark.parametrize("name", DROPOUT_FAMILIES)
def test_dropout_engages_in_training_only(name):
    """Twin of tests/test_all_models.py:157, PACA included: at dropout 0.3
    the loss depends on the generator's draws, and without a generator it
    is the eval loss; at dropout 0 a generator changes nothing, bit for
    bit."""
    _, _, _, model, cate_list, batch = _setup(name, seed=3, dropout=0.3)
    tb, cl = _torch(batch), torch.from_numpy(cate_list)
    with torch.no_grad():
        eval_loss = model.loss(tb, cl)
        l1 = model.loss(tb, cl, torch.Generator().manual_seed(1))
        l2 = model.loss(tb, cl, torch.Generator().manual_seed(2))
        again = model.loss(tb, cl, torch.Generator().manual_seed(1))
    assert l1 != l2 and l1 != eval_loss
    assert torch.equal(l1, again)  # the draws come from the generator alone
    _, _, _, model0, _, _ = _setup(name, seed=3, dropout=0.0)
    with torch.no_grad():
        assert torch.equal(model0.loss(tb, cl),
                           model0.loss(tb, cl, torch.Generator().manual_seed(1)))


# ------------------------------------------------------------------ layers


def test_lstm_scan_matches_jax():
    rng = np.random.default_rng(4)
    Bx, Tx, D, H = 5, 7, 6, 4
    x = rng.normal(size=(Bx, Tx, D)).astype(np.float32)
    w = rng.normal(size=(D + H, 4 * H)).astype(np.float32) * 0.5
    b = rng.normal(size=4 * H).astype(np.float32)
    want = jax_layers.lstm_scan(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), H)
    got = layers.lstm_scan(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_reverse_valid_and_gather_time_match_jax():
    """Both against jnp.take_along_axis, at lengths 0, 1, T and between;
    gather_time at index −1 (the step before an empty history) reads the
    last step, as JAX wraps it."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 6, 3)).astype(np.float32)
    lengths = np.array([0, 1, 6, 3, 5], np.int32)
    want = jax_layers.reverse_valid(jnp.asarray(x), jnp.asarray(lengths))
    got = layers.reverse_valid(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x2 = x[..., 0]  # the [B, T] form
    want2 = jax_layers.reverse_valid(jnp.asarray(x2), jnp.asarray(lengths))
    got2 = layers.reverse_valid(torch.from_numpy(x2), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    t = lengths - 1  # −1 at the empty row
    want3 = jax_layers.gather_time(jnp.asarray(x), jnp.asarray(t))
    got3 = layers.gather_time(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_array_equal(got3.numpy(), np.asarray(want3))
    np.testing.assert_array_equal(got3.numpy()[0], x[0, -1])


@pytest.mark.parametrize("clip", [True, False], ids=["lspm_clip", "bpr_softplus"])
def test_bpr_loss_matches_jax(clip):
    """Both forms, with and without valid rows, against
    tlsan_tpu/models/base.py::bpr_loss; logits large enough that σ
    saturates, so the clip engages."""
    rng = np.random.default_rng(6)
    pos = (rng.normal(size=16) * 12).astype(np.float32)
    neg = (rng.normal(size=16) * 12).astype(np.float32)
    valid = np.arange(16) < 11
    for v in (None, valid):
        want = jax_base.bpr_loss(jnp.asarray(pos), jnp.asarray(neg),
                                 None if v is None else jnp.asarray(v), clip=clip)
        got = base.bpr_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                            None if v is None else torch.from_numpy(v), clip=clip)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    # the sum form is the mean times the valid rows
    mean = base.bpr_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                         torch.from_numpy(valid), clip=clip)
    total = base.bpr_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                          torch.from_numpy(valid), clip=clip, reduction="sum")
    np.testing.assert_allclose(total.item(), 11 * mean.item(), rtol=1e-6)


# --------------------------------------------------------------------- CNN


def test_cnn_short_window_equals_pad_to_500():
    """Twin of tests/test_all_models.py:105: the conv over T + max(fs)
    rows equals the reference's literal form, padded to 500 and
    convolved with torch's conv2d over the whole length."""
    _, _, _, model, cate_list, batch = _setup("cnn", seed=3, cnn_pad_length=500)
    tb, cl = _torch(batch), torch.from_numpy(cate_list)
    with torch.no_grad():
        fast = model.user_repr(tb, cl)
        h = layers.dense(torch.cat([
            torch.cat([model.item_emb[tb["hist_i"].long()],
                       model.cate_emb[cl.long()[tb["hist_i"].long()]]], -1),
            layers.one_hot(tb["hist_t"], 12, torch.float32)], -1),
            model.time_w, model.time_b)
        h = h * (torch.arange(T)[None, :] < tb["sl"][:, None]).float()[:, :, None]
        h = torch.nn.functional.pad(h, (0, 0, 0, 500 - T))[:, None]  # NCHW, C=1
        pooled = []
        for tw in model.towers:
            w = tw["w"].permute(3, 2, 0, 1)  # [fs, D, 1, F] → [F, 1, fs, D]
            conv = torch.nn.functional.conv2d(h, w)[..., 0]  # [B, F, 500-fs+1]
            pooled.append(torch.amax(torch.relu(conv + tw["b"][:, None]), dim=2))
        ref = layers.dense(torch.cat(pooled, -1), model.out_w, model.out_b)
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------------- SHAN


def _ragged_tuples(rng, users=10, items=25, n=6):
    """(uid, pre, new, item, label) tuples of very different lengths
    (tests/test_shan_padding.py)."""
    return [(k, rng.integers(1, items, rng.integers(1, 9)).tolist(),
             rng.integers(1, items, rng.integers(1, 5)).tolist(),
             int(rng.integers(0, items)), float(rng.integers(0, 2)))
            for k in range(n)]


def test_shan_per_batch_width_matches_jax_and_is_width_invariant():
    """Twin of tests/test_shan_padding.py: packed far wider than any
    session, the port's forward equals the JAX one (which that file holds
    against the reference's per-batch padding), and widening the static
    buffers changes nothing."""
    rng = np.random.default_rng(3)
    tuples = _ragged_tuples(rng)
    kw = dict(model="shan", user_count=10, item_count=25, cate_count=3)
    jmodel = jax_get_model("shan")
    params = jmodel.init_params(jax.random.PRNGKey(2), JaxModelConfig(**kw))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              ModelConfig(**kw), "cpu")
    outs = []
    for Ls, Ts in ((8, 8), (24, 16), (80, 40)):
        packed = pack_session_train(tuples, Ls=Ls, Ts=Ts, variant="shan")
        want = jmodel.user_repr(
            params, _jax(jax_pack_session_train(tuples, Ls, Ts, "shan").arrays),
            None, JaxModelConfig(**kw))
        with torch.no_grad():
            got = model.user_repr(_torch(packed.arrays), None).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
        outs.append(got)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5, atol=1e-6)
