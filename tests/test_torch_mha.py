"""Multi-head attention in the PyTorch port against the JAX package: the
port's plain version (what a CPU tensor runs, and the CUDA kernel K3's
oracle) against multihead_attention and against the Pallas kernel in
interpret mode, on the same numpy-seeded inputs, with key and query
lengths 0, 1 and T; its gradients against jax.vjp; feedforward,
layer_norm and dense; and the dispatch rules."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tlsan_tpu.ops.pallas.mha as M
from tlsan_tpu.models.atrank import _attn_params, _ffn_params
from tlsan_tpu.nn import layers as jax_layers
from tlsan_tpu.ops import multihead_attention as jax_mha
from tlsan_tpu_torch.nn import layers
from tlsan_tpu_torch.nn.layers import GivenMasks
from tlsan_tpu_torch.ops import multihead_attention as T
from tlsan_tpu_torch.ops.cuda import mha as cuda_mha

D, H = 64, 8
TOL = 1e-5  # the bar of tests/test_pallas_mha.py


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        M.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _params(seed):
    return {k: np.array(v) for k, v in
            _attn_params(jax.random.PRNGKey(seed), D).items()}


def _inputs(B, Tq, Tk, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Tq, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk, D)).astype(np.float32)
    q_len = rng.integers(0, Tq + 1, B).astype(np.int32)
    k_len = rng.integers(0, Tk + 1, B).astype(np.int32)
    q_len[:3] = [0, 1, Tq]
    k_len[:3] = [Tk, 0, 1]
    k_len[3] = 0  # a full query row over an empty history
    return q, k, q_len, k_len


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("B,Tq,Tk", [(5, 12, 12), (4, 1, 10), (9, 7, 7)])
def test_plain_matches_jax_reference_and_pallas(B, Tq, Tk):
    q, k, q_len, k_len = _inputs(B, Tq, Tk, seed=B)
    p = _params(B)
    jargs = (jnp.asarray(q), jnp.asarray(q_len), jnp.asarray(k),
             jnp.asarray(k_len), H, {n: jnp.asarray(v) for n, v in p.items()})
    want, want_soft = jax_mha.multihead_attention(*jargs)
    pallas = M.mha_pallas(jargs[0], jargs[2], jargs[1], jargs[3], H, jargs[5])
    got, soft = T.multihead_attention_reference(
        torch.from_numpy(q), torch.from_numpy(q_len), torch.from_numpy(k),
        torch.from_numpy(k_len), H, _t(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(soft.numpy(), np.asarray(want_soft), rtol=TOL, atol=TOL)
    # k_len = 0: the −2³²+1 mask is finite, so the softmax is uniform over
    # every key, padding included (not zero, not NaN)
    np.testing.assert_allclose(soft.numpy()[1, :, :1], 1.0 / Tk, rtol=TOL)
    # a query-masked row is LayerNorm(q), not zeros
    row = q[0]
    ln = (row - row.mean(-1, keepdims=True)) / np.sqrt(row.var(-1, keepdims=True) + 1e-8)
    np.testing.assert_allclose(got.numpy()[0], ln, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("self_attention", [True, False])
def test_grads_match_jax_vjp(self_attention):
    """Gradients of q, k and every weight against jax.vjp of the JAX
    reference; with queries is keys they are summed into one."""
    B, Tq = 5, 9
    Tk = Tq if self_attention else 11
    q, k, q_len, k_len = _inputs(B, Tq, Tk, seed=11)
    if self_attention:
        k, k_len = q, q_len
    p = _params(3)
    g = np.random.default_rng(12).normal(size=(B, Tq, D)).astype(np.float32)

    def jax_fn(q_, k_, p_):
        kk = q_ if self_attention else k_
        return jax_mha.multihead_attention(q_, jnp.asarray(q_len), kk,
                                           jnp.asarray(k_len), H, p_)[0]

    _, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k),
                     {n: jnp.asarray(v) for n, v in p.items()})
    dq, dk, dp = vjp(jnp.asarray(g))

    qt = torch.from_numpy(q).requires_grad_(True)
    kt = qt if self_attention else torch.from_numpy(k).requires_grad_(True)
    pt = {n: v.requires_grad_(True) for n, v in _t(p).items()}
    out, _ = T.multihead_attention_reference(
        qt, torch.from_numpy(q_len), kt, torch.from_numpy(k_len), H, pt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dq), rtol=TOL, atol=TOL)
    if not self_attention:
        np.testing.assert_allclose(kt.grad.numpy(), np.asarray(dk), rtol=TOL, atol=TOL)
    for name, v in pt.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(dp[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_mha_function_backward_is_autograd_of_the_plain_version(monkeypatch):
    """MHAFunction with its K3 launch swapped for the plain forward and its
    K3b launch for the plain backward (the kernels need a card): its
    gradients are autograd's, the self-attention q and k terms summed by
    autograd, and the backward hands K3b the saved inputs and g."""
    B, Tq = 6, 8
    q, _, q_len, _ = _inputs(B, Tq, Tq, seed=21)
    p = _params(4)
    g = torch.from_numpy(np.random.default_rng(22).normal(
        size=(B, Tq, D)).astype(np.float32))
    names = ("wq", "bq", "wk", "bk", "wv", "bv", "ln_gamma", "ln_beta")

    def plain_forward(queries, keys, ql, kl, num_heads, *w):
        return T.multihead_attention_reference(
            queries, ql, keys, kl, num_heads, dict(zip(names, w)))[0]

    calls = []

    def plain_backward(queries, keys, ql, kl, num_heads, *rest):
        calls.append(queries.data_ptr() == keys.data_ptr())
        return T.multihead_attention_backward_reference(
            queries, ql, keys, kl, num_heads, dict(zip(names, rest[:8])), rest[8])

    monkeypatch.setattr(cuda_mha, "mha_forward", plain_forward)
    monkeypatch.setattr(cuda_mha, "mha_backward", plain_backward)
    lens = torch.from_numpy(q_len)
    grads = []
    for use_fn in (True, False):
        x = torch.from_numpy(q).requires_grad_(True)
        w = [torch.from_numpy(p[n]).requires_grad_(True) for n in names]
        if use_fn:
            out = cuda_mha.MHAFunction.apply(x, x, lens, lens, H, *w)
        else:
            out = plain_forward(x, x, lens, lens, H, *w)
        out.backward(g)
        grads.append([x.grad, *(t.grad for t in w)])
    assert calls == [True]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_feedforward_layer_norm_and_dense_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 7, D)).astype(np.float32)
    p = {k: np.array(v) for k, v in _ffn_params(jax.random.PRNGKey(6), D).items()}
    p["ln_gamma"] = rng.normal(size=D).astype(np.float32)
    p["ln_beta"] = rng.normal(size=D).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    xt, pt = torch.from_numpy(x), _t(p)
    np.testing.assert_allclose(T.feedforward(xt, pt).numpy(),
                               np.asarray(jax_mha.feedforward(jnp.asarray(x), jp)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        layers.layer_norm(xt, pt["ln_gamma"], pt["ln_beta"]).numpy(),
        np.asarray(jax_layers.layer_norm(jnp.asarray(x), jp["ln_gamma"], jp["ln_beta"])),
        rtol=1e-6, atol=1e-6)
    for b, act in ((None, None), (pt["b1"], torch.relu), (pt["b1"], torch.tanh)):
        jact = {None: None, torch.relu: jax.nn.relu, torch.tanh: jnp.tanh}[act]
        want = jax_layers.dense(jnp.asarray(x), jp["w1"],
                                None if b is None else jp["b1"], jact)
        np.testing.assert_allclose(layers.dense(xt, pt["w1"], b, act).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)


def test_cpu_dispatch_uses_plain_version_not_kernel():
    q, k, q_len, k_len = _inputs(6, 5, 9, seed=7)
    args = (torch.from_numpy(q), torch.from_numpy(q_len), torch.from_numpy(k),
            torch.from_numpy(k_len), H, _t(_params(7)))
    before = cuda_mha.launches
    got = T.multihead_attention(*args)
    assert torch.equal(got, T.multihead_attention_reference(*args)[0])
    assert cuda_mha.launches == before
    # with a generator, dropout engages on the CPU; without one it is off
    drop = T.multihead_attention(*args, dropout_rate=0.5,
                                 generator=torch.Generator().manual_seed(0))
    assert not torch.equal(drop, got)
    assert torch.equal(T.multihead_attention(*args, dropout_rate=0.5), got)


def test_cuda_dispatch_refuses_dropout_and_other_dtypes(monkeypatch):
    """On a (mocked) CUDA tensor, a dropout rate with a mask source no
    longer raises: the dispatcher draws the keep mask [B, H, Tq, Tk] and
    hands it, with the rate, to K3's MHAFunction, not to the plain
    version.  A dtype without a kernel raises."""
    p = _t(_params(8))
    lens = torch.ones(2, dtype=torch.int32)
    cuda_f32 = types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32,
                                     shape=(2, 3, D))
    mask = torch.rand((2, H, 3, 3), generator=torch.Generator().manual_seed(0)) < 0.9
    calls = []
    monkeypatch.setattr(cuda_mha.MHAFunction, "apply", lambda *a: calls.append(a))
    T.multihead_attention(cuda_f32, lens, cuda_f32, lens, H, p, dropout_rate=0.1,
                          generator=GivenMasks([mask]))
    (args,) = calls
    assert args[4] == H and args[-2] is mask and args[-1] == 0.1
    assert len(args) == 5 + len(cuda_mha.WEIGHTS) + 2
    cuda_f16 = types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="no kernel"):
        T.multihead_attention(cuda_f16, lens, cuda_f16, lens, H, p)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, q_len, k_len = _inputs(4, 3, 5, seed=9)
    p = _t(_params(9))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mha.mha_forward(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(q_len), torch.from_numpy(k_len), H,
                             *(p[n] for n in ("wq", "bq", "wk", "bk", "wv", "bv",
                                              "ln_gamma", "ln_beta")))
