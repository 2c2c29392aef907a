"""The backward of feature-wise attention in the PyTorch port against the JAX
package: the port's plain version of K2 (fwa_backward_reference, written in
the kernel's closed-form algebra) and autograd through the CPU dispatcher,
against jax.vjp of feature_wise_attention_reference and against the Pallas
backward (_fwa_backward) in interpret mode, on the same numpy-seeded inputs.
Lengths include 0 (every step masked: the softmax is uniform and the
gradients are not zero) and B=37 forces several batch tiles on the JAX
side.  Also: train-time dropout in the plain version, and FWAFunction's
argument order with the plain versions standing in for the CUDA launches."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tlsan_tpu.ops.pallas.fwa as F
from tlsan_tpu.ops.feature_attention import (
    feature_wise_attention_reference as jax_ref,
)
from tlsan_tpu_torch.nn.layers import dropout
from tlsan_tpu_torch.ops import feature_attention as T
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa

D, H = 64, 8
# the bars of tests/test_pallas_fwa.py:58-61; rtol is taken of the sum of
# the magnitudes of the terms each entry adds up (fwa_backward_error_scale),
# the scale of an f32 sum's rounding error: the weight gradients sum a few
# thousand terms that cancel (db2 = Σ dm2 is exactly 0), and the JAX Pallas
# backward itself differs from jax.vjp by 3e-6 on dw1 at B=37
RTOL, ATOL = 1e-5, 1e-6
GRADS = ("dx", "dw1", "db1", "dw2", "db2")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        F.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(B, S, seed=0):
    rng = np.random.default_rng(seed)
    dh = D // H
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    lengths = rng.integers(0, S + 1, B).astype(np.int32)
    lengths[:3] = [0, 1, S]
    ws = [(rng.normal(size=(dh, dh)) * 0.3).astype(np.float32),
          (rng.normal(size=(dh,)) * 0.1).astype(np.float32),
          (rng.normal(size=(dh, dh)) * 0.3).astype(np.float32),
          (rng.normal(size=(dh,)) * 0.1).astype(np.float32)]
    g = rng.normal(size=(B, D)).astype(np.float32)
    return x, lengths, ws, g


def _torch_args(x, lengths, ws, g):
    return (torch.from_numpy(x), torch.from_numpy(lengths), H,
            *map(torch.from_numpy, ws), torch.from_numpy(g))


def _autograd(x, lengths, ws, g, fn):
    """Gradients of fn(x, lengths, H, w1, b1, w2, b2) for the incoming g, in
    the order (dx, dw1, db1, dw2, db2)."""
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in [x, *ws]]
    out = fn(leaves[0], torch.from_numpy(lengths), H, *leaves[1:])
    return torch.autograd.grad(out, leaves, torch.from_numpy(g))


def _assert_grads(got, want, scale, what):
    for name, a, b, sc in zip(GRADS, got, want, scale):
        err = np.abs(np.asarray(a) - np.asarray(b))
        bar = ATOL + RTOL * np.asarray(sc)
        assert (err <= bar).all(), (
            f"{what}: {name} off by {err.max():.3e}, "
            f"{(err / bar).max():.2f}x the bar")


@pytest.mark.parametrize("B", [5, 37])
@pytest.mark.parametrize("S", [10, 17, 25])
def test_backward_matches_jax_vjp_and_pallas(B, S):
    x, lengths, ws, g = _inputs(B, S, seed=S + B)
    jx, jl = jnp.asarray(x), jnp.asarray(lengths)
    _, vjp = jax.vjp(lambda x, *w: jax_ref(x, jl, H, *w), jx,
                     *map(jnp.asarray, ws))
    want = vjp(jnp.asarray(g))
    pallas = F._fwa_backward(jx, jl, H, *map(jnp.asarray, ws), jnp.asarray(g))
    args = _torch_args(x, lengths, ws, g)
    scale = T.fwa_backward_error_scale(*args)
    _assert_grads(pallas, want, scale, "pallas vs jax.vjp")

    closed = T.fwa_backward_reference(*args)
    assert [tuple(t.shape) for t in closed] == [(B, S, D), (8, 8), (8,), (8, 8), (8,)]
    _assert_grads(closed, want, scale, "fwa_backward_reference vs jax.vjp")
    _assert_grads(closed, pallas, scale, "fwa_backward_reference vs pallas")
    auto = _autograd(x, lengths, ws, g, T.feature_wise_attention)
    _assert_grads(auto, want, scale, "CPU dispatcher autograd vs jax.vjp")
    # a length-0 row still gets a gradient, through the mask's addition
    assert float(closed[0][0].abs().max()) > 0.0


def test_dropout_engages_in_training_and_is_identity_at_rate_0():
    x, lengths, ws, _ = _inputs(16, 10, seed=4)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    wt = [torch.from_numpy(w) for w in ws]
    plain = T.feature_wise_attention(xt, lt, H, *wt)
    gen = torch.Generator().manual_seed(0)
    # rate 0 with a generator, or a rate without one (eval): the identity
    assert torch.equal(T.feature_wise_attention(xt, lt, H, *wt, dropout_rate=0.0,
                                                generator=gen), plain)
    assert torch.equal(T.feature_wise_attention(xt, lt, H, *wt,
                                                dropout_rate=0.5), plain)
    a = T.feature_wise_attention(xt, lt, H, *wt, dropout_rate=0.5,
                                 generator=torch.Generator().manual_seed(0))
    b = T.feature_wise_attention(xt, lt, H, *wt, dropout_rate=0.5,
                                 generator=torch.Generator().manual_seed(0))
    c = T.feature_wise_attention(xt, lt, H, *wt, dropout_rate=0.5,
                                 generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(a).all()
    assert not torch.allclose(a, plain)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_is_inverted():
    """Kept elements are scaled by 1 / (1 − rate); about `rate` are zeroed."""
    x = torch.ones(200_000)
    y = dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert dropout(x, 0.25) is x and dropout(x, 0.0, torch.Generator()) is x


def test_fwa_function_backward_returns_grads_in_argument_order(monkeypatch):
    """FWAFunction on the CPU with the plain versions in place of the K1 and
    K2 launches: its gradients are autograd's, leaf by leaf (w1/w2 and b1/b2
    share shapes, so only the values tell a swap), for a non-contiguous g."""
    def fwd(*args):
        with torch.no_grad():
            return T.feature_wise_attention_reference(*args)

    def bwd(x, lengths, num_heads, w1, b1, w2, b2, g):
        assert g.is_contiguous()
        return T.fwa_backward_reference(x, lengths, num_heads, w1, b1, w2, b2, g)

    monkeypatch.setattr(cuda_fwa, "fwa_forward", fwd)
    monkeypatch.setattr(cuda_fwa, "fwa_backward", bwd)
    x, lengths, ws, g = _inputs(37, 17, seed=5)
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in [x, *ws]]
    out = cuda_fwa.FWAFunction.apply(leaves[0], torch.from_numpy(lengths), H,
                                     *leaves[1:])
    g_t = torch.from_numpy(g.T.copy()).T  # g's values in a transposed layout
    assert not g_t.is_contiguous()
    got = torch.autograd.grad(out, leaves, g_t)
    want = _autograd(x, lengths, ws, g, T.feature_wise_attention_reference)
    _assert_grads(got, want, T.fwa_backward_error_scale(
        *_torch_args(x, lengths, ws, g)), "FWAFunction vs autograd")


def test_fwa_backward_refuses_cpu_tensors():
    args = _torch_args(*_inputs(4, 10, seed=6))
    before = cuda_fwa.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fwa.fwa_backward(*args)
    assert cuda_fwa.bwd_launches == before
