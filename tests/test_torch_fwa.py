"""Feature-wise attention in the PyTorch port against the JAX package: the
port's plain version (what a CPU tensor runs, and the CUDA kernel's oracle)
against feature_wise_attention_reference and against the Pallas kernel in
interpret mode, on the same numpy-seeded inputs.  Lengths include 0, the
padded rows a partial serving batch sends through the long tower."""

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
from tlsan_tpu_torch.ops import feature_attention as T
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa

D, H = 64, 8
RTOL, ATOL = 1e-5, 1e-6


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
    return x, lengths, ws


def _torch(x, lengths, ws):
    return (torch.from_numpy(x), torch.from_numpy(lengths),
            [torch.from_numpy(w) for w in ws])


@pytest.mark.parametrize("B", [5, 37])
@pytest.mark.parametrize("S", [10, 17, 25])
def test_plain_matches_jax_reference_and_pallas(B, S):
    x, lengths, ws = _inputs(B, S)
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(lengths), H,
                              *map(jnp.asarray, ws)))
    pallas = np.asarray(F.fwa_pallas(jnp.asarray(x), jnp.asarray(lengths), H,
                                     *map(jnp.asarray, ws)))
    xt, lt, wt = _torch(x, lengths, ws)
    got = T.feature_wise_attention(xt, lt, H, *wt)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=ATOL)
    # a length-0 row is a uniform softmax over all S: the mean of x
    np.testing.assert_allclose(got.numpy()[0], x[0].mean(0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,S", [(5, 10), (37, 25)])
def test_return_soft_matches_jax(B, S):
    x, lengths, ws = _inputs(B, S, seed=1)
    out_j, soft_j = jax_ref(jnp.asarray(x), jnp.asarray(lengths), H,
                            *map(jnp.asarray, ws), return_soft=True)
    xt, lt, wt = _torch(x, lengths, ws)
    out_t, soft_t = T.feature_wise_attention_reference(xt, lt, H, *wt,
                                                       return_soft=True)
    assert soft_t.shape == (B, S, H, D // H)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(soft_t.numpy(), np.asarray(soft_j),
                               rtol=RTOL, atol=ATOL)


def test_cpu_dispatch_uses_plain_version_not_kernel():
    x, lengths, ws = _inputs(6, 10, seed=2)
    before = cuda_fwa.launches
    xt, lt, wt = _torch(x, lengths, ws)
    got = T.feature_wise_attention(xt, lt, H, *wt)
    want = T.feature_wise_attention_reference(xt, lt, H, *wt)
    assert torch.equal(got, want)
    assert cuda_fwa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x, lengths, ws = _inputs(4, 10, seed=3)
    xt, lt, wt = _torch(x, lengths, ws)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fwa.fwa_forward(xt, lt, H, *wt)
