"""Feature-wise attention at the shapes that are edges of the CUDA kernels'
one-warp-per-(row, head) mapping, where lane t takes time step t: one step,
a warp's worth of steps and one past it, two warps' worth, and heads of 8,
16 and 32 features.  The port's plain versions (what a CPU tensor runs, and
K1's and K2's oracles on the card) against the JAX package's reference and
jax.vjp, on the same numpy-seeded inputs, with lengths 0, 1, S and S + 3.
Also: the kernels' launch plan, which the CPU can hold, and the build
cache's key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlsan_tpu.ops.feature_attention import (
    feature_wise_attention_reference as jax_ref,
)
from tlsan_tpu_torch.ops import feature_attention as T
from tlsan_tpu_torch.ops.cuda import build
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa

# the bars of tests/test_torch_fwa.py and tests/test_torch_fwa_bwd.py: the
# forward to 1e-5; each gradient entry to atol 1e-6 + rtol 1e-5 of the sum
# of the magnitudes of the terms it adds up (fwa_backward_error_scale)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-5, 1e-6
GRADS = ("dx", "dw1", "db1", "dw2", "db2")

# (S, D, H): S around the 32 lanes of a warp at dh = 8, then dh = 16 (D=64,
# H=4, as tests/test_cache.py runs TLSAN) and dh = 32 (D=128, H=4), each on
# both sides of one warp of steps
SHAPES = ([(S, 64, 8) for S in (1, 31, 32, 33, 64)]
          + [(17, 64, 4), (33, 64, 4), (17, 128, 4), (40, 128, 4)])


def _inputs(S, D, H, seed, B=6):
    rng = np.random.default_rng(seed)
    dh = D // H
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    lengths = rng.integers(0, S + 1, B).astype(np.int32)
    lengths[:4] = [0, 1, S, S + 3]
    ws = [(rng.normal(size=(dh, dh)) * 0.3).astype(np.float32),
          (rng.normal(size=(dh,)) * 0.1).astype(np.float32),
          (rng.normal(size=(dh, dh)) * 0.3).astype(np.float32),
          (rng.normal(size=(dh,)) * 0.1).astype(np.float32)]
    g = rng.normal(size=(B, D)).astype(np.float32)
    return x, lengths, ws, g


@pytest.mark.parametrize("S,D,H", SHAPES)
def test_plain_forward_matches_jax_at_mapping_edges(S, D, H):
    x, lengths, ws, _ = _inputs(S, D, H, seed=S + D + H)
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(lengths), H,
                              *map(jnp.asarray, ws)))
    got = T.feature_wise_attention(torch.from_numpy(x), torch.from_numpy(lengths),
                                   H, *map(torch.from_numpy, ws))
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)
    # length 0: a uniform softmax over all S, the mean of x; a length past
    # S masks nothing, as a length of S does
    np.testing.assert_allclose(got.numpy()[0], x[0].mean(0), rtol=FWD_RTOL, atol=FWD_ATOL)
    full = T.feature_wise_attention(torch.from_numpy(x[2:4]),
                                    torch.tensor([S, S], dtype=torch.int32), H,
                                    *map(torch.from_numpy, ws))
    np.testing.assert_allclose(got.numpy()[2:4], full.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("S,D,H", SHAPES)
def test_plain_backward_matches_jax_vjp_at_mapping_edges(S, D, H):
    x, lengths, ws, g = _inputs(S, D, H, seed=100 + S + D + H)
    jl = jnp.asarray(lengths)
    _, vjp = jax.vjp(lambda x, *w: jax_ref(x, jl, H, *w), jnp.asarray(x),
                     *map(jnp.asarray, ws))
    want = vjp(jnp.asarray(g))
    args = (torch.from_numpy(x), torch.from_numpy(lengths), H,
            *map(torch.from_numpy, ws), torch.from_numpy(g))
    got = T.fwa_backward_reference(*args)
    scale = T.fwa_backward_error_scale(*args)
    dh = D // H
    assert [tuple(t.shape) for t in got] == [(6, S, D), (dh, dh), (dh,), (dh, dh), (dh,)]
    for name, a, b, sc in zip(GRADS, got, want, scale):
        err = np.abs(a.numpy() - np.asarray(b))
        bar = ATOL + RTOL * sc.numpy()
        assert (err <= bar).all(), (
            f"{name} off by {err.max():.3e}, {(err / bar).max():.2f}x the bar")
    # a length-0 row still gets a gradient, through the mask's addition
    assert float(got[0][0].abs().max()) > 0.0


@pytest.mark.parametrize("backward", [False, True])
def test_launch_plan_fits_the_card_at_every_s(backward):
    """Every S the first designs took (K1 up to 301, K2 up to 181) and
    beyond, at the reference widths: one warp a (row, head) unit, a block
    within the H100's 1,024 threads and 232,448 bytes of shared memory,
    and for K2 scratch for every level of its cross-block tree."""
    B, D, H = 37, 64, 8
    for S in range(1, 302):
        plan = cuda_fwa.launch_plan(B, S, D, H, backward)
        assert plan.dh == 8 and plan.units == B * H
        assert plan.threads == 32 * plan.warps <= 1024
        assert plan.smem <= 232_448
        assert (plan.grid - 1) * plan.warps < plan.units <= plan.grid * plan.warps
        if backward:
            weights = 2 * 8 * 8 + 2 * 8
            levels = [plan.grid]
            while levels[-1] > 1:
                levels.append(-(-levels[-1] // cuda_fwa.GROUP))
            assert plan.slots == weights * sum(levels)
            assert plan.tickets == sum(levels[1:])
    # a large batch takes a tree of several levels, a single block none
    big = cuda_fwa.launch_plan(8192, 25, D, H, True)
    assert big.grid > cuda_fwa.GROUP and big.tickets > 1
    one = cuda_fwa.launch_plan(1, 25, D, H, True)
    assert one.grid == 1 and one.tickets == 0


@pytest.mark.parametrize("D,H,limit", [
    (96, 2, None), (128, 2, None), (64, 1, None),  # dh 48 and 64: the wide variant
    (1024, 1, None), (1032, 2, None),  # past 512 features: a thread takes several
    (16384, 1, "do not fit"),  # one step past a block's shared memory
    (64, 6, "D % num_heads"),
])
def test_launch_plan_refuses_heads_above_the_limit(D, H, limit):
    """Heads past the warp-a-unit variants' 32 features take the wide
    variant, one block a unit, within a block's shared memory; only heads
    of which not even one step fits it (and heads that do not divide D)
    are refused."""
    for backward in (False, True):
        if limit is not None:
            with pytest.raises(ValueError, match=limit):
                cuda_fwa.launch_plan(4, 10, D, H, backward)
            continue
        plan = cuda_fwa.launch_plan(4, 10, D, H, backward)
        assert plan.dh == D // H > cuda_fwa.MAX_HEAD_WIDTH
        assert plan.chunk == 10 and plan.threads == cuda_fwa.WIDE_THREADS
        assert 0 < plan.smem <= cuda_fwa.SMEM_LIMIT - 64
        assert plan.grid == (min(4 * H, cuda_fwa.WIDE_BLOCKS) if backward else 4 * H)
    with pytest.raises(ValueError, match="B, S, replicas >= 1"):
        cuda_fwa.launch_plan(0, 10, 64, 1)


def test_widest_head_fits_shared_memory():
    plan = cuda_fwa.launch_plan(37, 40, 128, 4, True)  # dh = 32
    assert plan.dh == cuda_fwa.MAX_HEAD_WIDTH and plan.smem <= cuda_fwa.SMEM_LIMIT


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    """A header shared by K1 and K2 is part of each library's key, so an
    edit to it builds anew instead of loading a stale library."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert build.library_path("k") not in (first, second)
