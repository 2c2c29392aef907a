"""The attention ops at every head and model width the command lines take
(`--num_heads`, `--hidden_units` and the embedding sizes), on the CPU.

The grid: every D with any H dividing it; its corners here are D in {64,
128, 256, 512} and heads of dh in {1, 64, 128, 512} features, and past
them D = 1024 in 8 heads and in one, and D = 50 (not a multiple of 4) in
5 and in 2 heads.

  - Plans: K1, K2, K3 and K3b plan every corner of the grid (K1/K2 at S
    from 1 to 301, K3/K3b at (128, 128) and (96, 96) self-attention and
    the (1, 96) and (1, 256) readouts among others), within a block's
    shared memory and, for K3, the clusters the card runs at once; the
    row-split and warp-a-unit variants keep every shape they took before.
  - The plain versions (what a CPU tensor runs, and the kernels' oracles
    on the card) against the JAX package: feature_wise_attention_reference
    and multihead_attention forward and backward (jax.vjp), without and
    with keep masks drawn by JAX, and on a replica axis under
    torch.func.vmap against jax.vmap.  The forward to 1e-5 (1e-5 · (1 +
    the output's magnitude) at heads of 128 features and more); every
    gradient entry to 1e-5 · (1 + the magnitudes of the terms it sums),
    K2's and K3b's bar.
  - The models: TLSAN and ATRank at num_heads=1, TLSAN at hidden_units
    128 in one head, ATRank at hidden_units 256 and 512 (the item and
    category embeddings half of it each, as ATRank's readout needs): the
    loss and every gradient leaf against
    jax.value_and_grad on a JAX init carried across by tools/params.py,
    and 20 SGD steps (lr 0.1 for TLSAN, 0.01 for ATRank) to 1e-4.
  - The command line: `train.cli --model atrank --num_heads 1 --device cpu`
    for one epoch over a seeded SNAP dump (tools/snap_fixture.py).
"""

import dataclasses
import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_atrank import _batch as atrank_batch
from tests.test_torch_atrank import _cate_list as atrank_cate_list
from tests.test_torch_fwa_shapes import check_wide_plan
from tests.test_torch_mha_bwd import _check_bwd_plan
from tests.test_torch_mha_shapes import check_wide_mha_plan
from tests.test_torch_train import _batch as tlsan_batch
from tests.test_torch_train import _tree_items
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.models.atrank import ATRank as JaxATRank
from tlsan_tpu.models.atrank import _attn_params
from tlsan_tpu.models.tlsan import TLSAN as JaxTLSAN
from tlsan_tpu.ops import feature_attention as jax_fa
from tlsan_tpu.ops import multihead_attention as jax_mha
from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.data import remap
from tlsan_tpu_torch.ops import feature_attention as F
from tlsan_tpu_torch.ops import multihead_attention as M
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa
from tlsan_tpu_torch.ops.cuda import mha as cuda_mha
from tlsan_tpu_torch.ops.cuda.common import SMEM_LIMIT
from tlsan_tpu_torch.tools.params import grads_to_numpy, params_from_numpy, params_to_numpy
from tlsan_tpu_torch.tools.snap_fixture import write_snap_fixture
from tlsan_tpu_torch.tools.widths import WIDTHS_FWA, WIDTHS_MHA
from tlsan_tpu_torch.train import cli

TOL = 1e-5
STEP_TOL = 1e-4  # 20 SGD steps: f32 sums in other orders, compounded
RATE = 0.1
R = 2  # the replica axis
R_MAX = 8  # the fan-out's replicas
CORNERS = [(D, D // dh) for D in (64, 128, 256, 512) for dh in (1, 64, 128, 512) if dh <= D]
CORNERS += [(1024, 8), (1024, 1), (50, 5), (50, 2)]
W = cuda_mha.WEIGHTS


def _np(*ts):
    return [t.detach().numpy() for t in ts]


def _fwd_bar(dh, want):
    return TOL * (1.0 + float(np.abs(want).max())) if dh >= 128 else TOL


def _assert_grads(got, want, scale, names):
    for name, a, b, sc in zip(names, got, want, scale):
        err = np.abs(np.asarray(a) - np.asarray(b))
        bar = TOL * (1.0 + np.asarray(sc))
        assert (err <= bar).all(), (
            f"{name} off by {err.max():.3e}, {(err / bar).max():.2f}x the bar")


# -------------------------------------------------------------------- plans


@pytest.mark.parametrize("D,H", CORNERS)
def test_every_kernel_plans_every_width(D, H):
    """K1 and K2 at every S, K3 and K3b at the grid's (Tq, Tk), with and
    without a replica axis: a plan within the card's limits.  Before the
    wide variants, heads past 32 features and D past 256 raised here."""
    dh = D // H
    for B in (1, 32, 128):
        for S in (1, 10, 25, 33, 301):
            for backward in (False, True):
                for replicas in (1, R):
                    plan = cuda_fwa.launch_plan(B, S, D, H, backward, replicas)
                    assert plan.dh == dh and plan.units == B * H
                    assert plan.smem <= SMEM_LIMIT - 64 and plan.threads <= 1024
                    assert plan.wide == (dh > cuda_fwa.MAX_HEAD_WIDTH)
                    if plan.wide:
                        check_wide_plan(plan, B, S, D, H, backward)
        for Tq, Tk, sa in ((128, 128, True), (96, 96, True), (1, 96, False),
                           (1, 256, False), (7, 250, False), (600, 17, False)):
            for rows, reps in ((B, 1), (R * B, 1), (R * B, R)):
                plan = cuda_mha.launch_plan(rows, Tq, Tk, D, H, sa, reps)
                assert plan.dh == dh and plan.smem <= SMEM_LIMIT
                assert plan.wide or (dh <= cuda_mha.MAX_HEAD_WIDTH and D <= cuda_mha.MAX_D)
                if plan.wide:
                    check_wide_mha_plan(plan, rows // reps, Tq, Tk, D, H, sa, reps)
            _check_bwd_plan(cuda_mha.backward_plan(B, Tq, Tk, D, H, R, sa), B, Tq, Tk, D, H,
                            R, sa)
    # D = 512 runs K3 wide whatever the head width; the readout at (1, 96)
    # of D = 256 in heads of 32 features stays on the row-split variant
    assert cuda_mha.launch_plan(32, 1, 96, 512, 512).wide
    assert not cuda_mha.launch_plan(32, 1, 96, 256, 8).wide
    assert cuda_mha.launch_plan(32, 96, 96, 256, 8, True).wide  # its shared memory


def test_reference_widths_keep_their_plans():
    """At D = 64, H = 8 (and every head of up to 32 features at D <= 256
    that fits) the plans are the row-split and warp-a-unit ones, as before."""
    for B in (16, 32, 64, 128, 8192):
        for S in (10, 25):
            for backward in (False, True):
                assert not cuda_fwa.launch_plan(B, S, 64, 8, backward).wide
        for Tq, sa in ((96, True), (1, False)):
            assert not cuda_mha.launch_plan(B, Tq, 96, 64, 8, sa).wide
    assert not cuda_fwa.launch_plan(32, 10, 1024, 32).wide  # dh = 32 at any D
    assert not cuda_mha.launch_plan(37, 17, 17, 128, 4).wide


# K3's and K3b's plans at the reference widths, as the parent of the
# streamed K3b design computed them (its launch_plan and backward_plan at
# D = 64, H = 8): (B, Tq, Tk, self-attention) → K3's (cs, grid, group,
# smem), K3b's (cs, clusters, qb, smem, per_cta, weights, slots, tickets)
REFERENCE_PLANS = {
    (32, 96, 96, True): ((4, 128, 16, 79232), (4, 32, 32, 112512, 28128, 3152, 35, 3)),
    (32, 1, 96, False): ((4, 128, 4, 71248), (4, 32, 1, 74512, 18628, 3152, 35, 3)),
    (128, 96, 96, True): ((2, 256, 16, 104960), (4, 62, 32, 112512, 28128, 3152, 67, 5)),
    (128, 1, 96, False): ((2, 256, 8, 91216), (2, 128, 1, 113040, 28260, 6304, 137, 9)),
    (16, 96, 96, True): ((8, 128, 16, 66368), (8, 16, 96, 93504, 23376, 1576, 17, 1)),
    (16, 1, 96, False): ((8, 128, 2, 61264), (8, 16, 1, 55248, 13812, 1576, 17, 1)),
}


def test_reference_widths_keep_the_parents_plans():
    """At D = 64, H = 8 (the train and serving batches, the mesh's per-rank
    batch) K3 and K3b plan exactly what they planned before K3b's streamed
    design: the resident design, the same cluster, blocks and layout."""
    for (B, Tq, Tk, sa), (fwd, bwd) in REFERENCE_PLANS.items():
        plan = cuda_mha.launch_plan(B, Tq, Tk, 64, 8, sa)
        assert not plan.wide and (plan.cs, plan.grid, plan.group, plan.smem) == fwd
        for R in (1, R_MAX):
            plan = cuda_mha.backward_plan(B, Tq, Tk, 64, 8, R, sa)
            assert plan.mode == cuda_mha.RESIDENT and plan.stage == 0 and plan.work == 0
            assert (plan.cs, plan.clusters, plan.qb, plan.smem, plan.per_cta, plan.weights,
                    plan.slots, plan.tickets) == bwd


@pytest.mark.parametrize("B,S,D,H", WIDTHS_FWA)
def test_fwa_plans_at_the_widths_shapes(B, S, D, H):
    """At every shape of chip_smoke.py's widths phase, K1's and K2's plans
    fit a block's shared memory and keep their scratch bounded (within
    WIDE_SCRATCH_FLOATS but for the weight gradients' slots, or one batch
    row's arrays where that is more); a replica's geometry is a single
    launch's, R times the scratch; and the plan is a pure function of the
    shape (the cached plan is the one computed anew)."""
    dh = D // H
    for backward in (False, True):
        plan = cuda_fwa.launch_plan(B, S, D, H, backward)
        assert plan.smem <= SMEM_LIMIT - 64 and plan.threads <= 1024
        for reps in (R, R_MAX):
            assert dataclasses.replace(cuda_fwa.launch_plan(B, S, D, H, backward, reps),
                                       replicas=1) == plan
        if not plan.wide:
            continue
        check_wide_plan(plan, B, S, D, H, backward)
        assert plan == cuda_fwa._wide_plan(B, S, dh, H, backward, 1)
        arrays = 0 if plan.fused else 4 if backward else 2
        slots = 2 * plan.splits * (dh + 1) * dh if plan.splits > 1 else 0
        assert plan.scratch - slots <= max(cuda_fwa.WIDE_SCRATCH_FLOATS, arrays * S * H * dh)
        assert slots <= max(cuda_fwa.WIDE_SCRATCH_FLOATS,
                            2 * cuda_fwa.WIDE_TARGET * cuda_fwa.WIDE_BM * cuda_fwa.WIDE_BN)


@pytest.mark.parametrize("S", [10, 25])
def test_fwa_wide_grids_fill_the_card_at_1024_features(S):
    """TLSAN at --hidden_units 1024 --num_heads 1 (both towers' S at the
    train batch): K1's and K2's products, and K2's dx and weight-gradient
    launch, each take at least 128 SMs' worth of CTAs."""
    for backward in (False, True):
        plan = cuda_fwa.launch_plan(32, S, 1024, 1, backward)
        assert plan.wide and plan.passes == 1 and plan.grid >= 128
    plan = cuda_fwa.launch_plan(32, S, 1024, 1, True)
    assert plan.grid + plan.splits * cuda_fwa.wide_weight_tiles(1024) >= 128


@pytest.mark.parametrize("backward", [False, True])
def test_fwa_wide_plans_take_what_the_parent_took(backward):
    """Every head the design before the tiles planned (up to 9,682
    features for K1, 6,455 for K2, where one step filled a block's shared
    memory) plans, and so do wider ones: a plan raises only for shapes
    that are no batch of heads."""
    widest = 9682 if backward is False else 6455
    for dh in list(range(33, 300, 7)) + [511, 512, 513, 1024, 4097, widest, widest + 1, 20000]:
        for B, S, H in ((1, 1, 1), (32, 10, 1), (7, 33, 3), (128, 25, 2)):
            plan = cuda_fwa.launch_plan(B, S, dh * H, H, backward)
            assert plan.wide and plan.smem <= SMEM_LIMIT and plan.grid >= 1


@pytest.mark.parametrize("D,H", [(64, 1), (512, 8), (1024, 8), (50, 5)])
def test_mha_wide_launches_fill_the_card(D, H):
    """ATRank's train step at one head, at D = 512 and 1024 in 8 heads and
    at D = 50 in 5 (B = 32, (96, 96) self-attention): each of K3's wide
    launches, the projections, the attention and LayerNorm (a warp a row,
    8 a CTA), takes at least 132 CTAs, one pass for the batch."""
    plan = cuda_mha.launch_plan(32, 96, 96, D, H, True)
    check_wide_mha_plan(plan, 32, 96, 96, D, H, True)
    assert plan.passes == 1
    assert min(plan.proj_grid, plan.grid, -(-32 * 96 // 8)) >= 132


@pytest.mark.parametrize("B,Tq,Tk,D,H,replicas", [
    (4096, 96, 96, 512, 8, 1), (512, 96, 96, 1024, 8, 1), (2048, 1, 96, 512, 8, 1),
    (64, 96, 96, 512, 8, 8), (1, 1, 30000, 1024, 8, 3), (2, 4000, 8, 64, 8, 2)])
def test_mha_wide_passes_are_bounded_by_the_scratch(B, Tq, Tk, D, H, replicas):
    """Where a batch's Q, K and V pass WIDE_SCRATCH_FLOATS, K3's wide
    variant runs passes of whole rows (of every replica, or past one row a
    replica of some replicas at a time) whose scratch stays within the cap,
    or one batch row's arrays where that is more; the passes cover every
    row of every replica."""
    plan = cuda_mha.launch_plan(replicas * B, Tq, Tk, D, H, Tq == Tk, replicas)
    check_wide_mha_plan(plan, B, Tq, Tk, D, H, Tq == Tk, replicas)
    per_row = (Tq + 2 * Tk) * D
    assert plan.work <= max(cuda_mha.WIDE_SCRATCH_FLOATS, per_row)
    assert plan.pass_rows * plan.pass_reps * plan.passes >= B * replicas
    if B * replicas * per_row > cuda_mha.WIDE_SCRATCH_FLOATS:
        assert plan.passes > 1


def _parent_wide_took(Tq, Tk, D, H):
    """Whether the wide design before the tiled one planned the shape: a
    cluster of the largest size dividing the heads (columns on 16 bytes for
    D a multiple of 4), a warp's probabilities over the keys in shared
    memory and the cluster's columns of Q, K and V within WORK_LIMIT."""
    vec = D % 4 == 0
    cs = max(c for c in (1, 2, 4, 8) if H % c == 0 and (not vec or (D // c) % 4 == 0))
    arrays = (Tq + 2 * Tk) * (-(-(D // cs) // 4) * 4 + 4)
    return 4 * (8 * (-(-Tk // 4) * 4) + 3 * 64) <= SMEM_LIMIT and cs * arrays <= 1 << 30


@pytest.mark.parametrize("D", [50, 64, 96, 128, 256, 288, 512, 1024, 2048])
def test_mha_wide_plans_take_what_the_parent_took(D):
    """Every shape the design before the tiles planned (keys up to 7,240,
    a cluster's arrays up to WORK_LIMIT) still plans, past its limits too:
    K3 raises only for no rows, heads that do not divide D and its own
    memory limits, which hold more."""
    heads = [h for h in (1, 2, 5, 8, 9, 64, D) if D % h == 0]
    for H in heads:
        for Tq, Tk in ((1, 1), (1, 96), (96, 96), (7, 250), (300, 300), (1, 4096),
                       (96, 7240), (1, 7241), (1, 20000), (8192, 1)):
            for B in (1, 32, 129):
                plan = cuda_mha.launch_plan(B, Tq, Tk, D, H, Tq == Tk)
                assert plan.smem <= SMEM_LIMIT
                if _parent_wide_took(Tq, Tk, D, H) and plan.wide:
                    check_wide_mha_plan(plan, B, Tq, Tk, D, H, Tq == Tk)


@pytest.mark.parametrize("B", [16, 32, 64, 128, 200, 8192])
def test_mha_reference_widths_keep_the_row_split(B):
    """At D = 64, H = 8, the ATRank blocks (96, 96) and the readout (1, 96),
    with and without a replica axis, K3 runs its row-split variant, never
    the wide one."""
    for Tq, sa in ((96, True), (1, False)):
        for reps in (1, R, R_MAX):
            plan = cuda_mha.launch_plan(reps * B, Tq, 96, 64, 8, sa, reps)
            assert not plan.wide and plan.cs in cuda_mha.CLUSTER_SIZES
            assert plan.grid == reps * B * plan.cs


@pytest.mark.parametrize("B,Tq,Tk,D,H", WIDTHS_MHA)
def test_streamed_plans_at_the_widths_shapes(B, Tq, Tk, D, H):
    """At every shape of chip_smoke.py's widths phase, self- and
    cross-attention: K3b's layout fits a CTA's shared memory (the streamed
    design's stage always does), and where K3b streams, a row takes a
    cluster of several CTAs and no CTA's layout holds the weights: it is
    the biases, Q, O, dy, K, V, dK and dV of the own columns, the block's
    statistics and probabilities, and nothing of size D·D."""
    for sa in ([True, False] if Tq == Tk else [False]):
        plan = cuda_mha.backward_plan(B, Tq, Tk, D, H, 1, sa)
        assert plan.smem <= SMEM_LIMIT - cuda_mha.STATIC_SMEM
        assert cuda_mha.launch_plan(B, Tq, Tk, D, H, sa).smem <= SMEM_LIMIT
        if plan.mode == cuda_mha.RESIDENT:
            continue
        assert plan.cs > 1
        hc = H if plan.mode == cuda_mha.ROWS else H // plan.cs
        dcp = hc * -(-(D // H) // 4) * 4
        ldc, qb = dcp + 4, plan.qb

        def r4(n):
            return -(-n // 4) * 4

        assert plan.per_cta == (4 * dcp + (3 * r4(Tq) + 4 * r4(Tk)) * ldc + r4(qb * hc)
                                + r4(2 * qb) + 8 * qb + r4(2 * hc * (D // H))
                                + hc * qb * (r4(Tk) + 4))


# ------------------------------------------------------ FWA's plain version


def _fwa_case(B, S, D, H, seed, lead=()):
    rng = np.random.default_rng(seed)
    dh = D // H
    fan = np.sqrt(8.0 / dh)
    x = rng.normal(size=lead + (B, S, D)).astype(np.float32)
    lengths = rng.integers(0, S + 1, lead + (B,)).astype(np.int32)
    lengths[..., :3] = [0, 1, S]
    ws = [(rng.normal(size=lead + (dh, dh)) * 0.3 * fan).astype(np.float32),
          (rng.normal(size=lead + (dh,)) * 0.1).astype(np.float32),
          (rng.normal(size=lead + (dh, dh)) * 0.3 * fan).astype(np.float32),
          (rng.normal(size=lead + (dh,)) * 0.1).astype(np.float32)]
    g = rng.normal(size=lead + (B, D)).astype(np.float32)
    return x, lengths, ws, g


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("D,H", CORNERS)
def test_fwa_plain_matches_jax_at_every_width(D, H, dropout):
    """K1's and K2's plain versions against the JAX reference and jax.vjp,
    with and without the keep masks JAX draws, at S = 5 and 33."""
    dh = D // H
    for S in (5, 33):
        x, lengths, ws, g = _fwa_case(3, S, D, H, seed=D + H + S)
        rate, rng, masks = 0.0, None, None
        if dropout:
            rate, rng = RATE, jax.random.PRNGKey(D + H + S)
            masks = tuple(torch.from_numpy(np.array(
                jax.random.bernoulli(k, 1 - rate, (3, S, H, dh))))
                for k in jax.random.split(rng))
        jl = jnp.asarray(lengths)

        def jax_fn(x, *w):
            return jax_fa.feature_wise_attention_reference(
                x, jl, H, *w, dropout_rate=rate, rng=rng)

        want, vjp = jax.vjp(jax_fn, jnp.asarray(x), *map(jnp.asarray, ws))
        args = (torch.from_numpy(x), torch.from_numpy(lengths), H,
                *map(torch.from_numpy, ws))
        got = F.feature_wise_attention_reference(*args, dropout_rate=rate, keep_masks=masks)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_fwd_bar(dh, want))
        grads = F.fwa_backward_reference(*args, torch.from_numpy(g), masks, rate)
        scale = F.fwa_backward_error_scale(*args, torch.from_numpy(g), masks, rate)
        _assert_grads(_np(*grads), vjp(jnp.asarray(g)), _np(*scale),
                      ("dx", "dw1", "db1", "dw2", "db2"))


@pytest.mark.parametrize("D,H", [(64, 1), (128, 1), (512, 1), (512, 8)])
def test_fwa_plain_under_vmap_matches_jax_vmap(D, H):
    """The replica axis: the port's dispatcher (the plain version on the
    CPU) and K2's plain version under torch.func.vmap against jax.vmap of
    the JAX reference and of its vjp, R replicas of their own weights."""
    x, lengths, ws, g = _fwa_case(3, 9, D, H, seed=7 * D + H, lead=(R,))
    dh = D // H

    def jax_fn(x, l, *w):
        return jax_fa.feature_wise_attention_reference(x, l, H, *w)

    def jax_bwd(x, l, g, *w):
        return jax.vjp(lambda x, *w: jax_fn(x, l, *w), x, *w)[1](g)

    jargs = (jnp.asarray(x), jnp.asarray(lengths))
    want = np.asarray(jax.vmap(jax_fn)(*jargs, *map(jnp.asarray, ws)))
    want_g = jax.vmap(jax_bwd)(*jargs, jnp.asarray(g), *map(jnp.asarray, ws))
    targs = (torch.from_numpy(x), torch.from_numpy(lengths), *map(torch.from_numpy, ws))
    got = torch.func.vmap(lambda x, l, *w: F.feature_wise_attention(x, l, H, *w))(*targs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_fwd_bar(dh, want))
    tg = torch.from_numpy(g)
    grads = torch.func.vmap(lambda x, l, g, *w: F.fwa_backward_reference(x, l, H, *w, g))(
        targs[0], targs[1], tg, *targs[2:])
    scale = torch.func.vmap(lambda x, l, g, *w: F.fwa_backward_error_scale(x, l, H, *w, g))(
        targs[0], targs[1], tg, *targs[2:])
    _assert_grads(_np(*grads), want_g, _np(*scale), ("dx", "dw1", "db1", "dw2", "db2"))


# ------------------------------------------------------ MHA's plain version


def _mha_case(B, Tq, Tk, D, self_attention, seed, lead=()):
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=lead + shape) * scale).astype(np.float32)

    q = f32(B, Tq, D)
    k = q if self_attention else f32(B, Tk, D)
    q_len = rng.integers(0, Tq + 1, lead + (B,)).astype(np.int32)
    k_len = q_len if self_attention else rng.integers(0, Tk + 1, lead + (B,)).astype(np.int32)
    q_len[..., 0], k_len[..., 1] = Tq, 0
    if lead:
        p = {n: f32(*((D, D) if n.startswith("w") else (D,)), scale=0.2 * np.sqrt(64.0 / D))
             for n in W}
        p["ln_gamma"] += 1.0
    else:
        p = {n: np.array(v) for n, v in _attn_params(jax.random.PRNGKey(seed), D).items()}
        p["ln_gamma"] = 1.0 + f32(D, scale=0.1)
        p["ln_beta"] = f32(D, scale=0.1)
    return q, k, q_len, k_len, p, f32(B, Tq, D)


def _mha_plain_vs_jax(B, Tq, Tk, D, H, sa, dropout, seed):
    """K3's plain version against the JAX multihead_attention and K3b's
    against jax.vjp, with or without the keep mask JAX draws."""
    q, k, q_len, k_len, p, g = _mha_case(B, Tq, Tk, D, sa, seed=seed)
    rate, rng, mask = 0.0, None, None
    if dropout:
        rate, rng = RATE, jax.random.PRNGKey(seed)
        mask = torch.from_numpy(np.array(jax.random.bernoulli(rng, 1 - rate, (B, H, Tq, Tk))))
    names = list(W)

    def jax_fn(q, k, *ws):
        return jax_mha.multihead_attention(
            q, jnp.asarray(q_len), k, jnp.asarray(k_len), H, dict(zip(names, ws)),
            dropout_rate=rate, rng=rng)[0]

    want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k),
                        *(jnp.asarray(p[n]) for n in names))
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    ql, kl = torch.from_numpy(q_len), torch.from_numpy(k_len)
    got, _ = M.multihead_attention_reference(tq, ql, tk, kl, H, tp, rate, keep_mask=mask)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_fwd_bar(D // H, want))
    tg = torch.from_numpy(g)
    grads = M.multihead_attention_backward_reference(tq, ql, tk, kl, H, tp, tg, rate, mask)
    scale = M.multihead_attention_backward_error_scale(tq, ql, tk, kl, H, tp, tg, rate, mask)
    _assert_grads(_np(*grads), vjp(jnp.asarray(g)), _np(*scale), ("d_queries", "d_keys", *names))


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("D,H", CORNERS)
def test_mha_plain_matches_jax_at_every_width(D, H, dropout):
    """K3's plain version against the JAX multihead_attention, and K3b's
    against jax.vjp, self-attention at T = 9 and the readout over 7 keys,
    with and without the keep mask JAX draws."""
    for Tq, Tk, sa in ((9, 9, True), (1, 7, False)):
        _mha_plain_vs_jax(3, Tq, Tk, D, H, sa, dropout, seed=D + H + Tq)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("Tq,Tk,sa", [(1, 300, False), (300, 300, True), (5, 300, False)])
def test_mha_plain_matches_jax_past_256_keys(Tq, Tk, sa, dropout):
    """Past 256 keys, where K3's wide variant now scores into a warp's
    slice of shared memory: the plain versions against JAX at D = 64, H =
    8."""
    _mha_plain_vs_jax(2, Tq, Tk, 64, 8, sa, dropout, seed=Tq + Tk)


@pytest.mark.parametrize("D,H", [(64, 1), (256, 4), (512, 8), (512, 1)])
def test_mha_plain_under_vmap_matches_jax_vmap(D, H):
    """The replica axis: the dispatcher (the plain version on the CPU) and
    K3b's plain version under torch.func.vmap against jax.vmap of the JAX
    function and of its vjp, R replicas of their own weights."""
    q, k, q_len, k_len, p, g = _mha_case(3, 6, 6, D, False, seed=3 * D + H, lead=(R,))
    names = list(W)

    def jax_fn(q, k, ql, kl, *ws):
        return jax_mha.multihead_attention(q, ql, k, kl, H, dict(zip(names, ws)))[0]

    def jax_bwd(q, k, ql, kl, g, *ws):
        return jax.vjp(lambda q, k, *ws: jax_fn(q, k, ql, kl, *ws), q, k, *ws)[1](g)

    jargs = [jnp.asarray(a) for a in (q, k, q_len, k_len)]
    jws = [jnp.asarray(p[n]) for n in names]
    want = np.asarray(jax.vmap(jax_fn)(*jargs, *jws))
    want_g = jax.vmap(jax_bwd)(*jargs, jnp.asarray(g), *jws)
    targs = [torch.from_numpy(a) for a in (q, k, q_len, k_len)]
    tws = [torch.from_numpy(p[n]) for n in names]
    got = torch.func.vmap(lambda q, k, ql, kl, *ws: M.multihead_attention(
        q, ql, k, kl, H, dict(zip(names, ws))))(*targs, *tws)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_fwd_bar(D // H, want))
    tg = torch.from_numpy(g)

    def bwd(fn):
        return torch.func.vmap(lambda q, k, ql, kl, g, *ws: fn(
            q, ql, k, kl, H, dict(zip(names, ws)), g))(*targs, tg, *tws)

    _assert_grads(_np(*bwd(M.multihead_attention_backward_reference)), want_g,
                  _np(*bwd(M.multihead_attention_backward_error_scale)),
                  ("d_queries", "d_keys", *names))


# ------------------------------------------------------------------- models


TLSAN_CFG = dict(model="tlsan", user_count=20, item_count=30, cate_count=5, Ls=10, Ts=8)
ATRANK_CFG = dict(model="atrank", user_count=21, item_count=29, cate_count=5, max_length=12)
MODELS = [("tlsan", dict(num_heads=1), 0.1),
          ("tlsan", dict(itemid_embedding_size=64, cateid_embedding_size=64,
                         userid_embedding_size=64, hidden_units=128, num_heads=1), 0.1),
          ("atrank", dict(num_heads=1), 0.01),
          ("atrank", dict(itemid_embedding_size=128, cateid_embedding_size=128,
                         hidden_units=256, num_heads=8), 0.01),
          ("atrank", dict(itemid_embedding_size=256, cateid_embedding_size=256,
                         hidden_units=512, num_heads=8), 0.01),
          # D = 50, not a multiple of 4: K3 and K3b read its rows a float at a time
          ("atrank", dict(itemid_embedding_size=30, cateid_embedding_size=20,
                         hidden_units=50, num_heads=5), 0.01)]


@pytest.mark.parametrize("family,over,lr", MODELS)
def test_model_at_width_matches_jax_for_20_sgd_steps(family, over, lr):
    """The loss and every gradient leaf against jax.value_and_grad at a
    JAX init carried across by tools/params.py, then 20 SGD steps of each
    side's own gradients at `lr`: every parameter within STEP_TOL."""
    jmodel, base = {"tlsan": (JaxTLSAN, TLSAN_CFG), "atrank": (JaxATRank, ATRANK_CFG)}[family]
    jcfg = JaxModelConfig(**base, **over)
    jparams = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                              ModelConfig(**base, **over), "cpu")
    if family == "tlsan":
        batch, cate_list = tlsan_batch()
    else:
        batch, cate_list = atrank_batch(seed=4, n=16), atrank_cate_list()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jcl, tcl = jnp.asarray(cate_list), torch.from_numpy(cate_list)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.loss), static_argnums=(3, 4))

    for step in range(20):
        want_loss, want_grads = grad_fn(jparams, jb, jcl, jcfg, False)
        model.zero_grad(set_to_none=True)
        loss = model.loss(tb, tcl)
        loss.backward()
        if step == 0:
            np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
            got = dict(_tree_items(grads_to_numpy(model)))
            want = dict(_tree_items(jax.tree_util.tree_map(np.asarray, want_grads)))
            assert got.keys() == want.keys()
            for name in want:
                np.testing.assert_allclose(got[name], want[name], rtol=TOL, atol=TOL,
                                           err_msg=f"grad {name}")
        jparams = jax.tree_util.tree_map(lambda p, g: p - lr * g, jparams, want_grads)
        with torch.no_grad():
            for prm in model.parameters():
                if prm.grad is not None:
                    prm -= lr * prm.grad
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=STEP_TOL, atol=STEP_TOL)
    got = dict(_tree_items(params_to_numpy(model)))
    want = dict(_tree_items(jax.tree_util.tree_map(np.asarray, jparams)))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=f"after 20 steps: {name}")


# ------------------------------------------------------------- command line


def test_train_cli_atrank_one_head_runs_an_epoch(tmp_path, monkeypatch):
    """`train.cli --model atrank --num_heads 1 --device cpu`: one epoch on a
    seeded SNAP dump, evaluations with AUCs in [0, 1], a final record."""
    monkeypatch.setenv("TLSAN_DATA_CACHE", "0")
    category = "Digital_Music"
    snap = tmp_path / "snap"
    write_snap_fixture(str(snap), category, users=60, items=40, cates=5, reviews=720,
                       seed=5)
    with gzip.open(snap / f"reviews_{category}_5.json.gz", "rt") as f:
        reviews = f.readlines()
    with gzip.open(snap / f"meta_{category}.json.gz", "rt") as f:
        meta = f.readlines()
    data = tmp_path / "Data"
    data.mkdir()
    with pytest.warns(UserWarning, match="no metadata"):
        remap.save_category(str(data / f"{category}.npz"),
                            *remap.remap_ids(*remap.convert_raw_lines(reviews, meta)))
    model_dir = str(tmp_path / "run")
    cli.main(["--model", "atrank", "--num_heads", "1", "--dataset", category,
              "--data_dir", str(data), "--max_epochs", "1", "--eval_freq", "5",
              "--best_after_step", "0", "--save_auc_gate", "0", "--model_dir", model_dir,
              "--device", "cpu"])
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    evals = [r for r in recs if r["kind"] in ("eval", "final")]
    assert len(evals) > 1 and evals[-1]["kind"] == "final"
    assert all(0.0 <= r["auc"] <= 1.0 for r in evals)
    sidecars = [f for f in os.listdir(model_dir) if f.startswith("atrank-") and
                f.endswith(".json")]
    assert sidecars
    with open(os.path.join(model_dir, sidecars[0])) as f:
        assert json.load(f)["ModelConfig"]["num_heads"] == 1
