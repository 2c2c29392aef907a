"""Multi-head attention at the shapes the CUDA kernel K3 takes since its
cluster-per-row redesign: heads of 16 and 32 features, histories past 128
keys and up to 256, and readouts over 256 keys.  The port's plain version
(what a CPU tensor runs, and K3's oracle on the card) against the JAX
package's multihead_attention, against the Pallas kernel in interpret mode
and against jax.vjp, on the same numpy-seeded inputs with query and key
lengths 0, 1 and T; ATRank at 4 heads and a history of 150 against the JAX
ATRank.  Also: K3's launch plan (cluster size, grid, shared memory), which
the CPU can hold, and the limits it refuses."""

import ctypes
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tlsan_tpu.ops.pallas.mha as M
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.models.atrank import ATRank as JaxATRank
from tlsan_tpu.models.atrank import _attn_params
from tlsan_tpu.ops import multihead_attention as jax_mha
from tests.test_torch_fwa_shapes import _c_params
from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.ops import multihead_attention as T
from tlsan_tpu_torch.ops.cuda import build
from tlsan_tpu_torch.ops.cuda import mha as cuda_mha
from tlsan_tpu_torch.tools.params import grads_to_numpy, params_from_numpy

TOL = 1e-5  # the bar of tests/test_pallas_mha.py and tests/test_torch_mha.py

# (B, Tq, Tk, D, H): heads of 16 (D=64, H=4) and 32 (D=128, H=4) features,
# self-attention at T = 129, 200 and 256, cross-attention at (1, 256) and
# (7, 250)
SHAPES = [(5, 12, 12, 64, 4), (5, 12, 12, 128, 4), (3, 129, 129, 64, 8),
          (3, 200, 200, 64, 4), (3, 256, 256, 128, 4), (4, 1, 256, 64, 8),
          (4, 1, 256, 128, 4), (4, 7, 250, 64, 4), (4, 7, 250, 128, 4)]

# K3's main-path shapes (B, Tq, Tk) at D=64, H=8: a request batch, a train
# step, and a rank's request batch and train step on a dp=2 mesh
MAIN = [(B, Tq, 96) for B in (128, 32, 64, 16) for Tq in (96, 1)]
# the edges chip_smoke.py runs: clusters of 8 and of 1, T past 128 and at
# 256 (B=200 takes clusters of 4 there for shared memory), 256 keys
EDGES = [(1, 96, 96, 64, 8), (1, 1, 96, 64, 8), (200, 96, 96, 64, 8),
         (200, 1, 96, 64, 8), (37, 17, 17, 64, 4), (37, 17, 17, 128, 4),
         (37, 129, 129, 64, 8), (4, 256, 256, 64, 8), (200, 256, 256, 64, 8),
         (37, 1, 256, 64, 8), (9, 7, 250, 64, 4)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        M.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _params(D, seed):
    p = {k: np.array(v) for k, v in _attn_params(jax.random.PRNGKey(seed), D).items()}
    rng = np.random.default_rng(seed)
    p["ln_gamma"] = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    p["ln_beta"] = (0.1 * rng.normal(size=D)).astype(np.float32)
    return p


def _inputs(B, Tq, Tk, D, seed):
    """queries, keys (queries itself when Tq = Tk: self-attention), q_len,
    k_len; lengths 0, 1 and T in the first rows, and a full query row over
    an empty history."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Tq, D)).astype(np.float32)
    q_len = rng.integers(0, Tq + 1, B).astype(np.int32)
    q_len[:3] = [0, 1, Tq]
    if Tq == Tk:
        return q, q, q_len, q_len
    k = rng.normal(size=(B, Tk, D)).astype(np.float32)
    k_len = rng.integers(0, Tk + 1, B).astype(np.int32)
    k_len[:4] = [Tk, 0, 1, 0]
    return q, k, q_len, k_len


@pytest.mark.parametrize("B,Tq,Tk,D,H", SHAPES)
def test_plain_matches_jax_reference_and_pallas(B, Tq, Tk, D, H):
    q, k, q_len, k_len = _inputs(B, Tq, Tk, D, seed=B + Tq + Tk + D + H)
    p = _params(D, Tk)
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    want, want_soft = jax_mha.multihead_attention(
        jq, jnp.asarray(q_len), jk, jnp.asarray(k_len), H, jp)
    pallas = M.mha_pallas(jq, jk, jnp.asarray(q_len), jnp.asarray(k_len), H, jp)
    got, soft = T.multihead_attention_reference(
        torch.from_numpy(q), torch.from_numpy(q_len), torch.from_numpy(k),
        torch.from_numpy(k_len), H, {n: torch.from_numpy(v) for n, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(soft.numpy(), np.asarray(want_soft), rtol=TOL, atol=TOL)
    if Tq != Tk:
        # row 1: a live query over k_len = 0 has a softmax uniform over all
        # Tk keys, padding included
        np.testing.assert_allclose(soft.numpy()[1, :, :1], 1.0 / Tk, rtol=TOL)
    else:
        # row 0: q_len = k_len = 0, the query mask zeroes the softmax
        assert not soft.numpy()[0].any()


@pytest.mark.parametrize("B,Tq,Tk,D,H", [(3, 129, 129, 64, 4), (4, 7, 250, 128, 4),
                                         (4, 1, 256, 64, 8)])
def test_grads_match_jax_vjp(B, Tq, Tk, D, H):
    """Gradients of q, k and every weight against jax.vjp of the JAX
    reference; for self-attention (queries is keys) summed into one."""
    self_attention = Tq == Tk
    q, k, q_len, k_len = _inputs(B, Tq, Tk, D, seed=7 + Tk)
    p = _params(D, 3)
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
    pt = {n: torch.from_numpy(v).requires_grad_(True) for n, v in p.items()}
    out, _ = T.multihead_attention_reference(
        qt, torch.from_numpy(q_len), kt, torch.from_numpy(k_len), H, pt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dq), rtol=TOL, atol=TOL)
    if not self_attention:
        np.testing.assert_allclose(kt.grad.numpy(), np.asarray(dk), rtol=TOL, atol=TOL)
    for name, v in pt.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(dp[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


def _check_plan(B, Tq, Tk, D, H, self_attention=False):
    plan = cuda_mha.launch_plan(B, Tq, Tk, D, H, self_attention)
    assert plan.dh == D // H
    assert plan.cs in cuda_mha.CLUSTER_SIZES and plan.grid == B * plan.cs
    assert plan.threads == cuda_mha.THREADS
    assert plan.smem <= cuda_mha.SMEM_LIMIT
    # the smallest group of lanes that holds every key of its unit, 8 a lane
    keys = -(-Tk // plan.cs) if Tq == 1 else Tk
    assert plan.group in (1, 2, 4, 8, 16, 32)
    assert plan.group * cuda_mha.PER_LANE >= keys
    assert plan.group == 1 or plan.group // 2 * cuda_mha.PER_LANE < keys
    # the largest cluster whose B clusters run at once, if any does
    smem = {cs: cuda_mha._smem(Tq, Tk, D, H, cs, self_attention)
            for cs in cuda_mha.CLUSTER_SIZES}
    assert plan.smem == smem[plan.cs]
    fits = [cs for cs in cuda_mha.CLUSTER_SIZES if smem[cs] <= cuda_mha.SMEM_LIMIT]

    def one_wave(cs):
        return B <= cuda_mha.ACTIVE_CLUSTERS[cs, cuda_mha.ctas_per_sm(smem[cs])]

    if any(map(one_wave, fits)):
        assert one_wave(plan.cs) and not any(one_wave(cs) for cs in fits if cs > plan.cs)
    else:
        assert plan.cs == fits[0]
    return plan


@pytest.mark.parametrize("shape", MAIN + EDGES)
def test_launch_plan_fits_main_shapes_and_edges(shape):
    B, Tq, Tk, D, H = (*shape, 64, 8)[:5]
    for self_attention in {False, Tq == Tk}:
        _check_plan(B, Tq, Tk, D, H, self_attention)


@pytest.mark.parametrize("Tq", [96, 1])
def test_launch_plan_fills_the_card_at_small_batches(Tq):
    """B=32 (a train step) and B=16 (a rank's train step on the mesh) take
    128 CTAs, one a row before, in clusters the card runs in one wave (8
    CTAs at B=16; at B=32 clusters of 4, since the card runs 30 clusters of
    8 at once); B=128 takes 256 CTAs and B=200 one a row."""
    self_attention = Tq == 96
    for B, cs in ((16, 8), (32, 4), (128, 2)):
        plan = cuda_mha.launch_plan(B, Tq, 96, 64, 8, self_attention)
        assert (plan.cs, plan.grid) == (cs, B * cs)
        assert B <= cuda_mha.ACTIVE_CLUSTERS[cs, cuda_mha.ctas_per_sm(plan.smem)]
        assert plan.grid >= 128
    assert cuda_mha.launch_plan(200, Tq, 96, 64, 8, self_attention).cs == 1


def test_launch_plan_takes_every_length_up_to_256():
    for T_ in range(1, 257):
        for B in (1, 37, 200):
            _check_plan(B, T_, T_, 64, 8)
            _check_plan(B, 1, T_, 64, 8)
    # heads of 16 and 32 features
    for D, H in ((64, 4), (128, 4), (256, 8), (96, 3), (20, 5)):
        _check_plan(37, 17, 17, D, H)
        _check_plan(37, 1, 256, D, H)


def _r4(n):
    return -(-n // 4) * 4


def _cdiv(n, d):
    return -(-n // d)


def check_wide_mha_plan(plan, B, Tq, Tk, D, H, self_attention=False, replicas=1):
    """K3's wide plan for `replicas` replicas of B batch rows, recomputed
    here from its rules: passes of as many whole rows as
    WIDE_SCRATCH_FLOATS hold (one at least, then as many replicas as it
    holds); the projections' tiles in one matrix's columns, 64 × 128 where
    D >= 128 and they give every SM a CTA, else 32 × 64; the attention's
    features (a power of two up to 64) and keys (a multiple of 32 up to
    128) staged at once, its layout (two buffers of Q and of a K or V tile,
    the scores, the sums, P·V's partial sums) within a CTA's shared memory
    and its blocks of query rows: the largest whose CTAs, one a (row,
    block, head), fill the card, else the smallest that fits."""
    dh, per_row = D // H, (Tq + 2 * Tk) * D
    cap = cuda_mha.WIDE_SCRATCH_FLOATS
    assert plan.wide and plan.dh == dh and plan.cs == 1
    assert plan.threads == cuda_mha.WIDE_THREADS == 256
    fc = max(4, 1 << (min(dh, 64) - 1).bit_length())
    assert plan.fc == fc and plan.kc == min(128, _cdiv(Tk, 32) * 32)
    rows = max(1, min(B, cap // (replicas * per_row)))
    reps = min(replicas, cuda_mha.MAX_GRID_Y)
    if rows == 1:
        reps = max(1, min(reps, cap // per_row))
    assert (plan.pass_rows, plan.pass_reps) == (rows, reps)
    assert plan.passes == _cdiv(B, rows) * _cdiv(replicas, reps)
    assert plan.work == reps * rows * per_row <= max(cap, per_row)

    def smem(q):
        return 4 * (2 * q * (fc + 4) + 2 * plan.kc * (fc + 4) + q * (_r4(Tk) + 4) + _r4(q)
                    + 256 * 16)

    def ctas(q):
        return reps * rows * _cdiv(Tq, q) * H

    assert plan.smem == smem(plan.qb) <= cuda_mha.SMEM_LIMIT
    blocks = [q for q in (32, 16, 8, 4, 2, 1)
              if (q <= Tq or q == 1) and smem(q) <= cuda_mha.SMEM_LIMIT]
    full = [q for q in blocks if ctas(q) >= 132]
    assert plan.qb == (max(full) if full else min(blocks))
    assert plan.grid == ctas(plan.qb)
    sa = self_attention and Tq == Tk

    def proj(bm, bn):
        n = _cdiv(D, bn)
        tiles = (_cdiv(rows * Tq, bm) * 3 * n if sa
                 else (_cdiv(rows * Tq, bm) + 2 * _cdiv(rows * Tk, bm)) * n)
        return reps * tiles

    assert plan.big == (D >= 128 and proj(64, 128) >= 132)
    assert plan.proj_grid == proj(*((64, 128) if plan.big else (32, 64)))


@pytest.mark.parametrize("shape,limit", [
    ((4, 10, 10, 128, 2), None),  # dh = 64: the wide variant
    ((4, 10, 10, 64, 1), None),
    ((4, 10, 10, 288, 9), None),  # D past 256
    ((4, 10, 10, 30, 5), None),  # D not a multiple of 4: one float at a time
    ((4, 10, 10, 1024, 8), None),  # D past 512
    ((4, 10, 257, 64, 8), None),  # past 256 keys: the keys in chunks
    ((4, 1, 300, 64, 8), None),
    ((4, 200, 200, 128, 4), None),  # past one CTA's shared memory
    ((4, 4000, 8, 64, 8), None),
    ((4, 1, 7300, 64, 8), None),  # past the 7,240 keys of the design before
    ((4, 10, 10, 64, 6), "D % num_heads"),
    ((0, 10, 10, 64, 8), "B, Tq, Tk >= 1"),
    ((4, 1, 60000, 64, 8), "scores over the Tk keys"),  # a memory limit
    ((1, 8192, 1, 1 << 17, 1), "device memory"),
])
def test_launch_plan_refuses_beyond_the_limits(shape, limit):
    """What the row-split variants refuse (heads past 32 features, D past
    256 or not a multiple of 4, more than 256 keys, a CTA past shared
    memory) takes the wide variant: passes of whole rows, the projections
    as tiled products, the attention a CTA a (row, block of query rows,
    head) within a CTA's shared memory (`check_wide_mha_plan`).  Only no
    rows, heads that do not divide D and what memory forces still raise,
    naming the limit: a query row's scores over the keys past a CTA's
    shared memory, a batch row's Q, K and V past WORK_LIMIT floats."""
    if limit is not None:
        with pytest.raises(ValueError, match=limit):
            cuda_mha.launch_plan(*shape)
        return
    check_wide_mha_plan(cuda_mha.launch_plan(*shape), *shape)


@pytest.mark.parametrize("fn", ["mha_fwd_launch", "mha_fwd_wide_launch"])
def test_launch_signatures_match_the_source(fn, monkeypatch):
    """The wrapper's ctypes declarations of K3's launch functions (pointers
    as c_void_p: ctypes would cut them to 32 bits otherwise) agree with
    csrc/mha_fwd.cu parameter by parameter, and the wide variant's
    constants in ops/cuda/mha.py with the source's: its attention's
    threads, blocks of query rows, features and keys staged, the replicas
    of a launch and the projections' tiles."""
    names = ("mha_fwd_launch", "mha_fwd_wide_launch", "mha_fwd_active_clusters",
             "mha_error_string")
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace(argtypes=None, restype=None)
                                   for n in names})
    monkeypatch.setattr(build, "load", lambda name: lib)
    cuda_mha._library()
    assert list(getattr(lib, fn).argtypes) == _c_params(cuda_mha.SOURCE, fn)
    assert getattr(lib, fn).restype is ctypes.c_int
    source = (build.CSRC / f"{cuda_mha.SOURCE}.cu").read_text()
    for name, value in (("kAttThreads", cuda_mha.WIDE_THREADS), ("kMaxQb", cuda_mha.WIDE_QB),
                        ("kMaxFc", cuda_mha.WIDE_FC), ("kMaxKc", cuda_mha.WIDE_KC),
                        ("kMaxGridY", cuda_mha.MAX_GRID_Y)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", source).group(1)) == value
    for name, tile in (("ProjBig", cuda_mha.WIDE_BIG_TILE),
                       ("ProjSmall", cuda_mha.WIDE_SMALL_TILE)):
        args = re.search(rf"using {name} = tile::Tiling<([^>]*)>;", source).group(1)
        assert tuple(int(a) for a in args.split(",")[2:4]) == tile


def _atrank_batch(n, T_, items, users, seed):
    rng = np.random.default_rng(seed)
    return {
        "u": rng.integers(0, users, n).astype(np.int32),
        "i": rng.integers(0, items, n).astype(np.int32),
        "j": rng.integers(0, items, n).astype(np.int32),
        "y": rng.integers(0, 2, n).astype(np.float32),
        "hist_i": rng.integers(0, items, (n, T_)).astype(np.int32),
        "hist_t": rng.integers(0, 13, (n, T_)).astype(np.int32),
        "sl": np.array(([0, 1, T_, 3, 129, 77] * n)[:n], np.int32),
    }


def test_atrank_at_four_heads_and_a_history_of_150_matches_jax():
    """ATRank with heads of 16 features (num_heads=4) and max_length=150,
    the configurations K3 now takes on the card: eval_logits, the loss and
    every gradient leaf against the JAX ATRank on a copied init."""
    users, items, cates, T_ = 21, 29, 5, 150
    kw = dict(model="atrank", user_count=users, item_count=items,
              cate_count=cates, max_length=T_, num_heads=4)
    jcfg = JaxModelConfig(**kw)
    jparams = JaxATRank.init_params(jax.random.PRNGKey(5), jcfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                              ModelConfig(**kw), "cpu")
    cate_list = np.random.default_rng(2).integers(0, cates, items).astype(np.int32)
    batch = _atrank_batch(6, T_, items, users, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    cl, tcl = jnp.asarray(cate_list), torch.from_numpy(cate_list)

    want = JaxATRank.eval_logits(jparams, jb, cl, jcfg, use_pallas=False)
    with torch.no_grad():
        got = model.eval_logits(tb, tcl)
    assert got.shape == (6, items)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    want_loss, want_grads = jax.value_and_grad(JaxATRank.loss)(jparams, jb, cl, jcfg, False)
    loss = model.loss(tb, tcl)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    got_grads = grads_to_numpy(model)
    want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
    flat_got = jax.tree_util.tree_leaves_with_path(got_grads)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, flat_want[path], rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
