"""K3b, the multi-head attention backward, on the CPU: its plain version
(`multihead_attention_backward_reference`, the kernel's oracle on the
card) against jax.vjp of the JAX package's multihead_attention and against
torch autograd of the port's plain forward, with k_len = 0 rows, query-
masked rows, JAX's dropout masks and the replica axis under vmap;
`MHAFunction` with K3's and K3b's launches swapped for the plain forward
and the plain backward (the kernels run only on the card) against
autograd; and K3b's launch plan and scratch sizing, which must take every
shape K3's plan takes.  Sizes are small (B <= 6, T in {1, 5, 9, 17}, D =
16 or 32, 2 or 4 heads), inputs from a numpy seed."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlsan_tpu.models.atrank import _attn_params
from tlsan_tpu.ops import multihead_attention as jax_mha
from tlsan_tpu_torch.nn.layers import layer_norm
from tlsan_tpu_torch.ops import multihead_attention as T
from tlsan_tpu_torch.ops.cuda import mha as cuda_mha
from tlsan_tpu_torch.ops.cuda.common import SMEM_LIMIT

TOL = 1e-5  # tests/test_torch_mha.py's bar
W = cuda_mha.WEIGHTS
GRADS = ("d_queries", "d_keys", *(f"d{n}" for n in W))


def _case(B, Tq, Tk, D, self_attention, seed, lead=()):
    """queries, keys, q_len, k_len, params and g as numpy arrays: query
    lengths Tq, 0, 1 and key lengths 0, Tk, 1 in the first rows (a full
    query row over an empty history, a query-masked row), random after;
    self-attention takes keys and k_len from the queries."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=lead + shape) * scale).astype(np.float32)

    q = f32(B, Tq, D)
    k = q if self_attention else f32(B, Tk, D)
    q_len = rng.integers(0, Tq + 1, lead + (B,)).astype(np.int32)
    k_len = rng.integers(0, Tk + 1, lead + (B,)).astype(np.int32)
    q_len[..., :3] = [Tq, 0, 1][:B]
    k_len[..., :3] = [0, Tk, 1][:B]
    if self_attention:
        k_len = q_len
    if lead:
        p = {n: f32(*((D, D) if n.startswith("w") else (D,)), scale=0.3) for n in W}
        p["ln_gamma"] += 1.0
    else:
        p = {n: np.array(v) for n, v in _attn_params(jax.random.PRNGKey(seed), D).items()}
        p["ln_gamma"] = 1.0 + f32(D, scale=0.1)
        p["ln_beta"] = f32(D, scale=0.1)
    return q, k, q_len, k_len, p, f32(B, Tq, D)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _fold(grads, self_attention):
    """(d_queries, d_keys, weights...) as autograd returns them for the
    leaves (queries[, keys], weights...): self-attention's two summed."""
    if self_attention:
        return (grads[0] + grads[1], *grads[2:])
    return tuple(grads)


def _close(got, want, names, tol=TOL):
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=name)


CASES = [(6, 9, 9, 32, 4, True), (4, 17, 17, 16, 2, True), (5, 1, 17, 32, 4, False),
         (6, 5, 9, 16, 2, False)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,Tq,Tk,D,H,self_attention", CASES)
def test_plain_backward_matches_jax_vjp(B, Tq, Tk, D, H, self_attention, rate):
    """(a) Every gradient against jax.vjp of the JAX reference: self- and
    cross-attention (the readout at Tq = 1), k_len = 0 and query-masked
    rows, and under dropout JAX's own mask (jax.random.bernoulli with the
    rng the JAX function draws from) handed to the port."""
    q, k, q_len, k_len, p, g = _case(B, Tq, Tk, D, self_attention, seed=B + Tq + D)
    names = sorted(p)
    rng = jax.random.PRNGKey(7 + Tq) if rate else None

    def jax_fn(q_, k_, *ws):
        return jax_mha.multihead_attention(
            q_, jnp.asarray(q_len), q_ if self_attention else k_, jnp.asarray(k_len), H,
            dict(zip(names, ws)), dropout_rate=rate, rng=rng)[0]

    _, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), *(jnp.asarray(p[n]) for n in names))
    want = vjp(jnp.asarray(g))
    want = dict(zip(["d_queries", "d_keys", *(f"d{n}" for n in names)], want))
    mask = (torch.from_numpy(np.array(jax.random.bernoulli(rng, 1 - rate, (B, H, Tq, Tk))))
            if rate else None)
    qt, kt, qlt, klt, gt = _t(q, k, q_len, k_len, g)
    got = T.multihead_attention_backward_reference(
        qt, qlt, kt, klt, H, dict(zip(names, _t(*(p[n] for n in names)))), gt, rate, mask)
    got = dict(zip(GRADS, got))
    if self_attention:  # jax.vjp's keys are unused there: queries carry both
        got["d_queries"] = got["d_queries"] + got.pop("d_keys")
        want.pop("d_keys")
    _close([got[n] for n in want], list(want.values()), list(want))


def test_edges_empty_history_and_query_masked_rows():
    """A row with k_len = 0 has a softmax uniform over every key, padding
    included: its dV is not zero at padded keys (d_keys and dwv move), its
    dQ and dK from the scores are (dwk and dbk are exactly 0 when every row
    is so).  A query row at t >= q_len passes dy to the queries through the
    residual alone: at q_len = 0 d_queries is LayerNorm's backward of g and
    dwq, dbq are exactly 0."""
    B, Tq, Tk, D, H = 3, 5, 9, 16, 2
    q, k, _, _, p, g = _case(B, Tq, Tk, D, False, seed=3)
    qt, kt, gt = _t(q, k, g)
    pt = dict(zip(W, _t(*(p[n] for n in W))))
    full = torch.full((B,), Tq, dtype=torch.int32)
    got = dict(zip(GRADS, T.multihead_attention_backward_reference(
        qt, full, kt, torch.zeros(B, dtype=torch.int32), H, pt, gt)))
    assert torch.count_nonzero(got["dwk"]) == 0 and torch.count_nonzero(got["dbk"]) == 0
    assert bool((got["d_keys"].abs().sum(-1) > 0).all())  # every key, padded ones too
    assert torch.count_nonzero(got["dwv"]) > 0
    got = dict(zip(GRADS, T.multihead_attention_backward_reference(
        qt, torch.zeros(B, dtype=torch.int32), kt, torch.full((B,), Tk, dtype=torch.int32),
        H, pt, gt)))
    x = qt.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(layer_norm(x, pt["ln_gamma"], pt["ln_beta"]), x, gt)
    np.testing.assert_allclose(got["d_queries"].numpy(), want.numpy(), rtol=TOL, atol=TOL)
    for name in ("dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "d_keys"):
        assert torch.count_nonzero(got[name]) == 0, name


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("self_attention", [True, False])
def test_plain_backward_replica_axis_matches_autograd_under_vmap(self_attention, rate):
    """(b) With a replica axis (R = 3), against torch autograd of
    multihead_attention_reference under torch.func.vmap: each replica's
    weight gradients its own."""
    R, B, Tq, D, H = 3, 4, 5, 16, 2
    Tk = Tq if self_attention else 9
    q, k, q_len, k_len, p, g = _case(B, Tq, Tk, D, self_attention, seed=21, lead=(R,))
    qt, kt, qlt, klt, gt = _t(q, k, q_len, k_len, g)
    pt = dict(zip(W, _t(*(p[n] for n in W))))
    mask = (torch.rand((R, B, H, Tq, Tk), generator=torch.Generator().manual_seed(5))
            < 1 - rate)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, *pt.values())]

    def one(x, y, ql, kl, m, *ws):
        return T.multihead_attention_reference(x, ql, x if self_attention else y, kl, H,
                                               dict(zip(W, ws)), rate, keep_mask=m)[0]

    out = torch.func.vmap(one)(*leaves[:2], qlt, klt, mask, *leaves[2:])
    want = torch.autograd.grad(out, leaves, gt, allow_unused=True)
    full = T.multihead_attention_backward_reference(qt, qlt, kt, klt, H, pt, gt, rate,
                                                    mask if rate else None)
    got = _fold(full, self_attention)
    if self_attention:
        want = (want[0], *want[2:])
    _close(got, want, GRADS[1:] if self_attention else GRADS)
    for r in range(R):  # a replica's gradients are a call's on its slice
        one_r = T.multihead_attention_backward_reference(
            qt[r], qlt[r], kt[r], klt[r], H, {n: v[r] for n, v in pt.items()}, gt[r], rate,
            mask[r] if rate else None)
        for a, b in zip(full, one_r):
            np.testing.assert_allclose(a[r].numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,Tq,Tk,self_attention", [(32, 96, 96, True), (32, 1, 96, False)])
def test_error_scale_bounds_f32_rounding(B, Tq, Tk, self_attention):
    """The bar the card holds K3b and MHAFunction to (chip_smoke.py's
    _mha_grad_err: MHA_GRAD_TOL · (1 + the error scale)) holds for the
    plain version in f32 against itself in float64, at the train step's
    shapes with chip_smoke.py's input scales (weights · 0.2); the scale
    bounds every gradient's magnitude."""
    D, H, tol = 64, 8, 1e-5
    q, k, q_len, k_len, p, g = _case(B, Tq, Tk, D, self_attention, seed=B + Tq, lead=())
    rng = np.random.default_rng(Tq)
    p = {n: (rng.normal(size=v.shape) * (0.2 if n.startswith("w") else 0.1)).astype(np.float32)
         for n, v in p.items()}
    p["ln_gamma"] += 1.0
    qt, kt, qlt, klt, gt = _t(q, k, q_len, k_len, g)
    pt = dict(zip(W, _t(*(p[n] for n in W))))
    args = (qt, qlt, kt, klt, H, pt, gt)
    f32 = T.multihead_attention_backward_reference(*args)
    f64 = T.multihead_attention_backward_reference(
        qt.double(), qlt, kt.double(), klt, H, {n: v.double() for n, v in pt.items()},
        gt.double())
    scale = T.multihead_attention_backward_error_scale(*args)
    for name, a, b, sc in zip(GRADS, f32, f64, scale):
        assert bool((sc >= b.abs().float() * (1 - 1e-5)).all()), name
        assert bool(((a.double() - b).abs() <= tol * (1.0 + sc.double())).all()), name


def _plain_forward(queries, keys, q_len, k_len, num_heads, *rest):
    """mha_forward's plain counterpart (a leading replica axis under vmap)."""
    def one(q, k, ql, kl, *ws):
        mask = ws[len(W)] if len(ws) > len(W) else None
        return T.multihead_attention_reference(
            q, ql, k, kl, num_heads, dict(zip(W, ws[:len(W)])), 1.0 - keep, keep_mask=mask)[0]

    keep = rest[-1] if len(rest) > len(W) else 1.0
    tensors = rest[:len(W) + 1] if len(rest) > len(W) else rest
    fn = torch.func.vmap(one) if queries.dim() == 4 else one
    return fn(queries, keys, q_len, k_len, *tensors)


def _swapped(monkeypatch):
    """K3's and K3b's entry points swapped for the plain forward and the
    plain backward; the backward's calls are recorded."""
    calls = []

    def plain_backward(queries, keys, q_len, k_len, num_heads, *rest):
        weights, g, drop = rest[:len(W)], rest[len(W)], rest[len(W) + 1:]
        calls.append((tuple(queries.shape), queries.data_ptr() == keys.data_ptr(),
                      None if not drop else (tuple(drop[0].shape), drop[1])))
        return T.multihead_attention_backward_reference(
            queries, q_len, keys, k_len, num_heads, dict(zip(W, weights)), g,
            1.0 - drop[1] if drop else 0.0, drop[0] if drop else None)

    monkeypatch.setattr(cuda_mha, "mha_forward", _plain_forward)
    monkeypatch.setattr(cuda_mha, "mha_backward", plain_backward)
    return calls


@pytest.mark.parametrize("kind", ["self", "readout", "dropout", "replicas"])
def test_mha_function_with_swapped_launches_is_autograd(monkeypatch, kind):
    """(c) MHAFunction, its K3 and K3b launches swapped for the plain
    forward and backward, against autograd of the plain forward:
    self-attention (queries is keys: autograd adds the two gradients), the
    readout, dropout (the mask and the rate reach the backward) and R = 3
    under vmap (one backward call for every replica).  The backward calls
    K3b's entry point once and never the plain forward or autograd."""
    calls = _swapped(monkeypatch)
    R = 3 if kind == "replicas" else None
    B, D, H = 4, 16, 2
    Tq, Tk = (1, 9) if kind == "readout" else (6, 6)
    self_attention = kind != "readout"
    rate = 0.5 if kind == "dropout" else 0.0
    lead = (R,) if R else ()
    q, k, q_len, k_len, p, g = _case(B, Tq, Tk, D, self_attention, seed=31, lead=lead)
    qt, kt, qlt, klt, gt = _t(q, k, q_len, k_len, g)
    ws = _t(*(p[n] for n in W))
    mask = (torch.rand((B, H, Tq, Tk), generator=torch.Generator().manual_seed(1)) < 0.5
            if rate else None)
    drop = (mask, rate) if rate else ()
    reference = T.multihead_attention_reference
    plain_calls = []
    monkeypatch.setattr(T, "multihead_attention_reference",
                        lambda *a, **kw: plain_calls.append(1) or reference(*a, **kw))

    def run(use_fn):
        x = qt.clone().requires_grad_(True)
        y = x if self_attention else kt.clone().requires_grad_(True)
        lw = [t.clone().requires_grad_(True) for t in ws]
        if use_fn:
            def fn(x_, y_, ql, kl, *w):
                return cuda_mha.MHAFunction.apply(x_, y_, ql, kl, H, *w, *drop)
        else:
            def fn(x_, y_, ql, kl, *w):
                return reference(x_, ql, y_, kl, H, dict(zip(W, w)), rate, keep_mask=mask)[0]
        if R:
            out = torch.func.vmap(lambda x_, ql, *w: fn(x_, x_, ql, ql, *w))(x, qlt, *lw)
        else:
            out = fn(x, y, qlt, klt, *lw)
        del plain_calls[:]
        leaves = [x, *lw] if self_attention else [x, y, *lw]
        return out, torch.autograd.grad(out, leaves, gt)

    got, got_grads = run(True)
    assert plain_calls == []  # the backward ran no plain forward, no autograd
    want, want_grads = run(False)
    shape = lead + (B, Tq, D)
    assert calls == [(shape, self_attention,
                      ((B, H, Tq, Tk), 1.0 - rate) if rate else None)]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=TOL, atol=TOL)
    _close(got_grads, want_grads, GRADS[1:] if self_attention else GRADS)


def test_mha_function_backward_raises_off_the_card(monkeypatch):
    """No fallback: with only the forward swapped for the plain version, the
    backward hands CPU tensors to K3b's wrapper, which refuses them."""
    monkeypatch.setattr(cuda_mha, "mha_forward", _plain_forward)
    q, _, q_len, _, p, g = _case(3, 4, 4, 16, True, seed=41)
    x, ql, gt = _t(q, q_len, g)
    x.requires_grad_(True)
    out = cuda_mha.MHAFunction.apply(x, x, ql, ql, 2, *_t(*(p[n] for n in W)))
    before = cuda_mha.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        torch.autograd.grad(out, x, gt)
    assert cuda_mha.bwd_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mha.mha_backward(x.detach(), x.detach(), ql, ql, 2, *_t(*(p[n] for n in W)), gt)


def _levels(n):
    slots, tickets = n, 0
    while n > 1:
        n = -(-n // cuda_mha.BWD_GROUP)
        slots, tickets = slots + n, tickets + n
    return slots, tickets


def _k3_shapes(D):
    """Every (B, Tq, Tk, H, self_attention) of a grid that K3's launch_plan
    accepts at width D."""
    for B, Tq, Tk, H, self_attention in itertools.product(
            (1, 37, 200, 5000), (1, 7, 96, 250, 256, 600), (1, 17, 96, 256),
            (1, 2, 4, 8, 16, 64), (False, True)):
        if self_attention and Tq != Tk:
            continue
        try:
            cuda_mha.launch_plan(B, Tq, Tk, D, H, self_attention)
        except ValueError:
            continue
        yield B, Tq, Tk, H, self_attention


def _check_bwd_plan(plan, B, Tq, Tk, D, H, R, self_attention):
    """A K3b plan within the card's limits: the resident design where its
    layout fits a CTA's shared memory at some cluster size dividing the
    heads (columns on 16-byte boundaries), with the clusters the card runs
    at once; else the streamed one (split by heads or by rows, its layout
    in shared memory or in device memory past it, the weights never in the
    layout); slots of a tree's columns and the scratch of its tree."""
    limit = SMEM_LIMIT - cuda_mha.STATIC_SMEM
    cs, rows = plan.cs, plan.mode == cuda_mha.ROWS
    assert cs in cuda_mha.CLUSTER_SIZES and (rows or H % cs == 0)
    assert plan.replicas == R and plan.dh == D // H
    assert plan.threads == cuda_mha.THREADS and plan.qb >= 1
    assert plan.qb <= (-(-Tq // cs) if rows else Tq)
    assert plan.alias == (self_attention and Tq == Tk)
    assert plan.smem <= limit
    if plan.mode == cuda_mha.RESIDENT:
        assert D % 4 == 0 and (D // cs) % 4 == 0 and plan.stage == 0 and plan.work == 0
        assert plan.per_cta == cuda_mha._bwd_layout(Tq, Tk, D, H, cs, plan.qb, plan.alias)
        assert plan.smem == 4 * plan.per_cta
        active = cuda_mha.ACTIVE_CLUSTERS[cs, cuda_mha.ctas_per_sm(plan.smem)]
        assert plan.clusters == min(B, active)
    else:
        # no resident layout fits, at any cluster size or block
        for c in cuda_mha.CLUSTER_SIZES:
            if D % 4 == 0 and H % c == 0 and (D // c) % 4 == 0:
                assert 4 * cuda_mha._bwd_layout(Tq, Tk, D, H, c, 1, plan.alias) > limit
        main, stage = cuda_mha._stream_layout(Tq, Tk, D, H, cs, plan.qb, rows)
        assert (plan.per_cta, plan.stage) == (main, stage)
        if plan.work:  # no streamed layout fits shared memory either
            assert plan.smem == 4 * stage and plan.work == plan.clusters * cs * main
            assert cs * main <= cuda_mha.WORK_LIMIT
        else:  # one CTA an SM: the streamed kernel's registers
            assert plan.smem == 4 * (main + stage)
            assert plan.clusters == min(B, cuda_mha.ACTIVE_CLUSTERS[cs, 1])
        # the stage holds two buffers, each a k-tile of the own query and key
        # rows of x and the three weights' tiles, so one loads while the
        # other is summed
        nq, nk = (-(-Tq // cs), -(-Tk // cs)) if rows else (Tq, Tk)
        ra, rk = (-(-min(n, cuda_mha.TILE_ROWS) // 4) * 4 for n in (nq, nk))
        dcp = (H if rows else H // cs) * (-(-(D // H) // 4) * 4)
        nc = min(dcp, cuda_mha.TILE_N)
        assert stage >= 2 * ((ra + rk) * (cuda_mha.TILE_K + cuda_mha.PAD)
                             + 3 * cuda_mha.TILE_K * (nc + cuda_mha.PAD))
    assert plan.grid == plan.clusters * cs <= 2 * 132  # two CTAs on each of 132 SMs
    dc = D if rows else D // cs
    assert plan.weights == 3 * D * dc + 5 * dc
    assert plan.trees == (1 if rows else cs)
    assert (plan.slots, plan.tickets) == _levels(plan.clusters * cs if rows else plan.clusters)


@pytest.mark.parametrize("D", [16, 48, 64, 128, 256])
def test_backward_plan_takes_every_shape_k3_takes(D):
    """(d) Wherever K3's launch_plan accepts a shape, K3b's backward_plan
    does, for R = 1 and 8 (`_check_bwd_plan`).  None of it grows with B
    past one wave: B = 5000 and B = 50,000 get one plan."""
    accepted = 0
    for B, Tq, Tk, H, self_attention in _k3_shapes(D):
        accepted += 1
        for R in (1, 8):
            plan = cuda_mha.backward_plan(B, Tq, Tk, D, H, R, self_attention)
            _check_bwd_plan(plan, B, Tq, Tk, D, H, R, self_attention)
            if B == 5000:
                assert cuda_mha.backward_plan(50_000, Tq, Tk, D, H, R, self_attention) == \
                    dataclasses.replace(plan)
    assert accepted > 0
    # the main-path shapes: a resident cluster of several CTAs a row in shared memory
    for Tq, self_attention in ((96, True), (1, False)):
        plan = cuda_mha.backward_plan(32, Tq, 96, 64, 8, 1, self_attention)
        assert plan.mode == cuda_mha.RESIDENT and plan.cs > 1 and plan.clusters == 32


def test_backward_plan_is_a_pure_function_of_the_shape():
    """The plan depends on the shape alone, not on what was planned before:
    two calls (and a call after the cache is cleared, the shapes taken in
    another order) give one plan; a replica launch's geometry is that of a
    single launch at the same shape, so replica r's gradients are bit for
    bit those of a launch on its slice."""
    shapes = [(32, 96, 96, 64, 8, True), (32, 1, 96, 64, 8, False), (2048, 96, 96, 64, 8, True),
              (37, 17, 17, 128, 4, True), (4, 600, 256, 256, 8, False), (9, 7, 250, 64, 4, False)]
    first = [cuda_mha.backward_plan(B, Tq, Tk, D, H, 1, sa) for B, Tq, Tk, D, H, sa in shapes]
    cuda_mha.backward_plan.cache_clear()
    again = [cuda_mha.backward_plan(B, Tq, Tk, D, H, 1, sa)
             for B, Tq, Tk, D, H, sa in reversed(shapes)][::-1]
    assert first == again
    for plan, (B, Tq, Tk, D, H, sa) in zip(first, shapes):
        for R in (2, 8):
            replica = cuda_mha.backward_plan(B, Tq, Tk, D, H, R, sa)
            assert dataclasses.replace(replica, replicas=1) == plan


def test_backward_plan_refuses_what_k3_refuses():
    """K3b refuses no rows and heads that do not divide D, as K3 does, and
    a layout past WORK_LIMIT floats a cluster; heads of 64 features, D =
    512, D past 512 and D not a multiple of 4, which refused before, take a
    plan: resident or streamed, in shared memory within a CTA's limit, or
    in device memory."""
    for shape, match in (((4, 5, 5, 64, 1), None),
                         ((4, 5, 5, 66, 6), None),
                         ((4, 5, 5, 512, 16), None),
                         ((4, 5, 5, 1024, 16), None),
                         ((4, 5, 5, 64, 6), "D % num_heads"),
                         ((1, 1, 1 << 24, 64, 1), "device memory"),
                         ((0, 5, 5, 64, 8), "B, Tq, Tk")):
        if match is None:
            plan = cuda_mha.backward_plan(*shape)
            assert cuda_mha.launch_plan(*shape).smem <= SMEM_LIMIT
            _check_bwd_plan(plan, *shape, 1, False)
            continue
        with pytest.raises(ValueError, match=match):
            cuda_mha.backward_plan(*shape)
        with pytest.raises(ValueError):
            cuda_mha.launch_plan(*shape)
    with pytest.raises(ValueError, match="replicas"):
        cuda_mha.backward_plan(4, 5, 5, 64, 8, 0)


def test_backward_scratch_grows_and_is_reused(monkeypatch):
    """K3b's scratch per device: slots for every replica's and rank's tree,
    tickets at 0, the workspace only for a plan past the shared memory; a
    larger plan grows it, a smaller one reuses it."""
    monkeypatch.setattr(cuda_mha, "_scratch", {})
    x = torch.empty(1)
    small = cuda_mha.backward_plan(32, 96, 96, 64, 8, 2, True)
    trees = 2 * small.cs
    slots, tickets, work = cuda_mha._bwd_scratch(x, small)
    assert slots.numel() == trees * small.slots * small.weights and work is None
    assert tickets.numel() == trees * small.tickets and torch.count_nonzero(tickets) == 0
    assert small.mode == cuda_mha.RESIDENT
    big = cuda_mha.backward_plan(4, 600, 600, 256, 8)
    assert big.work > 0 and big.smem == 4 * big.stage
    slots2, tickets2, work2 = cuda_mha._bwd_scratch(x, big)
    assert work2.numel() == big.work
    assert slots2.numel() >= big.trees * big.slots * big.weights
    again = cuda_mha._bwd_scratch(x, small)
    assert again[0] is slots2 and again[1] is tickets2 and again[2] is None
