"""The replica fan-out (train/ensemble.py) with dropout, on the CPU.

Each replica draws its masks from its own generator at seed_r + 1, in the
shapes and order its forward draws them, outside ``torch.func.vmap`` (the
JAX fan-out's per-replica key, tlsan_tpu/train/ensemble.py).  So replica r
of a fan-out takes the steps a ``Trainer(seed=seed_r)`` takes, masks and
all: for the five families that draw masks (TLSAN, ATRank, CNN, CSAN,
PACA), R = 3 replicas at dropout 0.1 after 20 steps against three Trainers
(within 1e-4), and a fan-out of one replica against its Trainer, bit for
bit.  lr 0.1, as tests/test_torch_ensemble_families.py takes it (ROADMAP
§3: CNN's and ATRank's kinks).  A file of its own, so that ``--dist
loadfile`` spreads it."""

import numpy as np
import pytest
import torch

from tests.test_torch_ensemble import _family
from tests.test_torch_family_paths import cfg_kw, family_data
from tests.test_torch_sparse import single_thread  # noqa: F401 (autouse)
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.train.ensemble import ReplicaFanout
from tlsan_tpu_torch.train.loop import Trainer

FAMILIES = ["tlsan", "atrank", "cnn", "csan", "paca"]
SEEDS = [1234, 42, 7]
STEPS = 20
RATE = 0.1
TOL = 1e-4
TRAIN_KW = dict(max_epochs=1, train_batch_size=32, test_batch_size=16,
                steps_per_call=4, eval_freq=4, best_after_step=0,
                learning_rate=0.1)


def _data(name):
    """(model config kwargs at dropout RATE, train, test, cate_list)."""
    if name in ("tlsan", "atrank"):
        cfg, train, test, cate_list = _family(name)
    else:
        _, _, train, test, cate_list = family_data(name, n_train=256)
        cfg = cfg_kw(name)
    return dict(cfg, dropout=RATE), train, test, cate_list


def _steps(fan, n):
    """[R, n, B]: each replica's first n steps of its own shuffle stream,
    epoch after epoch."""
    parts, have, epoch = [], 0, 0
    while have < n:
        idx = fan._epoch_index(epoch)  # [n_chunks, R, K, B]
        idx = idx.transpose(1, 0, 2, 3).reshape(idx.shape[1], -1, idx.shape[3])
        parts.append(idx)
        have += idx.shape[1]
        epoch += 1
    return np.concatenate(parts, axis=1)[:, :n]


@pytest.mark.parametrize("name", FAMILIES)
def test_replicas_equal_their_seeded_trainers(tmp_path, name):
    """R = 3 replicas with dropout 0.1, 20 steps: each replica's parameters
    and losses within 1e-4 of a Trainer at its seed with the same dropout;
    a fan-out of the first seed alone bit for bit its Trainer's; the
    replicas' masks differ (their losses do)."""
    cfg, train, test, cate_list = _data(name)
    model = get_model(name)
    fan = ReplicaFanout(model, ModelConfig(**cfg), TrainConfig(**TRAIN_KW), cate_list,
                        train, test, SEEDS, device="cpu")
    fan1 = ReplicaFanout(model, ModelConfig(**cfg), TrainConfig(**TRAIN_KW), cate_list,
                         train, test, SEEDS[:1], device="cpu")
    idx = torch.from_numpy(_steps(fan, STEPS))
    losses = fan._fan_chunk(idx)
    loss1 = fan1._fan_chunk(idx[:1])
    for r, seed in enumerate(SEEDS):
        tr = Trainer(model, ModelConfig(**cfg), TrainConfig(
            **TRAIN_KW, seed=seed, tb_histograms=False, model_dir=str(tmp_path / str(seed))),
            cate_list, train, test, device="cpu")
        want = tr._train_chunk(idx[r]).mean()
        np.testing.assert_allclose(float(losses[r]), float(want), rtol=TOL, atol=TOL)
        for n, p in tr.model.named_parameters():
            np.testing.assert_allclose(fan.params[n][r].detach().numpy(),
                                       p.detach().numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} replica {r} {n}")
            if r == 0:
                assert torch.equal(fan1.params[n][0], p.detach()), n
        if r == 0:
            assert torch.equal(loss1[0], want)
        tr.close()
    assert len(set(losses.tolist())) == len(SEEDS)


def test_draw_shapes_are_recorded_once_per_batch_shape():
    """The fan-out records a forward's draw shapes at construction for the
    train batch (TLSAN: two per tower, the masks of both dense maps' inputs,
    [B, S, H, dh]) and draws [R, ...] masks of them a step; dropout 0 draws
    nothing."""
    cfg, train, test, cate_list = _data("tlsan")
    fan = ReplicaFanout(get_model("tlsan"), ModelConfig(**cfg), TrainConfig(**TRAIN_KW),
                        cate_list, train, test, SEEDS, device="cpu")
    (shapes,) = fan._shapes.values()
    B, H, dh = 32, cfg.get("num_heads", 8), cfg.get("hidden_units", 64) // 8
    assert shapes == [(B, cfg["Ls"], H, dh)] * 2 + [(B, cfg["Ts"] + 1, H, dh)] * 2
    batch = {k: v[torch.zeros((len(SEEDS), B), dtype=torch.long)]
             for k, v in fan.data.items()}
    masks = fan._draw_masks(batch)
    assert [tuple(m.shape) for m in masks] == [(len(SEEDS),) + s for s in shapes]
    assert not torch.equal(masks[0][0], masks[0][1])  # each replica its own
    plain = ReplicaFanout(get_model("tlsan"), ModelConfig(**dict(cfg, dropout=0.0)),
                          TrainConfig(**TRAIN_KW), cate_list, train, test, SEEDS,
                          device="cpu")
    assert plain._gens == [] and plain._shapes == {}


def _replica_plain(fn):
    """`fn` under vmap over a leading replica axis of every tensor argument
    (the non-tensor ones shared): the plain stand-in for a replica kernel."""
    def call(*args):
        dims = tuple(0 if isinstance(a, torch.Tensor) else None for a in args)
        return torch.func.vmap(fn, in_dims=dims)(*args)
    return call


def test_kernel_functions_carry_the_masks_under_vmap(monkeypatch):
    """FWAFunction and MHAFunction with dropout masks under vmap (the
    fan-out's path on the card) hand the replica entry points the masks
    with the replica axis first and keep = 1 − rate; values and gradients
    equal vmap of the plain versions under autograd with the same masks
    (the entry points, K3b's too, swapped for the plain versions, as in
    tests/test_torch_ensemble.py, since the kernels run only on the card)."""
    from tlsan_tpu_torch.ops.cuda import fwa, mha
    from tlsan_tpu_torch.ops.feature_attention import (
        feature_wise_attention_reference,
        fwa_backward_reference,
    )
    from tlsan_tpu_torch.ops.multihead_attention import (
        multihead_attention_backward_reference,
        multihead_attention_reference,
    )

    rate = 0.5  # keep = 0.5 both ways exactly
    calls = []

    def fwd(x, lengths, H, w1, b1, w2, b2, k1, k2, keep):
        calls.append(("fwd", tuple(k1.shape), keep))
        return _replica_plain(lambda *a: feature_wise_attention_reference(
            *a[:7], dropout_rate=1 - keep, keep_masks=a[7:]))(
            x, lengths, H, w1, b1, w2, b2, k1, k2)

    def bwd(x, lengths, H, w1, b1, w2, b2, g, k1, k2, keep):
        calls.append(("bwd", tuple(k2.shape), keep))
        return _replica_plain(lambda *a: fwa_backward_reference(
            *a[:8], keep_masks=a[8:], dropout_rate=1 - keep))(
            x, lengths, H, w1, b1, w2, b2, g, k1, k2)

    monkeypatch.setattr(fwa, "fwa_forward", fwd)
    monkeypatch.setattr(fwa, "fwa_backward", bwd)
    rng = np.random.default_rng(0)
    R, B, S, D, H = 3, 4, 6, 16, 2
    gen = torch.Generator().manual_seed(1)

    def f32(*shape):
        return torch.tensor(rng.normal(size=shape) * 0.3, dtype=torch.float32,
                            requires_grad=True)

    x, w1, b1, w2, b2 = f32(R, B, S, D), f32(R, 8, 8), f32(R, 8), f32(R, 8, 8), f32(R, 8)
    lengths = torch.tensor(rng.integers(0, S + 1, (R, B)), dtype=torch.int32)
    k1, k2 = (torch.rand((R, B, S, H, 8), generator=gen) < 0.5 for _ in range(2))
    g = torch.randn((R, B, D), generator=gen)

    def run(fn):
        out = torch.func.vmap(fn)(x, lengths, w1, b1, w2, b2, k1, k2)
        return out, torch.autograd.grad(out, [x, w1, b1, w2, b2], g)

    got = run(lambda x, ln, w1, b1, w2, b2, m1, m2: fwa.FWAFunction.apply(
        x, ln, H, w1, b1, w2, b2, m1, m2, rate))
    want = run(lambda x, ln, w1, b1, w2, b2, m1, m2: feature_wise_attention_reference(
        x, ln, H, w1, b1, w2, b2, dropout_rate=rate, keep_masks=(m1, m2)))
    assert calls == [("fwd", (R, B, S, H, 8), 0.5), ("bwd", (R, B, S, H, 8), 0.5)]
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)

    mcalls = []

    def mfwd(q, k, ql, kl, H, *rest):
        mcalls.append((tuple(rest[-2].shape), rest[-1]))
        return _replica_plain(lambda q, k, ql, kl, *w: multihead_attention_reference(
            q, ql, k, kl, H, dict(zip(mha.WEIGHTS, w[:8])), 1 - rest[-1],
            keep_mask=w[8])[0])(q, k, ql, kl, *rest[:-1])

    def mbwd(q, k, ql, kl, H, *rest):
        mcalls.append(("bwd", tuple(rest[-2].shape), rest[-1]))
        return multihead_attention_backward_reference(
            q, ql, k, kl, H, dict(zip(mha.WEIGHTS, rest[:8])), rest[8], 1 - rest[-1],
            rest[-2])

    monkeypatch.setattr(mha, "mha_forward", mfwd)
    monkeypatch.setattr(mha, "mha_backward", mbwd)
    Tq = 5
    q = f32(R, B, Tq, D)
    qlen = torch.tensor(rng.integers(0, Tq + 1, (R, B)), dtype=torch.int32)
    ws = [f32(R, D, D) if n.startswith("w") else f32(R, D) for n in mha.WEIGHTS]
    mask = torch.rand((R, B, H, Tq, Tq), generator=gen) < 0.5
    gq = torch.randn((R, B, Tq, D), generator=gen)

    def mrun(fn):
        out = torch.func.vmap(lambda q, ql, m, *w: fn(q, ql, m, *w))(q, qlen, mask, *ws)
        return out, torch.autograd.grad(out, [q, *ws], gq)

    got = mrun(lambda q, ql, m, *w: mha.MHAFunction.apply(q, q, ql, ql, H, *w, m, rate))
    want = mrun(lambda q, ql, m, *w: multihead_attention_reference(
        q, ql, q, ql, H, dict(zip(mha.WEIGHTS, w)), rate, keep_mask=m)[0])
    assert mcalls == [((R, B, H, Tq, Tq), 0.5), ("bwd", (R, B, H, Tq, Tq), 0.5)]
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
