"""Optimizers, train state and the bf16 helpers, with optax's semantics
written out by hand.

Ported from tlsan_tpu/train/state.py (reference: TLSAN/model.py:185-205,
TLSAN/train.py:232-233): ``optax.chain(clip_by_global_norm(max), opt)``
with opt one of ``sgd``, ``adam``, ``adadelta`` or ``rmsprop`` at optax's
defaults, each driven by ``piecewise_constant_schedule(lr, {lr_drop_step:
0.1})``.  Torch's own pieces differ, so none is used:

  - the schedule count starts at 0 for the first update; the lr is `lr`
    while count < lr_drop_step and lr × 0.1 from count == lr_drop_step on
    (a torch scheduler counts its own way);
  - with g_norm = √Σ‖g‖² over every gradient, the update direction is g
    when g_norm < max, else g / g_norm · max (``clip_grad_norm_`` divides
    by ‖g‖ + 1e-6);
  - adam (b1 0.9, b2 0.999, eps 1e-8): the moments decay as
    (1 − b)·g^k + b·m, their bias correction counts from 1, and the step
    is m̂ / (√n̂ + eps);
  - adadelta (rho 0.9, eps 1e-6): E[g²] first, the step
    √(E[Δ²] + eps) / √(E[g²] + eps) · g, then E[Δ²] from that step;
  - rmsprop (decay 0.9, eps 1e-8 inside the root, no momentum): the step
    g / √(ν + eps) — torch's RMSprop has alpha 0.99 and eps outside;
  - the update is p ← p + (−lr)·u, a product and then a sum, as optax does.

Under a (dp, mp) mesh each rank's gradients are its dp share of the
global ones (models/base.py), so `step` first sums them over the dp group,
as one flattened buffer a step; the global norm then counts a replicated
gradient once and sums a vocab table's row shards over mp; the clip and
the update follow as on one device.  An optimizer's per-parameter state
(the slots) is shaped like its parameter, so a vocab table's state is
row-sharded with it.

`bf16_cast` and `wants_bf16` are the mixed-precision helpers: the network
runs on bf16 copies, and the cast's backward gives f32 gradients on the
f32 master parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tlsan_tpu_torch.core.config import TrainConfig
from tlsan_tpu_torch.parallel.mesh import Mesh, all_reduce


def bf16_cast(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every f32 tensor of `tensors` cast to bf16 (differentiably: the
    cast's backward casts the bf16 gradient back up to f32); the rest as
    they are."""
    return {k: v.to(torch.bfloat16)
            if isinstance(v, torch.Tensor) and v.dtype == torch.float32 else v
            for k, v in tensors.items()}


def wants_bf16(tc: TrainConfig) -> bool:
    dt = tc.compute_dtype
    if dt in ("float32", "f32", "fp32"):
        return False
    if dt in ("bfloat16", "bf16"):
        return True
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {dt!r}")


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """count → lr, in f32 as optax computes it: lr until count reaches
    lr_drop_step, then f32(0.1)·lr."""
    before = float(np.float32(tc.learning_rate))
    after = float(np.float32(0.1) * np.float32(tc.learning_rate))

    def schedule(count: int) -> float:
        return before if count < tc.lr_drop_step else after

    return schedule


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """√Σ‖g‖² over every tensor (optax.global_norm), on the device."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def mesh_global_norm(grads: Sequence[torch.Tensor], sharded: Sequence[bool],
                     mesh: Mesh) -> torch.Tensor:
    """The global norm of a mesh's gradients (already summed over dp): a
    replicated gradient counted once, a row-sharded one's squares summed
    over mp."""
    repl = sum(torch.sum(g * g) for g, s in zip(grads, sharded) if not s)
    part = sum(torch.sum(g * g) for g, s in zip(grads, sharded) if s)
    if isinstance(part, torch.Tensor):
        repl = repl + all_reduce(part, mesh.mp_group)
    return torch.sqrt(repl)


def dp_sum_gradients(grads: Sequence[torch.Tensor],
                     mesh: Mesh) -> List[torch.Tensor]:
    """Every gradient summed over the dp group, in one all_reduce of one
    flattened buffer."""
    if mesh.dp == 1:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.dp_group)
    return [f.view_as(g) for f, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def clip_factor(g_norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The clip as one factor: 1 below `max_norm`, else max_norm / g_norm
    (the sparse steps scale by it; `clip_by_global_norm` applies it)."""
    return torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                       max_norm / g_norm)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        g_norm: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g when the global norm (`g_norm`, by
    default `global_norm(grads)`) is below `max_norm`, else
    g / norm · max_norm.  Decided on the device (no sync)."""
    if g_norm is None:
        g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, g / g_norm * max_norm) for g in grads]


@dataclass
class OptState:
    """The updates applied so far (`count`, optax's schedule count, which
    is also Adam's) and the per-parameter state: for each slot name a list
    of tensors parallel to the parameters (none for SGD)."""

    count: int = 0
    slots: Dict[str, List[torch.Tensor]] = field(default_factory=dict)

    def clone(self) -> "OptState":
        return OptState(self.count, {k: [t.clone() for t in v]
                                     for k, v in self.slots.items()})

    def to_dict(self, names: Sequence[str]) -> Dict:
        """As a checkpoint stores it: the count, and each slot by the
        parameters' `names` (none for SGD)."""
        out: Dict = {"count": int(self.count)}
        if self.slots:
            out["slots"] = {s: dict(zip(names, ts)) for s, ts in self.slots.items()}
        return out


class Optimizer:
    """The clipped update on a step schedule.  `step` reads each
    parameter's `.grad` and updates the parameters and slots in place (JAX
    returns new arrays; in place saves a copy of every table a step)."""

    name = ""
    slot_names: tuple = ()

    def __init__(self, schedule: Callable[[int], float], max_norm: float):
        self.schedule = schedule
        self.max_norm = max_norm

    def init(self, params: Sequence[torch.Tensor] = ()) -> OptState:
        """Zero slots shaped like `params` (optax's zeros_like init)."""
        return OptState(0, {s: [torch.zeros_like(p) for p in params]
                            for s in self.slot_names})

    @torch.no_grad()
    def step(self, params: Sequence[torch.nn.Parameter], state: OptState,
             mesh: Optional[Mesh] = None,
             sharded: Sequence[bool] = ()) -> OptState:
        """With a `mesh`, `sharded` says which parameters are row shards of
        vocab tables."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        g_norm = None
        if mesh is not None:
            grads = dp_sum_gradients(grads, mesh)
            g_norm = mesh_global_norm(grads, sharded, mesh)
        grads = clip_by_global_norm(grads, self.max_norm, g_norm)
        self.apply(list(params), grads, state, range(len(params)))
        return OptState(state.count + 1, state.slots)

    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: OptState,
              which: Sequence[int]) -> None:
        """The update of parameters `params` (slot indices `which`) by the
        clipped gradients `grads`, at schedule count `state.count`."""
        raise NotImplementedError


class SGD(Optimizer):
    name = "sgd"

    def apply(self, params, grads, state, which):
        neg_lr = -self.schedule(state.count)
        for p, g in zip(params, grads):
            p.add_(g * neg_lr)


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count in f32 (optax.tree.bias_correction)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Adam(Optimizer):
    name = "adam"
    slot_names = ("mu", "nu")
    b1, b2, eps = 0.9, 0.999, 1e-8

    def corrections(self, count: int):
        """(1 − b1^t, 1 − b2^t) for the update at schedule count `count`
        (t = count + 1)."""
        return (_bias_correction(self.b1, count + 1),
                _bias_correction(self.b2, count + 1))

    def direction(self, m: torch.Tensor, n: torch.Tensor, count: int) -> torch.Tensor:
        """m̂ / (√n̂ + eps) for moments already updated at `count`."""
        c1, c2 = self.corrections(count)
        return (m / c1) / (torch.sqrt(n / c2) + self.eps)

    def apply(self, params, grads, state, which):
        neg_lr = -self.schedule(state.count)
        mu, nu = state.slots["mu"], state.slots["nu"]
        for p, g, i in zip(params, grads, which):
            m, n = mu[i], nu[i]
            m.mul_(self.b1).add_(g * (1 - self.b1))
            n.mul_(self.b2).add_(g * g * (1 - self.b2))
            p.add_(self.direction(m, n, state.count) * neg_lr)


class Adadelta(Optimizer):
    name = "adadelta"
    slot_names = ("e_g", "e_x")
    rho, eps = 0.9, 1e-6

    def apply(self, params, grads, state, which):
        neg_lr = -self.schedule(state.count)
        e_g, e_x = state.slots["e_g"], state.slots["e_x"]
        for p, g, i in zip(params, grads, which):
            eg, ex = e_g[i], e_x[i]
            eg.mul_(self.rho).add_(g * g * (1 - self.rho))
            u = torch.sqrt(ex + self.eps) / torch.sqrt(eg + self.eps) * g
            ex.mul_(self.rho).add_(u * u * (1 - self.rho))
            p.add_(u * neg_lr)


class RMSProp(Optimizer):
    name = "rmsprop"
    slot_names = ("nu",)
    decay, eps = 0.9, 1e-8

    def apply(self, params, grads, state, which):
        neg_lr = -self.schedule(state.count)
        nu = state.slots["nu"]
        for p, g, i in zip(params, grads, which):
            n = nu[i]
            n.mul_(self.decay).add_(g * g * (1 - self.decay))
            p.add_(torch.rsqrt(n + self.eps) * g * neg_lr)


OPTIMIZERS = {cls.name: cls for cls in (SGD, Adam, Adadelta, RMSProp)}


def make_optimizer(tc: TrainConfig) -> Optimizer:
    if tc.optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {sorted(OPTIMIZERS)}, "
                         f"got {tc.optimizer!r}")
    return OPTIMIZERS[tc.optimizer](lr_schedule(tc), tc.max_gradient_norm)
