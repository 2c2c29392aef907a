"""Optimizer and train state, with optax's semantics written out by hand.

Ported from tlsan_tpu/train/state.py (reference: TLSAN/model.py:185-205,
TLSAN/train.py:232-233): ``optax.chain(clip_by_global_norm(max),
sgd(piecewise_constant_schedule(lr, {lr_drop_step: 0.1})))``.  Torch's own
pieces differ: ``clip_grad_norm_`` divides by ‖g‖ + 1e-6, and a torch
scheduler counts epochs or steps its own way.  So here:

  - the schedule count starts at 0 for the first update; the lr is `lr`
    while count < lr_drop_step and lr × 0.1 from count == lr_drop_step on;
  - with g_norm = √Σ‖g‖² over every gradient, the update direction is g
    when g_norm < max, else g / g_norm · max;
  - the update is p ← p + (−lr)·g, a product and then a sum, as optax does.

Under a (dp, mp) mesh each rank's gradients are its dp share of the
global ones (models/base.py), so `step` first sums them over the dp group,
as one flattened buffer a step; the global norm then counts a replicated
gradient once and sums a vocab table's row shards over mp; the clip and
the update follow as on one device.

Only SGD, the TLSAN default, is ported; adam, adadelta and rmsprop raise
(ROADMAP.md queue 1, item 24).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tlsan_tpu_torch.core.config import TrainConfig
from tlsan_tpu_torch.parallel.mesh import Mesh, all_reduce


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
    """optax's ScaleByScheduleState for SGD: the updates applied so far."""

    count: int = 0


class SGD:
    """Clipped SGD on a step schedule.  `step` reads each parameter's
    `.grad` and updates the parameters in place (JAX returns new arrays;
    in place saves a copy of every table a step)."""

    def __init__(self, schedule: Callable[[int], float], max_norm: float):
        self.schedule = schedule
        self.max_norm = max_norm

    def init(self) -> OptState:
        return OptState()

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
        neg_lr = -self.schedule(state.count)
        for p, g in zip(params, clip_by_global_norm(grads, self.max_norm, g_norm)):
            p.add_(g * neg_lr)
        return OptState(state.count + 1)


def make_optimizer(tc: TrainConfig) -> SGD:
    if tc.optimizer != "sgd":
        raise NotImplementedError(
            f"optimizer {tc.optimizer!r} is not ported yet (ROADMAP.md "
            "queue 1, item 24); sgd is the TLSAN default")
    return SGD(lr_schedule(tc), tc.max_gradient_norm)
