"""Shared layers.  Ported from tlsan_tpu/nn/layers.py: `dropout`,
`layer_norm` and `dense`; `lstm_scan`, `reverse_valid` and `gather_time`
come with the models that use them (ROADMAP.md queue 1, item 1)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    """LayerNorm over the last axis with the biased moment variance and
    `eps` inside the square root (reference: ATRank/model.py:461-488)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + eps) + beta


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (≡ tf.nn.dropout at train time): keep each element
    with probability 1 − rate and scale it by 1 / (1 − rate).  The mask is
    drawn from `generator`, which lives on x's device.  No-op when rate is 0
    or there is no generator (eval)."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
          ) -> torch.Tensor:
    """x @ w (+ b) (then `activation`), with w [in, out] as in the JAX
    package.  f32 at full precision: the entry points keep TF32 off."""
    out = x @ w
    if b is not None:
        out = out + b
    if activation is not None:
        out = activation(out)
    return out
