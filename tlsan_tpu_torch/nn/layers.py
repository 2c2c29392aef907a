"""Shared layers.  Ported from tlsan_tpu/nn/layers.py: `dropout` so far;
the rest comes with the models that use it (ROADMAP.md queue 1, item 1)."""

from __future__ import annotations

from typing import Optional

import torch


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
