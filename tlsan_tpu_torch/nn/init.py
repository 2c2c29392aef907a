"""Parameter initializers matching TF 1.8 defaults.

``tf.get_variable`` and ``tf.layers.dense`` default to glorot-uniform kernels
and zero biases, and the reference never overrides them (TLSAN/model.py:62-81,
:347).  `glorot_uniform` draws from the same distribution as
``jax.nn.initializers.glorot_uniform`` (fans from the last two axes, as
``variance_scaling`` computes them), but not the same numbers: every draw
takes an explicit ``torch.Generator``.
"""

import math
from typing import Sequence

import torch
from torch import nn


def zeros_param(*shape: int, device) -> nn.Parameter:
    """An f32 parameter of zeros on `device`: the models allocate their
    parameters so, and `init_params` draws the values."""
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


def glorot_uniform(shape: Sequence[int],
                   generator: torch.Generator) -> torch.Tensor:
    """f32 U(−limit, limit) with limit = sqrt(6 / (fan_in + fan_out)), drawn
    on the generator's device."""
    if len(shape) < 2:
        raise ValueError(f"glorot_uniform needs at least 2 axes, got {shape}")
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (2.0 * u - 1.0) * limit


def truncated_normal(shape: Sequence[int], stddev: float,
                     generator: torch.Generator) -> torch.Tensor:
    """f32 normal(0, stddev) truncated to ±2·stddev, as
    ``stddev * jax.random.truncated_normal(rng, -2, 2, shape)``, drawn on
    the generator's device."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(out, 0.0, stddev, -2.0 * stddev,
                                       2.0 * stddev, generator=generator)
