"""Feature-wise multi-head attention — TLSAN's core op.

Semantics (reference: TLSAN/model.py:370-394 `feature_wise_attention`,
ported from tlsan_tpu/ops/feature_attention.py):
  - split the feature axis into H heads (a reshape);
  - two per-head dense maps sharing weights across heads and batch:
    map1 = relu(x·W1 + b1), map2 = map1·W2 + b2;
  - additive −1e30 mask on padded time positions;
  - softmax over the TIME axis per feature;
  - weighted sum over time, heads re-concatenated on features.

Shapes: x [B, S, D], lengths [B] → out [B, D], soft [B, S, H, D/H].

`feature_wise_attention` runs the plain version for a CPU tensor and, for
a CUDA f32 tensor, `ops/cuda/fwa.py::FWAFunction`: the CUDA forward kernel
K1 and, under autograd, the CUDA backward kernel K2.  A bf16 tensor runs
as f32 between two casts; any other dtype on CUDA raises.
Train-time dropout (rate > 0 with a generator) runs in the plain version
only; on CUDA it raises until the kernels draw their own masks (ROADMAP.md
queue 1, item 25).
"""

from __future__ import annotations

from typing import Optional

import torch

from tlsan_tpu_torch.nn.layers import dropout
from tlsan_tpu_torch.nn.masks import additive_neg_mask, sequence_mask
from tlsan_tpu_torch.ops.cuda import fwa


def feature_wise_attention_reference(x, lengths, num_heads: int, w1, b1, w2,
                                     b2, return_soft: bool = False,
                                     dropout_rate: float = 0.0,
                                     generator: Optional[torch.Generator] = None):
    """Plain PyTorch version (the correctness oracle of the kernel).  On
    CUDA the caller keeps TF32 off, as the f32 contract needs.  Dropout
    lands on the input of each dense map (TLSAN/model.py:428-431), drawn
    from `generator` (x's input first, then map1's)."""
    B, S, D = x.shape
    dh = D // num_heads
    x4 = x.reshape(B, S, num_heads, dh)
    x_in = dropout(x4, dropout_rate, generator)
    m1 = torch.relu(torch.einsum("bshd,de->bshe", x_in, w1) + b1)
    m1_in = dropout(m1, dropout_rate, generator)
    m2 = torch.einsum("bshd,de->bshe", m1_in, w2) + b2
    mask = sequence_mask(lengths, S)  # [B, S]
    m2 = additive_neg_mask(m2, mask[:, :, None, None])
    soft = torch.softmax(m2, dim=1)
    out = torch.sum(soft * x4, dim=1).reshape(B, D)
    if return_soft:
        return out, soft
    return out


def _backward_terms(x, lengths, num_heads: int, w1, b1, w2, b2, g):
    """The closed-form backward's elementwise terms, per head:
    (x4, m1, soft, g4, dm2, dz1), with dz1 already masked by [z1 > 0]."""
    B, S, D = x.shape
    dh = D // num_heads
    x4 = x.reshape(B, S, num_heads, dh)
    z1 = torch.einsum("bshd,de->bshe", x4, w1) + b1
    m1 = torch.relu(z1)
    m2 = torch.einsum("bshd,de->bshe", m1, w2) + b2
    m2 = additive_neg_mask(m2, sequence_mask(lengths, S)[:, :, None, None])
    soft = torch.softmax(m2, dim=1)
    g4 = g.reshape(B, 1, num_heads, dh)
    ds = g4 * x4
    dm2 = soft * (ds - torch.sum(soft * ds, dim=1, keepdim=True))
    dz1 = torch.einsum("bshe,de->bshd", dm2, w2) * (z1 > 0)
    return x4, m1, soft, g4, dm2, dz1


def _backward_sums(x4, m1, soft, g4, dm2, dz1, w1):
    B, S, H, dh = x4.shape
    dx = soft * g4 + torch.einsum("bshe,de->bshd", dz1, w1)
    dw1 = torch.einsum("bshd,bshe->de", x4, dz1)
    dw2 = torch.einsum("bshd,bshe->de", m1, dm2)
    return (dx.reshape(B, S, H * dh), dw1, dz1.sum(dim=(0, 1, 2)), dw2,
            dm2.sum(dim=(0, 1, 2)))


def fwa_backward_reference(x, lengths, num_heads: int, w1, b1, w2, b2, g):
    """Plain PyTorch version of K2, in the kernel's closed-form algebra (not
    autograd): the gradients (dx, dw1, db1, dw2, db2) of the forward at
    (x, w1, b1, w2, b2) for the incoming gradient g = dL/dout [B, D].  It is
    K2's oracle on the card and what the CPU tests hold against JAX."""
    terms = _backward_terms(x, lengths, num_heads, w1, b1, w2, b2, g)
    return _backward_sums(*terms, w1)


def fwa_backward_error_scale(x, lengths, num_heads: int, w1, b1, w2, b2, g):
    """For each entry of (dx, dw1, db1, dw2, db2), the sum of the magnitudes
    of the terms it adds up: the scale of its f32 rounding error, which two
    correct implementations that sum in other orders may differ by (times
    a few ε).  It matters where terms cancel: db2 = Σ dm2 is exactly 0
    (Σ_t soft = 1 for every row), so its computed value is rounding noise
    of order ε·Σ|dm2|, and only a tolerance relative to this scale, not to
    the value, tells a right kernel from a wrong one."""
    terms = _backward_terms(x, lengths, num_heads, w1, b1, w2, b2, g)
    return _backward_sums(*map(torch.abs, terms), torch.abs(w1))


def feature_wise_attention(x, lengths, num_heads: int, w1, b1, w2, b2,
                           dropout_rate: float = 0.0,
                           generator: Optional[torch.Generator] = None):
    """Plain version on the CPU, K1 (and K2 under autograd) on a CUDA f32
    tensor.  A bf16 `x` (mixed precision) is cast to f32 with the weights,
    runs as f32 does, and its output is cast back: the kernels keep their
    f32 contract, so the card and the CPU compute the same function, and
    the casts' backward hands K2 an f32 gradient.  Dropout engages when
    `dropout_rate` > 0 and a generator is given (training); without one it
    is the identity."""
    if x.dtype == torch.bfloat16:
        w1, b1, w2, b2 = (t.float() for t in (w1, b1, w2, b2))
        return feature_wise_attention(
            x.float(), lengths, num_heads, w1, b1, w2, b2, dropout_rate,
            generator).to(torch.bfloat16)
    if x.device.type == "cpu":
        return feature_wise_attention_reference(
            x, lengths, num_heads, w1, b1, w2, b2,
            dropout_rate=dropout_rate, generator=generator)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        if dropout_rate > 0.0 and generator is not None:
            raise NotImplementedError(
                "feature_wise_attention: dropout in the CUDA kernels is not "
                "ported yet (ROADMAP.md queue 1, item 25); every reference "
                "flag table has dropout 0")
        return fwa.FWAFunction.apply(x, lengths, num_heads, w1, b1, w2, b2)
    raise NotImplementedError(
        f"feature_wise_attention: no kernel for {x.dtype} on {x.device}")
