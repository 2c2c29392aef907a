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
Train-time dropout (rate > 0 with a generator or a mask source,
nn/layers.py) lands on the input of each dense map: the dispatcher draws
both keep masks first ([B, S, H, dh], x's then map1's, one ``torch.rand``
each), then hands them to the plain version on the CPU or to K1 and K2 on
CUDA, so the two see the same masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from tlsan_tpu_torch.nn.layers import apply_keep, draw_keep
from tlsan_tpu_torch.nn.masks import additive_neg_mask, sequence_mask
from tlsan_tpu_torch.ops.cuda import fwa


def draw_masks(x, num_heads: int, dropout_rate: float, generator):
    """The two keep masks (bool [B, S, H, dh]: x's, then map1's) of a
    train-time forward on x [B, S, D], or None without dropout."""
    if dropout_rate <= 0.0 or generator is None:
        return None
    B, S, D = x.shape
    shape = (B, S, num_heads, D // num_heads)
    keep = 1.0 - dropout_rate
    return (draw_keep(generator, shape, keep, x.device),
            draw_keep(generator, shape, keep, x.device))


def _masked(v, mask, rate):
    return v if mask is None else apply_keep(v, mask, rate)


def feature_wise_attention_reference(x, lengths, num_heads: int, w1, b1, w2,
                                     b2, return_soft: bool = False,
                                     dropout_rate: float = 0.0,
                                     generator: Optional[torch.Generator] = None,
                                     keep_masks=None):
    """Plain PyTorch version (the correctness oracle of the kernel).  On
    CUDA the caller keeps TF32 off, as the f32 contract needs.  Dropout
    lands on the input of each dense map (TLSAN/model.py:428-431): the
    `keep_masks` (x's, map1's) when given, else drawn from `generator`
    (`draw_masks`); the weighted sum reads the undropped x."""
    B, S, D = x.shape
    dh = D // num_heads
    x4 = x.reshape(B, S, num_heads, dh)
    if keep_masks is None:
        keep_masks = draw_masks(x, num_heads, dropout_rate, generator)
    k1, k2 = keep_masks or (None, None)
    x_in = _masked(x4, k1, dropout_rate)
    m1 = torch.relu(torch.einsum("bshd,de->bshe", x_in, w1) + b1)
    m1_in = _masked(m1, k2, dropout_rate)
    m2 = torch.einsum("bshd,de->bshe", m1_in, w2) + b2
    mask = sequence_mask(lengths, S)  # [B, S]
    m2 = additive_neg_mask(m2, mask[:, :, None, None])
    soft = torch.softmax(m2, dim=1)
    out = torch.sum(soft * x4, dim=1).reshape(B, D)
    if return_soft:
        return out, soft
    return out


def _backward_terms(x, lengths, num_heads: int, w1, b1, w2, b2, g,
                    keep_masks=None, rate: float = 0.0):
    """The closed-form backward's elementwise terms, per head: (x4, x_in,
    m1_in, soft, g4, dm2, dz1), with dz1 already masked by [z1 > 0] and,
    under dropout, by map1's keep mask (x_in and m1_in are the dropped
    inputs of the two maps; without dropout x4 and m1)."""
    B, S, D = x.shape
    dh = D // num_heads
    k1, k2 = keep_masks or (None, None)
    x4 = x.reshape(B, S, num_heads, dh)
    x_in = _masked(x4, k1, rate)
    z1 = torch.einsum("bshd,de->bshe", x_in, w1) + b1
    m1_in = _masked(torch.relu(z1), k2, rate)
    m2 = torch.einsum("bshd,de->bshe", m1_in, w2) + b2
    m2 = additive_neg_mask(m2, sequence_mask(lengths, S)[:, :, None, None])
    soft = torch.softmax(m2, dim=1)
    g4 = g.reshape(B, 1, num_heads, dh)
    ds = g4 * x4
    dm2 = soft * (ds - torch.sum(soft * ds, dim=1, keepdim=True))
    dz1 = _masked(torch.einsum("bshe,de->bshd", dm2, w2), k2, rate) * (z1 > 0)
    return x4, x_in, m1_in, soft, g4, dm2, dz1


def _backward_sums(x4, x_in, m1_in, soft, g4, dm2, dz1, w1, k1=None,
                   rate: float = 0.0):
    B, S, H, dh = x4.shape
    dx = soft * g4 + _masked(torch.einsum("bshe,de->bshd", dz1, w1), k1, rate)
    dw1 = torch.einsum("bshd,bshe->de", x_in, dz1)
    dw2 = torch.einsum("bshd,bshe->de", m1_in, dm2)
    return (dx.reshape(B, S, H * dh), dw1, dz1.sum(dim=(0, 1, 2)), dw2,
            dm2.sum(dim=(0, 1, 2)))


def fwa_backward_reference(x, lengths, num_heads: int, w1, b1, w2, b2, g,
                           keep_masks=None, dropout_rate: float = 0.0):
    """Plain PyTorch version of K2, in the kernel's closed-form algebra (not
    autograd): the gradients (dx, dw1, db1, dw2, db2) of the forward at
    (x, w1, b1, w2, b2) for the incoming gradient g = dL/dout [B, D]; with
    the forward's dropout `keep_masks` (x's, map1's) and rate, of the
    dropped forward.  It is K2's oracle on the card and what the CPU tests
    hold against JAX."""
    terms = _backward_terms(x, lengths, num_heads, w1, b1, w2, b2, g,
                            keep_masks, dropout_rate)
    k1 = keep_masks[0] if keep_masks else None
    return _backward_sums(*terms, w1, k1, dropout_rate)


def fwa_backward_error_scale(x, lengths, num_heads: int, w1, b1, w2, b2, g,
                             keep_masks=None, dropout_rate: float = 0.0):
    """For each entry of (dx, dw1, db1, dw2, db2), the sum of the magnitudes
    of the terms it adds up: the scale of its f32 rounding error, which two
    correct implementations that sum in other orders may differ by (times
    a few ε).  It matters where terms cancel: db2 = Σ dm2 is exactly 0
    (Σ_t soft = 1 for every row), so its computed value is rounding noise
    of order ε·Σ|dm2|, and only a tolerance relative to this scale, not to
    the value, tells a right kernel from a wrong one.  Under dropout, of
    the dropped forward's terms."""
    terms = _backward_terms(x, lengths, num_heads, w1, b1, w2, b2, g,
                            keep_masks, dropout_rate)
    k1 = keep_masks[0] if keep_masks else None
    return _backward_sums(*map(torch.abs, terms), torch.abs(w1), k1,
                          dropout_rate)


def feature_wise_attention(x, lengths, num_heads: int, w1, b1, w2, b2,
                           dropout_rate: float = 0.0, generator=None):
    """Plain version on the CPU, K1 (and K2 under autograd) on a CUDA f32
    tensor.  A bf16 `x` (mixed precision) is cast to f32 with the weights,
    runs as f32 does, and its output is cast back: the kernels keep their
    f32 contract, so the card and the CPU compute the same function, and
    the casts' backward hands K2 an f32 gradient.  Dropout engages when
    `dropout_rate` > 0 and a generator (or a mask source, nn/layers.py) is
    given (training): both masks are drawn here, then the plain version or
    the kernels apply them; without one it is the identity."""
    if x.dtype == torch.bfloat16:
        w1, b1, w2, b2 = (t.float() for t in (w1, b1, w2, b2))
        return feature_wise_attention(
            x.float(), lengths, num_heads, w1, b1, w2, b2, dropout_rate,
            generator).to(torch.bfloat16)
    masks = draw_masks(x, num_heads, dropout_rate, generator)
    if x.device.type == "cpu":
        return feature_wise_attention_reference(
            x, lengths, num_heads, w1, b1, w2, b2, dropout_rate=dropout_rate,
            keep_masks=masks)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        drop = () if masks is None else (*masks, dropout_rate)
        return fwa.FWAFunction.apply(x, lengths, num_heads, w1, b1, w2, b2, *drop)
    raise NotImplementedError(
        f"feature_wise_attention: no kernel for {x.dtype} on {x.device}")
