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

`feature_wise_attention` runs the plain version for a CPU tensor and the
CUDA kernel (ops/cuda/fwa.py) for a CUDA f32 tensor; anything else raises.
Train-time dropout comes with the training slice: serving never uses it.
"""

from __future__ import annotations

import torch

from tlsan_tpu_torch.nn.masks import additive_neg_mask, sequence_mask
from tlsan_tpu_torch.ops.cuda import fwa


def feature_wise_attention_reference(x, lengths, num_heads: int, w1, b1, w2,
                                     b2, return_soft: bool = False):
    """Plain PyTorch version (the correctness oracle of the kernel).  On
    CUDA the caller keeps TF32 off, as the f32 contract needs."""
    B, S, D = x.shape
    dh = D // num_heads
    x4 = x.reshape(B, S, num_heads, dh)
    m1 = torch.relu(torch.einsum("bshd,de->bshe", x4, w1) + b1)
    m2 = torch.einsum("bshd,de->bshe", m1, w2) + b2
    mask = sequence_mask(lengths, S)  # [B, S]
    m2 = additive_neg_mask(m2, mask[:, :, None, None])
    soft = torch.softmax(m2, dim=1)
    out = torch.sum(soft * x4, dim=1).reshape(B, D)
    if return_soft:
        return out, soft
    return out


def feature_wise_attention(x, lengths, num_heads: int, w1, b1, w2, b2):
    """Plain version on the CPU, the CUDA kernel on a CUDA f32 tensor."""
    if x.device.type == "cpu":
        return feature_wise_attention_reference(
            x, lengths, num_heads, w1, b1, w2, b2)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        return fwa.fwa_forward(x, lengths, num_heads, w1, b1, w2, b2)
    raise NotImplementedError(
        f"feature_wise_attention: no kernel for {x.dtype} on {x.device}")
