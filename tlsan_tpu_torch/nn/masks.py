"""Masking utilities.

Additive −1e30 masking matches the reference's `exp_mask_for_high_rank`
(TLSAN/model.py:480-483, VERY_NEGATIVE_NUMBER at :10-11).  It is added, not
substituted: a row whose every position is masked keeps a finite softmax
(uniform over time), exactly as in the JAX package.
"""

import torch

VERY_NEGATIVE_NUMBER = -1e30


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """Boolean [*, maxlen] mask, True for positions < length
    (≡ tf.sequence_mask, used at TLSAN/model.py:376)."""
    pos = torch.arange(maxlen, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def additive_neg_mask(logits: torch.Tensor, mask: torch.Tensor,
                      value: float = VERY_NEGATIVE_NUMBER) -> torch.Tensor:
    """Add `value` where mask is False; mask broadcasts against logits."""
    return logits + (1.0 - mask.to(logits.dtype)) * value
