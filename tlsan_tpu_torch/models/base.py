"""Shared model substrate: pointwise logits and full-catalog scoring.

Ported from tlsan_tpu/models/base.py (reference: TLSAN/model.py:137-140).
Losses, L2 and AUC come with the training slice.
"""

from __future__ import annotations

import torch


def pointwise_logits(u_repr, i_emb, i_b=None):
    """logits = Σ(u ⊙ i) [+ i_b]  (reference: TLSAN/model.py:137)."""
    logits = torch.sum(u_repr * i_emb, dim=-1)
    if i_b is not None:
        logits = logits + i_b
    return logits


def full_catalog_logits(u_repr, all_emb, all_b=None):
    """eval_logits = u @ all_emb.T [+ item_b]  (reference: TLSAN/model.py:140),
    a [B, D] × [D, I] product at the process's f32 matmul precision, which
    the serving entry point sets to full f32 (`serve/recommender.py`)."""
    logits = u_repr @ all_emb.T
    if all_b is not None:
        logits = logits + all_b
    return logits
