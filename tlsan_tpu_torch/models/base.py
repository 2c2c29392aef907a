"""Shared model substrate: losses, logits, catalog scoring.

Ported from tlsan_tpu/models/base.py (reference: TLSAN/model.py:137-172):
pointwise dot-product logits with item bias, sigmoid cross-entropy loss
with table-level L2, the pairwise AUC and the full-catalog eval product.
`bpr_loss` comes with the models that use it (BPR-MF, LSPM).
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
    the entry points (`Recommender`, `Trainer`) set to full f32."""
    logits = u_repr @ all_emb.T
    if all_b is not None:
        logits = logits + all_b
    return logits


def sigmoid_ce_loss(logits, labels, valid=None):
    """Mean sigmoid cross-entropy (reference: TLSAN/model.py:171), in the
    JAX package's stable form max(x, 0) − x·y + log1p(exp(−|x|)).  `valid`
    masks padded batch rows: the mean is over valid rows (at least 1)."""
    logits = logits.float()
    labels = labels.float()
    ce = (torch.clamp_min(logits, 0.0) - logits * labels
          + torch.log1p(torch.exp(-torch.abs(logits))))
    if valid is None:
        return torch.mean(ce)
    v = valid.to(ce.dtype)
    return torch.sum(ce * v) / torch.clamp_min(torch.sum(v), 1.0)


def l2_tables(*tables):
    """Σ tf.nn.l2_loss(t) = Σ sum(t²)/2 (reference: TLSAN/model.py:164-169),
    in f32."""
    return sum(0.5 * torch.sum(torch.square(t.float())) for t in tables)


def auc_from_pair(pos_logits, neg_logits, valid=None):
    """Pairwise AUC: fraction of users whose positive outscores the negative
    (reference: TLSAN/model.py:263 `np.mean(res1 - res2 > 0)`)."""
    wins = (pos_logits - neg_logits > 0).float()
    if valid is None:
        return torch.mean(wins)
    v = valid.float()
    return torch.sum(wins * v) / torch.clamp_min(torch.sum(v), 1.0)
