"""Shared model substrate: losses, logits, catalog scoring.

Ported from tlsan_tpu/models/base.py (reference: TLSAN/model.py:137-172):
pointwise dot-product logits with item bias, sigmoid cross-entropy loss
with table-level L2, the pairwise AUC and the full-catalog eval product.
`bpr_loss` comes with the models that use it (BPR-MF, LSPM).

Under a (dp, mp) mesh (nn/embedding.py `mesh_context`) each rank holds a
dp share of the batch, and a loss equals the single-process loss of the
global batch: the cross-entropy's numerator and denominator are summed
over dp (`sum_over_batch`), and the L2 of full tables, of which each mp
rank holds a row shard, is summed over mp and enters once, not once per dp
rank (`l2_full_tables`).  Each rank's gradient is then its share of the
global one, and the dp all_reduce of the gradients (train/state.py) sums
the shares.
"""

from __future__ import annotations

import torch

from tlsan_tpu_torch.nn.embedding import current_batch_mesh
from tlsan_tpu_torch.parallel.mesh import all_reduce, once_over_dp, sum_over


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
    mesh = current_batch_mesh()
    if mesh is not None and mesh.dp > 1:
        # over the global batch: Σ ce·v / max(Σ v, 1), both sums over dp
        v = torch.ones_like(ce) if valid is None else valid.to(ce.dtype)
        n = all_reduce(torch.sum(v), mesh.dp_group)
        return sum_over(torch.sum(ce * v), mesh.dp_group) / torch.clamp_min(n, 1.0)
    if valid is None:
        return torch.mean(ce)
    v = valid.to(ce.dtype)
    return torch.sum(ce * v) / torch.clamp_min(torch.sum(v), 1.0)


def sum_over_batch(x: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's batch rows made a sum over the global batch:
    summed over dp under a mesh, each rank's gradient its own share."""
    mesh = current_batch_mesh()
    if mesh is None or mesh.dp == 1:
        return x
    return sum_over(x, mesh.dp_group)


def l2_full_tables(*tables):
    """`l2_tables` of whole vocab tables, of which under a mesh each mp rank
    holds a row shard (pad rows are zero): summed over mp, and its gradient
    counted once over dp."""
    l2 = l2_tables(*tables)
    mesh = current_batch_mesh()
    if mesh is None:
        return l2
    if mesh.mp > 1:
        l2 = sum_over(l2, mesh.mp_group)
    return once_over_dp(l2, mesh) if mesh.dp > 1 else l2


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
