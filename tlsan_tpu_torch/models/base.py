"""Shared model substrate: losses, logits, catalog scoring.

Ported from tlsan_tpu/models/base.py (reference: TLSAN/model.py:137-172):
pointwise dot-product logits with item bias, sigmoid cross-entropy loss
with table-level L2, the BPR pairwise loss (BPR-MF, LSPM), the pairwise
AUC and the full-catalog eval product.

Under a (dp, mp) mesh (nn/embedding.py `mesh_context`) each rank holds a
dp share of the batch, and a loss equals the single-process loss of the
global batch: the cross-entropy's numerator and denominator are summed
over dp (`sum_over_batch`), and the L2 of full tables, of which each mp
rank holds a row shard, is summed over mp and enters once, not once per dp
rank (`l2_full_tables`); that of dense weights, which every rank holds
whole, enters once (`l2_replicated`).  Each rank's gradient is then its
share of the global one, and the dp all_reduce of the gradients
(train/state.py) sums the shares.
"""

from __future__ import annotations

import torch

from tlsan_tpu_torch.core import spans
from tlsan_tpu_torch.nn.embedding import current_batch_mesh, current_mesh
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
    the entry points (`Recommender`, `Trainer`) set to full f32.  Span
    ``models.catalog_logits`` inside serving's model call
    (core/spans.py)."""
    with spans.inner("models.catalog_logits"):
        logits = u_repr @ all_emb.T
        if all_b is not None:
            logits = logits + all_b
    return logits


def sigmoid_ce_loss(logits, labels, valid=None):
    """Mean sigmoid cross-entropy (reference: TLSAN/model.py:171), in the
    JAX package's stable form max(x, 0) − x·y + log1p(exp(−|x|)), with its
    gradient at x = 0 too.  `valid` masks padded batch rows: the mean is
    over valid rows (at least 1)."""
    logits = logits.float()
    labels = labels.float()
    # at a logit of exactly 0 (a zero user vector: an empty history in
    # CSAN) the form has kinks; JAX's subgradients there are ½ for the max
    # and 1 for |x|, which torch.maximum and this `where` reproduce
    # (clamp_min and abs would give 1 and 0)
    ce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
          + torch.log1p(torch.exp(-torch.where(logits >= 0, logits, -logits))))
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


def bpr_loss(pos_logits, neg_logits, valid=None, clip: bool = True,
             reduction: str = "mean"):
    """BPR pairwise loss −log σ(pos − neg) over valid rows: LSPM's clipped
    form −log clip(σ(x), 1e-8, 1) (reference: LSPM/model.py:99-101), or
    BPR-MF's softplus(−x) (BPR/model.py:71-72).  `reduction` "mean"
    divides by the valid rows (at least 1); "sum" is LSPM's batch sum.
    Under a dp mesh both sums run over the global batch."""
    x = pos_logits.float() - neg_logits.float()
    if clip:
        nll = -torch.log(torch.clamp(torch.sigmoid(x), 1e-8, 1.0))
    else:
        nll = torch.nn.functional.softplus(-x)
    v = torch.ones_like(nll) if valid is None else valid.to(nll.dtype)
    total = sum_over_batch(torch.sum(nll * v))
    if reduction == "sum":
        return total
    mesh = current_batch_mesh()
    n = torch.sum(v)
    if mesh is not None and mesh.dp > 1:
        n = all_reduce(n, mesh.dp_group)
    return total / torch.clamp_min(n, 1.0)


def sum_over_batch(x: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's batch rows made a sum over the global batch:
    summed over dp under a mesh, each rank's gradient its own share."""
    mesh = current_batch_mesh()
    if mesh is None or mesh.dp == 1:
        return x
    return sum_over(x, mesh.dp_group)


def batch_l2(valid, *rows: torch.Tensor) -> torch.Tensor:
    """Σ ½‖r‖² of batch-level embeddings ([B, ...] each) over the valid
    rows (every row without `valid`), over the global batch under a dp
    mesh: the row-L2 of ATRank, BPR-MF and LSPM."""
    if valid is None:
        l2 = l2_tables(*rows)
    else:
        v = valid.to(torch.float32)
        l2 = 0.5 * sum(torch.sum(torch.square(r.float()) * v.reshape((-1,) + (1,) * (r.dim() - 1)))
                       for r in rows)
    return sum_over_batch(l2)


def l2_full_tables(*tables):
    """`l2_tables` of whole vocab tables, of which under a vocab-sharded
    mesh each mp rank holds a row shard (pad rows are zero): summed over
    mp, and its gradient counted once over dp.  The sparse step's row
    blocks are whole on every rank, so with the sharded lookups off
    (`mesh_context(mesh, False)`) no mp sum is taken."""
    l2 = l2_tables(*tables)
    mesh = current_batch_mesh()
    if mesh is None:
        return l2
    if current_mesh() is not None:
        l2 = sum_over(l2, mesh.mp_group)
    return once_over_dp(l2, mesh) if mesh.dp > 1 else l2


def l2_replicated(*weights):
    """`l2_tables` of dense weights every rank holds whole (SHAN's layer
    maps, PACA's position table): its gradient counted once over dp."""
    l2 = l2_tables(*weights)
    mesh = current_batch_mesh()
    return once_over_dp(l2, mesh) if mesh is not None and mesh.dp > 1 else l2


def l2_tables(*tables):
    """Σ tf.nn.l2_loss(t) = Σ sum(t²)/2 (reference: TLSAN/model.py:164-169),
    accumulated in f32 whatever the tables' dtype (under bf16 a large
    table's sum of squares in bf16 would lose the term)."""
    return sum(0.5 * torch.sum(torch.square(t.float())) for t in tables)


def auc_from_pair(pos_logits, neg_logits, valid=None):
    """Pairwise AUC: fraction of users whose positive outscores the negative
    (reference: TLSAN/model.py:263 `np.mean(res1 - res2 > 0)`)."""
    wins = (pos_logits - neg_logits > 0).float()
    if valid is None:
        return torch.mean(wins)
    v = valid.float()
    return torch.sum(wins * v) / torch.clamp_min(torch.sum(v), 1.0)
