"""SHAN — Sequential Hierarchical Attention Network baseline.

Ported from tlsan_tpu/models/shan.py (reference graph: SHAN/model.py:52-104,
attention_net :271-321).  Pure-embedding two-layer hierarchical attention
in the 32-d item space:

  layer1: weight = softmax(u · sigmoid(pre·W1 + b1)ᵀ) over the long-term
          session items; long = Σ weight·pre          (:307-312)
  layer2: session = [current_session ∥ long]; weight = softmax(long ·
          sigmoid(session·W2 + b2)ᵀ); hybrid = Σ weight·session  (:314-321)

There is no length masking, as in the reference: pad item 0 takes part in
both softmaxes.  The reference pads each batch to its own longest session
(SHAN/input.py:31-43) and the packers to the dataset's, so each softmax is
limited to the first max(sl) columns of the batch: the key multiset per
row is then the reference's.  The limit is a mask computed on the device
(no read to the host); under a dp mesh it is the max over the global
batch, as in the JAX package.

Batch layout: u[B], hist_i[B,Ls], hist_i_new[B,Ts], sl[B], sl_new[B], plus
i[B] and y[B] for the loss, an optional valid[B], and j[B] for the pair.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models import base
from tlsan_tpu_torch.nn.embedding import current_batch_mesh, lookup
from tlsan_tpu_torch.nn.init import glorot_uniform, zeros_param
from tlsan_tpu_torch.parallel.mesh import all_reduce

Batch = Dict[str, torch.Tensor]


def _batch_max(lengths: torch.Tensor) -> torch.Tensor:
    """max(lengths) over the batch — over the global batch under a dp mesh
    — as a 0-d device tensor."""
    m = lengths.max().float()
    mesh = current_batch_mesh()
    if mesh is not None and mesh.dp > 1:
        m = all_reduce(m, mesh.dp_group, dist.ReduceOp.MAX)
    return m


def _attention_layer(query, keys, w, b, n_cols, always_last: bool = False):
    """softmax(query · sigmoid(keys·W + b)ᵀ) weighted sum of keys:
    query [B, E], keys [B, L, E] → [B, E] (SHAN/model.py:307-312).  Only
    the first `n_cols` key columns (a 0-d tensor) enter the softmax, and
    with `always_last` the last column too (layer 2's appended long-term
    vector, SHAN/model.py:314)."""
    L = keys.shape[1]
    proj = torch.sigmoid(keys @ w + b)
    scores = torch.einsum("be,ble->bl", query, proj)
    cols = torch.arange(L, device=keys.device)
    live = cols < n_cols
    if always_last:
        live = live | (cols == L - 1)
    scores = torch.where(live[None, :], scores, -torch.inf)
    weight = torch.softmax(scores, dim=-1)
    return torch.sum(keys * weight[:, :, None], dim=1)


class SHAN(nn.Module):
    name = "shan"
    # tables and maps the reference regularizes as full variables
    # (SHAN/model.py:131-136)
    l2_full_tables = ("user_emb", "item_emb", "layer1_w", "layer2_w")

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        E = cfg.itemid_embedding_size
        self.item_emb = zeros_param(cfg.item_count, E, device=device)
        self.item_b = zeros_param(cfg.item_count, device=device)
        self.user_emb = zeros_param(cfg.user_count, E, device=device)
        self.layer1_w = zeros_param(E, E, device=device)
        self.layer1_b = zeros_param(1, E, device=device)
        self.layer2_w = zeros_param(E, E, device=device)
        self.layer2_b = zeros_param(1, E, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "SHAN":
        """The JAX package's initial values in distribution: every table,
        map and layer bias glorot-uniform (the reference's [1, E] biases
        are get_variables with the default initializer, SHAN/model.py:72-77),
        item biases zero.  Returns self."""
        for name, p in self.named_parameters():
            if name == "item_b":
                p.zero_()
            else:
                p.copy_(glorot_uniform(tuple(p.shape), generator))
        return self

    def _user_repr(self, batch: Batch) -> torch.Tensor:
        u_emb = lookup(self.user_emb, batch["u"])
        h = lookup(self.item_emb, batch["hist_i"])
        h_new = lookup(self.item_emb, batch["hist_i_new"])
        # per-batch dynamic-padding widths (SHAN/input.py:31-43); padded
        # eval rows carry sl = 0 and cannot raise the max
        long = _attention_layer(u_emb, h, self.layer1_w, self.layer1_b,
                                _batch_max(batch["sl"]))
        session = torch.cat([h_new, long[:, None, :]], dim=1)
        return _attention_layer(long, session, self.layer2_w, self.layer2_b,
                                _batch_max(batch["sl_new"]), always_last=True)

    def user_repr(self, batch: Batch, cate_list) -> torch.Tensor:
        return self._user_repr(batch)

    def item_repr(self, ids, cate_list):
        return lookup(self.item_emb, ids), lookup(self.item_b, ids)

    def all_item_repr(self, cate_list):
        """(item table [I, E], item biases [I]); under a vocab-sharded mesh
        this rank's rows of both."""
        return self.item_emb, self.item_b

    def pair_logits(self, batch: Batch, cate_list):
        u = self._user_repr(batch)
        return tuple(base.pointwise_logits(u, *self.item_repr(batch[key], cate_list))
                     for key in ("i", "j"))

    def eval_logits(self, batch: Batch, cate_list) -> torch.Tensor:
        return base.full_catalog_logits(self._user_repr(batch), self.item_emb,
                                        self.item_b)

    def loss(self, batch: Batch, cate_list,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sigmoid cross-entropy plus the L2 of the user and item tables and
        both layer maps (SHAN/model.py:131-136).  SHAN has no dropout:
        `generator` is unused."""
        u = self._user_repr(batch)
        logits = base.pointwise_logits(u, *self.item_repr(batch["i"], cate_list))
        l2 = (base.l2_full_tables(self.user_emb, self.item_emb)
              + base.l2_replicated(self.layer1_w, self.layer2_w))
        return (base.sigmoid_ce_loss(logits, batch["y"], batch.get("valid"))
                + self.cfg.regulation_rate * l2)
