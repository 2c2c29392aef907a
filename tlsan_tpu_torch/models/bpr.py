"""BPR-MF — Bayesian Personalized Ranking matrix factorization baseline.

Ported from tlsan_tpu/models/bpr.py (reference graph: BPR/model.py:5-75):
user(64) against item(32)⊕cate(32) factorization; the pairwise loss
−mean log σ(x), x = i_b − j_b + u·(i − j), in its softplus form, plus the
L2 of the batch's embeddings, not of the whole tables (:65-69); plain SGD.
The user representation is the user row alone, so serving takes the user
id and nothing else.

Batch layout: u[B], i[B] (pos), j[B] (neg), an optional valid[B].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models import base
from tlsan_tpu_torch.nn.embedding import (
    ItemCate,
    item_cate_lookup,
    item_cate_rows,
    lookup,
)
from tlsan_tpu_torch.nn.init import glorot_uniform, zeros_param

Batch = Dict[str, torch.Tensor]


class BPR(nn.Module):
    name = "bpr"
    # tables the reference regularizes as full variables: none, only the
    # batch embeddings (BPR/model.py:65-69)
    l2_full_tables = ()

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        self.user_emb = zeros_param(cfg.user_count, cfg.bpr_user_embedding_size,
                                    device=device)
        self.item_emb = zeros_param(cfg.item_count, cfg.itemid_embedding_size,
                                    device=device)
        self.item_b = zeros_param(cfg.item_count, device=device)
        self.cate_emb = zeros_param(cfg.cate_count, cfg.cateid_embedding_size,
                                    device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "BPR":
        """Glorot-uniform tables, zero item biases.  Returns self."""
        for name, p in self.named_parameters():
            if name == "item_b":
                p.zero_()
            else:
                p.copy_(glorot_uniform(tuple(p.shape), generator))
        return self

    def user_repr(self, batch: Batch, cate_list) -> torch.Tensor:
        return lookup(self.user_emb, batch["u"])

    def item_repr(self, ids, cate_list):
        return (item_cate_lookup(self.item_emb, self.cate_emb, ids, cate_list),
                lookup(self.item_b, ids))

    def all_item_repr(self, cate_list):
        """(item⊕cate table [I, Di+Dc], item biases [I]); under a
        vocab-sharded mesh this rank's rows of both."""
        return item_cate_rows(self.item_emb, self.cate_emb, cate_list), self.item_b

    def _pair(self, batch: Batch, cate_list):
        """(u, i_emb, j_emb, pos, neg) of the batch's (i, j) pairs."""
        items = ItemCate(self.item_emb, self.cate_emb, cate_list)
        u = lookup(self.user_emb, batch["u"])
        i_emb, j_emb = items(batch["i"]), items(batch["j"])
        pos = base.pointwise_logits(u, i_emb, lookup(self.item_b, batch["i"]))
        neg = base.pointwise_logits(u, j_emb, lookup(self.item_b, batch["j"]))
        return u, i_emb, j_emb, pos, neg

    def pair_logits(self, batch: Batch, cate_list):
        return self._pair(batch, cate_list)[3:]

    def eval_logits(self, batch: Batch, cate_list) -> torch.Tensor:
        return base.full_catalog_logits(lookup(self.user_emb, batch["u"]),
                                        *self.all_item_repr(cate_list))

    def loss(self, batch: Batch, cate_list,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """−mean log σ(pos − neg) over valid rows plus the batch-level L2
        of u, i and j (BPR/model.py:65-72).  No dropout: `generator` is
        unused."""
        u, i_emb, j_emb, pos, neg = self._pair(batch, cate_list)
        valid = batch.get("valid")
        return (self.cfg.regulation_rate * base.batch_l2(valid, u, i_emb, j_emb)
                + base.bpr_loss(pos, neg, valid, clip=False))
