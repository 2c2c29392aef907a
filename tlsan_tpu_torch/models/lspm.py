"""LSPM — Long- and Short-term Preference Model baseline.

Ported from tlsan_tpu/models/lspm.py (reference graph: LSPM/model.py:36-101):
a long-term user vector plus a short-term weighted sum of the last k items
with the fixed harmonic decay D = [1/k … 1/1] (:46-49), p = u + α·s (:57);
the pairwise loss Σ −log clip(σ(r_i − r_j)) — a sum over the batch, not a
mean (:99-101) — plus the L2 of the batch's embeddings (:92-97), at
regulation_rate 1e-2 in the reference's flag table.

short_w (item rows) and long_w (user rows) are vocab tables, row-sharded
over mp like item_emb.

Batch layout: u[B], hist_i[B, k] right-aligned (LSPM/input.py:30-37), sl[B],
i[B] (pos), j[B] (neg), an optional valid[B].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models import base
from tlsan_tpu_torch.nn.embedding import lookup
from tlsan_tpu_torch.nn.init import glorot_uniform, zeros_param

Batch = Dict[str, torch.Tensor]


class LSPM(nn.Module):
    name = "lspm"
    # tables the reference regularizes as full variables: none, only the
    # batch embeddings (LSPM/model.py:92-97)
    l2_full_tables = ()

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        E = cfg.itemid_embedding_size
        self.item_emb = zeros_param(cfg.item_count, E, device=device)
        self.short_w = zeros_param(cfg.item_count, E, device=device)
        self.long_w = zeros_param(cfg.user_count, E, device=device)
        # D = [1/k, 1/(k-1), ..., 1/1] (LSPM/model.py:46-48)
        self.register_buffer("decay", torch.tensor(
            [1.0 / (cfg.lspm_k - x) for x in range(cfg.lspm_k)],
            dtype=torch.float32, device=device), persistent=False)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "LSPM":
        """Glorot-uniform tables.  Returns self."""
        for p in self.parameters():
            p.copy_(glorot_uniform(tuple(p.shape), generator))
        return self

    def _parts(self, batch: Batch):
        """(p, u_emb, is_emb): the user vector and the rows it reads."""
        is_emb = lookup(self.short_w, batch["hist_i"])  # [B, k, E]
        s_emb = torch.sum(is_emb * self.decay[None, :, None], dim=1)
        u_emb = lookup(self.long_w, batch["u"])
        return u_emb + self.cfg.lspm_alpha * s_emb, u_emb, is_emb

    def user_repr(self, batch: Batch, cate_list) -> torch.Tensor:
        return self._parts(batch)[0]

    def item_repr(self, ids, cate_list):
        return lookup(self.item_emb, ids), None

    def all_item_repr(self, cate_list):
        """(item table [I, E], None: no biases); under a vocab-sharded mesh
        this rank's rows."""
        return self.item_emb, None

    def pair_logits(self, batch: Batch, cate_list):
        p = self._parts(batch)[0]
        return tuple(base.pointwise_logits(p, lookup(self.item_emb, batch[key]))
                     for key in ("i", "j"))

    def eval_logits(self, batch: Batch, cate_list) -> torch.Tensor:
        return base.full_catalog_logits(self._parts(batch)[0], self.item_emb)

    def loss(self, batch: Batch, cate_list,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Σ −log clip(σ(x)) over valid rows plus regulation_rate × the L2
        of u, the window rows, i and j (LSPM/model.py:92-101).  No dropout:
        `generator` is unused."""
        p, u_emb, is_emb = self._parts(batch)
        hi = lookup(self.item_emb, batch["i"])
        hj = lookup(self.item_emb, batch["j"])
        valid = batch.get("valid")
        nll = base.bpr_loss(base.pointwise_logits(p, hi), base.pointwise_logits(p, hj),
                            valid, clip=True, reduction="sum")
        return nll + self.cfg.regulation_rate * base.batch_l2(valid, u_emb, is_emb, hi, hj)
