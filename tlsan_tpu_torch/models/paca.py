"""PACA — Position-Aware Context Attention baseline.

Ported from tlsan_tpu/models/paca.py (reference graph: PACA/model.py:40-109,
PositionAwareAttention :260-305).  No user id at all: the user
representation is built from the session alone.

  - position_w [kernel_size, max_len, E] (:44-46); per kernel
    score[t] = Σ_d sigmoid(h[t,d]) · w_p[kernel, t, d] (:286-292);
  - max over kernels (:294-295);
  - softmax over time of score·mask — the reference softmaxes the
    zero-masked scores (padded slots contribute exp(0)), then re-masks and
    renormalizes over valid positions (:297-301), kept as it is;
  - weighted sum → bilinear map linear_w (:307-319);
  - plain dot-product logits, no item bias (:71-74).

Dropout (train only) at the reference's two sites: the session embedding
(:272-273) and the pooled vector before the bilinear map (:315-316), both
drawn from one generator in that order.  position_w is a dense weight,
replicated on a mesh.

Batch layout: hist_i[B,T] (T ≤ paca_max_len), sl[B], plus i[B] and y[B]
for the loss, an optional valid[B], and j[B] for the pair.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models import base
from tlsan_tpu_torch.nn.embedding import lookup
from tlsan_tpu_torch.nn.init import glorot_uniform, zeros_param
from tlsan_tpu_torch.nn.layers import dropout
from tlsan_tpu_torch.nn.masks import sequence_mask

Batch = Dict[str, torch.Tensor]


class PACA(nn.Module):
    name = "paca"
    # tables the reference regularizes as full variables (PACA/model.py:100-103)
    l2_full_tables = ("item_emb", "position_w")

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        E = cfg.itemid_embedding_size
        self.item_emb = zeros_param(cfg.item_count, E, device=device)
        self.position_w = zeros_param(cfg.paca_kernel_size, cfg.paca_max_len, E,
                                      device=device)
        self.linear_w = zeros_param(E, E, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "PACA":
        """Glorot-uniform everything, as the JAX package draws it
        (fans of position_w from its last two axes).  Returns self."""
        for p in self.parameters():
            p.copy_(glorot_uniform(tuple(p.shape), generator))
        return self

    def _user_repr(self, batch: Batch,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.cfg.dropout
        if rate <= 0.0:
            generator = None
        h = lookup(self.item_emb, batch["hist_i"])  # [B, T, E]
        h = dropout(h, rate, generator)
        T = h.shape[1]
        mask = sequence_mask(batch["sl"], T).to(h.dtype)  # [B, T]
        h = h * mask[:, :, None]
        tmp = torch.sigmoid(h)  # sigmoid of the masked embedding, as the reference
        wp = self.position_w[:, :T, :]  # [K, T, E]
        scores = torch.einsum("btd,ktd->kbt", tmp, wp)
        # amax shares the gradient among ties, as jnp.max does
        sim = torch.amax(scores, dim=0)  # [B, T]
        att = torch.softmax(sim * mask, dim=1) * mask
        att = att / torch.clamp_min(torch.sum(att, dim=1, keepdim=True), 1e-20)
        paa = torch.sum(h * att[:, :, None], dim=1)  # [B, E]
        paa = dropout(paa, rate, generator)
        return paa @ self.linear_w

    def user_repr(self, batch: Batch, cate_list) -> torch.Tensor:
        return self._user_repr(batch)

    def item_repr(self, ids, cate_list):
        return lookup(self.item_emb, ids), None

    def all_item_repr(self, cate_list):
        """(item table [I, E], None: no biases); under a vocab-sharded mesh
        this rank's rows."""
        return self.item_emb, None

    def pair_logits(self, batch: Batch, cate_list):
        u = self._user_repr(batch)
        return tuple(base.pointwise_logits(u, lookup(self.item_emb, batch[key]))
                     for key in ("i", "j"))

    def eval_logits(self, batch: Batch, cate_list) -> torch.Tensor:
        return base.full_catalog_logits(self._user_repr(batch), self.item_emb)

    def loss(self, batch: Batch, cate_list,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sigmoid cross-entropy plus the L2 of the item table and the
        position weights (PACA/model.py:100-103); `generator` draws the
        train-time dropout masks."""
        u = self._user_repr(batch, generator)
        logits = base.pointwise_logits(u, lookup(self.item_emb, batch["i"]))
        l2 = (base.l2_full_tables(self.item_emb)
              + base.l2_replicated(self.position_w))
        return (base.sigmoid_ce_loss(logits, batch["y"], batch.get("valid"))
                + self.cfg.regulation_rate * l2)
