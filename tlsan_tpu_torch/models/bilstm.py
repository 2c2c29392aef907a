"""Bi-LSTM baseline: a bidirectional LSTM user encoder.

Ported from tlsan_tpu/models/bilstm.py (reference graph:
Bi-LSTM/model.py:20-75): item(32)⊕cate(32) history → one bidirectional
LSTM layer of 64 units; user repr = dense(concat(forward output at step
sl−1, backward output at step 0)) (:60-70); logits = i_b + Σ(u⊙i) (:74);
loss = mean sigmoid-CE + 5e-5 · L2 of the user, item and cate tables
(:107-119) — user_emb is regularized but never read by the forward, a
reference quirk kept.

The backward direction reverses only the valid prefix (tf
bidirectional_dynamic_rnn with sequence_length); its output at original
step 0 is the reversed sequence's output at step sl−1.  Both LSTMs are
`nn/layers.py::lstm_scan`: TF-1.8 gates, plain matrix products.  A row
with sl = 0 (an empty history, a padded eval row) reads step −1, which
wraps to the last step as in the JAX package (`gather_time`).

Batch layout: hist_i[B,T], sl[B], plus i[B] and y[B] for the loss, an
optional valid[B], and j[B] for the pair.
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
from tlsan_tpu_torch.nn.layers import dense, gather_time, lstm_scan, reverse_valid

Batch = Dict[str, torch.Tensor]


class BiLSTM(nn.Module):
    name = "bilstm"
    # tables the reference regularizes as full variables (Bi-LSTM/model.py:108-112)
    l2_full_tables = ("user_emb", "item_emb", "cate_emb")

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        H = cfg.lstm_hidden_units
        D = cfg.itemid_embedding_size + cfg.cateid_embedding_size
        self.user_emb = zeros_param(cfg.user_count, H, device=device)
        self.item_emb = zeros_param(cfg.item_count, cfg.itemid_embedding_size,
                                    device=device)
        self.item_b = zeros_param(cfg.item_count, device=device)
        self.cate_emb = zeros_param(cfg.cate_count, cfg.cateid_embedding_size,
                                    device=device)
        self.lstm_fw_w = zeros_param(D + H, 4 * H, device=device)
        self.lstm_fw_b = zeros_param(4 * H, device=device)
        self.lstm_bw_w = zeros_param(D + H, 4 * H, device=device)
        self.lstm_bw_b = zeros_param(4 * H, device=device)
        self.out_w = zeros_param(2 * H, H, device=device)
        self.out_b = zeros_param(H, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "BiLSTM":
        """Glorot-uniform tables and kernels, zero biases.  Returns self."""
        for p in self.parameters():
            if p.dim() == 2:
                p.copy_(glorot_uniform(tuple(p.shape), generator))
            else:
                p.zero_()
        return self

    def _user_repr(self, batch: Batch, items: ItemCate) -> torch.Tensor:
        H = self.cfg.lstm_hidden_units
        h = items(batch["hist_i"])
        sl = batch["sl"]
        fw = lstm_scan(h, self.lstm_fw_w, self.lstm_fw_b, H)
        bw = lstm_scan(reverse_valid(h, sl), self.lstm_bw_w, self.lstm_bw_b, H)
        hist = torch.cat([gather_time(fw, sl - 1), gather_time(bw, sl - 1)], dim=-1)
        return dense(hist, self.out_w, self.out_b)

    def user_repr(self, batch: Batch, cate_list) -> torch.Tensor:
        return self._user_repr(batch, ItemCate(self.item_emb, self.cate_emb, cate_list))

    def item_repr(self, ids, cate_list):
        return (item_cate_lookup(self.item_emb, self.cate_emb, ids, cate_list),
                lookup(self.item_b, ids))

    def all_item_repr(self, cate_list):
        """(item⊕cate table [I, Di+Dc], item biases [I]); under a
        vocab-sharded mesh this rank's rows of both."""
        return item_cate_rows(self.item_emb, self.cate_emb, cate_list), self.item_b

    def pair_logits(self, batch: Batch, cate_list):
        items = ItemCate(self.item_emb, self.cate_emb, cate_list)
        u = self._user_repr(batch, items)
        return tuple(base.pointwise_logits(u, items(batch[key]),
                                           lookup(self.item_b, batch[key]))
                     for key in ("i", "j"))

    def eval_logits(self, batch: Batch, cate_list) -> torch.Tensor:
        items = ItemCate(self.item_emb, self.cate_emb, cate_list)
        return base.full_catalog_logits(self._user_repr(batch, items),
                                        items.table, self.item_b)

    def loss(self, batch: Batch, cate_list,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sigmoid cross-entropy plus the L2 of the user, item and cate
        tables (Bi-LSTM/model.py:107-119).  No dropout: `generator` is
        unused."""
        items = ItemCate(self.item_emb, self.cate_emb, cate_list)
        u = self._user_repr(batch, items)
        logits = base.pointwise_logits(u, items(batch["i"]),
                                       lookup(self.item_b, batch["i"]))
        l2 = base.l2_full_tables(self.user_emb, self.item_emb, self.cate_emb)
        return (base.sigmoid_ce_loss(logits, batch["y"], batch.get("valid"))
                + self.cfg.regulation_rate * l2)
