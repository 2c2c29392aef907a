"""CNN (TextCNN) baseline.

Ported from tlsan_tpu/models/cnn.py (reference graph: CNN/model.py:45-93,
cnn_net :285-334).  The same embedding and time front as ATRank
(item⊕cate + one-hot(12) time bucket + dense; with concat_time_emb off, a
tanh-dense of the bucket added), then: mask, zero-pad the time axis, ten
conv towers (filter heights 1..10 × 32 filters, truncated-normal(0.1)
weights, 0.1 biases, :306-318), relu, max-pool over time (:320-324),
concat to 320 features, dropout (train only), dense to hidden_units (:91).
Loss: mean sigmoid-CE + L2 over the item and cate tables (:126-135).

Each filter spans the whole feature width, so a tower's VALID conv is one
GEMM of the [B, P, fs·D] windows (im2col) against [fs·D, F], as in the JAX
package: plain matrix products, no cuDNN.  The reference pads the time
axis to a fixed 500 (:299-301); only windows that touch a real row differ
from relu(b), and padding to T + max(filter_sizes) keeps at least one
all-zero window per tower, so the max-pool over the shorter conv equals
the one over 500 exactly (tests/test_torch_families.py checks it against
the literal pad-to-500 form).

Batch layout: hist_i[B,T], hist_t[B,T] (int buckets 0..12), sl[B], plus
i[B] and y[B] for the loss, an optional valid[B], and j[B] for the pair.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models import base
from tlsan_tpu_torch.models.atrank import N_TIME_BUCKETS
from tlsan_tpu_torch.nn.embedding import (
    ItemCate,
    item_cate_lookup,
    item_cate_rows,
    lookup,
)
from tlsan_tpu_torch.nn.init import glorot_uniform, truncated_normal, zeros_param
from tlsan_tpu_torch.nn.layers import dense, dropout, one_hot
from tlsan_tpu_torch.nn.masks import sequence_mask

Batch = Dict[str, torch.Tensor]


class CNN(nn.Module):
    name = "cnn"
    # tables the reference regularizes as full variables (CNN/model.py:126-129)
    l2_full_tables = ("item_emb", "cate_emb")

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        D, F = cfg.hidden_units, cfg.cnn_num_filters
        self.item_emb = zeros_param(cfg.item_count, cfg.itemid_embedding_size,
                                    device=device)
        self.item_b = zeros_param(cfg.item_count, device=device)
        self.cate_emb = zeros_param(cfg.cate_count, cfg.cateid_embedding_size,
                                    device=device)
        time_in = (cfg.itemid_embedding_size + cfg.cateid_embedding_size
                   + N_TIME_BUCKETS) if cfg.concat_time_emb else 1
        self.time_w = zeros_param(time_in, D, device=device)
        self.time_b = zeros_param(D, device=device)
        # filter [fs, D, 1, F], the reference's layout (CNN/model.py:309-311)
        self.towers = nn.ModuleList(nn.ParameterDict({
            "w": zeros_param(fs, D, 1, F, device=device),
            "b": zeros_param(F, device=device)}) for fs in cfg.cnn_filter_sizes)
        self.out_w = zeros_param(F * len(cfg.cnn_filter_sizes), D, device=device)
        self.out_b = zeros_param(D, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "CNN":
        """The JAX package's initial values in distribution: glorot-uniform
        tables and dense kernels, truncated-normal(0.1) filters, 0.1 filter
        biases, other biases zero.  Returns self."""
        for name, p in self.named_parameters():
            if name.startswith("towers."):
                if name.endswith(".w"):
                    p.copy_(truncated_normal(tuple(p.shape), 0.1, generator))
                else:
                    p.fill_(0.1)
            elif p.dim() == 2:
                p.copy_(glorot_uniform(tuple(p.shape), generator))
            else:
                p.zero_()
        return self

    def _user_repr(self, batch: Batch, items: ItemCate,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        h = items(batch["hist_i"])
        if cfg.concat_time_emb:
            onehot = one_hot(batch["hist_t"], N_TIME_BUCKETS, h.dtype)
            h = dense(torch.cat([h, onehot], dim=-1), self.time_w, self.time_b)
        else:
            t = batch["hist_t"].to(h.dtype)[..., None]
            h = h + dense(t, self.time_w, self.time_b, torch.tanh)
        B, T, D = h.shape
        h = h * sequence_mask(batch["sl"], T).to(h.dtype)[:, :, None]
        pad_len = min(cfg.cnn_pad_length, T + max(cfg.cnn_filter_sizes))
        h = torch.nn.functional.pad(h, (0, 0, 0, pad_len - T))
        pooled = []
        for tw in self.towers:
            fs = tw["w"].shape[0]
            P = pad_len - fs + 1
            # im2col: window p holds rows p..p+fs-1, each D wide
            win = torch.stack([h[:, k:k + P, :] for k in range(fs)], dim=2)
            conv = win.reshape(B, P, fs * D) @ tw["w"][:, :, 0, :].reshape(fs * D, -1)
            act = torch.relu(conv + tw["b"])  # [B, P, F]
            # amax shares the gradient among ties, as jnp.max does
            pooled.append(torch.amax(act, dim=1))
        flat = torch.cat(pooled, dim=-1)  # [B, F · towers]
        if cfg.dropout > 0.0:
            # dropout on the pooled features (CNN/model.py:331-333)
            flat = dropout(flat, cfg.dropout, generator)
        return dense(flat, self.out_w, self.out_b)

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
        """Sigmoid cross-entropy plus the L2 of the item and cate tables
        (CNN/model.py:126-135); `generator` draws the train-time dropout
        mask."""
        items = ItemCate(self.item_emb, self.cate_emb, cate_list)
        u = self._user_repr(batch, items, generator)
        logits = base.pointwise_logits(u, items(batch["i"]),
                                       lookup(self.item_b, batch["i"]))
        l2 = base.l2_full_tables(self.item_emb, self.cate_emb)
        return (base.sigmoid_ce_loss(logits, batch["y"], batch.get("valid"))
                + self.cfg.regulation_rate * l2)
