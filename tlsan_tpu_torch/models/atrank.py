"""ATRank — attention-based user behavior modeling baseline.

Ported from tlsan_tpu/models/atrank.py (reference graph: ATRank/model.py:46-104,
attention_net :288-331):

  - item⊕cate embedding + one-hot(12) time bucket concat + dense to
    hidden_units (:59-73, the default concat_time_emb=True path); the
    concat_time_emb=False path adds a tanh-dense of the bucket as a float
    (the JAX package's fix of a reference dtype bug);
  - num_blocks × (multi-head self-attention + FFN) over the history
    (:291-308);
  - readout: the TARGET ITEM is the query of a 1-step vanilla attention over
    the encoded history + FFN (:310-328), so the user representation is
    conditioned on the candidate item, also at full-catalog eval (the
    reference scores every item with the positive-item-conditioned
    representation, :100-104).

Each attention is `ops/multihead_attention.py::multihead_attention`: the
plain version on the CPU, the CUDA kernel K3 on a CUDA f32 tensor, so a
forward launches K3 twice a block (self-attention and readout).  The
parameters keep the JAX names and layouts (``self_blocks.0.attn.wq`` is
[in, out]), so tools/params.py moves a JAX tree in and out.

Batch layout (static shapes): u[B], hist_i[B,T], hist_t[B,T] (int buckets
0..12), sl[B], i[B] (the query item), plus y[B] for the loss, an optional
valid[B], and j[B] for the AUC pair.
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
from tlsan_tpu_torch.nn.layers import dense, one_hot
from tlsan_tpu_torch.ops.multihead_attention import (
    feedforward,
    multihead_attention,
)

Batch = Dict[str, torch.Tensor]

N_TIME_BUCKETS = 12  # one-hot width (ATRank/model.py:71)


def _block(D: int, device) -> nn.ModuleDict:
    """One {attn, ffn} block with the JAX package's parameter names."""
    attn = {name: zeros_param(D, D, device=device) for name in ("wq", "wk", "wv")}
    attn.update({name: zeros_param(D, device=device)
                 for name in ("bq", "bk", "bv", "ln_gamma", "ln_beta")})
    ffn = {"w1": zeros_param(D, D // 4, device=device),
           "b1": zeros_param(D // 4, device=device),
           "w2": zeros_param(D // 4, D, device=device),
           "b2": zeros_param(D, device=device),
           "ln_gamma": zeros_param(D, device=device),
           "ln_beta": zeros_param(D, device=device)}
    return nn.ModuleDict({"attn": nn.ParameterDict(attn),
                          "ffn": nn.ParameterDict(ffn)})


class ATRank(nn.Module):
    name = "atrank"
    # tables the reference regularizes as full variables: none, only the
    # batch-level L2 of the user output and item embedding (ATRank/model.py:130-133)
    l2_full_tables = ()

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_units
        self.item_emb = zeros_param(cfg.item_count, cfg.itemid_embedding_size,
                                    device=device)
        self.item_b = zeros_param(cfg.item_count, device=device)
        self.cate_emb = zeros_param(cfg.cate_count, cfg.cateid_embedding_size,
                                    device=device)
        time_in = (cfg.itemid_embedding_size + cfg.cateid_embedding_size
                   + N_TIME_BUCKETS) if cfg.concat_time_emb else 1
        self.time_w = zeros_param(time_in, D, device=device)
        self.time_b = zeros_param(D, device=device)
        self.self_blocks = nn.ModuleList(
            _block(D, device) for _ in range(cfg.num_blocks))
        self.vanilla_blocks = nn.ModuleList(
            _block(D, device) for _ in range(cfg.num_blocks))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ATRank":
        """The JAX package's initial values in distribution: glorot-uniform
        tables and kernels, zero biases, LayerNorm gain 1
        (tlsan_tpu/models/atrank.py:35-89).  Returns self."""
        def glorot(p: nn.Parameter):
            p.copy_(glorot_uniform(tuple(p.shape), generator))

        glorot(self.item_emb)
        self.item_b.zero_()
        glorot(self.cate_emb)
        glorot(self.time_w)
        self.time_b.zero_()
        for blk in (*self.self_blocks, *self.vanilla_blocks):
            for part in blk.values():
                for name, p in part.items():
                    if p.dim() == 2:
                        glorot(p)
                    elif name == "ln_gamma":
                        p.fill_(1.0)
                    else:
                        p.zero_()
        return self

    # ------------------------------------------------------------------ fwd
    # Every item embedding of a forward comes from one `ItemCate`: on one
    # device rows of one item⊕cate table, built once and shared by the
    # history, query and catalog gathers; under a vocab-sharded mesh the
    # per-site sharded lookups.

    def _items(self, cate_list) -> ItemCate:
        return ItemCate(self.item_emb, self.cate_emb, cate_list)

    def _encode_history(self, batch: Batch, items: ItemCate,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
        """Query-independent self-attention encoding of the history; the
        readout conditions on a candidate item, so pair eval encodes once."""
        cfg = self.cfg
        h = items(batch["hist_i"])
        if cfg.concat_time_emb:
            onehot = one_hot(batch["hist_t"], N_TIME_BUCKETS, h.dtype)
            h = dense(torch.cat([h, onehot], dim=-1), self.time_w, self.time_b)
        else:
            t = batch["hist_t"].to(h.dtype)[..., None]
            h = h + dense(t, self.time_w, self.time_b, torch.tanh)
        sl = batch["sl"]
        enc = h
        for blk in self.self_blocks:
            enc = multihead_attention(enc, sl, enc, sl, cfg.num_heads,
                                      blk["attn"], cfg.dropout, generator)
            enc = feedforward(enc, blk["ffn"])
        return enc

    def _readout(self, enc, query_items, batch: Batch, items: ItemCate,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        """1-query vanilla attention of the candidate item over the encoded
        history (ATRank/model.py:310-328)."""
        cfg = self.cfg
        sl = batch["sl"]
        dec = items(query_items)[:, None, :]
        ones = torch.ones_like(sl)
        for blk in self.vanilla_blocks:
            dec = multihead_attention(dec, ones, enc, sl, cfg.num_heads,
                                      blk["attn"], cfg.dropout, generator)
            dec = feedforward(dec, blk["ffn"])
        return dec[:, 0, :]

    def _user_repr(self, batch: Batch, items: ItemCate,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the train-time dropout masks of every
        attention, one after the other; dropout is off without it or at
        rate 0."""
        if self.cfg.dropout <= 0.0:
            generator = None
        enc = self._encode_history(batch, items, generator)
        return self._readout(enc, batch["i"], batch, items, generator)

    def user_repr(self, batch: Batch, cate_list) -> torch.Tensor:
        return self._user_repr(batch, self._items(cate_list))

    def item_repr(self, ids, cate_list):
        return (item_cate_lookup(self.item_emb, self.cate_emb, ids, cate_list),
                lookup(self.item_b, ids))

    def all_item_repr(self, cate_list):
        """(item⊕cate table [I, Di+Dc], item biases [I]); under a
        vocab-sharded mesh this rank's rows of both."""
        return item_cate_rows(self.item_emb, self.cate_emb, cate_list), self.item_b

    def pair_logits(self, batch: Batch, cate_list):
        """(pos, neg) logits for the AUC pair: the history encoded once,
        then one readout per query item (the reference recomputes the
        encoder in two sess.runs, ATRank/model.py:253-282)."""
        items = self._items(cate_list)
        enc = self._encode_history(batch, items, None)
        return tuple(
            base.pointwise_logits(self._readout(enc, batch[key], batch, items, None),
                                  items(batch[key]),
                                  lookup(self.item_b, batch[key]))
            for key in ("i", "j"))

    def eval_logits(self, batch: Batch, cate_list) -> torch.Tensor:
        """Full-catalog scores [B, I] with the representation conditioned on
        batch["i"] (ATRank/model.py:100-104), on one device or a dp-only
        mesh; a vocab-sharded mesh scores through parallel/topk.py."""
        items = self._items(cate_list)
        return base.full_catalog_logits(self._user_repr(batch, items),
                                        items.table, self.item_b)

    # ----------------------------------------------------------------- loss

    def loss(self, batch: Batch, cate_list,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sigmoid cross-entropy of the (i, y) examples plus the batch-level
        L2 of the user output and the item embedding (ATRank/model.py:130-133),
        over valid rows when the batch has a `valid` mask; `generator`
        draws the train-time dropout masks.  Under a mesh, the global
        batch's loss: the L2 of batch rows sums over dp (models/base.py)."""
        items = self._items(cate_list)
        u = self._user_repr(batch, items, generator)
        i_emb = items(batch["i"])
        logits = base.pointwise_logits(u, i_emb, lookup(self.item_b, batch["i"]))
        valid = batch.get("valid")
        return (base.sigmoid_ce_loss(logits, batch["y"], valid)
                + self.cfg.regulation_rate * base.batch_l2(valid, u, i_emb))
