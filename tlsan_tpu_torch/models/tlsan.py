"""TLSAN — Time-aware Long- and Short-term Attention Network (headline model).

Ported from tlsan_tpu/models/tlsan.py (reference graph: TLSAN/model.py:56-140,
attention_net :316-366, feature_wise_attention :370-394):

  - item(32)⊕cate(32) and user(32)⊕dominant-cate(32) embeddings (:84-95);
  - personalized time-interval positional embedding: per-user per-position
    weights `usert_emb[u] * hist_t`, scaled by a learned scalar gamma and
    multiplied into the long-term history embeddings (:98-109);
  - long-term layer: num_blocks × feature-wise attention over the fixed
    Ls-window, then a dense map expanded to a 1-step pseudo-item (:330-347);
  - short-term layer: pseudo-item concatenated before the current session,
    feature-wise attention with valid length sl_new+1 (:349-364);
  - u_t = attention output + user embedding; logits = Σ(u_t⊙i_emb)+i_b (:135-137).

The parameters keep the JAX names and layouts (``long.0.proj_w`` is
[in, out] and is applied as ``enc @ proj_w``), so one numpy copy moves a JAX
parameter tree in and out (tools/params.py).

Batch layout (static shapes, tensors on the model's device):
  u[B], c[B] (dominant cate), hist_i[B,Ls], hist_t[B,Ls], hist_i_new[B,Ts],
  sl[B], sl_new[B] (int32), plus i[B] and y[B] (float) for the loss, an
  optional valid[B] (bool) masking padded rows, and i[B], j[B] for the AUC
  pair.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
from tlsan_tpu_torch.ops.feature_attention import (
    feature_wise_attention,
    feature_wise_attention_reference,
)

Batch = Dict[str, torch.Tensor]


class TLSAN(nn.Module):
    name = "tlsan"
    # tables the reference regularizes as full variables (TLSAN/model.py:164-169)
    l2_full_tables = ("user_emb", "item_emb", "cate_emb", "usert_emb")

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_units
        dh = D // cfg.num_heads
        self.gamma = zeros_param(device=device)
        self.item_emb = zeros_param(cfg.item_count, cfg.itemid_embedding_size,
                                    device=device)
        self.item_b = zeros_param(cfg.item_count, device=device)
        self.user_emb = zeros_param(cfg.user_count, cfg.userid_embedding_size,
                                    device=device)
        self.usert_emb = zeros_param(cfg.user_count, cfg.Ls, device=device)
        self.cate_emb = zeros_param(cfg.cate_count, cfg.cateid_embedding_size,
                                    device=device)
        self.long = nn.ModuleList(nn.ParameterDict({
            "w1": zeros_param(dh, dh, device=device), "b1": zeros_param(dh, device=device),
            "w2": zeros_param(dh, dh, device=device), "b2": zeros_param(dh, device=device),
            "proj_w": zeros_param(D, D, device=device),
            "proj_b": zeros_param(D, device=device),
        }) for _ in range(cfg.num_blocks))
        self.short = nn.ModuleList(nn.ParameterDict({
            "w1": zeros_param(dh, dh, device=device), "b1": zeros_param(dh, device=device),
            "w2": zeros_param(dh, dh, device=device), "b2": zeros_param(dh, device=device),
        }) for _ in range(cfg.num_blocks))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TLSAN":
        """The JAX package's initial values in distribution: glorot-uniform
        tables and maps, zero biases, gamma 1, usert_emb −1
        (TLSAN/model.py:58-81, :347).  Returns self."""
        def glorot(p: nn.Parameter):
            p.copy_(glorot_uniform(tuple(p.shape), generator))

        self.gamma.fill_(1.0)
        glorot(self.item_emb)
        self.item_b.zero_()
        glorot(self.user_emb)
        self.usert_emb.fill_(-1.0)
        glorot(self.cate_emb)
        for lb, sb in zip(self.long, self.short):
            glorot(lb["w1"])
            glorot(lb["w2"])
            glorot(lb["proj_w"])
            glorot(sb["w1"])
            glorot(sb["w2"])
            for blk in (lb, sb):
                for key in ("b1", "b2"):
                    blk[key].zero_()
            lb["proj_b"].zero_()
        return self

    # ------------------------------------------------------------------ fwd
    # Every item embedding of a forward comes from one `ItemCate`: on one
    # device rows of one item⊕cate table, built once and shared by the
    # history gathers and the catalog product; under a vocab-sharded mesh
    # the per-site sharded lookups.

    def _items(self, cate_list) -> ItemCate:
        return ItemCate(self.item_emb, self.cate_emb, cate_list)

    def _long_input(self, batch: Batch, items: ItemCate):
        """History embeddings scaled by the personalized time weights
        gamma·usert_emb[u]·hist_t (TLSAN/model.py:98-109)."""
        ut = lookup(self.usert_emb, batch["u"]) * batch["hist_t"]  # [B, Ls]
        return items(batch["hist_i"]) * (self.gamma * ut)[..., None]

    def _user_repr(self, batch: Batch, items: ItemCate,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the train-time dropout masks of both towers,
        one draw after the other (the JAX package splits its key per tower,
        tlsan_tpu/models/tlsan.py:112-117); dropout is off without it or
        at rate 0."""
        cfg = self.cfg
        if cfg.dropout <= 0.0:
            generator = None
        u_emb = torch.cat([lookup(self.user_emb, batch["u"]),
                           lookup(self.cate_emb, batch["c"])], dim=-1)
        h_new = items(batch["hist_i_new"])

        # long-term tower (TLSAN/model.py:330-347)
        enc = self._long_input(batch, items)
        for blk in self.long:
            enc = feature_wise_attention(enc, batch["sl"], cfg.num_heads,
                                         blk["w1"], blk["b1"], blk["w2"],
                                         blk["b2"], cfg.dropout, generator)
            enc = enc @ blk["proj_w"] + blk["proj_b"]
            enc = enc[:, None, :]  # 1-step pseudo-item

        # short-term tower (TLSAN/model.py:349-364): pseudo-item prepended,
        # valid length sl_new+1; each block reads the same concat input
        enc = torch.cat([enc, h_new], dim=1)
        out = None
        for blk in self.short:
            out = feature_wise_attention(enc, batch["sl_new"] + 1,
                                         cfg.num_heads, blk["w1"], blk["b1"],
                                         blk["w2"], blk["b2"], cfg.dropout,
                                         generator)
        return out + u_emb  # (TLSAN/model.py:135)

    def user_repr(self, batch: Batch, cate_list) -> torch.Tensor:
        return self._user_repr(batch, self._items(cate_list))

    def attention_maps(self, batch: Batch, cate_list
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(att0, att1): the long- and short-term attention maps, through the
        plain version as in the JAX package (TLSAN/model.py:122,366).
        Shapes: att0 [B, Ls, H, dh], att1 [B, Ts+1, H, dh]."""
        cfg = self.cfg
        items = self._items(cate_list)
        att0 = att1 = None
        enc = self._long_input(batch, items)
        for blk in self.long:
            enc, att0 = feature_wise_attention_reference(
                enc, batch["sl"], cfg.num_heads,
                blk["w1"], blk["b1"], blk["w2"], blk["b2"], return_soft=True)
            enc = (enc @ blk["proj_w"] + blk["proj_b"])[:, None, :]
        enc = torch.cat([enc, items(batch["hist_i_new"])], dim=1)
        for blk in self.short:
            _, att1 = feature_wise_attention_reference(
                enc, batch["sl_new"] + 1, cfg.num_heads,
                blk["w1"], blk["b1"], blk["w2"], blk["b2"], return_soft=True)
        return att0, att1

    def item_repr(self, ids, cate_list):
        return (item_cate_lookup(self.item_emb, self.cate_emb, ids, cate_list),
                lookup(self.item_b, ids))

    def all_item_repr(self, cate_list):
        """(item⊕cate table [I, Di+Dc], item biases [I]); under a
        vocab-sharded mesh this rank's rows of both."""
        return item_cate_rows(self.item_emb, self.cate_emb, cate_list), self.item_b

    def pair_logits(self, batch: Batch, cate_list):
        """(pos, neg) logits for the AUC pair from one user forward
        (TLSAN/model.py:239-261)."""
        items = self._items(cate_list)
        u_t = self._user_repr(batch, items)
        return tuple(base.pointwise_logits(u_t, items(batch[key]),
                                           lookup(self.item_b, batch[key]))
                     for key in ("i", "j"))

    def eval_logits(self, batch: Batch, cate_list) -> torch.Tensor:
        """Full-catalog scores [B, I] (TLSAN/model.py:140), on one device
        or a dp-only mesh; a vocab-sharded mesh scores through
        parallel/topk.py."""
        items = self._items(cate_list)
        return base.full_catalog_logits(self._user_repr(batch, items),
                                        items.table, self.item_b)

    # ----------------------------------------------------------------- loss

    def loss(self, batch: Batch, cate_list,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sigmoid cross-entropy of the (i, y) examples plus the L2 of the
        four full tables (TLSAN/model.py:160-171); `generator` draws the
        train-time dropout masks.  Under a mesh, the global batch's loss
        (models/base.py)."""
        items = self._items(cate_list)
        u_t = self._user_repr(batch, items, generator)
        logits = base.pointwise_logits(u_t, items(batch["i"]),
                                       lookup(self.item_b, batch["i"]))
        l2 = base.l2_full_tables(*(getattr(self, n) for n in self.l2_full_tables))
        return (base.sigmoid_ce_loss(logits, batch["y"], batch.get("valid"))
                + self.cfg.regulation_rate * l2)
