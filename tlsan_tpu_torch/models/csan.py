"""CSAN– — directional self-attention (DiSAN-style) baseline, the item-only
reduced variant the reference ships ("CSAN–" column, README.md:30).

Ported from tlsan_tpu/models/csan.py (reference graph: CSAN/model.py:51-85,
attention_net :251-314, directional_attention_with_dense :351-419,
feature_wise_self_attention :422-442, vanilla_attention :316-346).

Per block:
  - forward and backward directional attention: token-pair logits
    scaled_tanh(dependent + head + f_bias, 5) over [B, T, T, E], strict
    triangular direction masks at VERY_NEGATIVE_NUMBER, an additive
    −|tᵢ−tⱼ| day-distance penalty, softmax over the attended axis then a
    hard re-mask, and a sigmoid fusion gate between rep_map and the
    attention result;
  - feature-wise self-attention over concat(fw, bw) [B, T, 2E] —
    elementwise soft·rep (the time axis stays), then dense back to E;
  - readout: scaled-dot vanilla attention of the target item over the
    encoded sequence, masked at −2³²+1 before the 1/√E scale, in the
    reference's order.

Dropout (train only) at the reference's sites, all drawn from one
generator in a fixed order — per block: forward direction (input, rep_map,
both gate inputs), backward direction (the same four), feature-wise
self-attention (both map inputs).  The user representation is conditioned
on the query item, also at full-catalog eval (the reference scores every
item with the positive item's representation); the history encoding does
not depend on it, so the AUC pair encodes once and reads out twice.

Batch layout: hist_i[B,T], hist_t[B,T] (float day deltas), sl[B], i[B]
(the query item), plus y[B] for the loss, an optional valid[B], and j[B]
for the pair.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models import base
from tlsan_tpu_torch.nn.embedding import lookup
from tlsan_tpu_torch.nn.init import glorot_uniform, zeros_param
from tlsan_tpu_torch.nn.layers import dense, dropout
from tlsan_tpu_torch.nn.masks import VERY_NEGATIVE_NUMBER, sequence_mask

Batch = Dict[str, torch.Tensor]
Params = Mapping[str, torch.Tensor]

KEY_MASK_VALUE = -(2.0 ** 32) + 1


def _scaled_tanh(x, scale: float = 5.0):
    return scale * torch.tanh(x / scale)


def _directional_attention(x, rep_time, sl, p: Params, forward: bool,
                           rate: float, gen: Optional[torch.Generator]):
    """One direction of DiSAN attention (CSAN/model.py:351-419).  Dropout
    lands on the map dense's input (:383), on rep_map where it feeds
    dependent and head (:385, :391-392), and on both fusion-gate inputs
    (:407-408); the attention value and the gate's convex combination use
    the un-dropped rep_map."""
    B, T, E = x.shape
    rep_mask = sequence_mask(sl, T)  # [B, T]
    rep_map = dense(dropout(x, rate, gen), p["map_w"], p["map_b"], torch.relu)
    rep_map_dp = dropout(rep_map, rate, gen)
    dependent = dense(rep_map_dp, p["dep_w"])  # [B, T, E]
    head = dense(rep_map_dp, p["head_w"])      # [B, T, E]
    # logits[b, th, td, d] = scaled_tanh(dep[b,td,d] + head[b,th,d] + f_bias)
    logits = _scaled_tanh(dependent[:, None, :, :] + head[:, :, None, :] + p["f_bias"])

    r = torch.arange(T, device=x.device)
    direct = (r[:, None] > r[None, :]) if forward else (r[:, None] < r[None, :])
    attn_mask = direct[None, :, :] & rep_mask[:, None, :]  # [B, T, T]
    # additive time-distance penalty −|tᵢ−tⱼ| (CSAN/model.py:376-378, :397)
    position = -torch.abs(rep_time[:, :, None] - rep_time[:, None, :])
    logits = (logits
              + ((1.0 - attn_mask.to(logits.dtype)) * VERY_NEGATIVE_NUMBER)[..., None]
              + position[..., None])
    score = torch.softmax(logits, dim=2)
    score = score * attn_mask[..., None].to(score.dtype)  # hard re-mask
    attn_result = torch.einsum("bhcd,bcd->bhd", score, rep_map)

    gate = torch.sigmoid(
        dense(dropout(rep_map, rate, gen), p["fus_i_w"], p["fus_i_b"])
        + dense(dropout(attn_result, rate, gen), p["fus_a_w"], p["fus_a_b"])
        + p["o_bias"])
    out = gate * rep_map + (1.0 - gate) * attn_result
    return out * rep_mask[:, :, None].to(out.dtype)


def _feature_wise_self_attention(x, sl, p: Params, rate: float,
                                 gen: Optional[torch.Generator]):
    """Elementwise soft·rep over the time-masked softmax
    (CSAN/model.py:422-442): the output keeps [B, T, 2E].  Dropout on both
    map denses' inputs (:429-432); the product uses the un-dropped x."""
    T = x.shape[1]
    m1 = dense(dropout(x, rate, gen), p["w1"], p["b1"], torch.relu)
    m2 = dense(dropout(m1, rate, gen), p["w2"], p["b2"])
    mask = sequence_mask(sl, T)
    m2 = m2 + ((1.0 - mask.to(m2.dtype)) * VERY_NEGATIVE_NUMBER)[:, :, None]
    return torch.softmax(m2, dim=1) * x


def _vanilla_attention(query, keys, sl):
    """Target-query readout; the reference masks at −2³²+1 before the
    1/√E scale (CSAN/model.py:328-340), in that order."""
    T, E = keys.shape[1], keys.shape[2]
    scores = torch.einsum("be,bte->bt", query, keys)
    scores = torch.where(sequence_mask(sl, T), scores, KEY_MASK_VALUE)
    scores = scores / (E ** 0.5)
    soft = torch.softmax(scores, dim=-1)
    return torch.einsum("bt,bte->be", soft, keys)


def _direction(E: int, device) -> nn.ParameterDict:
    """One direction's maps ([E, E]) and biases ([E]), by the JAX names."""
    maps = ("map_w", "dep_w", "head_w", "fus_i_w", "fus_a_w")
    biases = ("map_b", "f_bias", "fus_i_b", "fus_a_b", "o_bias")
    return nn.ParameterDict({**{k: zeros_param(E, E, device=device) for k in maps},
                             **{k: zeros_param(E, device=device) for k in biases}})


class _Block(nn.Module):
    """One DiSAN block with the JAX package's names: fw, bw, fwsa and the
    projection back to E."""

    def __init__(self, E: int, device):
        super().__init__()
        self.fw = _direction(E, device)
        self.bw = _direction(E, device)
        self.fwsa = nn.ParameterDict({
            "w1": zeros_param(2 * E, 2 * E, device=device),
            "b1": zeros_param(2 * E, device=device),
            "w2": zeros_param(2 * E, 2 * E, device=device),
            "b2": zeros_param(2 * E, device=device)})
        self.proj_w = zeros_param(2 * E, E, device=device)
        self.proj_b = zeros_param(E, device=device)


class CSAN(nn.Module):
    name = "csan"
    # tables the reference regularizes as full variables (CSAN/model.py:112-114)
    l2_full_tables = ("item_emb",)

    def __init__(self, cfg: ModelConfig, device):
        """Allocates the parameters (zeros) on `device`; `init_params`
        draws their initial values."""
        super().__init__()
        self.cfg = cfg
        E = cfg.itemid_embedding_size
        self.item_emb = zeros_param(cfg.item_count, E, device=device)
        self.item_b = zeros_param(cfg.item_count, device=device)
        self.blocks = nn.ModuleList(_Block(E, device) for _ in range(cfg.num_blocks))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "CSAN":
        """Glorot-uniform tables and kernels, zero biases.  Returns self."""
        for p in self.parameters():
            if p.dim() == 2:
                p.copy_(glorot_uniform(tuple(p.shape), generator))
            else:
                p.zero_()
        return self

    def _encode_history(self, batch: Batch,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The query-independent DiSAN encoder; dropout engages with a
        generator at a rate above 0 (training)."""
        rate = self.cfg.dropout
        if rate <= 0.0:
            generator = None
        enc = lookup(self.item_emb, batch["hist_i"])
        sl, rep_time = batch["sl"], batch["hist_t"]
        for blk in self.blocks:
            fw = _directional_attention(enc, rep_time, sl, blk.fw, True, rate, generator)
            bw = _directional_attention(enc, rep_time, sl, blk.bw, False, rate, generator)
            enc = _feature_wise_self_attention(torch.cat([fw, bw], dim=-1), sl,
                                               blk.fwsa, rate, generator)
            enc = dense(enc, blk.proj_w, blk.proj_b)
        return enc

    def _readout(self, enc, query, sl) -> torch.Tensor:
        dec = lookup(self.item_emb, query)
        for _ in self.blocks:
            dec = _vanilla_attention(dec, enc, sl)
        return dec

    def _user_repr(self, batch: Batch, generator=None) -> torch.Tensor:
        enc = self._encode_history(batch, generator)
        return self._readout(enc, batch["i"], batch["sl"])

    def user_repr(self, batch: Batch, cate_list) -> torch.Tensor:
        return self._user_repr(batch)

    def item_repr(self, ids, cate_list):
        return lookup(self.item_emb, ids), lookup(self.item_b, ids)

    def all_item_repr(self, cate_list):
        """(item table [I, E], item biases [I]); under a vocab-sharded mesh
        this rank's rows of both."""
        return self.item_emb, self.item_b

    def pair_logits(self, batch: Batch, cate_list):
        """(pos, neg): the history encoded once, one readout per query item
        (the reference recomputes the encoder in two sess.runs)."""
        enc = self._encode_history(batch)
        return tuple(
            base.pointwise_logits(self._readout(enc, batch[key], batch["sl"]),
                                  *self.item_repr(batch[key], cate_list))
            for key in ("i", "j"))

    def eval_logits(self, batch: Batch, cate_list) -> torch.Tensor:
        return base.full_catalog_logits(self._user_repr(batch), self.item_emb,
                                        self.item_b)

    def loss(self, batch: Batch, cate_list,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sigmoid cross-entropy plus the L2 of the item table
        (CSAN/model.py:112-114); `generator` draws the train-time dropout
        masks."""
        u = self._user_repr(batch, generator)
        logits = base.pointwise_logits(u, *self.item_repr(batch["i"], cate_list))
        l2 = base.l2_full_tables(self.item_emb)
        return (base.sigmoid_ce_loss(logits, batch["y"], batch.get("valid"))
                + self.cfg.regulation_rate * l2)
