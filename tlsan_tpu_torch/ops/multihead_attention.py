"""Multi-head scaled-dot attention — ATRank's substrate.

Ported from tlsan_tpu/ops/multihead_attention.py (reference:
ATRank/model.py:334-424 `multihead_attention`):
  - relu Q/K/V projections (:369-371);
  - heads split on features (a reshape);
  - scaled dot-product, key-padding mask at −2³²+1 (:382-393), a finite
    constant: a row with k_len = 0 gets a softmax uniform over all keys;
  - softmax over keys, then query-mask zeroing (:398-404);
  - weighted sum, heads re-concatenated, residual += queries, LayerNorm
    (:413-422).

Shapes: queries [B, Tq, D], keys [B, Tk, D] → [B, Tq, D].

`multihead_attention` runs the plain version for a CPU tensor and, for a
CUDA f32 tensor, `ops/cuda/mha.py::MHAFunction`: the CUDA kernel K3
forward, the plain version recomputed under autograd backward.  A bf16
tensor runs as f32 between two casts; any other dtype on CUDA raises.
Train-time dropout (rate > 0 with a generator or a mask source,
nn/layers.py) lands on the attention probabilities after the query mask:
the dispatcher draws the keep mask first ([B, H, Tq, Tk], one
``torch.rand``), then hands it to the plain version on the CPU or to K3
(and the backward's plain recompute) on CUDA.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from tlsan_tpu_torch.nn.layers import dense, draw_keep, dropout, layer_norm
from tlsan_tpu_torch.nn.masks import sequence_mask
from tlsan_tpu_torch.ops.cuda import mha

KEY_MASK_VALUE = -(2.0 ** 32) + 1


def draw_mask(queries, keys, num_heads: int, dropout_rate: float, generator):
    """The keep mask (bool [B, H, Tq, Tk]) of a train-time attention of
    queries [B, Tq, D] over keys [B, Tk, D], or None without dropout."""
    if dropout_rate <= 0.0 or generator is None:
        return None
    B, Tq = queries.shape[:2]
    return draw_keep(generator, (B, num_heads, Tq, keys.shape[1]),
                     1.0 - dropout_rate, queries.device)


def multihead_attention_reference(queries, q_len, keys, k_len, num_heads: int,
                                  p: Mapping[str, torch.Tensor],
                                  dropout_rate: float = 0.0,
                                  generator: Optional[torch.Generator] = None,
                                  keep_mask: Optional[torch.Tensor] = None):
    """Plain PyTorch version (the correctness oracle of K3) → (out, soft).
    p holds wq, bq, wk, bk, wv, bv ([D, D] / [D]) and ln_gamma, ln_beta [D].
    Train-time dropout lands on the attention probabilities
    (ATRank/model.py:410): `keep_mask` when given, else drawn from
    `generator`.  On CUDA the caller keeps TF32 off, as the f32 contract
    needs."""
    B, Tq, D = queries.shape
    Tk = keys.shape[1]
    dh = D // num_heads

    Q = dense(queries, p["wq"], p["bq"], torch.relu)
    K = dense(keys, p["wk"], p["bk"], torch.relu)
    V = dense(keys, p["wv"], p["bv"], torch.relu)

    Qh = Q.reshape(B, Tq, num_heads, dh)
    Kh = K.reshape(B, Tk, num_heads, dh)
    Vh = V.reshape(B, Tk, num_heads, dh)

    scores = torch.einsum("bqhd,bkhd->bhqk", Qh, Kh) / (dh ** 0.5)
    key_mask = sequence_mask(k_len, Tk)[:, None, None, :]  # [B, 1, 1, Tk]
    scores = torch.where(key_mask, scores, KEY_MASK_VALUE)
    soft = torch.softmax(scores, dim=-1)
    # query-mask zeroing (ATRank/model.py:401-404)
    q_mask = sequence_mask(q_len, Tq).to(soft.dtype)[:, None, :, None]
    soft = soft * q_mask
    soft = dropout(soft, dropout_rate, generator, keep_mask)

    out = torch.einsum("bhqk,bkhd->bqhd", soft, Vh).reshape(B, Tq, D)
    out = out + queries  # residual (:419)
    return layer_norm(out, p["ln_gamma"], p["ln_beta"]), soft


def multihead_attention(queries, q_len, keys, k_len, num_heads: int,
                        p: Mapping[str, torch.Tensor],
                        dropout_rate: float = 0.0, generator=None):
    """The attention output [B, Tq, D]: the plain version on the CPU, K3
    (`MHAFunction`) on a CUDA f32 tensor.  bf16 `queries` (mixed
    precision) are cast to f32 with the keys and weights, run as f32 does,
    and the output is cast back: K3 keeps its f32 contract.  Dropout
    engages when `dropout_rate` > 0 and a generator (or a mask source,
    nn/layers.py) is given (training): the mask is drawn here, then the
    plain version or K3 applies it."""
    if queries.dtype == torch.bfloat16:
        return multihead_attention(
            queries.float(), q_len, keys.float(), k_len, num_heads,
            {k: v.float() for k, v in p.items()}, dropout_rate,
            generator).to(torch.bfloat16)
    mask = draw_mask(queries, keys, num_heads, dropout_rate, generator)
    if queries.device.type == "cpu":
        return multihead_attention_reference(
            queries, q_len, keys, k_len, num_heads, p,
            dropout_rate=dropout_rate, keep_mask=mask)[0]
    if queries.device.type == "cuda" and queries.dtype == torch.float32:
        drop = () if mask is None else (mask, dropout_rate)
        return mha.MHAFunction.apply(queries, keys, q_len, k_len, num_heads,
                                     *(p[name] for name in mha.WEIGHTS), *drop)
    raise NotImplementedError(
        f"multihead_attention: no kernel for {queries.dtype} on {queries.device}")


def feedforward(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Conv1d(kernel 1) FFN + residual + LayerNorm (reference:
    ATRank/model.py:426-459): relu dense to D/4, then linear back."""
    out = dense(x, p["w1"], p["b1"], torch.relu)
    out = dense(out, p["w2"], p["b2"])
    return layer_norm(out + x, p["ln_gamma"], p["ln_beta"])
