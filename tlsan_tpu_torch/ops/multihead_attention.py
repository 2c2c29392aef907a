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
forward and K3b backward.  A bf16 tensor runs as f32 between two casts;
any other dtype on CUDA raises.  Train-time dropout (rate > 0 with a
generator or a mask source, nn/layers.py) lands on the attention
probabilities after the query mask: the dispatcher draws the keep mask
first ([B, H, Tq, Tk], one ``torch.rand``), then hands it to the plain
version on the CPU or to K3 and K3b on CUDA.
`multihead_attention_backward_reference` is K3b's plain version, and
`multihead_attention_backward_error_scale` the scale of its rounding.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from tlsan_tpu_torch.nn.layers import apply_keep, dense, draw_keep, dropout, layer_norm
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


def _backward_one(queries, q_len, keys, k_len, num_heads: int, p, g,
                  dropout_rate: float, keep_mask, scale: bool = False):
    """`multihead_attention_backward_reference` for one replica; with
    `scale`, `multihead_attention_backward_error_scale`'s: the same algebra
    on the magnitudes of its terms (every difference a sum)."""
    mag = torch.abs if scale else (lambda t: t)
    sign = 1.0 if scale else -1.0
    B, Tq, D = queries.shape
    Tk = keys.shape[1]
    dh = D // num_heads
    # the forward, as multihead_attention_reference computes it
    Q = dense(queries, p["wq"], p["bq"], torch.relu)
    K = dense(keys, p["wk"], p["bk"], torch.relu)
    V = dense(keys, p["wv"], p["bv"], torch.relu)
    Qh = Q.reshape(B, Tq, num_heads, dh)
    Kh = K.reshape(B, Tk, num_heads, dh)
    Vh = V.reshape(B, Tk, num_heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", Qh, Kh) / (dh ** 0.5)
    key_mask = sequence_mask(k_len, Tk)[:, None, None, :]
    p0 = torch.softmax(torch.where(key_mask, scores, KEY_MASK_VALUE), dim=-1)
    q_mask = sequence_mask(q_len, Tq).to(p0.dtype)[:, None, :, None]
    soft = dropout(p0 * q_mask, dropout_rate, None, keep_mask)
    y = torch.einsum("bhqk,bkhd->bqhd", soft, Vh).reshape(B, Tq, D) + queries
    mean = torch.mean(y, dim=-1, keepdim=True)
    centred = y - mean
    denom = torch.sqrt(torch.mean(torch.square(centred), dim=-1, keepdim=True) + 1e-8)
    y_hat = mag(centred / denom)
    g = mag(g)

    # LayerNorm: dγ, dβ, and dy through the normalisation
    d_gamma = torch.sum(g * y_hat, dim=(0, 1))
    d_beta = torch.sum(g, dim=(0, 1))
    dy_hat = g * mag(p["ln_gamma"])
    dy = (dy_hat + sign * torch.mean(dy_hat, dim=-1, keepdim=True)
          + sign * y_hat * torch.mean(dy_hat * y_hat, dim=-1, keepdim=True)) / denom
    dyh = dy.reshape(B, Tq, num_heads, dh)
    # the weighted sum, then the dropout, the query mask and the softmax
    dVh = torch.einsum("bhqk,bqhd->bkhd", soft, dyh)
    dp0 = torch.einsum("bqhd,bkhd->bhqk", dyh, Vh) * q_mask
    if keep_mask is not None and dropout_rate > 0.0:  # as `dropout` applies it
        dp0 = apply_keep(dp0, keep_mask, dropout_rate)
    ds = p0 * (dp0 + sign * torch.sum(dp0 * p0, dim=-1, keepdim=True))
    ds = torch.where(key_mask, ds, 0.0) / (dh ** 0.5)
    dQh = torch.einsum("bhqk,bkhd->bqhd", ds, Kh)
    dKh = torch.einsum("bhqk,bqhd->bkhd", ds, Qh)
    # the ReLU projections (relu's output is > 0 exactly where its input is)
    dq_pre = dQh.reshape(B, Tq, D) * (Q > 0)
    dk_pre = dKh.reshape(B, Tk, D) * (K > 0)
    dv_pre = dVh.reshape(B, Tk, D) * (V > 0)
    d_queries = dy + dq_pre @ mag(p["wq"]).T
    d_keys = dk_pre @ mag(p["wk"]).T + dv_pre @ mag(p["wv"]).T

    def weight(x, d_pre):
        return torch.einsum("btd,bte->de", mag(x), d_pre), torch.sum(d_pre, dim=(0, 1))

    return (d_queries, d_keys, *weight(queries, dq_pre), *weight(keys, dk_pre),
            *weight(keys, dv_pre), d_gamma, d_beta)


def _backward(queries, q_len, keys, k_len, num_heads, p, g, dropout_rate, keep_mask,
              scale: bool):
    """`_backward_one`, under vmap over a leading replica axis where the
    tensors have one."""
    if queries.dim() == 3:
        return _backward_one(queries, q_len, keys, k_len, num_heads, p, g,
                             dropout_rate, keep_mask, scale)
    names = sorted(p)

    def one(q, ql, k, kl, grad, mask, *ws):
        return _backward_one(q, ql, k, kl, num_heads, dict(zip(names, ws)), grad,
                             dropout_rate, mask, scale)

    mask_dim = None if keep_mask is None else 0
    return torch.func.vmap(one, in_dims=(0, 0, 0, 0, 0, mask_dim) + (0,) * len(names))(
        queries, q_len, keys, k_len, g, keep_mask, *(p[n] for n in names))


def multihead_attention_backward_reference(queries, q_len, keys, k_len,
                                           num_heads: int,
                                           p: Mapping[str, torch.Tensor], g,
                                           dropout_rate: float = 0.0,
                                           keep_mask: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K3b (csrc/mha_bwd.cu), in explicit algebra
    (not autograd): the gradients (d_queries, d_keys, dwq, dbq, dwk, dbk,
    dwv, dbv, d_gamma, d_beta) of `multihead_attention_reference`'s output
    at (queries, keys, p) for the incoming gradient g = dL/dout [B, Tq, D];
    with the forward's dropout `keep_mask` and rate, of the dropped
    forward.  For self-attention (keys is queries) the caller adds
    d_queries and d_keys.  With a replica axis every tensor leads with R
    (queries [R, B, Tq, D], p's weights [R, D, D] and [R, D], the mask [R,
    B, H, Tq, Tk]) and each replica's weight gradients are its own.  Per
    row and head, with P₀ the softmax before the query mask:

      dγ = Σ g⊙ŷ, dβ = Σ g, dy = (dŷ − mean dŷ − ŷ·mean(dŷ⊙ŷ)) / σ
      (dŷ = g⊙γ; the residual sends dy to the queries);
      dV = P′ᵀ·dy, with P′ the masked, dropped-out probabilities;
      dP₀ = (dy·Vᵀ) ⊙ qmask ⊙ keep/kp;
      dS = P₀ ⊙ (dP₀ − rowsum(dP₀⊙P₀)), zero at masked keys;
      dQ = dS·K/√dh, dK = dSᵀ·Q/√dh; then the ReLU masks and the
      projections' transposes, dW = xᵀ·dpre and db = Σ dpre over every row.

    A row with k_len = 0 has a softmax uniform over every key, padding
    included: its dV is not zero at padded keys, its dQ and dK from the
    scores are.  It is K3b's oracle on the card and what the CPU tests
    hold against jax.vjp."""
    return _backward(queries, q_len, keys, k_len, num_heads, p, g, dropout_rate,
                     keep_mask, scale=False)


def multihead_attention_backward_error_scale(queries, q_len, keys, k_len,
                                             num_heads: int,
                                             p: Mapping[str, torch.Tensor], g,
                                             dropout_rate: float = 0.0,
                                             keep_mask: Optional[torch.Tensor] = None):
    """For each gradient of `multihead_attention_backward_reference`, the
    sum of the magnitudes of the terms it adds up, through the backward's
    algebra (the forward's values, then every product of magnitudes and
    every difference a sum): the scale of its f32 rounding error, which two
    correct implementations that round in other places differ by (times a
    few ε).  A weight gradient sums a product a row over the whole batch,
    and where those terms cancel, its value is far below that scale: a bar
    relative to the value would test noise (ops/feature_attention.py::
    fwa_backward_error_scale is K2's)."""
    return _backward(queries, q_len, keys, k_len, num_heads, p, g, dropout_rate,
                     keep_mask, scale=True)


def multihead_attention(queries, q_len, keys, k_len, num_heads: int,
                        p: Mapping[str, torch.Tensor],
                        dropout_rate: float = 0.0, generator=None):
    """The attention output [B, Tq, D]: the plain version on the CPU, K3
    and K3b (`MHAFunction`) on a CUDA f32 tensor.  bf16 `queries` (mixed
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
