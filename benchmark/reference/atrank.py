"""ATRank in plain PyTorch, from the equations of its code in the TLSAN
repository (ATRank/model.py:46-133, multihead_attention :334-424,
feedforward :426-459, normalize :461-488):

  - history rows are item(32) ⊕ cate(32) ⊕ one-hot(12) of the time
    bucket, mapped by a dense layer to 64 features;
  - a self-attention block: relu(x·Wq + bq), relu(x·Wk + bk),
    relu(x·Wv + bv), heads splitting the features, scores QKᵀ/√dh, keys
    past the length set to −2³² + 1, a softmax over keys, rows past the
    query length zeroed, the weighted sum of V, the queries added back,
    LayerNorm; then relu(x·W1 + b1)·W2 + b2 with x added back, LayerNorm;
  - the readout: the target item's row is the one query of the same
    block over the encoded history;
  - logit = u · item row + the item's bias; the loss is the mean sigmoid
    cross-entropy plus 5e-5 × ½‖·‖² of u and the item rows of the batch.

Departures: none in the arithmetic; dropout is 0 as in the flags.  The
served user's query item is its newest history item (the code scores
with the positive item's representation).
"""

from __future__ import annotations

import torch

from benchmark.reference.common import GLOROT, l2, layer_norm, sigmoid_ce, uniform

HISTORY = (("hist_i", "sl"),)
SERVE_FIELDS = ("u", "hist_i", "hist_t", "sl", "i")
BUCKETS = 12
KEY_MASK = -(2.0 ** 32) + 1

BIAS = uniform(-0.1, 0.1)


def _block(prefix: str, D: int):
    attn = [(f"{prefix}.attn.{w}", (D, D), GLOROT) for w in ("wq", "wk", "wv")]
    attn += [(f"{prefix}.attn.{b}", (D,), BIAS) for b in ("bq", "bk", "bv")]
    attn += [(f"{prefix}.attn.ln_gamma", (D,), uniform(0.9, 1.1)),
             (f"{prefix}.attn.ln_beta", (D,), BIAS)]
    ffn = [(f"{prefix}.ffn.w1", (D, D // 4), GLOROT), (f"{prefix}.ffn.b1", (D // 4,), BIAS),
           (f"{prefix}.ffn.w2", (D // 4, D), GLOROT), (f"{prefix}.ffn.b2", (D,), BIAS),
           (f"{prefix}.ffn.ln_gamma", (D,), uniform(0.9, 1.1)),
           (f"{prefix}.ffn.ln_beta", (D,), BIAS)]
    return attn + ffn


def param_specs(config: dict):
    m, cat = config["model"], config["catalog"]
    D = m["hidden_units"]
    Di, Dc = m["itemid_embedding_size"], m["cateid_embedding_size"]
    specs = [("item_emb", (cat["items"], Di), GLOROT), ("item_b", (cat["items"],), BIAS),
             ("cate_emb", (cat["cates"], Dc), GLOROT),
             ("time_w", (Di + Dc + BUCKETS, D), GLOROT), ("time_b", (D,), BIAS)]
    for n in range(m["num_blocks"]):
        specs += _block(f"self_blocks.{n}", D)
    for n in range(m["num_blocks"]):
        specs += _block(f"vanilla_blocks.{n}", D)
    return specs


def attention(q, q_len, k, k_len, heads, p, pre):
    B, Tq, D = q.shape
    Tk, dh = k.shape[1], D // heads

    def proj(x, w, T):
        return torch.relu(x @ p[f"{pre}.w{w}"] + p[f"{pre}.b{w}"]).reshape(
            B, T, heads, dh).transpose(1, 2)

    Q, K, V = proj(q, "q", Tq), proj(k, "k", Tk), proj(k, "v", Tk)
    s = Q @ K.transpose(-1, -2) / dh ** 0.5
    keys = torch.arange(Tk, device=q.device)[None, :] < k_len[:, None].long()
    s = torch.where(keys[:, None, None, :], s, KEY_MASK)
    rows = torch.arange(Tq, device=q.device)[None, :] < q_len[:, None].long()
    a = torch.softmax(s, dim=-1) * rows.to(s.dtype)[:, None, :, None]
    out = (a @ V).transpose(1, 2).reshape(B, Tq, D) + q
    return layer_norm(out, p[f"{pre}.ln_gamma"], p[f"{pre}.ln_beta"])


def feedforward(x, p, pre):
    h = torch.relu(x @ p[f"{pre}.w1"] + p[f"{pre}.b1"]) @ p[f"{pre}.w2"] + p[f"{pre}.b2"]
    return layer_norm(h + x, p[f"{pre}.ln_gamma"], p[f"{pre}.ln_beta"])


def user_repr(p, b, cate_list, m):
    H = m["num_heads"]
    rows = torch.cat([p["item_emb"], p["cate_emb"][cate_list.long()]], dim=1)
    t = b["hist_t"].long()
    onehot = (t[..., None] == torch.arange(BUCKETS, device=t.device)).to(rows.dtype)
    x = torch.cat([rows[b["hist_i"].long()], onehot], dim=-1) @ p["time_w"] + p["time_b"]
    sl = b["sl"]
    for n in range(m["num_blocks"]):
        x = attention(x, sl, x, sl, H, p, f"self_blocks.{n}.attn")
        x = feedforward(x, p, f"self_blocks.{n}.ffn")
    q = rows[b["i"].long()][:, None, :]
    ones = torch.ones_like(sl)
    for n in range(m["num_blocks"]):
        q = attention(q, ones, x, sl, H, p, f"vanilla_blocks.{n}.attn")
        q = feedforward(q, p, f"vanilla_blocks.{n}.ffn")
    return q[:, 0, :], rows


def loss(p, b, cate_list, m):
    u, rows = user_repr(p, b, cate_list, m)
    i = b["i"].long()
    item = rows[i]
    logits = torch.sum(u * item, dim=-1) + p["item_b"][i]
    return sigmoid_ce(logits, b["y"]) + m["regulation_rate"] * l2(u, item)


def scores(p, b, cate_list, m):
    """[B, items] logits of every catalog item, the representation
    conditioned on the batch's query item."""
    u, rows = user_repr(p, b, cate_list, m)
    return u @ rows.T + p["item_b"]
