"""TLSAN in plain PyTorch, from the paper's and the official code's
equations (TLSAN/model.py:56-171, feature-wise attention :370-394):

  - item rows are item(32) ⊕ cate(32), the user row user(32) ⊕ the
    dominant category's(32);
  - the long-term history is scaled by γ · usert_emb[u] · the reciprocal
    time weight of each item;
  - feature-wise attention over time, heads splitting the features:
    z = relu(x·W1 + b1)·W2 + b2 for each head, −1e30 added at padded
    steps, a softmax over time for each feature, Σ_t softmax · x;
  - the long tower's output through a dense map becomes one pseudo-item
    put before the current session; the short tower attends over it with
    length sl_new + 1;
  - u = the short tower's output + the user row; logit = u · item row +
    the item's bias; the loss is the mean sigmoid cross-entropy plus
    5e-5 × ½‖·‖² of the user, item, category and time tables.

Departure: the session is padded to the catalog's Ts, a multiple of 8
over its longest session, as the port pads it (the code pads each batch
to its own longest), which the masking makes invisible.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import GLOROT, l2, sigmoid_ce, uniform

HISTORY = (("hist_i", "sl"), ("hist_i_new", "sl_new"))
SERVE_FIELDS = ("u", "c", "hist_i", "hist_t", "hist_i_new", "sl", "sl_new")
L2_TABLES = ("user_emb", "item_emb", "cate_emb", "usert_emb")

BIAS = uniform(-0.1, 0.1)


def param_specs(config: dict):
    m, cat = config["model"], config["catalog"]
    D, H = m["hidden_units"], m["num_heads"]
    dh = D // H
    specs = [("gamma", (), uniform(0.9, 1.1)),
             ("item_emb", (cat["items"], m["itemid_embedding_size"]), GLOROT),
             ("item_b", (cat["items"],), BIAS),
             ("user_emb", (cat["users"], m["userid_embedding_size"]), GLOROT),
             ("usert_emb", (cat["users"], m["Ls"]), uniform(-1.1, -0.9)),
             ("cate_emb", (cat["cates"], m["cateid_embedding_size"]), GLOROT)]
    for n in range(m["num_blocks"]):
        specs += [(f"long.{n}.w1", (dh, dh), GLOROT), (f"long.{n}.b1", (dh,), BIAS),
                  (f"long.{n}.w2", (dh, dh), GLOROT), (f"long.{n}.b2", (dh,), BIAS),
                  (f"long.{n}.proj_w", (D, D), GLOROT), (f"long.{n}.proj_b", (D,), BIAS)]
    for n in range(m["num_blocks"]):
        specs += [(f"short.{n}.w1", (dh, dh), GLOROT), (f"short.{n}.b1", (dh,), BIAS),
                  (f"short.{n}.w2", (dh, dh), GLOROT), (f"short.{n}.b2", (dh,), BIAS)]
    return specs


def feature_attention(x, lengths, heads, w1, b1, w2, b2):
    B, S, D = x.shape
    xh = x.reshape(B, S, heads, D // heads)
    z = torch.relu(xh @ w1 + b1) @ w2 + b2
    pad = torch.arange(S, device=x.device)[None, :] >= lengths[:, None].long()
    z = z + pad.to(z.dtype)[:, :, None, None] * -1e30
    return torch.sum(torch.softmax(z, dim=1) * xh, dim=1).reshape(B, D)


def user_repr(p, b, cate_list, m):
    H = m["num_heads"]
    rows = torch.cat([p["item_emb"], p["cate_emb"][cate_list.long()]], dim=1)
    u, c = b["u"].long(), b["c"].long()
    weight = p["gamma"] * p["usert_emb"][u] * b["hist_t"]
    x = rows[b["hist_i"].long()] * weight[..., None]
    for n in range(m["num_blocks"]):
        x = feature_attention(x, b["sl"], H, p[f"long.{n}.w1"], p[f"long.{n}.b1"],
                              p[f"long.{n}.w2"], p[f"long.{n}.b2"])
        x = (x @ p[f"long.{n}.proj_w"] + p[f"long.{n}.proj_b"])[:, None, :]
    x = torch.cat([x, rows[b["hist_i_new"].long()]], dim=1)
    for n in range(m["num_blocks"]):
        out = feature_attention(x, b["sl_new"] + 1, H, p[f"short.{n}.w1"],
                                p[f"short.{n}.b1"], p[f"short.{n}.w2"],
                                p[f"short.{n}.b2"])
    return out + torch.cat([p["user_emb"][u], p["cate_emb"][c]], dim=1), rows


def loss(p, b, cate_list, m):
    u, rows = user_repr(p, b, cate_list, m)
    i = b["i"].long()
    logits = torch.sum(u * rows[i], dim=-1) + p["item_b"][i]
    return sigmoid_ce(logits, b["y"]) + m["regulation_rate"] * l2(
        *(p[n] for n in L2_TABLES))


def scores(p, b, cate_list, m):
    """[B, items] logits of every catalog item."""
    u, rows = user_repr(p, b, cate_list, m)
    return u @ rows.T + p["item_b"]
