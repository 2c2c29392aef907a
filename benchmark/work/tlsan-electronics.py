"""Operations and bytes of TLSAN's kernels and step, counted from the
batch's valid lengths, so a kernel that skips padding still reads at most
its roofline.

Units: f32 operations (a multiply-add is two) and HBM bytes, each input
read once and each output written once, of valid steps only.

  - K1, feature-wise attention forward over x [B, S, D] (S = Ls for the
    long tower with length sl, S = Ts + 1 for the short one with length
    sl_new + 1, valid v = min(length, S)): 4·dh + 9 operations a valid
    (step, feature) (two dh-wide maps, bias, relu, mask, exp, sum, divide,
    weighted sum); bytes of the valid x, the lengths, W1, b1, W2, b2 and
    the output [B, D];
  - K2, its backward: 12·dh + 18 operations a valid (step, feature) (the
    forward again, dm1, dx and the two weight gradients at 2·dh each, the
    softmax backward); bytes of the valid x and dx, g [B, D], the lengths,
    the weights read and their gradients written;
  - the step: the forward (gathers and scaling, both towers, the dense
    map, the user row, logits, loss, the tables' L2), the backward at
    twice the forward, and clipped SGD at 6 operations a parameter (the
    global norm's square and sum, the scale, the update);
  - a served batch: the forward without loss, the catalog product
    [B, D] × [D, items] and its bias.
"""

from typing import Dict, List, Tuple

import numpy as np

F32 = 4


def _widths(config):
    m = config["model"]
    D, H = m["hidden_units"], m["num_heads"]
    return D, D // H, m["Ls"], m["Ts"] + 1


def _valid(lengths, S):
    return np.minimum(np.asarray(lengths, np.int64), S)


def _fwa(v, B, D, dh, backward: bool) -> Tuple[float, float]:
    weights = 2 * dh * dh + 2 * dh
    if backward:
        ops = float(v.sum()) * D * (12 * dh + 18)
        nbytes = F32 * (2 * float(v.sum()) * D + B * D + B + 2 * weights)
    else:
        ops = float(v.sum()) * D * (4 * dh + 9)
        nbytes = F32 * (float(v.sum()) * D + B + weights + B * D)
    return nbytes, ops


def unit_kernels(lengths: Dict[str, np.ndarray], config: dict,
                 train: bool) -> Dict[str, List[Tuple[float, float]]]:
    """(bytes, operations) of each kernel call of one step (train) or one
    served batch, by kernel family."""
    D, dh, Ls, S = _widths(config)
    long_v, short_v = _valid(lengths["sl"], Ls), _valid(np.asarray(lengths["sl_new"]) + 1, S)
    B = len(long_v)
    out = {"fwa_fwd": [_fwa(long_v, B, D, dh, False), _fwa(short_v, B, D, dh, False)]}
    if train:
        out["fwa_bwd"] = [_fwa(long_v, B, D, dh, True), _fwa(short_v, B, D, dh, True)]
    return out


def n_params(config: dict) -> int:
    m, cat = config["model"], config["catalog"]
    D, dh = m["hidden_units"], m["hidden_units"] // m["num_heads"]
    tables = (cat["items"] * (m["itemid_embedding_size"] + 1)
              + cat["users"] * (m["userid_embedding_size"] + m["Ls"])
              + cat["cates"] * m["cateid_embedding_size"])
    blocks = m["num_blocks"] * (2 * (2 * dh * dh + 2 * dh) + D * D + D)
    return 1 + tables + blocks


def unit_flops(lengths: Dict[str, np.ndarray], config: dict, train: bool) -> float:
    """Operations of one train step, or of one served batch."""
    D, dh, Ls, S = _widths(config)
    m, cat = config["model"], config["catalog"]
    long_v, short_v = _valid(lengths["sl"], Ls), _valid(np.asarray(lengths["sl_new"]) + 1, S)
    B = len(long_v)
    fwd = (3 * float(long_v.sum()) * D                       # the time weights
           + float((long_v.sum() + short_v.sum()) * D * (4 * dh + 9))
           + B * (2 * D * D + D)                              # the dense map
           + B * D)                                           # + the user row
    if not train:
        return fwd + 2.0 * B * D * cat["items"] + B * cat["items"]
    tables = (cat["items"] * m["itemid_embedding_size"]
              + cat["users"] * (m["userid_embedding_size"] + m["Ls"])
              + cat["cates"] * m["cateid_embedding_size"])
    fwd += B * (2 * D + 1) + 10 * B + 2 * tables               # logits, loss, L2
    return 3 * fwd + 6 * n_params(config)
