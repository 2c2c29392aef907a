"""Operations and bytes of ATRank's kernels and step, counted from the
batch's valid lengths (sl of T = 96), so a kernel that skips padding still
reads at most its roofline.

Units: f32 operations (a multiply-add is two) and HBM bytes, each input
read once and each output written once, of valid rows only.

  - K3, multi-head attention forward of tq valid query rows over tk valid
    keys: the three projections, (tq + 2·tk)·D² multiply-adds, the scores
    and the weighted sum, 2·tq·tk·D; bytes of the valid queries (and keys
    where they differ), the two lengths, the weights (3·D² + 5·D) and the
    valid output rows.  Self-attention has tq = tk = sl, the readout
    tq = 1 over tk = sl;
  - K3b, its backward: three times the forward's operations; bytes of the
    valid queries (keys), the output's gradient, the two lengths, the
    queries' and keys' gradients and the weights read and written;
  - the step: the forward (the time layer on valid rows, both attentions,
    both feed-forward blocks, logits, loss, L2), the backward at twice the
    forward, clipped SGD at 6 operations a parameter;
  - a served batch: the forward without loss, the catalog product and its
    bias.
"""

from typing import Dict, List, Tuple

import numpy as np

F32 = 4
BUCKETS = 12


def _mha(tq, tk, D, self_attention: bool, backward: bool) -> Tuple[float, float]:
    tq, tk = np.asarray(tq, np.float64), np.asarray(tk, np.float64)
    B = len(tk)
    ops = float(np.sum(2 * ((tq + 2 * tk) * D * D + 2 * tq * tk * D)))
    weights = 3 * D * D + 5 * D
    keys = 0.0 if self_attention else float(tk.sum()) * D
    if backward:
        nbytes = F32 * (2 * float(tq.sum()) * D + keys + 2 * B + float(tq.sum()) * D
                        + float(tk.sum()) * D + 2 * weights)
        return nbytes, 3 * ops
    return F32 * (float(tq.sum()) * D + keys + 2 * B + weights + float(tq.sum()) * D), ops


def _valid(config, lengths):
    return np.minimum(np.asarray(lengths["sl"], np.int64), config["model"]["max_length"])


def unit_kernels(lengths: Dict[str, np.ndarray], config: dict,
                 train: bool) -> Dict[str, List[Tuple[float, float]]]:
    """(bytes, operations) of each kernel call of one step (train) or one
    served batch, by kernel family."""
    D = config["model"]["hidden_units"]
    v = _valid(config, lengths)
    ones = np.ones_like(v)
    out = {"mha_fwd": [_mha(v, v, D, True, False), _mha(ones, v, D, False, False)]}
    if train:
        out["mha_bwd"] = [_mha(v, v, D, True, True), _mha(ones, v, D, False, True)]
    return out


def n_params(config: dict) -> int:
    m, cat = config["model"], config["catalog"]
    D, Di, Dc = m["hidden_units"], m["itemid_embedding_size"], m["cateid_embedding_size"]
    block = 3 * D * D + 5 * D + 2 * D * (D // 4) + D // 4 + 3 * D
    return (cat["items"] * (Di + 1) + cat["cates"] * Dc + (Di + Dc + BUCKETS) * D + D
            + 2 * m["num_blocks"] * block)


def unit_flops(lengths: Dict[str, np.ndarray], config: dict, train: bool) -> float:
    """Operations of one train step, or of one served batch."""
    m, cat = config["model"], config["catalog"]
    D, Di, Dc = m["hidden_units"], m["itemid_embedding_size"], m["cateid_embedding_size"]
    v = _valid(config, lengths).astype(np.float64)
    B = len(v)
    ones = np.ones_like(v)
    ffn = 2 * 2 * D * (D // 4) + 10 * D                      # two maps, residual, LayerNorm
    fwd = (float(v.sum()) * 2 * (Di + Dc + BUCKETS) * D       # the time layer
           + _mha(v, v, D, True, False)[1] + _mha(ones, v, D, False, False)[1]
           + 8 * D * float(v.sum() + B)                        # softmax, residual, LayerNorm
           + ffn * float(v.sum() + B))
    if not train:
        return fwd + 2.0 * B * D * cat["items"] + B * cat["items"]
    fwd += B * (2 * D + 1) + 10 * B + 4 * B * D                # logits, loss, L2
    return 3 * fwd + 6 * n_params(config)
