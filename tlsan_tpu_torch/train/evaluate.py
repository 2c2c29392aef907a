"""Evaluation: pairwise AUC and P@k/R@k over the full catalog, one device.

Ported from tlsan_tpu/train/evaluate.py, keeping its two departures from
the reference:
  - AUC runs ONE forward pass per batch (the reference runs two sess.runs
    that recompute the identical user tower — TLSAN/model.py:239-261);
  - P@k/R@k counters reset at the start of every evaluation (the reference's
    streaming tf.metrics counters accumulate across the whole run —
    TLSAN/train.py:75-76; documented deviation).

P@k with a single relevant label equals hit/k and R@k equals hit, matching
tf.metrics.precision_at_k / recall_at_k with one label id
(reference: TLSAN/model.py:142-156).  The padded test set lives on the
device as [n_batches, B, ...] tensors; a Python loop over its batches
replaces the JAX lax.scan, and the sums stay on the device until the one
read at the end.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tlsan_tpu_torch.data.batcher import Batches, pad_to_multiple

TOPK_KS = (1, 10, 20, 30, 40, 50)

Data = Dict[str, torch.Tensor]


def device_data(batches: Batches, batch_size: int, device) -> Tuple[Data, int]:
    """The test set padded to whole batches, as [n_batches, B, ...] tensors
    on `device`, with its `valid` mask."""
    padded = pad_to_multiple(batches, batch_size)
    n_batches = padded.n // batch_size
    data = {k: torch.from_numpy(v.reshape((n_batches, batch_size) + v.shape[1:]))
            .to(device) for k, v in padded.arrays.items()}
    return data, n_batches


def _batches(data: Data):
    n_batches = len(next(iter(data.values())))
    for b in range(n_batches):
        yield {k: v[b] for k, v in data.items()}


def make_auc_fn(cate_list):
    """Returns auc(model, data) → the AUC over valid users, a 0-d tensor
    (batch AUCs weighted by batch size, TLSAN/train.py:86-96)."""

    @torch.no_grad()
    def auc(model, data: Data) -> torch.Tensor:
        wins_sum = n = 0.0
        for batch in _batches(data):
            pos, neg = model.pair_logits(batch, cate_list)
            v = batch["valid"].float()
            wins = ((pos - neg) > 0).float()
            wins_sum = wins_sum + torch.sum(wins * v)
            n = n + torch.sum(v)
        return wins_sum / torch.clamp_min(torch.as_tensor(n), 1.0)

    return auc


def make_topk_fn(cfg, cate_list):
    """Returns topk(model, data) → (P@k, R@k) tensors over k in TOPK_KS.

    Per batch: full-catalog logits [B, I], catalog rows at or past
    `cfg.catalog_items` masked to −inf, the top-50 indices, the rank of the
    positive label (50 when absent), hits@k accumulated over valid rows."""
    max_k = max(TOPK_KS)

    @torch.no_grad()
    def topk(model, data: Data) -> Tuple[torch.Tensor, torch.Tensor]:
        hits_sum = n = None
        # made once a call: a host-to-device copy waits for the stream
        ks = torch.tensor(TOPK_KS, device=next(iter(data.values())).device)
        for batch in _batches(data):
            logits = model.eval_logits(batch, cate_list)
            V = logits.shape[1]
            if cfg.catalog_items and cfg.catalog_items < V:
                logits[:, cfg.catalog_items:] = -torch.inf
            # catalogs smaller than 50 (tiny tests) clamp k
            top_idx = torch.topk(logits, min(max_k, V), dim=1).indices
            match = top_idx == batch["i"][:, None].long()
            rank = torch.where(match.any(dim=1), match.int().argmax(dim=1),
                               max_k)
            v = batch["valid"].float()
            hits = torch.sum((rank[:, None] < ks).float() * v[:, None], dim=0)
            hits_sum = hits if hits_sum is None else hits_sum + hits
            n = torch.sum(v) if n is None else n + torch.sum(v)
        recall = hits_sum / torch.clamp_min(n, 1.0)
        return recall / ks, recall

    return topk


class Evaluator:
    """Holds the device-resident padded test set and the eval functions;
    `auc(model)` and `topk(model)` evaluate the model's current weights."""

    def __init__(self, cfg, cate_list: torch.Tensor, test_batches: Batches,
                 batch_size: int, device):
        self.data, self.n_batches = device_data(test_batches, batch_size,
                                                device)
        self._auc = make_auc_fn(cate_list)
        self._topk = make_topk_fn(cfg, cate_list)

    def auc(self, model) -> float:
        return float(self._auc(model, self.data))

    def topk(self, model) -> Dict[str, float]:
        prec, recall = self._topk(model, self.data)
        prec, recall = prec.cpu().tolist(), recall.cpu().tolist()
        out = {}
        for i, k in enumerate(TOPK_KS):
            out[f"P@{k}"] = float(prec[i])
            out[f"R@{k}"] = float(recall[i])
        return out
