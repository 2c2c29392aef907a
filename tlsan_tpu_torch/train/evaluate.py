"""Evaluation: pairwise AUC and P@k/R@k over the full catalog.

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

Under a (dp, mp) mesh (ported from tlsan_tpu/train/evaluate.py:31-41,
:73-112, :142-152) each rank evaluates its dp share of every test batch's
rows; with vocab-sharded tables the top-k goes through
parallel/topk.py; the win, hit and user counts are summed over dp, so
every rank reads the metrics of the whole test set.

The replica fan-out (train/ensemble.py) evaluates R replicas at once:
`make_replica_auc_fn` runs the AUC pass's body under ``torch.func.vmap``
over parameters stacked on a leading replica axis, the test data shared.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tlsan_tpu_torch.data.batcher import Batches, pad_to_multiple
from tlsan_tpu_torch.nn.embedding import current_batch_mesh, mesh_context
from tlsan_tpu_torch.parallel.api import shard_batch
from tlsan_tpu_torch.parallel.mesh import Mesh, all_reduce
from tlsan_tpu_torch.parallel.topk import sharded_topk_scores
from tlsan_tpu_torch.train.sparse import call_with

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


def _sum_over_dp(x: torch.Tensor) -> torch.Tensor:
    """Counts of this rank's rows made counts of the whole set."""
    mesh = current_batch_mesh()
    return x if mesh is None else all_reduce(x, mesh.dp_group)


def _auc_counts(pos, neg, batch) -> torch.Tensor:
    """(wins, users) of one batch: valid users whose positive outscores
    the negative, and valid users."""
    v = batch["valid"].float()
    wins = ((pos - neg) > 0).float()
    return torch.stack([torch.sum(wins * v), torch.sum(v)])


def make_auc_fn(cate_list):
    """Returns auc(model, data) → the AUC over valid users, a 0-d tensor
    (batch AUCs weighted by batch size, TLSAN/train.py:86-96)."""

    @torch.no_grad()
    def auc(model, data: Data) -> torch.Tensor:
        counts = 0.0  # (wins, users)
        for batch in _batches(data):
            counts = counts + _auc_counts(*model.pair_logits(batch, cate_list),
                                          batch)
        wins_sum, n = _sum_over_dp(counts)
        return wins_sum / torch.clamp_min(n, 1.0)

    return auc


def make_replica_auc_fn(model, cate_list):
    """Returns auc(params, data) → [R] AUCs of R replicas of `model`, whose
    parameters `params` (by name) are stacked on a leading replica axis:
    `make_auc_fn`'s pass with its body under ``torch.func.vmap`` over the
    parameters, the test data shared (one device)."""

    def counts(params, batch):
        return _auc_counts(*call_with(model, "pair_logits", params, batch,
                                      cate_list), batch)

    replica_counts = torch.func.vmap(counts, in_dims=(0, None))

    @torch.no_grad()
    def auc(params, data: Data) -> torch.Tensor:
        total = 0.0  # [R, (wins, users)]
        for batch in _batches(data):
            total = total + replica_counts(params, batch)
        return total[:, 0] / torch.clamp_min(total[:, 1], 1.0)

    return auc


def make_topk_fn(cfg, cate_list):
    """Returns topk(model, data) → (P@k, R@k) tensors over k in TOPK_KS.

    Per batch: full-catalog logits [B, I], catalog rows at or past
    `cfg.catalog_items` masked to −inf, the top-50 indices, the rank of the
    positive label (50 when absent), hits@k accumulated over valid rows.
    Under a vocab-sharded mesh the scores and the top-50 come from
    `sharded_topk_scores`."""
    max_k = max(TOPK_KS)

    def top_indices(model, batch):
        mesh = current_batch_mesh()
        if mesh is not None and mesh.mp > 1:
            all_emb, all_b = model.all_item_repr(cate_list)
            return sharded_topk_scores(
                mesh, model.user_repr(batch, cate_list), all_emb, all_b,
                min(max_k, all_emb.shape[0] * mesh.mp),
                cfg.catalog_items or None)[1]
        logits = model.eval_logits(batch, cate_list)
        V = logits.shape[1]
        if cfg.catalog_items and cfg.catalog_items < V:
            logits[:, cfg.catalog_items:] = -torch.inf
        # catalogs smaller than 50 (tiny tests) clamp k
        return torch.topk(logits, min(max_k, V), dim=1).indices

    @torch.no_grad()
    def topk(model, data: Data) -> Tuple[torch.Tensor, torch.Tensor]:
        counts = 0.0  # (hits@k for k in TOPK_KS, users)
        # made once a call: a host-to-device copy waits for the stream
        ks = torch.tensor(TOPK_KS, device=next(iter(data.values())).device)
        for batch in _batches(data):
            top_idx = top_indices(model, batch)
            match = top_idx == batch["i"][:, None].long()
            rank = torch.where(match.any(dim=1), match.int().argmax(dim=1),
                               max_k)
            v = batch["valid"].float()
            hits = torch.sum((rank[:, None] < ks).float() * v[:, None], dim=0)
            counts = counts + torch.cat([hits, torch.sum(v)[None]])
        counts = _sum_over_dp(counts)
        recall = counts[:-1] / torch.clamp_min(counts[-1], 1.0)
        return recall / ks, recall

    return topk


class Evaluator:
    """Holds the device-resident padded test set and the eval functions;
    `auc(model)` and `topk(model)` evaluate the model's current weights.
    With a `mesh` it holds this rank's dp share of every batch, and every
    rank must evaluate (the counts are summed over dp)."""

    def __init__(self, cfg, cate_list: torch.Tensor, test_batches: Batches,
                 batch_size: int, device, mesh: Optional[Mesh] = None):
        self.data, self.n_batches = device_data(test_batches, batch_size,
                                                device)
        if mesh is not None:
            self.data = shard_batch(self.data, mesh, axis=1)
        self.mesh = mesh
        self._auc = make_auc_fn(cate_list)
        self._topk = make_topk_fn(cfg, cate_list)

    def auc(self, model) -> float:
        with mesh_context(self.mesh):
            return float(self._auc(model, self.data))

    def topk(self, model) -> Dict[str, float]:
        with mesh_context(self.mesh):
            prec, recall = self._topk(model, self.data)
        prec, recall = prec.cpu().tolist(), recall.cpu().tolist()
        out = {}
        for i, k in enumerate(TOPK_KS):
            out[f"P@{k}"] = float(prec[i])
            out[f"R@{k}"] = float(recall[i])
        return out
