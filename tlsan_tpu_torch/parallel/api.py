"""Place a model and its batches on a (dp, mp) mesh.

Ported from tlsan_tpu/parallel/api.py.  Vocab sizes are padded up to a
multiple of mp so every rank holds an equal row range; the weights are
drawn (or restored) at the true shapes first, zero-padded, then sliced, so
a mesh run starts from the single-process weights, and checkpoints are
written unpadded, so they restore under any (dp, mp).  Pad rows start at
zero, stay zero under SGD with L2 (they get no gradient), and never rank
(`catalog_items`).

State dicts here are flat ``{dotted name: tensor}`` maps, as
``nn.Module.state_dict`` gives them; a table is matched by the last part of
its name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    is_vocab_sharded,
    shard_rows,
)
from tlsan_tpu_torch.parallel.multihost import local_batch_slice

Counts = Tuple[int, int, int]  # (users, items, cates)
State = Dict[str, torch.Tensor]


def pad_config_for_mp(cfg: ModelConfig, mp: int) -> ModelConfig:
    """Round the vocab sizes up to multiples of mp; record the true item
    count in `catalog_items` for the catalog mask."""
    if mp <= 1:
        return cfg
    up = lambda n: ((n + mp - 1) // mp) * mp  # noqa: E731
    return dataclasses.replace(
        cfg,
        catalog_items=cfg.catalog_items or cfg.item_count,
        item_count=up(cfg.item_count),
        user_count=up(cfg.user_count),
        cate_count=up(cfg.cate_count),
    )


def pad_cate_list(cate_list, cfg: ModelConfig) -> np.ndarray:
    """The item→cate map extended to the padded item count (pad rows map to
    category 0)."""
    cate_list = np.asarray(cate_list)
    n = cfg.item_count - len(cate_list)
    if n <= 0:
        return cate_list
    return np.concatenate([cate_list, np.zeros(n, dtype=cate_list.dtype)])


def counts(cfg: ModelConfig) -> Counts:
    return cfg.user_count, cfg.item_count, cfg.cate_count


def vocab_rows(counts_: Counts) -> Dict[str, int]:
    """Rows of each vocab table, by its name, at these counts."""
    u, i, c = counts_
    return {"item_emb": i, "item_b": i, "user_emb": u, "usert_emb": u,
            "cate_emb": c, "short_w": i, "long_w": u}


def pad_vocab_rows(state: State, counts_true: Counts,
                   counts_padded: Counts) -> State:
    """Zero-pad the vocab rows of every table from its true count to the
    padded one; other entries pass through."""
    true_of, pad_of = vocab_rows(counts_true), vocab_rows(counts_padded)
    out = {}
    for name, t in state.items():
        leaf = name.split(".")[-1]
        if leaf in true_of and t.dim() >= 1 and t.shape[0] == true_of[leaf] \
                and pad_of[leaf] > true_of[leaf]:
            pad = t.new_zeros((pad_of[leaf] - true_of[leaf],) + tuple(t.shape[1:]))
            t = torch.cat([t, pad])
        out[name] = t
    return out


def unpad_vocab_rows(state: State, counts_true: Counts) -> State:
    """The inverse of `pad_vocab_rows`: every table cut back to its true
    rows, the canonical form of a checkpoint."""
    true_of = vocab_rows(counts_true)
    out = {}
    for name, t in state.items():
        leaf = name.split(".")[-1]
        if leaf in true_of and t.dim() >= 1 and t.shape[0] > true_of[leaf]:
            t = t[:true_of[leaf]]
        out[name] = t
    return out


def shard_train_state(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's row range of every vocab table (in place); dense
    weights stay replicated.  An optimizer's slots are made from the
    placed parameters, or placed by `place_named`.  Returns `model`."""
    if mesh.mp > 1:
        for name, p in model.named_parameters():
            if is_vocab_sharded(name):
                p.data = p.data[shard_rows(p.shape[0], mesh)].clone()
    return model


def shard_model(model: nn.Module, mesh: Mesh, device) -> nn.Module:
    """A copy of `model` (true vocab sizes, any device) placed on the mesh:
    its config padded for mp, its tables zero-padded and cut to this
    rank's rows, on `device`."""
    cfg = pad_config_for_mp(model.cfg, mesh.mp)
    state = pad_vocab_rows({k: v.detach().cpu() for k, v in
                            model.state_dict().items()},
                           counts(model.cfg), counts(cfg))
    placed = type(model)(cfg, "cpu")
    placed.load_state_dict(state)
    return shard_train_state(placed, mesh).to(device)


def gather_state(model: nn.Module, mesh: Mesh, counts_true: Counts) -> State:
    """The whole, unpadded state of a mesh-placed model, on the CPU, on
    every rank (collective: every rank calls it)."""
    return gather_named(model.state_dict(), mesh, counts_true)


def gather_named(state: State, mesh: Mesh, counts_true: Counts) -> State:
    """A mesh-placed flat state (a model's, or an optimizer slot's by
    parameter name) whole and unpadded, on the CPU, on every rank
    (collective)."""
    out = {}
    for name, t in state.items():
        if mesh.mp > 1 and is_vocab_sharded(name):
            t = gather_rows(t, mesh)
        out[name] = t.detach().to("cpu", copy=True)  # never the live tensor
    return unpad_vocab_rows(out, counts_true)


def place_named(state: State, mesh: Mesh, counts_true: Counts,
                counts_padded: Counts, device) -> State:
    """The inverse of `gather_named`: a whole, unpadded flat state padded
    for mp and cut to this rank's rows, on `device`."""
    out = {}
    for name, t in pad_vocab_rows(state, counts_true, counts_padded).items():
        if mesh.mp > 1 and is_vocab_sharded(name):
            t = t[shard_rows(t.shape[0], mesh)]
        out[name] = t.to(device, copy=True)
    return out


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh,
                axis: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's dp rows of a global batch, along `axis` (1 for the
    [K, B, ...] chunks and [n_batches, B, ...] sets)."""
    rows = local_batch_slice(batch[next(iter(batch))].shape[axis], mesh)
    index = (slice(None),) * axis + (rows,)
    return {k: v[index].contiguous() for k, v in batch.items()}
