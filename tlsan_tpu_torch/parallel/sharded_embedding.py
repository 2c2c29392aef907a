"""Row-sharded embedding tables with an explicit exchange.

Ported from tlsan_tpu/parallel/sharded_embedding.py (reference:
TLSAN/model.py:84-113 `tf.nn.embedding_lookup`).  Each mp rank holds a
contiguous row range of a table; a lookup gathers the rows it holds, zeros
the rest, and sums over the mp group: each id lives on exactly one rank, so
the sum is an exchange and exact.  The mp ranks of one dp index look up
the same ids, so each holds the whole cotangent of the result; the
backward is therefore the local masked scatter-add of that cotangent, with
no collective (an all_reduce of the cotangent, which
``torch.distributed.nn.functional.all_reduce`` would do, gives mp× the
table gradient).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tlsan_tpu_torch.parallel.mesh import Mesh


class ShardedLookup(torch.autograd.Function):
    """rows = table[ids] for a table row-sharded over mp; `shard` is this
    rank's rows, `ids` global ids (the same on every mp rank)."""

    @staticmethod
    def forward(ctx, shard, ids, mesh: Mesh):
        vloc = shard.shape[0]
        local = ids.long() - mesh.m * vloc
        inrange = (local >= 0) & (local < vloc)
        safe = local.clamp(0, vloc - 1)
        keep = inrange.reshape(inrange.shape + (1,) * (shard.dim() - 1))
        rows = torch.where(keep, shard[safe], 0.0)
        if mesh.mp > 1:
            dist.all_reduce(rows, group=mesh.mp_group)
        ctx.save_for_backward(safe, keep)
        ctx.shard_shape = shard.shape
        return rows

    @staticmethod
    def backward(ctx, g):
        safe, keep = ctx.saved_tensors
        grad = g.new_zeros(ctx.shard_shape).index_put_(
            (safe,), torch.where(keep, g, 0.0), accumulate=True)
        return grad, None, None


def sharded_lookup(mesh: Mesh, table: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup on a vocab-sharded table: `table` is this rank's
    row shard ([V/mp, D], or [V/mp] for biases), `ids` this dp shard's
    global ids [...]; returns the rows [..., D]."""
    return ShardedLookup.apply(table, ids, mesh)


# ------------------------------------------------ the sparse step's rows
# The touched-row step (train/sparse.py) gathers whole row blocks by a
# replicated, sorted, sentinel-padded id buffer, runs the model on them,
# and writes the update back row by row.  A sentinel id (the vocab size)
# reads as zeros and is never written.  Without a mesh (or with mp = 1)
# `table` is the whole table; under a vocab-sharded mesh it is this
# rank's row shard and `ids` are global and the same on every rank.


def _local_ids(ids: torch.Tensor, vloc: int, offset: int):
    """(safe, ok): ids shifted into the local row range and clamped into
    it (an index out of range is a device assert on CUDA), and whether
    each id lies in the range."""
    local = ids.long() - offset
    ok = (local >= 0) & (local < vloc)
    return local.clamp(0, vloc - 1), ok


def _rows_mask(ok: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return ok.reshape(ok.shape + (1,) * (table.dim() - 1))


def row_gather(table: torch.Tensor, ids: torch.Tensor,
               mesh: Mesh = None) -> torch.Tensor:
    """table[ids] with zero rows for ids outside the table (no gradient):
    a masked local gather, summed over the mp group under a vocab-sharded
    `mesh`, so every rank gets the whole rows."""
    vloc = table.shape[0]
    offset = 0 if mesh is None else mesh.m * vloc
    safe, ok = _local_ids(ids, vloc, offset)
    rows = torch.where(_rows_mask(ok, table), table.detach()[safe], 0.0)
    if mesh is not None and mesh.mp > 1:
        dist.all_reduce(rows, group=mesh.mp_group)
    return rows


@torch.no_grad()
def row_scatter_add_(table: torch.Tensor, ids: torch.Tensor,
                     delta: torch.Tensor, mesh: Mesh = None) -> None:
    """table[ids] += delta in place, for the ids in this rank's row range
    (all of them without a vocab-sharded `mesh`); the rest, sentinels
    included, are dropped.  `ids` are unique but for the sentinels, whose
    zeroed deltas land on a row as + 0, so the result is deterministic."""
    vloc = table.shape[0]
    offset = 0 if mesh is None else mesh.m * vloc
    safe, ok = _local_ids(ids, vloc, offset)
    table.index_add_(0, safe, torch.where(_rows_mask(ok, delta), delta, 0.0))


class GatherWhole(torch.autograd.Function):
    """The whole table of which `shard` is this rank's mp row shard; its
    backward hands this rank its rows of the gradient.  The mp ranks of a
    dp index run the same forward on the same rows, so each holds the
    whole gradient, and no collective is needed (as `ShardedLookup`)."""

    @staticmethod
    def forward(ctx, shard, mesh: Mesh):
        ctx.rows = slice(mesh.m * shard.shape[0], (mesh.m + 1) * shard.shape[0])
        full = shard.new_zeros((mesh.mp * shard.shape[0],) + tuple(shard.shape[1:]))
        full[ctx.rows] = shard.detach()
        dist.all_reduce(full, group=mesh.mp_group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None


def gather_whole(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A vocab-sharded table whole on every mp rank, differentiably."""
    return GatherWhole.apply(shard, mesh)
