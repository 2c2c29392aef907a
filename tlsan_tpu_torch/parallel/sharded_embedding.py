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
