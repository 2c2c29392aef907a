"""Embedding lookups, on one device or a (dp, mp) mesh.

The JAX package's gather strategies (the one-hot matmul backward, the
vocab threshold between a fused and a per-table item⊕cate gather) are TPU
mechanisms; the port owes their values, not their mechanism.  A row gather
is exact on every device, and its gradient, a scatter-add into the table,
comes from plain autograd.  So on one device the port has one path, the
one the JAX package takes at the reference catalogs (items ≤ 24,576,
`tlsan_tpu/nn/embedding.py:180-185`): the fused item⊕cate table, built once
per forward and shared by every gather of it and by the catalog product.
Its gradient reaches ``item_emb`` through the concat and ``cate_emb``
through the ``cate_list`` gather; it differs from the JAX per-table branch
only by f32 summation order.

Under a mesh (`mesh_context`, ported from `tlsan_tpu/nn/embedding.py:22-49`)
with vocab-sharded tables (mp > 1), `lookup` is the sharded lookup over
the mp group (parallel/sharded_embedding.py), and the item⊕cate rows take
the per-site form, as the JAX package does at `:180`: building the fused
table would need the cate rows of every item of the shard through the
exchange.  The catalog's own rows (`item_cate_rows`) are the one place that
needs them: there the small cate table is gathered whole instead.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from tlsan_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from tlsan_tpu_torch.parallel.sharded_embedding import sharded_lookup

_state = threading.local()


@contextmanager
def mesh_context(mesh: Optional[Mesh]):
    """Declare the mesh the enclosed forwards run on (None: one device).
    With mp > 1 the vocab lookups run the sharded lookup; with dp > 1 the
    losses and metrics sum over the dp group."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def current_batch_mesh() -> Optional[Mesh]:
    """The active mesh, whatever its shape (None on one device)."""
    return getattr(_state, "mesh", None)


def current_mesh() -> Optional[Mesh]:
    """The active mesh when its vocab tables are sharded (mp > 1)."""
    mesh = current_batch_mesh()
    return mesh if mesh is not None and mesh.mp > 1 else None


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows of an embedding table ([V, D] or [V] bias) at integer
    (int32 or int64) ids; under a vocab-sharded mesh `table` is this rank's
    row shard and the ids are global."""
    mesh = current_mesh()
    if mesh is not None:
        return sharded_lookup(mesh, table, ids)
    return table[ids]


def item_cate_table(item_emb: torch.Tensor, cate_emb: torch.Tensor,
                    cate_list: torch.Tensor) -> torch.Tensor:
    """The fused item⊕cate table [V, Di+Dc]: row v is ``concat(item_emb[v],
    cate_emb[cate_list[v]])`` (reference: TLSAN/model.py:84-87, :140)."""
    return torch.cat([item_emb, lookup(cate_emb, cate_list)], dim=-1)


def item_cate_lookup(item_emb: torch.Tensor, cate_emb: torch.Tensor,
                     ids: torch.Tensor, cate_list: torch.Tensor) -> torch.Tensor:
    """item⊕cate embedding of an id tensor: rows of `item_cate_table` at
    `ids` on one device; the per-site form (item rows, then cate rows,
    each a sharded lookup) under a vocab-sharded mesh.  Gather and concat
    commute exactly, so both equal the JAX package's lookup on either of
    its branches, bit for bit."""
    if current_mesh() is not None:
        return torch.cat([lookup(item_emb, ids),
                          lookup(cate_emb, cate_list[ids.long()])], dim=-1)
    return lookup(item_cate_table(item_emb, cate_emb, cate_list), ids)


def item_cate_rows(item_emb: torch.Tensor, cate_emb: torch.Tensor,
                   cate_list: torch.Tensor) -> torch.Tensor:
    """The catalog's item⊕cate rows: `item_cate_table` on one device; under
    a vocab-sharded mesh this rank's rows of it, with the cate table
    gathered whole (C rows, not the items' V).  No gradient reaches
    `cate_emb` through that gather: scoring and serving use it, the losses
    use `ItemCate`."""
    mesh = current_mesh()
    if mesh is None:
        return item_cate_table(item_emb, cate_emb, cate_list)
    cates = gather_rows(cate_emb, mesh)
    local = cate_list[shard_rows(len(cate_list), mesh)].long()
    return torch.cat([item_emb, cates[local]], dim=-1)


class ItemCate:
    """The item⊕cate rows of one forward: called on ids, it gives their
    rows.  On one device the fused table (`table`) is built once and every
    site gathers from it; under a vocab-sharded mesh each site takes the
    per-site form and `table` is None."""

    def __init__(self, item_emb: torch.Tensor, cate_emb: torch.Tensor,
                 cate_list: torch.Tensor):
        self.item_emb, self.cate_emb, self.cate_list = item_emb, cate_emb, cate_list
        self.table = (None if current_mesh() is not None
                      else item_cate_table(item_emb, cate_emb, cate_list))

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        if self.table is None:
            return item_cate_lookup(self.item_emb, self.cate_emb, ids,
                                    self.cate_list)
        return lookup(self.table, ids)
