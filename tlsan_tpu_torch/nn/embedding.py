"""Embedding lookups.

The JAX package's gather strategies (the one-hot matmul backward, the
vocab-sharded mesh gather, the vocab threshold between a fused and a
per-table item⊕cate gather) are TPU mechanisms; the port owes their values,
not their mechanism.  A row gather is exact on every device, and its
gradient, a scatter-add into the table, comes from plain autograd.  So the
port has one path, the one the JAX package takes at the reference catalogs
(items ≤ 24,576, `tlsan_tpu/nn/embedding.py:180-185`): the fused item⊕cate
table, built once per forward and shared by every gather of it and by the
catalog product.  Its gradient reaches ``item_emb`` through the concat and
``cate_emb`` through the ``cate_list`` gather; it differs from the JAX
per-table branch only by f32 summation order.
"""

from __future__ import annotations

import torch


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows of an embedding table ([V, D] or [V] bias) at integer
    (int32 or int64) ids."""
    return table[ids]


def item_cate_table(item_emb: torch.Tensor, cate_emb: torch.Tensor,
                    cate_list: torch.Tensor) -> torch.Tensor:
    """The fused item⊕cate table [V, Di+Dc]: row v is ``concat(item_emb[v],
    cate_emb[cate_list[v]])`` (reference: TLSAN/model.py:84-87, :140)."""
    return torch.cat([item_emb, lookup(cate_emb, cate_list)], dim=-1)


def item_cate_lookup(item_emb: torch.Tensor, cate_emb: torch.Tensor,
                     ids: torch.Tensor, cate_list: torch.Tensor) -> torch.Tensor:
    """item⊕cate embedding of an id tensor: rows of `item_cate_table` at
    `ids`.  Gather and concat commute exactly, so this equals the JAX
    package's lookup on either of its branches, bit for bit."""
    return lookup(item_cate_table(item_emb, cate_emb, cate_list), ids)
