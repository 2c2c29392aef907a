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
`mesh_context(mesh, vocab_is_sharded=False)` keeps the mesh for the batch
(the dp sums of losses and metrics) with plain lookups: the sparse step
runs the model on row blocks gathered whole (train/sparse.py).

The backward of a gather is chosen by `gather_bwd(mode)` (ported from
`tlsan_tpu/nn/embedding.py:70-132`): ``take``, torch's index backward (a
scatter-add); ``onehot``, ``one_hot(ids, V)ᵀ @ ct`` accumulated in f32 and
cast to the table's dtype (`OneHotGather`), for a [V, D] table; ``auto``
(the default) engages the one-hot product only where the JAX package's
``_accel()`` is true, on a TPU, so on the card and on the CPU ``auto`` is
``take``: no H100 crossover of the two has been measured.  The forward is
the same row gather in every mode.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from tlsan_tpu_torch.core import spans
from tlsan_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from tlsan_tpu_torch.parallel.sharded_embedding import sharded_lookup

_state = threading.local()


@contextmanager
def mesh_context(mesh: Optional[Mesh], vocab_is_sharded: bool = True):
    """Declare the mesh the enclosed forwards run on (None: one device).
    With mp > 1 and `vocab_is_sharded` the vocab lookups run the sharded
    lookup; with dp > 1 the losses and metrics sum over the dp group."""
    prev = getattr(_state, "ctx", (None, False))
    _state.ctx = (mesh, vocab_is_sharded)
    try:
        yield
    finally:
        _state.ctx = prev


def current_batch_mesh() -> Optional[Mesh]:
    """The active mesh, whatever its shape (None on one device)."""
    return getattr(_state, "ctx", (None, False))[0]


def current_mesh() -> Optional[Mesh]:
    """The active mesh when its vocab tables are sharded (mp > 1 and
    declared so)."""
    mesh, sharded = getattr(_state, "ctx", (None, False))
    return mesh if sharded and mesh is not None and mesh.mp > 1 else None


GATHER_BWD_MODES = ("auto", "take", "onehot")


@contextmanager
def gather_bwd(mode: str):
    """The gather backward of the enclosed forwards: 'auto' (the default;
    'take' off a TPU), 'take' (the index backward's scatter-add) or
    'onehot' (the one-hot product, for every [V, D] table)."""
    if mode not in GATHER_BWD_MODES:
        raise ValueError(f"gather_bwd mode must be one of {GATHER_BWD_MODES}, "
                         f"got {mode!r}")
    prev = gather_bwd_mode()
    _state.gather_bwd = mode
    try:
        yield
    finally:
        _state.gather_bwd = prev


def gather_bwd_mode() -> str:
    return getattr(_state, "gather_bwd", "auto")


class OneHotGather(torch.autograd.Function):
    """rows = table[ids], whose backward is ``one_hot(ids, V)ᵀ @ ct``,
    accumulated in f32 and cast to the table's dtype (the JAX package's
    `_take_matmul_bwd`, `tlsan_tpu/nn/embedding.py:106-132`).  The
    one-hot entries are exact, so it differs from the scatter-add by f32
    summation order only.  Its forward and backward are plain torch, so
    ``torch.func.vmap`` batches them by rule (the replica fan-out runs it
    as ``jax.vmap`` runs the JAX one)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(table, ids):
        return table[ids]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids = inputs
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).long()
        ct2 = ct.reshape(flat.shape[0], ct.shape[-1]).float()
        classes = torch.arange(ctx.vocab, device=flat.device)
        oh = (flat[:, None] == classes).float()
        return (oh.T @ ct2).to(ctx.dtype), None


def lookup(table: torch.Tensor, ids: torch.Tensor,
           span: str = "nn.embedding") -> torch.Tensor:
    """Gather rows of an embedding table ([V, D] or [V] bias) at integer
    (int32 or int64) ids; under a vocab-sharded mesh `table` is this rank's
    row shard and the ids are global.  A [V, D] table's backward is the
    one-hot product under ``gather_bwd('onehot')``.  On one device the
    gather is span `span` and its backward ``<span>.bwd`` (core/spans.py:
    inside the train step's forward, while a profiler records)."""
    mesh = current_mesh()
    if mesh is not None:
        return sharded_lookup(mesh, table, ids)
    with spans.inner(span) as on:
        if table.dim() == 2 and gather_bwd_mode() == "onehot":
            out = OneHotGather.apply(table, ids)
        else:
            out = table[ids]
    if on:
        spans.backward_span(out, span + ".bwd")
    return out


def item_cate_table(item_emb: torch.Tensor, cate_emb: torch.Tensor,
                    cate_list: torch.Tensor) -> torch.Tensor:
    """The fused item⊕cate table [V, Di+Dc]: row v is ``concat(item_emb[v],
    cate_emb[cate_list[v]])`` (reference: TLSAN/model.py:84-87, :140)."""
    return torch.cat([item_emb, lookup(cate_emb, cate_list, "nn.embedding.cate_list")],
                     dim=-1)


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
    return lookup(item_cate_table(item_emb, cate_emb, cate_list), ids,
                  "nn.embedding.item_cate")


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
        return lookup(self.table, ids, "nn.embedding.item_cate")
