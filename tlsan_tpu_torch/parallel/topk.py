"""Full-catalog scoring and top-k over a vocab-sharded item table.

Ported from tlsan_tpu/parallel/topk.py (reference: TLSAN/model.py:140-156,
the eval product and the streaming top-k).  Each mp rank scores its row
range of the catalog ([B_local, D] × [D, V/mp] in full f32), takes a local
top-k with its indices made global, and the k·mp candidates are exchanged
over the mp group and reduced to the global top-k.  The exchange is an
all_reduce SUM over a zero-filled [B_local, mp·k] buffer in which each rank
writes its own slot: the values survive exactly (−inf included), and only
k·mp (value, index) pairs a query cross instead of the [B, V] scores.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tlsan_tpu_torch.parallel.mesh import Mesh, gather_rows


def sharded_topk_scores(mesh: Mesh, u_repr: torch.Tensor, all_emb: torch.Tensor,
                        all_b: Optional[torch.Tensor], k: int,
                        catalog_items: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k (values [B_local, k], int64 indices [B_local, k]) of
    u_repr @ all_emb.T + all_b, for this rank's dp rows `u_repr` [B_local, D]
    and mp shard `all_emb` [V/mp, D] (`all_b` [V/mp] or None).
    `catalog_items` masks the global rows at or past it (the mp padding)
    out of the ranking; at or past V it masks nothing.  The product runs at
    the process's f32 matmul precision, which the entry points set to full
    f32 (TF32 off)."""
    vloc = all_emb.shape[0]
    scores = u_repr @ all_emb.T                       # [B_local, V/mp]
    if all_b is not None:
        scores = scores + all_b
    gids = mesh.m * vloc + torch.arange(vloc, device=scores.device)
    if catalog_items is not None:
        scores = torch.where(gids[None, :] < catalog_items, scores, -torch.inf)
    k_local = min(k, vloc)
    vals, idx = torch.topk(scores, k_local, dim=1)
    idx = gids[idx]                                  # globalize
    # this rank's candidates in its slot of every rank's [B, mp·k_local]
    vals_all = gather_rows(vals.T.contiguous(), mesh).T
    idx_all = gather_rows(idx.T.contiguous(), mesh).T
    vals_g, pos = torch.topk(vals_all, k, dim=1)
    return vals_g, torch.gather(idx_all, 1, pos)
