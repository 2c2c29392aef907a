"""The (dp, mp) process grid and its collectives.

Ported from tlsan_tpu/parallel/mesh.py.  The JAX package is one controller
over a device mesh; torch runs one process per rank, so the mesh is a grid
of processes:

  dp — data parallel: each dp index holds a contiguous share of every
       global batch's rows; dense weights are replicated;
  mp — model parallel: each mp index holds a contiguous share of the rows
       of every vocab table (`VOCAB_SHARDED_PARAMS`).

Rank r sits at (d, m) = (r // mp, r % mp), the order of
``devices[:dp*mp].reshape(dp, mp)`` in the JAX package.  A rank's dp group
is the dp ranks that share its m (gradients of its rows sum over it); its
mp group the mp ranks that share its d (lookups exchange rows over it).
Every rank creates every group, in the same order, or the world hangs.

Collectives are `all_reduce` (SUM, MIN, MAX) only, the ones Gloo documents
for CUDA tensors, so ranks that share one card can run over Gloo.  A
gather is an all_reduce SUM over a zero-filled buffer in which each rank
writes only its own slot: exact, since x + 0 = x and −inf + 0 = −inf.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

DP_AXIS = "dp"
MP_AXIS = "mp"

# model parameters whose leading dim is a vocab axis → row-sharded over mp
# (short_w/long_w are LSPM's item-/user-vocab tables — LSPM/model.py:46-49)
VOCAB_SHARDED_PARAMS = ("item_emb", "item_b", "user_emb", "usert_emb",
                        "cate_emb", "short_w", "long_w")


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (dp, mp) grid, its two groups and its
    device."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    dp_group: object
    mp_group: object

    @property
    def d(self) -> int:
        return self.rank // self.mp

    @property
    def m(self) -> int:
        return self.rank % self.mp

    @property
    def size(self) -> int:
        return self.dp * self.mp


def make_mesh(dp: int, mp: int, device) -> Mesh:
    """The (dp, mp) mesh over the initialized default process group, whose
    world must be exactly dp·mp ranks.  Collective: every rank calls it,
    in the same order as every other group it creates."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/multihost.py init_distributed)")
    world = dist.get_world_size()
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} ranks, the world "
                         f"has {world}")
    rank = dist.get_rank()
    dp_groups = [dist.new_group([d * mp + m for d in range(dp)])
                 for m in range(mp)]
    mp_groups = [dist.new_group([d * mp + m for m in range(mp)])
                 for d in range(dp)]
    return Mesh(dp, mp, rank, torch.device(device),
                dp_groups[rank % mp], mp_groups[rank // mp])


def is_vocab_sharded(name: str) -> bool:
    """Whether the parameter `name` (a dotted state_dict name) is a vocab
    table, row-sharded over mp (JAX `param_spec`); everything else, gamma
    and the attention maps, is replicated."""
    return name.split(".")[-1] in VOCAB_SHARDED_PARAMS


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of an mp-sharded table of `n` (padded) rows."""
    per = n // mesh.mp
    return slice(mesh.m * per, (mesh.m + 1) * per)


# ------------------------------------------------------------ collectives


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`x` reduced over `group`, in a new tensor (x is left as it is); a
    group of one rank makes no call."""
    out = x.detach().clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


class _SumOver(torch.autograd.Function):
    """Forward: the sum over `group`; backward: the incoming gradient as it
    is.  Each rank's copy of the sum depends on its own term, and every
    rank back-propagates the same cotangent, so the gradient of a rank's
    term is the cotangent itself: no collective in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of `x` over `group`, differentiable as `_SumOver` says."""
    return _SumOver.apply(x, group)


class _OnceOverDp(torch.autograd.Function):
    """Forward: x; backward: the gradient on dp index 0 only.  For a term
    that every dp rank computes alike (the L2 of full tables): the dp
    gradient all_reduce then counts it once, not dp times."""

    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def once_over_dp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _OnceOverDp.apply(x, mesh.d == 0)


def gather_rows(shard: torch.Tensor, mesh: Mesh, group=None,
                index: int = None, parts: int = None) -> torch.Tensor:
    """The full table of which `shard` is this rank's slot `index` of
    `parts` equal row ranges (by default the mp shard): a zero-filled
    buffer with this rank's rows written, summed over `group` (the mp group
    by default).  No gradient flows through it."""
    group = mesh.mp_group if group is None else group
    index = mesh.m if index is None else index
    parts = mesh.mp if parts is None else parts
    n = shard.shape[0]
    full = shard.new_zeros((parts * n,) + tuple(shard.shape[1:]))
    full[index * n:(index + 1) * n] = shard.detach()
    if parts > 1:
        dist.all_reduce(full, group=group)
    return full


def barrier(mesh: Mesh) -> None:
    """Every rank waits for every other: an all_reduce of one element over
    the world, on the mesh's device."""
    dist.all_reduce(torch.zeros(1, device=mesh.device))
