"""Sparse (touched-row) updates of the vocab embedding tables.

Ported from tlsan_tpu/train/sparse.py (reference: TLSAN/model.py:84-113,
:197-205: TF's embedding lookups give `IndexedSlices`, which the
optimizer applies row by row).  A dense step pays for the gradient of a
[V, D] table in full: a scatter-add into zeros, the global-norm read and
the update, some five passes over every table a step.  This step touches
only the rows the global batch uses, with the dense step's semantics:

  * unique ids: per id space (the item ids and the user ids), the batch's
    ids sorted, the first of each run flagged, a cumsum numbering the runs
    and a scatter into a fixed [K] buffer filled with the sentinel
    `vocab`: K = B × the space's id slots, so the buffer is sorted, and
    no host sync sizes it (``torch.unique`` on CUDA would);
  * row blocks: each table of the space gathered at the buffer (a
    sentinel reads as a zero row), the batch's ids remapped to positions
    in it, and the model run by ``torch.func.functional_call`` on the
    blocks in place of the tables, with the local cate view
    ``cate_list[uids]``;
  * the L2 of a family that regularizes whole tables (TLSAN, SHAN, PACA,
    CSAN, CNN, Bi-LSTM) is computed over the blocks, which gives the dense
    gradient on the touched rows; the untouched rows' part, rr·T, is a
    decay T ← (1 − a·rr)·T, kept as a lazy scale per table (T = scale·W)
    and folded into the stored table once a chunk;
  * the clip: the tree's ‖g‖² plus rr²·max(q − ‖rows‖², 0), with q = ‖T‖²
    carried by the exact recurrence q' = d²·(q − ‖rows‖²) + ‖rows'‖² and
    read densely once a chunk (SGD), or read densely each step (Adam,
    whose own passes read every row anyway);
  * SGD scatters the touched rows' update; Adam decays both moments
    densely, m ← b1·m, v ← b2·v (plus the untouched L2 field), scatters
    the touched rows' moments, and updates every row: the dense Adam's
    semantics, as TF's sparse Adam has them (`sparse.py:30-45`).

None of this is a kernel in the JAX package: the gathers, scatters and
elementwise passes are plain torch ops here too.  The results equal the
dense step's to float associativity (tests/test_torch_sparse.py).

Under a (dp, mp) mesh every rank holds the global [K, B] index chunk, so
every rank computes the same unique buffer over the global batch; a row
block is gathered from an mp-sharded table by a masked local gather and a
sum over mp, so it is whole on every rank; the model runs on this rank's
dp rows with the sharded lookups off (`mesh_context(mesh, False)`), and a
vocab table that is no space's (TLSAN's cate_emb) is gathered whole for
the forward (`gather_whole`).  The dp sum of the gradients is one
all_reduce of the [K_space, D] row gradients and the dense leaves, never
of whole tables; ‖T‖² and the sharded leaves' squares are summed over mp
once; each rank scatters into its own row range.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Mapping, Optional, Tuple

import torch
from torch import nn

from tlsan_tpu_torch.core.config import TrainConfig
from tlsan_tpu_torch.nn.embedding import mesh_context
from tlsan_tpu_torch.parallel.mesh import Mesh, all_reduce, is_vocab_sharded
from tlsan_tpu_torch.parallel.sharded_embedding import (
    gather_whole,
    row_gather,
    row_scatter_add_,
)
from tlsan_tpu_torch.train.state import (
    Adam,
    Optimizer,
    OptState,
    bf16_cast,
    clip_by_global_norm,
    clip_factor,
    dp_sum_gradients,
    wants_bf16,
)

# id spaces: which batch keys hold ids of a space, and which tables the
# space indexes (a model uses those of them it has)
ITEM_KEYS: Tuple[str, ...] = ("hist_i", "hist_i_new", "i", "j")
ITEM_TABLES: Tuple[str, ...] = ("item_emb", "item_b", "short_w")
USER_KEYS: Tuple[str, ...] = ("u",)
USER_TABLES: Tuple[str, ...] = ("user_emb", "usert_emb", "long_w")


class SpaceSpec:
    """One id space: batch keys, table names, the unique buffer's size K
    and the sentinel id (the vocab size, above every real id)."""

    def __init__(self, keys: List[str], tables: List[str], size: int,
                 vocab: int):
        self.keys = keys
        self.tables = tables
        self.size = size
        self.vocab = vocab


def build_spaces(params: Mapping[str, torch.Tensor], data: Mapping,
                 batch_size: int,
                 vocab_rows: Optional[Mapping[str, int]] = None
                 ) -> List[SpaceSpec]:
    """The id spaces that can be sparsified for this model and data.
    `params` maps the model's parameter names to tensors, `data` the
    packed arrays ([N, ...]) whose trailing dims give each key's id slots;
    `vocab_rows` the tables' global rows, where `params` holds shards."""

    def slots(key):
        n = 1
        for d in data[key].shape[1:]:
            n *= int(d)
        return n

    def space(keys, tables):
        keys = [k for k in keys if k in data]
        tables = [t for t in tables if t in params]
        if not (keys and tables):
            return []
        vocab = (int(vocab_rows[tables[0]]) if vocab_rows is not None
                 else int(params[tables[0]].shape[0]))
        return [SpaceSpec(keys, tables,
                          batch_size * sum(slots(k) for k in keys), vocab)]

    return space(ITEM_KEYS, ITEM_TABLES) + space(USER_KEYS, USER_TABLES)


def sparsifiable(params: Mapping[str, torch.Tensor], data: Mapping) -> bool:
    return bool(build_spaces(params, data, 1))


def unique_padded(ids: torch.Tensor, size: int, sentinel: int) -> torch.Tensor:
    """The sorted unique values of `ids` in a [size] buffer padded with
    `sentinel` (jnp.unique(size=, fill_value=)), with no host sync: sort,
    flag the first of each run, number the runs by a cumsum, scatter each
    first into its slot (the others into a dropped slot past the end)."""
    s = torch.sort(ids.reshape(-1).long()).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    slot = torch.where(first, torch.cumsum(first, 0) - 1, size)
    out = torch.full((size + 1,), sentinel, dtype=s.dtype, device=s.device)
    return out.scatter_(0, slot, s)[:size]


def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x)


class ModelCall(nn.Module):
    """`model.<method>(*args)` as a module call, so that
    ``torch.func.functional_call`` can run it with other tensors in place
    of the model's parameters (the names keep a ``model.`` prefix)."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


def call_with(model: nn.Module, method: str, tensors: Mapping[str, torch.Tensor],
              *args):
    """`model.<method>(*args)` with `tensors` (by parameter name) in place
    of those parameters."""
    return torch.func.functional_call(
        ModelCall(model, method), {f"model.{k}": v for k, v in tensors.items()},
        args)


class SparseStep:
    """The touched-row step of `opt` (SGD or Adam) for `model` on the
    packed `data`; under a `mesh`, one rank's share of it.  `chunk` runs
    K steps and updates the model's parameters and `opt`'s slots in
    place."""

    def __init__(self, model: nn.Module, tc: TrainConfig, data: Mapping,
                 opt: Optimizer, mesh: Optional[Mesh] = None,
                 vocab_rows: Optional[Mapping[str, int]] = None):
        if opt.name not in ("sgd", "adam"):
            raise ValueError(f"sparse updates run sgd or adam, not {opt.name}")
        params = dict(model.named_parameters())
        self.spaces = build_spaces(params, data, tc.train_batch_size, vocab_rows)
        if not self.spaces:
            raise ValueError(f"{model.name}: no sparsifiable id space")
        self.opt, self.mesh = opt, mesh
        self.names = list(params)
        self.sparse_names = {t for sp in self.spaces for t in sp.tables}
        self.decay = sorted(self.sparse_names & set(model.l2_full_tables))
        self.rr = model.cfg.regulation_rate
        self.bf16 = wants_bf16(tc)
        self.vocab_sharded = mesh is not None and mesh.mp > 1
        self.rows_mesh = mesh if self.vocab_sharded else None
        self.dense = [n for n in self.names if n not in self.sparse_names]
        # vocab tables that are no space's: whole on every rank for the
        # forward, their gradient a row shard (summed over mp in the norm)
        self.whole = [n for n in self.dense
                      if self.vocab_sharded and is_vocab_sharded(n)]
        self.keys = [k for sp in self.spaces for k in sp.keys]

    # ------------------------------------------------------------ helpers

    def _mp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.mesh.mp_group) if self.vocab_sharded else x

    def _table_sq(self, table: torch.Tensor) -> torch.Tensor:
        """‖T‖² of a whole table (its shards' summed over mp)."""
        return self._mp_sum(_sq(table.detach()))

    def _ctx(self):
        return (mesh_context(self.mesh, False) if self.mesh is not None
                else nullcontext())

    # --------------------------------------------------------------- step

    def _forward_backward(self, model, params, scale, gbatch, lbatch,
                          cate_list, generator):
        """Gather the row blocks, run the loss on them and back-propagate.
        Returns (loss, uids per space, row blocks (true values), their
        gradients, the dense leaves' gradients)."""
        uids_by_space, rows = [], {}
        sub_batch = dict(lbatch)
        local_cate = cate_list
        for sp in self.spaces:
            flat = torch.cat([gbatch[k].reshape(-1) for k in sp.keys])
            uids = unique_padded(flat, sp.size, sp.vocab)
            uids_by_space.append(uids)
            for t in sp.tables:
                r = row_gather(params[t], uids, self.rows_mesh)
                if scale is not None and t in scale:
                    r = r * scale[t]
                rows[t] = r.requires_grad_(True)
            for k in sp.keys:
                sub_batch[k] = torch.searchsorted(
                    uids, lbatch[k].long()).to(lbatch[k].dtype)
            if "item_emb" in sp.tables:
                real = uids < sp.vocab
                local_cate = torch.where(
                    real, cate_list[uids.clamp(max=sp.vocab - 1)], 0
                ).to(cate_list.dtype)
        for p in params.values():
            p.grad = None
        tensors = dict(rows)
        for n in self.whole:
            tensors[n] = gather_whole(params[n], self.mesh)
        if self.bf16:
            tensors = bf16_cast({**params, **tensors})
            sub_batch = bf16_cast(sub_batch)
        with self._ctx():
            loss = call_with(model, "loss", tensors, sub_batch, local_cate,
                             generator)
        loss.backward()
        g_rows = {t: r.grad if r.grad is not None else torch.zeros_like(r)
                  for t, r in rows.items()}
        g_dense = [params[n].grad if params[n].grad is not None
                   else torch.zeros_like(params[n]) for n in self.dense]
        return (loss.detach(), uids_by_space,
                {t: r.detach() for t, r in rows.items()}, g_rows, g_dense)

    def _grads_and_norm(self, g_rows, g_dense, untouched):
        """The dp-summed gradients and the global norm of the whole tree,
        the untouched rows' analytic L2 part included."""
        names = list(g_rows)
        if self.mesh is not None and self.mesh.dp > 1:
            summed = dp_sum_gradients([g_rows[t] for t in names] + g_dense,
                                      self.mesh)
            g_rows = dict(zip(names, summed[:len(names)]))
            g_dense = summed[len(names):]
        gsq = sum(_sq(g) for g in g_rows.values())
        part = torch.zeros_like(gsq)
        for n, g in zip(self.dense, g_dense):
            if n in self.whole:
                part = part + _sq(g)
            else:
                gsq = gsq + _sq(g)
        if self.whole:
            gsq = gsq + self._mp_sum(part)
        for t in self.decay:
            gsq = gsq + self.rr * self.rr * untouched[t]
        return g_rows, g_dense, torch.sqrt(gsq)

    @torch.no_grad()
    def _sgd_step(self, model, params, state, scale, q, gbatch, lbatch,
                  cate_list, generator):
        with torch.enable_grad():
            loss, uids_by_space, rows, g_rows, g_dense = self._forward_backward(
                model, params, scale, gbatch, lbatch, cate_list, generator)
        untouched = {t: torch.clamp_min(q[t] - _sq(rows[t]), 0.0)
                     for t in self.decay}
        g_rows, g_dense, g_norm = self._grads_and_norm(g_rows, g_dense, untouched)
        lr = self.opt.schedule(state.count)
        neg_lr = -lr
        for n, g in zip(self.dense, clip_by_global_norm(g_dense, self.opt.max_norm,
                                                         g_norm)):
            params[n].add_(g * neg_lr)
        a = lr * clip_factor(g_norm, self.opt.max_norm)
        for sp, uids in zip(self.spaces, uids_by_space):
            for t in sp.tables:
                g, r = g_rows[t], rows[t]
                if t in self.decay:
                    # T' = d·T + scatter(δ) = s'·(W + scatter(δ / s'))
                    d = 1.0 - a * self.rr
                    s_new = scale[t] * d
                    delta = a * self.rr * r - a * g
                    row_scatter_add_(params[t], uids, delta / s_new, self.rows_mesh)
                    scale[t] = s_new
                    q[t] = d * d * untouched[t] + _sq(r - a * g)
                else:  # the dense step's arithmetic on the touched rows
                    g = clip_by_global_norm([g], self.opt.max_norm, g_norm)[0]
                    row_scatter_add_(params[t], uids, g * neg_lr, self.rows_mesh)
        # the untouched rows' L2 mass, which the block L2 cannot see
        return loss + 0.5 * self.rr * sum(untouched.values(), torch.zeros_like(loss))

    @torch.no_grad()
    def _adam_step(self, model, params, state, gbatch, lbatch, cate_list,
                   generator):
        opt: Adam = self.opt
        with torch.enable_grad():
            loss, uids_by_space, rows, g_rows, g_dense = self._forward_backward(
                model, params, None, gbatch, lbatch, cate_list, generator)
        untouched = {t: torch.clamp_min(self._table_sq(params[t]) - _sq(rows[t]), 0.0)
                     for t in self.decay}
        g_rows, g_dense, g_norm = self._grads_and_norm(g_rows, g_dense, untouched)
        index = {n: i for i, n in enumerate(self.names)}
        opt.apply([params[n] for n in self.dense],
                  clip_by_global_norm(g_dense, opt.max_norm, g_norm), state,
                  [index[n] for n in self.dense])
        c = clip_factor(g_norm, opt.max_norm)
        neg_lr = -opt.schedule(state.count)
        b1, b2 = opt.b1, opt.b2
        mu, nu = state.slots["mu"], state.slots["nu"]
        for sp, uids in zip(self.spaces, uids_by_space):
            for t in sp.tables:
                g, r, T = c * g_rows[t], rows[t], params[t]
                m, n = mu[index[t]], nu[index[t]]
                if t in self.decay:
                    gu = c * self.rr  # the untouched rows' gradient is gu·T
                    m.mul_(b1).add_(T * (gu * (1 - b1)))
                    row_scatter_add_(m, uids, (1 - b1) * (g - gu * r), self.rows_mesh)
                    n.mul_(b2).add_(torch.square(gu * T) * (1 - b2))
                    row_scatter_add_(n, uids, (1 - b2) * (g * g - torch.square(gu * r)),
                                     self.rows_mesh)
                else:
                    m.mul_(b1)
                    row_scatter_add_(m, uids, (1 - b1) * g, self.rows_mesh)
                    n.mul_(b2)
                    row_scatter_add_(n, uids, (1 - b2) * (g * g), self.rows_mesh)
                T.add_(opt.moment_direction(m, n, state.count) * neg_lr)
        return loss + 0.5 * self.rr * sum(untouched.values(), torch.zeros_like(loss))

    def chunk(self, model: nn.Module, gxs: Mapping[str, torch.Tensor],
              lxs: Mapping[str, torch.Tensor], cate_list: torch.Tensor,
              state: OptState, generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, OptState]:
        """K steps: `gxs` holds the space keys of the K global batches
        ([K, B, ...]), `lxs` this rank's rows of every array ([K, B/dp,
        ...]; the same as `gxs` on one device).  Returns the K losses (of
        the global batches, on the device) and the state after them.  The
        tables leave it with the lazy scale folded in."""
        params = dict(model.named_parameters())
        K = next(iter(lxs.values())).shape[0]
        losses = []
        if self.opt.name == "sgd":
            scale = {t: torch.ones((), device=params[t].device) for t in self.decay}
            with torch.no_grad():
                q = {t: self._table_sq(params[t]) for t in self.decay}
            for s in range(K):
                losses.append(self._sgd_step(
                    model, params, state, scale, q, {k: gxs[k][s] for k in self.keys},
                    {k: v[s] for k, v in lxs.items()}, cate_list, generator))
                state = OptState(state.count + 1, state.slots)
            with torch.no_grad():
                for t in self.decay:
                    params[t].mul_(scale[t])
        else:
            for s in range(K):
                losses.append(self._adam_step(
                    model, params, state, {k: gxs[k][s] for k in self.keys},
                    {k: v[s] for k, v in lxs.items()}, cate_list, generator))
                state = OptState(state.count + 1, state.slots)
        for p in params.values():
            p.grad = None
        return torch.stack(losses), state


def wants_sparse(tc: TrainConfig, item_count: int, user_count: int) -> bool:
    """The Trainer's gate (tlsan_tpu/train/loop.py:169-186): forced by
    `tc.sparse_updates`, else engaged at `sparse_auto_rows` vocab rows or
    more (items + users), except Adam at batch > 128, where the dense
    moments' passes leave it no gain in the JAX package's measurements."""
    want = tc.sparse_updates
    if want is None:
        want = item_count + user_count >= tc.sparse_auto_rows
        if tc.optimizer == "adam" and tc.train_batch_size > 128:
            want = False
    return bool(want) and tc.optimizer in ("sgd", "adam")
