"""The training loop: device-resident data, K-step chunks, eval cadence.

Ported from tlsan_tpu/train/loop.py (the single-device dense path), which
reproduces the reference trainer flow (TLSAN/train.py:121-239): initial
eval, epoch loop with per-epoch shuffle, loss records every display_freq
steps, AUC + P@k/R@k eval every eval_freq steps, best-metric tracking after
best_after_step, AUC-gated checkpointing, and the lr step schedule.

  - The packed train set lives on the device; each chunk gathers its
    [K, B, ...] batches by an `epoch_index` chunk and runs K optimizer steps
    as a plain Python loop (the JAX lax.scan).  Each step is a forward, a
    backward through autograd — on CUDA TLSAN's feature-wise attention runs
    K1 forward and K2 backward, ATRank's multi-head attention K3 forward;
    the seven baselines run plain PyTorch — and the clipped SGD update in
    place.  Pairwise families (BPR-MF, LSPM) train on (i, j) pairs with no
    label.
  - Loss and histogram records are deferred: they stay device tensors until
    an eval or epoch boundary, so the host does not wait on the card between
    chunks.

It runs on CUDA unless the caller passes ``device="cpu"``; with no GPU and
no explicit CPU it raises.

With ``tc.dp · tc.mp > 1`` it is one rank of a (dp, mp) mesh (ported from
tlsan_tpu/train/loop.py:69-144, :195-276, :439-474, :517-533): every rank
of an initialized process group of dp·mp ranks builds its Trainer, in the
same order, on its own `device`.  The weights are drawn (or restored) at
the true vocab sizes on the CPU, zero-padded to a multiple of mp and cut
to the rank's rows (parallel/api.py); each step runs on the rank's dp
share of the global batch, and its loss is the global batch's; summaries
and metrics are those of the whole model and test set; rank 0 alone writes
metrics and checkpoints, in the unpadded form, so a save restores under
any (dp, mp).

Sparse touched-row updates (train/sparse.py) engage for SGD and Adam
when `tc.sparse_updates` forces them or, with it None, at
`tc.sparse_auto_rows` vocab rows or more, except Adam at batch > 128 (the
JAX Trainer's gate, tlsan_tpu/train/loop.py:169-186), on one device and on
the mesh.  Under `tc.compute_dtype` bfloat16 the train loss and the
summary's forward run on `bf16_cast` copies of the parameters and the
batch's float fields; gradients land in f32 on the master parameters,
and evaluation stays f32.  `profile_trace` writes a `torch.profiler`
trace of a few chunks run on copies of the model and optimizer state.

While a profiler records, the dense step records spans (core/spans.py):
``train.step`` around each step, and on one device ``train.forward``
(with the gathers' spans inside it), ``train.backward`` and
``train.optimizer``.  The sparse step and a mesh's phases record none.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from contextlib import nullcontext
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tlsan_tpu_torch.core import spans
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches, epoch_index
from tlsan_tpu_torch.models import base
from tlsan_tpu_torch.nn.embedding import mesh_context
from tlsan_tpu_torch.nn.layers import RowShardMasks
from tlsan_tpu_torch.parallel import api
from tlsan_tpu_torch.parallel.mesh import (
    all_reduce,
    barrier,
    is_vocab_sharded,
    make_mesh,
)
from tlsan_tpu_torch.serve.recommender import resolve_device
from tlsan_tpu_torch.train import checkpoint as ckpt
from tlsan_tpu_torch.train import sparse
from tlsan_tpu_torch.train import tensorboard as tb
from tlsan_tpu_torch.train.evaluate import Evaluator
from tlsan_tpu_torch.train.metrics import MetricWriter
from tlsan_tpu_torch.train.state import OptState, bf16_cast, make_optimizer, wants_bf16

# the tables a train summary digests, when the model has them, in the JAX
# package's order (tlsan_tpu/train/loop.py:439-461); TLSAN's carry the
# reference's tags (TLSAN/model.py:173-183), the others embedding/<name>
_SUMMARY_TABLES = ("item_emb", "user_emb", "cate_emb", "usert_emb", "item_b",
                   "short_w", "long_w", "position_w")
_TLSAN_TAGS = {"item_emb": "embedding/1_item_emb",
               "user_emb": "embedding/2_user_emb",
               "cate_emb": "embedding/3_cate_emb",
               "usert_emb": "embedding/4_usert_emb"}


def _summary_params(model):
    """(name, tag, parameter) of a train summary, as the JAX Trainer picks
    them: the tables present, then gamma where it exists; the attention
    output of the chunk's last batch (tag ``attention_output``) follows."""
    params = dict(model.named_parameters())
    tags = [(n, _TLSAN_TAGS.get(n, f"embedding/{n}") if model.name == "tlsan"
             else f"embedding/{n}", params[n])
            for n in _SUMMARY_TABLES if n in params]
    if "gamma" in params:
        tags.append(("gamma", "gamma", params["gamma"]))
    return tags


class _NullWriter:
    """Ranks other than 0: metrics and checkpoints are rank 0's to write."""

    def write(self, *a, **k):
        pass

    def write_histograms(self, *a, **k):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, model, cfg: ModelConfig, tc: TrainConfig,
                 cate_list: np.ndarray, train_batches: Batches,
                 test_batches: Batches, device=None):
        """`model` is the model class (any of `models.MODELS`).  Restores
        the newest checkpoint under ``tc.model_dir`` if there is one (after the
        `from_scratch` wipe), else draws the initial weights from
        ``torch.Generator().manual_seed(tc.seed)`` — on the CPU, so every
        device, and every mesh, starts from the same weights."""
        self.bf16 = wants_bf16(tc)  # raises on a dtype it does not know
        self.device = resolve_device(device)
        # float32 matrix products in full f32 (TF32 off), as the JAX package
        # pins precision='highest'
        torch.set_float32_matmul_precision("highest")
        self.tc = tc
        self._cfg_true = dataclasses.replace(cfg, catalog_items=0)
        self._counts_true = api.counts(cfg)
        self.mesh = None
        if tc.dp * tc.mp > 1:
            self.mesh = make_mesh(tc.dp, tc.mp, self.device)
            for name in ("train_batch_size", "test_batch_size"):
                if getattr(tc, name) % tc.dp:
                    raise ValueError(f"{name} {getattr(tc, name)} must divide "
                                     f"evenly over dp={tc.dp}")
            cfg = api.pad_config_for_mp(cfg, tc.mp)
            cate_list = api.pad_cate_list(cate_list, cfg)
        self.is_chief = self.mesh is None or self.mesh.rank == 0
        self.cfg = cfg
        self.opt = make_optimizer(tc)
        self.cate_list = torch.from_numpy(
            np.asarray(cate_list, np.int32)).to(self.device)
        self.train_data = {k: torch.from_numpy(v).to(self.device)
                           for k, v in train_batches.arrays.items()}
        self.n_train = train_batches.n

        # restore-or-init (reference: TLSAN/train.py:59-84), at the true
        # vocab sizes; a mesh then pads and shards
        if self.is_chief:
            ckpt.maybe_wipe(tc.model_dir, tc.from_scratch)
        if self.mesh is not None:  # no rank restores before rank 0 wipes
            barrier(self.mesh)
        # a mesh draws at the true sizes on the CPU, then pads and shards
        self.model = (model(cfg, self.device) if self.mesh is None
                      else model(self._cfg_true, "cpu")).init_params(
            torch.Generator().manual_seed(tc.seed))
        self.step = 0
        saved = None
        latest = ckpt.latest_checkpoint(tc.model_dir)
        if latest is not None:
            self.step, _, saved = ckpt.restore(latest, self.model, tc.optimizer)
            if self.is_chief:
                print(f"restored from {latest} at step {self.step}", flush=True)
        self._sharded = []
        if self.mesh is not None:
            self.model = api.shard_model(self.model, self.mesh, self.device)
            self._sharded = [tc.mp > 1 and is_vocab_sharded(n)
                             for n, _ in self.model.named_parameters()]
        self.params = list(self.model.parameters())
        self._names = [n for n, _ in self.model.named_parameters()]
        self.opt_state = self._restore_opt_state(saved)

        self._sparse = None
        if (sparse.wants_sparse(tc, cfg.item_count, cfg.user_count)
                and sparse.sparsifiable(dict(self.model.named_parameters()),
                                        self.train_data)):
            self._sparse = sparse.SparseStep(
                self.model, tc, self.train_data, self.opt, self.mesh,
                api.vocab_rows(api.counts(cfg)))

        # dropout's masks: from one generator at seed + 1; a mesh rank
        # draws the global batch's and keeps its rows (nn/layers.py)
        self._dropout_gen = self._masks = None
        if cfg.dropout > 0.0:
            self._dropout_gen = torch.Generator(
                device=self.device).manual_seed(tc.seed + 1)
            self._masks = (self._dropout_gen if self.mesh is None else
                           RowShardMasks(self._dropout_gen, tc.dp, self.mesh.d))
        self.evaluator = Evaluator(cfg, self.cate_list, test_batches,
                                   tc.test_batch_size, self.device, self.mesh)
        self.writer = MetricWriter(tc.model_dir) if self.is_chief else _NullWriter()
        self._summary_tags = [tag for _, tag, _ in _summary_params(self.model)]
        self._summary_tags.append("attention_output")
        self._limits = None
        if tc.tb_histograms:
            self._limits = torch.tensor(tb.tf_bucket_limits(),
                                        dtype=torch.float32, device=self.device)

    @property
    def _use_sparse(self) -> bool:
        return self._sparse is not None

    def _restore_opt_state(self, saved) -> OptState:
        """The optimizer state from a checkpoint's (None: a serving-only
        save, whose count is its step), placed as the parameters are;
        slots the save lacks (another optimizer's save) start at zero."""
        state = self.opt.init(self.params)
        state.count = self.step if saved is None else int(saved["count"])
        for slot, by_name in (saved or {}).get("slots", {}).items():
            if slot not in state.slots:
                continue
            if self.mesh is not None:
                by_name = api.place_named(by_name, self.mesh, self._counts_true,
                                          api.counts(self.cfg), self.device)
            for t, name in zip(state.slots[slot], self._names):
                t.copy_(by_name[name])
        return state

    def _forward(self, method: str, batch: Dict[str, torch.Tensor], *args):
        """`model.<method>(batch, cate_list, *args)`; under bf16 on cast
        copies of the parameters and the batch's float fields."""
        if not self.bf16:
            return getattr(self.model, method)(batch, self.cate_list, *args)
        return sparse.call_with(self.model, method,
                                bf16_cast(dict(self.model.named_parameters())),
                                bf16_cast(batch), self.cate_list, *args)

    # ------------------------------------------------------------------

    def _train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        for p in self.params:
            p.grad = None
        # the phases' spans on one device; a mesh's step records train.step alone
        one = self.mesh is None
        with spans.span("train.forward", inner="nn.embedding") if one else nullcontext():
            loss = self._forward("loss", batch, self._masks)
        with spans.span("train.backward") if one else nullcontext():
            loss.backward()
        with spans.span("train.optimizer") if one else nullcontext():
            self.opt_state = self.opt.step(self.params, self.opt_state,
                                           self.mesh, self._sharded)
        return loss.detach()

    def _local(self, idx: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a [..., B] global batch-index tensor."""
        if self.mesh is None:
            return idx
        return api.shard_batch({"idx": idx}, self.mesh, axis=idx.dim() - 1)["idx"]

    def _train_chunk(self, idx: torch.Tensor) -> torch.Tensor:
        """K optimizer steps on the [K, B] global index chunk `idx` (a
        device tensor), on this rank's rows of each batch; returns the K
        losses of the global batches, on the device."""
        # one gather per array for the whole chunk; each step slices it
        xs = {k: v[self._local(idx)] for k, v in self.train_data.items()}
        if self._sparse is not None:
            gxs = {k: self.train_data[k][idx] for k in self._sparse.keys}
            losses, self.opt_state = self._sparse.chunk(
                self.model, gxs, xs, self.cate_list, self.opt_state,
                self._masks)
            return losses
        losses = []
        with mesh_context(self.mesh):
            for s in range(idx.shape[0]):
                with spans.span("train.step", device=self.device):
                    losses.append(self._train_step({k: v[s] for k, v in xs.items()}))
        return torch.stack(losses)

    def _epoch_index(self, epoch: int) -> np.ndarray:
        """Shuffled [n_chunks, K, B] batch-index tensor (data/batcher.py
        epoch_index, byte-identical to the JAX package's)."""
        return epoch_index(self.n_train, self.tc.train_batch_size,
                           self.tc.steps_per_call, epoch, self.tc.seed)

    def _digest(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """One packed histogram row (min, max, num, sum, sumsq, counts over
        the TF bucket grid), computed on the device; with a `group`, of the
        union of its ranks' `x` (min and max reduced, the rest summed)."""
        x = x.detach().float().reshape(-1)
        s = torch.sort(x).values
        cum = torch.searchsorted(s, self._limits, right=True)
        counts = torch.cat([cum[:1], cum[1:] - cum[:-1]]).float()
        num = torch.full((), float(x.numel()), device=x.device)
        lo, hi = (s[0], s[-1]) if len(s) else (x.new_tensor(torch.inf),
                                               x.new_tensor(-torch.inf))
        if group is not None:
            lo = all_reduce(lo, group, dist.ReduceOp.MIN)
            hi = all_reduce(hi, group, dist.ReduceOp.MAX)
            num, total, sq, counts = all_reduce(
                torch.cat([torch.stack([num, torch.sum(x), torch.sum(x * x)]),
                           counts]), group).split([1, 1, 1, len(counts)])
            return torch.cat([torch.stack([lo, hi]), num, total, sq, counts])
        head = torch.stack([lo, hi, num, torch.sum(x), torch.sum(x * x)])
        return torch.cat([head, counts])

    def _true_rows(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """This rank's shard `p` of table `name` without the mp padding
        rows it holds."""
        true_n = api.vocab_rows(self._counts_true)[name]
        return p[:max(0, min(p.shape[0], true_n - self.mesh.m * p.shape[0]))]

    @torch.no_grad()
    def _summaries(self, batch_idx: torch.Tensor):
        """Histogram digests of the reference's train-summary set
        (TLSAN/model.py:173-183): the vocab tables, gamma, the attention
        output of `batch_idx`'s batch, and the L2_norm_user_item scalar of
        the full tables (0 for a model that has none).  Under a mesh, those
        of the whole tables (without their padding rows) and of the whole
        batch.  Returns device tensors ([n_tags, 5 + buckets], l2)."""
        model, mesh = self.model, self.mesh
        sharded = mesh is not None and self.tc.mp > 1
        rows = []
        for name, _, p in _summary_params(model):
            if sharded and is_vocab_sharded(name):
                rows.append(self._digest(self._true_rows(name, p), mesh.mp_group))
            else:
                rows.append(self._digest(p))
        batch = {k: v[self._local(batch_idx)] for k, v in self.train_data.items()}
        with mesh_context(mesh):
            u = self._forward("user_repr", batch)
        rows.append(self._digest(u, None if mesh is None else mesh.dp_group))
        # a row-sharded table's L2 sums over mp; a replicated weight's
        # (SHAN's layer maps, PACA's position table) is whole on each rank
        l2 = torch.zeros((), device=self.device)
        l2_rows = torch.zeros((), device=self.device)
        for n in model.l2_full_tables:
            if sharded and is_vocab_sharded(n):
                l2_rows = l2_rows + base.l2_tables(getattr(model, n))
            else:
                l2 = l2 + base.l2_tables(getattr(model, n))
        if sharded:
            l2 = l2 + all_reduce(l2_rows, mesh.mp_group)
        return torch.stack(rows), l2

    # ------------------------------------------------------------------

    def evaluate(self) -> Dict[str, float]:
        metrics = {"auc": self.evaluator.auc(self.model)}
        metrics.update(self.evaluator.topk(self.model))
        return metrics

    def _ckpt_opt_state(self) -> Dict:
        """The optimizer state to save: the count (the step, for the sparse
        step as for the dense one) and each slot by parameter name, whole
        and unpadded under a mesh as the parameters are (collective), so a
        save restores under any (dp, mp) and into either step."""
        state = self.opt_state.to_dict(self._names)
        for slot, by_name in state.get("slots", {}).items():
            state["slots"][slot] = (
                {k: v.detach().cpu() for k, v in by_name.items()}
                if self.mesh is None else
                api.gather_named(by_name, self.mesh, self._counts_true))
        return state

    def _save(self, best: bool = False) -> None:
        """Under a mesh every rank joins the gather of the whole, unpadded
        state, rank 0 writes it, and every rank waits for the write."""
        state = self.model
        if self.mesh is not None:
            state = api.gather_state(self.model, self.mesh, self._counts_true)
        opt_state = self._ckpt_opt_state()
        if self.is_chief:
            ckpt.save(self.tc.model_dir, self.model.name, self.step, state,
                      opt_state, self._cfg_true, self.tc, best=best)
        if self.mesh is not None:
            barrier(self.mesh)

    def profile_trace(self, n_chunks: int = 3,
                      out_dir: Optional[str] = None) -> str:
        """A `torch.profiler` trace (host and, on CUDA, device events) of
        the first `n_chunks` chunks of epoch 0, written as Chrome trace
        JSON under `out_dir` (default ``{model_dir}/profile``; one file a
        rank under a mesh), and beside it the port's spans over those
        chunks (`core/spans.py::take`) as JSON (``spans.json``, or
        ``spans_rank<r>.json``).  The chunks run on copies of the model
        and the optimizer state, and the dropout generator's state is put
        back, so the real run that follows is unchanged.  Returns
        `out_dir`."""
        out_dir = out_dir or os.path.join(self.tc.model_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        idx = torch.from_numpy(self._epoch_index(0)[:n_chunks]).to(self.device)
        live = self.model, self.params, self.opt_state
        gen = None if self._dropout_gen is None else self._dropout_gen.get_state()
        self.model = copy.deepcopy(self.model)
        self.params = list(self.model.parameters())
        self.opt_state = self.opt_state.clone()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        spans.take()  # what an earlier profiler left
        try:
            with torch.profiler.profile(activities=activities) as prof:
                for chunk in idx:
                    self._train_chunk(chunk)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            rank = "" if self.mesh is None else f"_rank{self.mesh.rank}"
            prof.export_chrome_trace(os.path.join(out_dir, f"trace{rank}.json"))
            with open(os.path.join(out_dir, f"spans{rank}.json"), "w") as f:
                json.dump(spans.take(), f, indent=1)
        finally:
            self.model, self.params, self.opt_state = live
            if gen is not None:
                self._dropout_gen.set_state(gen)
        return out_dir

    def train(self) -> Dict[str, float]:
        tc = self.tc
        best = {"auc": 0.0, "step": 0}
        self.writer.write("eval", self.step, self.evaluate())

        examples_seen = 0
        t_start = time.time()
        steps_since_eval = steps_since_display = steps_since_summary = 0
        pending = []  # (step, loss tensor, (histos, l2) tensors or None)

        def flush_display():
            for s, l, h in pending:
                self.writer.write("train", s, {"loss": float(l)})
                if h is not None:
                    packed, l2 = h[0].cpu().numpy(), float(h[1])
                    histos = {
                        tag: (row[0], row[1], row[2], row[3], row[4], row[5:])
                        for tag, row in zip(self._summary_tags, packed)}
                    scalars = {"Training Loss": float(l)}
                    if l2 > 0.0:
                        scalars["L2_norm_user_item"] = l2
                    self.writer.write_histograms(s, histos, scalars)
            pending.clear()

        for epoch in range(tc.max_epochs):
            t_epoch = time.time()
            examples_at_epoch_start = examples_seen
            # one host-to-device copy an epoch (each waits for the stream)
            epoch_idx = torch.from_numpy(self._epoch_index(epoch)).to(self.device)
            for chunk_idx in epoch_idx:
                loss = self._train_chunk(chunk_idx).mean()
                K = chunk_idx.shape[0]
                self.step += K
                steps_since_eval += K
                steps_since_display += K
                steps_since_summary += K
                examples_seen += chunk_idx.numel()
                if steps_since_display >= tc.display_freq:
                    steps_since_display = 0
                    h = None
                    if (self._limits is not None
                            and steps_since_summary >= tc.summary_freq):
                        steps_since_summary = 0
                        h = self._summaries(chunk_idx[-1])
                    pending.append((self.step, loss, h))

                if steps_since_eval >= tc.eval_freq:
                    steps_since_eval = 0
                    flush_display()
                    metrics = self.evaluate()
                    self.writer.write("eval", self.step, metrics)
                    # best tracking + gated save (reference: TLSAN/train.py:222-230)
                    if self.step > tc.best_after_step and metrics["auc"] > best["auc"]:
                        best = {**metrics, "step": self.step}
                        if metrics["auc"] > tc.save_auc_gate:
                            self._save(best=True)
            flush_display()
            dt = time.time() - t_epoch
            epoch_examples = examples_seen - examples_at_epoch_start
            self.writer.write("epoch", self.step, {
                "epoch": epoch, "epoch_s": dt,
                "examples_per_s": epoch_examples / max(dt, 1e-9),
                "cum_examples_per_s":
                    examples_seen / max(time.time() - t_start, 1e-9),
            })

        final = self.evaluate()
        self.writer.write("final", self.step, final)
        if final["auc"] > best["auc"]:
            best = {**final, "step": self.step}
        self._save()
        return best

    def close(self) -> None:
        self.writer.close()
