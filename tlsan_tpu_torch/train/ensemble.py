"""Replica fan-out: train R independent seed/LR replicas in one program.

Ported from tlsan_tpu/train/ensemble.py.  Seed envelopes (R runs that
differ only in init seed and shuffle order) and small LR sweeps cost R full
trainings one after the other; on the card a TLSAN-class step leaves the
device idle most of the time (the host sets the pace), so R replicas can
share one stream of launches.  This module stacks the R parameter sets on
a leading axis and runs the Trainer's step (train/loop.py) under
``torch.func.vmap`` of ``functional_call``: K1, K2 and K3 take the replica
axis through their vmap rules (ops/cuda/fwa.py, ops/cuda/mha.py), one launch
for all R replicas, as ``jax.vmap`` of the ``pallas_call`` adds a grid axis.
Each replica's trajectory is that of a single run.

Semantics per replica r:
  - its init drawn as the Trainer draws it at seed r
    (``init_params(torch.Generator().manual_seed(seed_r))``, on the CPU);
  - its own epoch shuffle stream (``epoch_index(..., seed=seed_r)``);
  - its optimizer slots, and optax's global-norm clip over its own leaves;
  - an optional lr_scale_r on the update after the clip and the schedule:
    the exact per-replica learning rate for SGD, whose update is linear in
    lr (the reference protocol is SGD everywhere, TLSAN/train.py:44);
  - the pairwise AUC, one vmapped pass over the shared test set.

The gradients come from one ``.backward()`` of the sum of the R losses:
the replicas share no parameter, so each replica's slice of a ``.grad`` is
its own gradient.  No checkpoints or metric files: this is the sweep
harness, not the production Trainer; it returns per-replica curves and
bests.  It composes with bf16 (``tc.compute_dtype``; K1–K3 run in f32
between casts, as in the Trainer) and with ``gather_bwd('onehot')``.  It is
single-device (a mesh raises), and dropout raises: the kernels draw no
masks (ROADMAP.md item 25), and explicit generators do not run under
``vmap``.  It runs on CUDA unless the caller passes ``device="cpu"``.

    python -m tlsan_tpu_torch.train.ensemble --model tlsan \\
        --dataset Digital_Music --data_dir Data --seeds 1 2 3 4 [--device cpu]
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches, epoch_index
from tlsan_tpu_torch.serve.recommender import resolve_device
from tlsan_tpu_torch.train.evaluate import device_data, make_replica_auc_fn
from tlsan_tpu_torch.train.sparse import call_with
from tlsan_tpu_torch.train.state import bf16_cast, make_optimizer, wants_bf16

DEFAULT_SEEDS = (1234, 42, 7, 99, 2024, 11, 5, 321)


class ReplicaFanout:
    def __init__(self, model, cfg: ModelConfig, tc: TrainConfig,
                 cate_list: np.ndarray, train_batches: Batches,
                 test_batches: Batches, seeds: Sequence[int],
                 lr_scales: Optional[Sequence[float]] = None, device=None):
        """`model` is the model class (any of `models.MODELS`); one replica
        a seed of `seeds`; `lr_scales` (SGD only) one a replica."""
        if tc.dp * tc.mp > 1:
            raise ValueError(f"the fan-out runs on one device; got dp={tc.dp}, "
                             f"mp={tc.mp}")
        if lr_scales is not None and tc.optimizer != "sgd":
            raise ValueError(
                "per-replica lr_scales are exact only for SGD (linear in "
                f"lr), not {tc.optimizer}; use a shared LR for other optimizers")
        if cfg.dropout > 0.0:
            raise ValueError(
                f"the fan-out runs no dropout (rate {cfg.dropout}): the CUDA "
                "kernels draw no masks (ROADMAP.md item 25), and explicit "
                "torch.Generators do not run under torch.func.vmap")
        self.bf16 = wants_bf16(tc)  # raises on a dtype it does not know
        self.device = resolve_device(device)
        # float32 matrix products in full f32 (TF32 off), as the Trainer
        torch.set_float32_matmul_precision("highest")
        self.cfg, self.tc = cfg, tc
        self.seeds = list(seeds)
        R = len(self.seeds)
        scales = [1.0] * R if lr_scales is None else [float(x) for x in lr_scales]
        if len(scales) != R:
            raise ValueError(f"{len(scales)} lr_scales for {R} replicas")
        self.lr_scales = torch.tensor(scales, dtype=torch.float32,
                                      device=self.device)
        # ×1.0 is exact: without lr_scales the update skips the product
        self._scales = None if lr_scales is None else self.lr_scales
        self.cate_list = torch.from_numpy(
            np.asarray(cate_list, np.int32)).to(self.device)
        self.data = {k: torch.from_numpy(v).to(self.device)
                     for k, v in train_batches.arrays.items()}
        self.n_train = train_batches.n

        # the model gives the layout and the methods; every call runs it on
        # the stacked parameters in place of its own
        self.model = model(cfg, self.device)
        self.params = {}
        for r, seed in enumerate(self.seeds):
            init = dict(model(cfg, self.device).init_params(
                torch.Generator().manual_seed(seed)).named_parameters())
            for name, p in init.items():
                if r == 0:
                    self.params[name] = p.new_empty((R,) + p.shape)
                self.params[name][r] = p.detach()
        for p in self.params.values():
            p.requires_grad_(True)
        self.opt = make_optimizer(tc)
        self.opt_state = self.opt.init(list(self.params.values()))
        self.step = 0
        self._test_data, _ = device_data(test_batches, tc.test_batch_size,
                                         self.device)
        self._auc = make_replica_auc_fn(self.model, self.cate_list)

    # ------------------------------------------------------------------

    def _replica_losses(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[R] losses of the replicas, each on its own rows of `batch`
        ([R, B, ...] fields); under bf16 on cast copies of the parameters
        and the batch's float fields."""

        def loss(params, rows):
            if self.bf16:
                params, rows = bf16_cast(params), bf16_cast(rows)
            return call_with(self.model, "loss", params, rows, self.cate_list)

        return torch.func.vmap(loss)(self.params, batch)

    def _fan_chunk(self, idx: torch.Tensor) -> torch.Tensor:
        """K optimizer steps of every replica on the [R, K, B] index chunk
        `idx` (a device tensor; replica r's rows from its own stream),
        updating the stacked parameters and slots in place; returns each
        replica's mean loss over the K steps, [R], on the device."""
        steps = idx.transpose(0, 1)  # [K, R, B]
        # one gather per array for the whole chunk; each step slices it
        xs = {k: v[steps] for k, v in self.data.items()}
        params = list(self.params.values())
        losses = []
        for s in range(steps.shape[0]):
            for p in params:
                p.grad = None
            loss = self._replica_losses({k: v[s] for k, v in xs.items()})
            loss.sum().backward()
            self.opt_state = self.opt.replica_step(params, self.opt_state,
                                                   self._scales)
            losses.append(loss.detach())
        return torch.stack(losses).mean(dim=0)

    def _epoch_index(self, epoch: int) -> np.ndarray:
        """[n_chunks, R, K, B]: each replica gets its OWN seed's shuffle
        stream; per replica exactly the Trainer's epoch_index
        (data/batcher.py)."""
        B, K = self.tc.train_batch_size, self.tc.steps_per_call
        per_replica = [epoch_index(self.n_train, B, K, epoch, s)
                       for s in self.seeds]
        # [R, n_chunks, K, B] → [n_chunks, R, K, B]
        return np.stack(per_replica).transpose(1, 0, 2, 3)

    def auc(self) -> np.ndarray:
        """Each replica's pairwise AUC over the test set, [R]."""
        return self._auc(self.params, self._test_data).cpu().numpy()

    def train(self, log=print) -> Dict:
        tc = self.tc
        R = len(self.seeds)
        best = np.zeros(R)
        best_step = np.zeros(R, np.int64)
        curves: List[Dict] = []
        steps_since_eval = 0
        t0 = time.time()
        compile_s = None  # the first chunk's time: its warm-up
        examples = 0
        for epoch in range(tc.max_epochs):
            epoch_idx = torch.from_numpy(self._epoch_index(epoch)).to(self.device)
            for chunk_idx in epoch_idx:
                losses = self._fan_chunk(chunk_idx)
                if compile_s is None:
                    losses = losses.cpu()  # waits for the chunk
                    compile_s = time.time() - t0
                self.step += chunk_idx.shape[1]
                steps_since_eval += chunk_idx.shape[1]
                examples += chunk_idx.numel()
                if steps_since_eval >= tc.eval_freq:
                    steps_since_eval = 0
                    aucs = self.auc()
                    hit = (self.step > tc.best_after_step) & (aucs > best)
                    best = np.where(hit, aucs, best)
                    best_step = np.where(hit, self.step, best_step)
                    curves.append({"step": self.step,
                                   "auc": [round(float(a), 6) for a in aucs]})
                    log(f"[fanout] step={self.step} "
                        f"auc={np.array2string(aucs, precision=4)} "
                        f"loss={np.array2string(losses.cpu().numpy(), precision=4)}")
        aucs = self.auc()
        hit = aucs > best
        best = np.where(hit, aucs, best)
        best_step = np.where(hit, self.step, best_step)
        wall = time.time() - t0
        compile_s = compile_s or 0.0
        return {
            "seeds": self.seeds,
            "lr_scales": [float(x) for x in self.lr_scales],
            "best_auc": [round(float(a), 6) for a in best],
            "best_step": [int(s) for s in best_step],
            "mean_best": round(float(best.mean()), 6),
            "range": [round(float(best.min()), 6), round(float(best.max()), 6)],
            "wall_s": round(wall, 2),
            "compile_s": round(compile_s, 2),
            "post_compile_wall_s": round(wall - compile_s, 2),
            "replica_examples_per_s": round(examples / wall, 1),
            # warm-up excluded: short probes are warm-up dominated
            "post_compile_replica_examples_per_s": round(
                examples / max(wall - compile_s, 1e-9), 1),
            "curves": curves,
        }


def main(argv=None):
    import argparse
    import json

    from tlsan_tpu_torch.data.remap import category_path
    from tlsan_tpu_torch.models import get_model
    from tlsan_tpu_torch.train.cli import _device_arg, prepare

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="tlsan")
    p.add_argument("--dataset", default="Clothing_Shoes_and_Jewelry")
    p.add_argument("--data_dir", default="Data")
    p.add_argument("--seeds", type=int, nargs="+", default=list(DEFAULT_SEEDS))
    p.add_argument("--lr_scales", type=float, nargs="+", default=None,
                   help="per-replica LR multipliers (SGD only); default all 1")
    p.add_argument("--max_epochs", type=int, default=20)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--test_batch_size", type=int, default=128)
    p.add_argument("--learning_rate", type=float, default=1.0)
    p.add_argument("--lr_drop_step", type=int, default=150_000)
    p.add_argument("--eval_freq", type=int, default=1000)
    p.add_argument("--steps_per_call", type=int, default=100)
    p.add_argument("--best_after_step", type=int, default=0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--build_seed", type=int, default=1234,
                   help="dataset-builder seed (fixed; replicas vary TRAIN "
                        "seeds only, like the reference seed studies)")
    p.add_argument("--compute_dtype", choices=["f32", "float32", "bf16",
                                               "bfloat16"], default="float32")
    p.add_argument("--device", type=_device_arg, default="cuda",
                   help="cuda (the default; raises without a GPU), cuda:N or cpu")
    p.add_argument("--out", default=None, help="write the result JSON here")
    args = p.parse_args(argv)

    cfg = ModelConfig(model=args.model, dropout=args.dropout,
                      hidden_units={"csan": 32}.get(args.model, 64),
                      regulation_rate={"lspm": 1e-2}.get(args.model, 5e-5))
    tc = TrainConfig(
        optimizer="sgd", learning_rate=args.learning_rate,
        lr_drop_step=args.lr_drop_step,
        train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size,
        max_epochs=args.max_epochs, eval_freq=args.eval_freq,
        steps_per_call=args.steps_per_call,
        best_after_step=args.best_after_step,
        compute_dtype={"f32": "float32", "bf16": "bfloat16"}.get(
            args.compute_dtype, args.compute_dtype))
    device = resolve_device(args.device)
    prep = prepare(args.model, category_path(args.data_dir, args.dataset), cfg,
                   args.build_seed)
    print(f"fanout model={args.model} dataset={args.dataset} "
          f"replicas={len(args.seeds)} train={prep.train.n} test={prep.test.n} "
          f"device={device}", flush=True)
    fan = ReplicaFanout(get_model(args.model), prep.cfg, tc, prep.cate_list,
                        prep.train, prep.test, args.seeds, args.lr_scales,
                        device=device)
    result = fan.train()
    out = dict(result)
    out.pop("curves")
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
