"""Rank programs: what `run_local` runs on every rank of a local world.

Each takes the rank's `Mesh` first and numpy or config arguments, drives
the port's own entry points (`sharded_lookup`, `sharded_topk_scores`, a
train step, `Trainer`, `Recommender`) on the rank's device, and returns
picklable results: numpy arrays, metrics, seconds and the rank's kernel
launch counts (per process, so each rank counts its own).  The mesh tests
and chip_smoke.py compare them with the JAX package and with one process.
Whole states are returned by rank 0 only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tlsan_tpu_torch.data.batcher import Batches, epoch_index
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.nn.embedding import mesh_context
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa
from tlsan_tpu_torch.ops.cuda import mha as cuda_mha
from tlsan_tpu_torch.parallel import api
from tlsan_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    gather_rows,
    is_vocab_sharded,
    shard_rows,
)
from tlsan_tpu_torch.parallel.multihost import local_batch_slice
from tlsan_tpu_torch.parallel.sharded_embedding import sharded_lookup
from tlsan_tpu_torch.parallel.topk import sharded_topk_scores
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.train.loop import Trainer
from tlsan_tpu_torch.train.state import make_optimizer


def reset_launches() -> None:
    cuda_fwa.launches = cuda_fwa.bwd_launches = 0
    cuda_mha.launches = cuda_mha.bwd_launches = 0


def launch_counts() -> Dict[str, int]:
    """This process's launches of K1, K2, K3 and K3b."""
    return {"fwa_fwd": cuda_fwa.launches, "fwa_bwd": cuda_fwa.bwd_launches,
            "mha_fwd": cuda_mha.launches, "mha_bwd": cuda_mha.bwd_launches}


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _numpy(state) -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in state.items()}


def _whole_state(model, mesh: Mesh, counts) -> Optional[Dict[str, np.ndarray]]:
    """The gathered, unpadded state on rank 0 (None elsewhere); every rank
    joins the gather."""
    state = api.gather_state(model, mesh, counts)
    return _numpy(state) if mesh.rank == 0 else None


def _pad_max(model, mesh: Mesh, counts) -> float:
    """The largest |value| in any mp padding row of the model's tables."""
    true_of = api.vocab_rows(counts)
    worst = torch.zeros((), device=mesh.device)
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if mesh.mp > 1 and is_vocab_sharded(name):
            pad = p.detach()[max(0, true_of[leaf] - mesh.m * p.shape[0]):]
            if pad.numel():
                worst = torch.maximum(worst, pad.abs().max())
    return float(all_reduce(worst, None, torch.distributed.ReduceOp.MAX))


def sequence(mesh: Mesh, *jobs):
    """Run several programs in one world: each job is (program, kwargs)."""
    return [fn(mesh, **kwargs) for fn, kwargs in jobs]


def check_ops(mesh: Mesh, lookups: Sequence[dict] = (),
              topks: Sequence[dict] = ()) -> dict:
    """Sharded lookups and top-k on global numpy inputs.

    Each lookup {"table": [V, ...] with V a multiple of mp, "ids": [B, ...]
    with B a multiple of dp, "ct": the cotangent of the rows} gives this
    rank's rows of table[ids] ("out") and the table's whole gradient of
    Σ rows·ct ("grad": each rank's shard gradient summed over dp, as the
    trainer does, then gathered over mp).  Each top-k {"u": [B, D], "emb":
    [V, D], "bias": [V] or None, "k", "catalog": int or None} gives this
    rank's rows of the global top-k ("vals", "idx")."""
    dev = mesh.device
    out = {"lookups": [], "topks": []}
    for case in lookups:
        table = torch.from_numpy(case["table"]).to(dev)
        shard = table[shard_rows(len(table), mesh)].clone().requires_grad_(True)
        rows = local_batch_slice(len(case["ids"]), mesh)
        ids = torch.from_numpy(case["ids"][rows]).to(dev)
        got = sharded_lookup(mesh, shard, ids)
        (got * torch.from_numpy(case["ct"][rows]).to(dev)).sum().backward()
        grad = gather_rows(all_reduce(shard.grad, mesh.dp_group), mesh)
        out["lookups"].append({"out": got.detach().cpu().numpy(),
                               "grad": grad.cpu().numpy()})
    for case in topks:
        rows = local_batch_slice(len(case["u"]), mesh)
        emb = torch.from_numpy(case["emb"]).to(dev)
        shard = shard_rows(len(emb), mesh)
        bias = (None if case["bias"] is None
                else torch.from_numpy(case["bias"]).to(dev)[shard])
        vals, idx = sharded_topk_scores(
            mesh, torch.from_numpy(case["u"][rows]).to(dev), emb[shard], bias,
            case["k"], case["catalog"])
        out["topks"].append({"vals": vals.cpu().numpy(), "idx": idx.cpu().numpy()})
    return out


def train_step(mesh: Mesh, cfg, tc, state: Dict[str, np.ndarray],
               batch: Dict[str, np.ndarray], cate_list: np.ndarray) -> dict:
    """One optimizer step of `get_model(cfg.model)` from the whole weights
    `state` on the global `batch`: the weights padded and sharded, the
    step on this rank's rows.  Returns the loss of the global batch and,
    on rank 0, the whole unpadded weights after the step."""
    model = get_model(cfg.model)(cfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    placed = api.shard_model(model, mesh, mesh.device)
    cate = torch.from_numpy(api.pad_cate_list(cate_list, placed.cfg)).to(mesh.device)
    local = api.shard_batch({k: torch.from_numpy(v).to(mesh.device)
                             for k, v in batch.items()}, mesh)
    params = list(placed.parameters())
    sharded = [mesh.mp > 1 and is_vocab_sharded(n)
               for n, _ in placed.named_parameters()]
    opt = make_optimizer(tc)
    with mesh_context(mesh):
        loss = placed.loss(local, cate)
    loss.backward()
    opt.step(params, opt.init(), mesh, sharded)
    return {"loss": float(loss.detach()), "state": _whole_state(placed, mesh, api.counts(cfg))}


def train_program(mesh: Mesh, cfg, tc, cate_list: np.ndarray, train: Batches,
                  test: Batches, parity_idx: Optional[np.ndarray] = None,
                  parity_lr: Optional[float] = None,
                  timed_chunks: int = 0) -> dict:
    """`Trainer(get_model(cfg.model), cfg, tc, ...)` on this rank (tc.dp ×
    tc.mp must be the mesh's shape).

    With `parity_idx` ([S, B] global batch indices), first a fresh Trainer
    from tc.seed (its own model_dir, and `parity_lr` if given) takes those
    S steps: "parity_losses" and, on rank 0, "parity_state".  Then the Trainer on tc.model_dir:
    "start" (its step, and on rank 0 its whole weights, as restored or
    drawn), `train()` ("best", "train_s"), `evaluate()` ("metrics") and,
    on rank 0, "final_state"; with `timed_chunks`, that many more chunks of
    epoch 1 after a warm-up chunk ("chunks_s").  "launches" holds this
    rank's kernel launches of each part."""
    model, dev, counts = get_model(cfg.model), mesh.device, api.counts(cfg)
    out = {"rank": mesh.rank, "launches": {}}

    def timed(part, fn):
        reset_launches()
        _sync(mesh)
        t0 = time.perf_counter()
        result = fn()
        _sync(mesh)
        out["launches"][part] = launch_counts()
        return result, time.perf_counter() - t0

    if parity_idx is not None:
        ptc = dataclasses.replace(tc, model_dir=tc.model_dir + "_parity",
                                  tb_histograms=False,
                                  learning_rate=parity_lr or tc.learning_rate)
        tr = Trainer(model, cfg, ptc, cate_list, train, test, device=dev)
        losses, _ = timed("parity", lambda: tr._train_chunk(
            torch.from_numpy(parity_idx).to(dev)))
        out["parity_losses"] = losses.cpu().numpy()
        out["parity_state"] = _whole_state(tr.model, mesh, counts)
        tr.close()

    tr = Trainer(model, cfg, tc, cate_list, train, test, device=dev)
    out["start"] = {"step": tr.step,
                    "state": _whole_state(tr.model, mesh, counts),
                    "shards": {n: tuple(p.shape) for n, p in
                               tr.model.named_parameters()}}
    out["best"], out["train_s"] = timed("train", tr.train)
    out["metrics"], _ = timed("evaluate", tr.evaluate)
    out["step"], out["count"] = tr.step, tr.opt_state.count
    out["final_state"] = _whole_state(tr.model, mesh, counts)
    out["pad_max"] = _pad_max(tr.model, mesh, counts)
    if timed_chunks:
        chunks = torch.from_numpy(epoch_index(
            tr.n_train, tc.train_batch_size, tc.steps_per_call, 1, tc.seed)).to(dev)
        tr._train_chunk(chunks[0])  # warm-up
        _, out["chunks_s"] = timed("chunks", lambda: [
            tr._train_chunk(chunks[1 + c % (len(chunks) - 1)])
            for c in range(timed_chunks)])
    tr.close()
    return out


def chunk_program(mesh: Mesh, cfg, tc, cate_list: np.ndarray, train: Batches,
                  test: Batches, idx: np.ndarray) -> dict:
    """A fresh `Trainer(get_model(cfg.model), cfg, tc, ...)` from tc.seed
    on this rank takes the [S, B] global batch indices `idx` as one chunk
    ("losses"), digests a train summary of the chunk's last batch
    ("summary": the packed histogram rows and "l2", on every rank),
    evaluates ("metrics") and saves to tc.model_dir as a best checkpoint
    at step S, so that `serve_program` can serve it.  Rank 0 returns the
    whole weights ("state"); "launches" holds this rank's kernel launches
    of each part."""
    dev = mesh.device
    out = {"rank": mesh.rank, "launches": {}}
    tr = Trainer(get_model(cfg.model), cfg, tc, cate_list, train, test, device=dev)
    out["sparse"] = tr._use_sparse
    chunk = torch.from_numpy(idx).to(dev)
    reset_launches()
    out["losses"] = tr._train_chunk(chunk).cpu().numpy()
    tr.step += len(idx)
    out["launches"]["chunk"] = launch_counts()
    opt_state = tr._ckpt_opt_state()  # collective: every rank gathers
    out["opt_state"] = None if mesh.rank else {
        "count": opt_state["count"],
        "slots": {s: _numpy(v) for s, v in opt_state.get("slots", {}).items()}}
    if tc.tb_histograms:
        rows, l2 = tr._summaries(chunk[-1])
        out["summary"] = {"rows": rows.cpu().numpy(), "l2": float(l2)}
    reset_launches()
    out["metrics"] = tr.evaluate()
    out["launches"]["evaluate"] = launch_counts()
    tr._save(best=True)
    out["state"] = _whole_state(tr.model, mesh, api.counts(cfg))
    out["pad_max"] = _pad_max(tr.model, mesh, api.counts(cfg))
    tr.close()
    return out


# The JAX package's production legs of its multi-chip dry run
# (__graft_entry__.py:253-256): one family of each sparse-space shape —
# full-table L2 (TLSAN), row L2 with scatter-moment Adam (ATRank), LSPM's
# auxiliary vocab tables — as (family, optimizer, compute dtype)
PRODUCTION_LEGS = (("tlsan", "sgd", "bfloat16"),
                   ("atrank", "adam", "bfloat16"),
                   ("lspm", "sgd", "float32"))


def leg_config(tc, optimizer: str, dtype: str):
    """`tc` made a production leg's: sparse forced, the optimizer at the
    dry run's rate (sgd 1.0, adam 0.01), the compute dtype."""
    return dataclasses.replace(
        tc, sparse_updates=True, optimizer=optimizer, compute_dtype=dtype,
        learning_rate=1.0 if optimizer == "sgd" else 0.01)


def production_leg(mesh: Mesh, cfg, tc, cate_list: np.ndarray, train: Batches,
                   test: Batches, idx: np.ndarray, optimizer: str,
                   dtype: str) -> dict:
    """One production leg on this rank: `chunk_program` with `tc` made the
    leg's (`leg_config`).  "sparse" says whether the touched-row step
    engaged; rank 0's "opt_state" holds the count and the whole, unpadded
    slots (numpy)."""
    return chunk_program(mesh, cfg, leg_config(tc, optimizer, dtype), cate_list,
                         train, test, idx)


def serve_program(mesh: Mesh, model_dir: str, cate_list: np.ndarray,
                  requests: Dict[str, np.ndarray], k: int = 50,
                  batch_size: int = 128, exclude_history: bool = False,
                  calls: int = 0) -> dict:
    """`Recommender.from_model_dir(..., mesh=mesh)` on this rank: the
    answer to `requests` ("ids", "scores", on every rank), its launches,
    and with `calls`, that many more timed calls ("calls_s")."""
    rec = Recommender.from_model_dir(model_dir, cate_list, device=mesh.device,
                                     mesh=mesh, k=k, batch_size=batch_size,
                                     exclude_history=exclude_history)
    reset_launches()
    ids, scores = rec.recommend(requests)
    out = {"rank": mesh.rank, "ids": ids, "scores": scores,
           "launches": {"first": launch_counts()}}
    if calls:
        reset_launches()
        _sync(mesh)
        t0 = time.perf_counter()
        for _ in range(calls):
            rec.recommend(requests)
        _sync(mesh)
        out["calls_s"] = time.perf_counter() - t0
        out["launches"]["calls"] = launch_counts()
    return out
