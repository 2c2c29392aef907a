"""Trainer CLI — `python -m tlsan_tpu_torch.train.cli --model tlsan --dataset Digital_Music`.

Ported from tlsan_tpu/train/cli.py.  Replaces the reference's nine
per-model `train.py` flag scripts (e.g. TLSAN/train.py:26-57) with one
entry point: loads the category file (``<data_dir>/<dataset>.npz``, else
the reference's ``.pkl``, which needs pandas), builds the model's example
set (the right windowing scheme; the native builder when g++ is there),
packs it into static shapes, and runs the Trainer on CUDA unless
``--device cpu`` is given.

``--dp D --mp M`` with D·M > 1 trains on a (dp, mp) mesh of D·M processes
over ``--dist_backend`` (nccl: one card a rank; gloo: ranks may share a
card, ``--device cuda:N``, or run on the CPU).  Without ``--rank`` the CLI
spawns the whole world on this machine; with ``--rank R --world W
--init_method URL`` this process joins a world started elsewhere.  Rank 0
builds the example set and writes the packed cache; the other ranks read
it after a barrier.

``--optimizer {sgd,adam,adadelta,rmsprop}``, ``--sparse/--no_sparse``
(touched-row updates; auto by catalog size without either),
``--compute_dtype bf16``, ``--gather_bwd {auto,take,onehot}`` (the
embedding gathers' backward for the whole run) and ``--profile`` (a
`Trainer.profile_trace` before training; it also prints the port's span
table over the traced chunks) run as the JAX CLI's do.  The
flags that configure JAX (``--platform``, ``--compile_cache``) are not
carried over.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data import cache as dcache
from tlsan_tpu_torch.data import native
from tlsan_tpu_torch.data.batcher import (
    Batches,
    pack_pairwise,
    pack_prefix_test,
    pack_prefix_train,
    pack_session_test,
    pack_session_train,
    round8,
)
from tlsan_tpu_torch.data.builders import (
    build_pairwise_examples,
    build_prefix_examples,
    build_session_examples,
)
from tlsan_tpu_torch.data.remap import category_path, load_category
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.nn.embedding import GATHER_BWD_MODES, gather_bwd
from tlsan_tpu_torch.parallel.mesh import Mesh, barrier, make_mesh
from tlsan_tpu_torch.parallel.multihost import init_distributed, rank_device, run_local
from tlsan_tpu_torch.serve.recommender import resolve_device
from tlsan_tpu_torch.train.loop import Trainer

MODELS = ["tlsan", "atrank", "shan", "csan", "lspm", "paca", "cnn", "bilstm",
          "bpr"]
# a spawned world's limit, and each collective's: a training run's length
# is unknown, and a rank that dies fails the world at once (multihost.py)
WORLD_TIMEOUT_S = 7 * 24 * 3600.0


class Prepared(NamedTuple):
    """A packed example set, and where it came from: "native" or "numpy"
    (the builder that ran) or "cache" (a hit)."""

    train: Batches
    test: Batches
    cate_list: np.ndarray
    cfg: ModelConfig
    builder: str


def auto_steps_per_call(n_train: int, batch_size: int, eval_freq: int) -> int:
    """Chunk length when --steps_per_call is not given: the JAX package's
    rule (tlsan_tpu/train/cli.py:37-48), so both chunk an epoch alike —
    500 at 2,000 or more steps an epoch, else 100, never above eval_freq
    (the eval cadence is checked at chunk boundaries)."""
    steps_per_epoch = max(1, (n_train + batch_size - 1) // batch_size)
    k = 500 if steps_per_epoch >= 2000 else 100
    return max(1, min(k, eval_freq))


def prepare(model_name: str, data_path: str, cfg: ModelConfig, seed: int = 1234,
            use_cache: Optional[bool] = None) -> Prepared:
    """Build + pack the example set for one model family.

    Packed arrays are cached on disk (data/cache.py — the framework's
    ``dataset.pkl``, reference: TLSAN/build_dataset.py:80-84), keyed by the
    builder-code fingerprint + category-file identity + model/seed/shape
    config; a second start on the same category skips the build entirely.
    Opt out with use_cache=False or TLSAN_DATA_CACHE=0.
    """
    if use_cache is None:
        use_cache = dcache.enabled()
    cpath = None
    if use_cache:
        cpath = dcache.cache_path(model_name, data_path, cfg, seed)
        hit = dcache.load(cpath)
        if hit is not None:
            # Merge ONLY the build-derived fields from the stored config into
            # the caller's cfg: the cache key covers the shape fields but not
            # hyperparameters like dropout/hidden_units, so returning the
            # stored cfg wholesale would silently revive stale hyperparams.
            train_b, test_b, cate_list, stored = hit
            merged = dataclasses.replace(
                cfg,
                user_count=stored.user_count,
                item_count=stored.item_count,
                cate_count=stored.cate_count,
                catalog_items=stored.catalog_items,
                Ls=stored.Ls, Ts=stored.Ts, max_length=stored.max_length)
            return Prepared(train_b, test_b, cate_list, merged, "cache")
    out = _prepare_uncached(model_name, data_path, cfg, seed)
    if cpath is not None:
        dcache.store(cpath, out.train, out.test, out.cate_list, out.cfg)
    return out


def _prepare_uncached(model_name: str, data_path: str, cfg: ModelConfig,
                      seed: int = 1234) -> Prepared:
    reviews, _, cate_list, counts = load_category(data_path)
    cfg = cfg.with_counts(counts)
    use_native = native.available()

    if model_name == "tlsan" and use_native:
        # fused native (C++) build+pack, byte-identical to the numpy path
        train_b, test_b, Ts = native.build_tlsan_packed(
            reviews, cate_list, counts.item_count,
            Ls=cfg.Ls, max_length=cfg.max_length, seed=seed)
        cfg = dataclasses.replace(cfg, Ts=Ts)
        return Prepared(train_b, test_b, cate_list, cfg, "native")

    if model_name in ("shan", "paca") and use_native:
        train_b, test_b, Ls, Ts = native.build_session_basic_packed(
            reviews, cate_list, counts.item_count, model_name,
            max_length=cfg.max_length, seed=seed,
            Ls_cap=cfg.paca_max_len if model_name == "paca" else None)
        cfg = dataclasses.replace(cfg, Ls=Ls, Ts=Ts)
        return Prepared(train_b, test_b, cate_list, cfg, "native")

    if model_name in ("tlsan", "shan", "paca"):
        train_set, test_set = build_session_examples(
            reviews, cate_list, counts.item_count,
            variant=model_name, max_length=cfg.max_length, seed=seed)
        hist_idx = 0 if model_name == "paca" else 1
        if model_name == "tlsan":
            Ls = cfg.Ls  # fixed window (TLSAN/train.py:36)
        else:
            Ls = max(
                max((len(t[hist_idx]) for t in train_set), default=1),
                max((len(t[hist_idx]) for t in test_set), default=1))
        sess_max = max(
            max((len(t[2]) for t in train_set), default=1),
            max((len(t[2]) for t in test_set), default=1),
        ) if model_name != "paca" else 1
        Ts = round8(sess_max)
        if model_name != "tlsan":
            Ls = round8(Ls)
        if model_name == "paca":
            # position_w covers max_len positions (PACA/model.py:44-46)
            Ls = min(Ls, cfg.paca_max_len)
        cfg = dataclasses.replace(cfg, Ls=Ls, Ts=Ts)
        train_b = pack_session_train(train_set, Ls, Ts, model_name)
        test_b = pack_session_test(test_set, Ls, Ts, model_name)
        return Prepared(train_b, test_b, cate_list, cfg, "numpy")

    if model_name in ("atrank", "cnn", "csan", "bilstm", "lspm"):
        time_mode = {"atrank": "bucket", "cnn": "bucket",
                     "csan": "raw", "bilstm": "none", "lspm": "none"}[model_name]
        max_length = 80 if model_name == "cnn" else cfg.max_length
        pack_pair = model_name == "lspm"
        if use_native:
            train_b, test_b, T = native.build_prefix_packed(
                reviews, counts.item_count, time_mode=time_mode,
                max_length=max_length, pack_pos_neg=pack_pair,
                align="right" if pack_pair else "left",
                T=cfg.lspm_k if pack_pair else None, seed=seed)
            cfg = dataclasses.replace(cfg, max_length=T)
            return Prepared(train_b, test_b, cate_list, cfg, "native")
        train_set, test_set = build_prefix_examples(
            reviews, counts.item_count, time_mode=time_mode,
            max_length=max_length, pack_pos_neg=pack_pair, seed=seed)
        if model_name == "lspm":
            T = cfg.lspm_k  # fixed right-aligned window (LSPM/input.py:30-37)
            align = "right"
        else:
            T = round8(max(
                max((len(t[1]) for t in train_set), default=1),
                max((len(t[1]) for t in test_set), default=1)))
            align = "left"
        cfg = dataclasses.replace(cfg, max_length=T)
        with_time = time_mode != "none"
        tdt = np.float32 if model_name == "csan" else np.int32
        train_b = pack_prefix_train(train_set, T, with_time=with_time,
                                    pack_pos_neg=pack_pair, align=align, time_dtype=tdt)
        test_b = pack_prefix_test(test_set, T, with_time=with_time,
                                  align=align, time_dtype=tdt)
        return Prepared(train_b, test_b, cate_list, cfg, "numpy")

    if model_name == "bpr":
        if use_native:
            train_arr, test_arr = native.build_bpr_packed(
                reviews, counts.item_count, seed=seed)
        else:
            train_arr, test_arr = build_pairwise_examples(
                reviews, counts.item_count, seed=seed)
        return Prepared(pack_pairwise(train_arr), pack_pairwise(test_arr),
                        cate_list, cfg, "native" if use_native else "numpy")

    raise ValueError(f"unknown model {model_name}")


def _device_arg(value: str) -> str:
    dev = torch.device(value)  # raises on a malformed name
    if dev.type not in ("cuda", "cpu") or (dev.type == "cpu" and dev.index):
        raise argparse.ArgumentTypeError(f"{value}: cuda, cuda:N or cpu")
    return value


def print_spans(path: str) -> None:
    """The span table `Trainer.profile_trace` wrote: a line a span, in
    milliseconds over the traced chunks."""
    with open(path) as f:
        table = json.load(f)
    print(f"{'span':<28} {'count':>6} {'host_ms':>10} {'device_ms':>10} "
          f"{'self_ms':>10}", flush=True)
    for name, r in sorted(table.items()):
        print(f"{name:<28} {r['count']:>6} {r['host_ms']:>10.3f} "
              f"{r['device_ms']:>10.3f} {r['self_device_ms']:>10.3f}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="tlsan", choices=MODELS)
    p.add_argument("--dataset", default="Digital_Music")
    p.add_argument("--data_dir", default="Data")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--test_batch_size", type=int, default=128)
    p.add_argument("--learning_rate", type=float, default=1.0)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "adadelta", "rmsprop"],
                   help="optax's update rules at their defaults, after the "
                        "global-norm clip")
    p.add_argument("--lr_drop_step", type=int, default=None)
    p.add_argument("--steps_per_call", type=int, default=None,
                   help="train steps a chunk (default: 100, or 500 at "
                        "≥2000 steps/epoch; never above eval_freq)")
    p.add_argument("--eval_freq", type=int, default=1000)
    p.add_argument("--display_freq", type=int, default=100,
                   help="steps between train-loss log lines (granularity is "
                        "one chunk = steps_per_call)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--best_after_step", type=int, default=20_000)
    p.add_argument("--save_auc_gate", type=float, default=None,
                   help="checkpoint only when AUC exceeds this (per-model "
                        "reference gates: 0.8 TLSAN/ATRank/PACA, 0.7 "
                        "SHAN/CSAN/CNN/LSPM, none Bi-LSTM/BPR)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh axis (batch sharding)")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel mesh axis (vocab-table row sharding)")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="the mesh's torch.distributed backend, required "
                        "with dp·mp > 1: nccl for one card a rank, gloo for "
                        "ranks that share a card or run on the CPU")
    p.add_argument("--rank", type=int, default=None,
                   help="join a world started elsewhere as this rank "
                        "(with --world and --init_method); without it the "
                        "CLI spawns all dp·mp ranks on this machine")
    p.add_argument("--world", type=int, default=None,
                   help="the world's size, dp·mp")
    p.add_argument("--init_method", default=None,
                   help="the world's rendezvous, e.g. tcp://host:port")
    p.add_argument("--device", type=_device_arg, default="cuda",
                   help="cuda (one card a rank on a mesh), cuda:N (every "
                        "rank on card N) or cpu")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--Ls", type=int, default=10,
                   help="TLSAN long-term window (reference flag, "
                        "TLSAN/train.py:29)")
    p.add_argument("--num_blocks", type=int, default=1,
                   help="attention blocks per tower (reference flag, "
                        "TLSAN/train.py:27)")
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--hidden_units", type=int, default=None,
                   help="default: 64 (CSAN: 32), the reference per-model "
                        "values; must equal item+cate emb width for the "
                        "concat models")
    p.add_argument("--itemid_embedding_size", type=int, default=32)
    p.add_argument("--userid_embedding_size", type=int, default=32)
    p.add_argument("--cateid_embedding_size", type=int, default=32)
    p.add_argument("--max_gradient_norm", type=float, default=5.0)
    p.add_argument("--lspm_k", type=int, default=5,
                   help="LSPM short-term window (reference k=5)")
    p.add_argument("--lspm_alpha", type=float, default=1.0,
                   help="LSPM short-term weight (reference alpha=1.0)")
    p.add_argument("--regulation_rate", type=float, default=None,
                   help="L2 rate override (reference: 1e-2 LSPM, 5e-5 others)")
    p.add_argument("--pallas", dest="use_pallas", action="store_true",
                   default=False,
                   help="accepted so that the JAX package's command lines "
                        "parse; on the card the hand-written CUDA kernels "
                        "always run, and the CPU runs their plain versions")
    p.add_argument("--no_pallas", dest="use_pallas", action="store_false",
                   help="accepted, as --pallas; it does not route the card "
                        "to the plain versions")
    p.add_argument("--no_data_cache", dest="data_cache", action="store_false",
                   default=True,
                   help="rebuild+repack the example set instead of using the "
                        "packed-dataset cache (data/cache.py)")
    p.add_argument("--sparse", dest="sparse_updates", action="store_true",
                   default=None,
                   help="force touched-row vocab-table updates (sgd and "
                        "adam); without --sparse or --no_sparse they engage "
                        "at 100,000 vocab rows or more (not for adam at "
                        "batch > 128)")
    p.add_argument("--no_sparse", dest="sparse_updates", action="store_false",
                   help="force dense [V,D] table updates")
    p.add_argument("--compute_dtype", choices=["f32", "float32", "bf16",
                                               "bfloat16"],
                   default="float32",
                   help="bf16: the network's forward and backward on bf16 "
                        "copies, f32 master weights, loss head and L2; "
                        "evaluation in f32")
    p.add_argument("--gather_bwd", choices=list(GATHER_BWD_MODES),
                   default="auto",
                   help="the embedding gathers' backward: take (scatter-"
                        "add), onehot (one_hot(ids)^T @ grad, f32 "
                        "accumulation) or auto (take: the one-hot product "
                        "engages only on a TPU in the JAX package)")
    p.add_argument("--profile", action="store_true",
                   help="before training, write a torch.profiler trace of "
                        "3 chunks (run on copies) and their span table under "
                        "<model_dir>/profile, and print the table")
    p.add_argument("--from_scratch", action="store_true", default=True)
    p.add_argument("--resume", dest="from_scratch", action="store_false")
    p.add_argument("--no_histograms", dest="tb_histograms",
                   action="store_false", default=True,
                   help="disable TensorBoard histogram summaries")
    p.add_argument("--summary_freq", type=int, default=1000,
                   help="steps between histogram summaries (the reference "
                        "histograms at display_freq; the default matches "
                        "the eval cadence)")
    args = p.parse_args(argv)
    world = args.dp * args.mp
    if world > 1 and args.dist_backend is None:
        p.error(f"--dp {args.dp} --mp {args.mp}: --dist_backend is required")
    if args.rank is not None and (args.world != world or not args.init_method):
        p.error(f"--rank needs --world {world} (dp·mp) and --init_method")

    # per-model reference defaults (SURVEY.md §2.6)
    default_epochs = {"tlsan": 20, "atrank": 10, "csan": 20, "lspm": 10,
                      "paca": 70, "shan": 40, "cnn": 20, "bilstm": 20, "bpr": 20}
    default_drop = {"tlsan": 150_000, "atrank": 270_000, "csan": 270_000,
                    "cnn": 540_000, "lspm": 150_000, "paca": 150_000,
                    "shan": 150_000, "bilstm": 270_000, "bpr": 10**9}
    hidden = (args.hidden_units if args.hidden_units is not None
              else {"csan": 32}.get(args.model, 64))
    # LSPM regularizes at 1e-2, all others at 5e-5 (LSPM/train.py:31)
    reg = args.regulation_rate
    if reg is None:
        reg = {"lspm": 1e-2}.get(args.model, 5e-5)

    cfg = ModelConfig(model=args.model, hidden_units=hidden,
                      dropout=args.dropout, regulation_rate=reg,
                      Ls=args.Ls, num_blocks=args.num_blocks,
                      num_heads=args.num_heads,
                      itemid_embedding_size=args.itemid_embedding_size,
                      userid_embedding_size=args.userid_embedding_size,
                      cateid_embedding_size=args.cateid_embedding_size,
                      lspm_k=args.lspm_k, lspm_alpha=args.lspm_alpha)
    tc = TrainConfig(
        dataset=args.dataset,
        data_dir=args.data_dir,
        model_dir=args.model_dir or f"save_{args.model}_{args.dataset}",
        from_scratch=args.from_scratch,
        optimizer=args.optimizer,
        learning_rate=args.learning_rate,
        lr_drop_step=(args.lr_drop_step if args.lr_drop_step is not None
                      else default_drop[args.model]),
        train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size,
        max_epochs=(args.max_epochs if args.max_epochs is not None
                    else default_epochs[args.model]),
        eval_freq=args.eval_freq,
        display_freq=args.display_freq,
        steps_per_call=args.steps_per_call or 100,  # resolved after prepare
        seed=args.seed,
        max_gradient_norm=args.max_gradient_norm,
        best_after_step=args.best_after_step,
        # reference gate per trainer: TLSAN/train.py:228, ATRank:215,
        # PACA:208 → 0.8; SHAN/CSAN/CNN:208/214 & LSPM:206 → 0.7;
        # Bi-LSTM:70 & BPR:81 save on every new best → 0.0
        save_auc_gate=(args.save_auc_gate if args.save_auc_gate is not None
                       else {"tlsan": 0.8, "atrank": 0.8, "paca": 0.8,
                             "shan": 0.7, "csan": 0.7, "cnn": 0.7,
                             "lspm": 0.7, "bilstm": 0.0,
                             "bpr": 0.0}[args.model]),
        dp=args.dp,
        mp=args.mp,
        sparse_updates=args.sparse_updates,
        tb_histograms=args.tb_histograms,
        summary_freq=args.summary_freq,
        compute_dtype={"f32": "float32", "bf16": "bfloat16"}.get(
            args.compute_dtype, args.compute_dtype),
    )

    if world == 1:
        return _train(None, args, cfg, tc)
    if args.rank is None:  # the whole world, spawned here
        resolve_device(args.device)  # raise before spawning anything
        return run_local(_train, args.dp, args.mp, args.dist_backend,
                         args.device, WORLD_TIMEOUT_S, args, cfg, tc)[0]
    device = rank_device(args.device, args.rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(args.dist_backend, args.init_method, world, args.rank,
                     WORLD_TIMEOUT_S)
    try:
        return _train(make_mesh(args.dp, args.mp, device), args, cfg, tc)
    finally:
        dist.destroy_process_group()


def _train(mesh: Optional[Mesh], args, cfg: ModelConfig, tc: TrainConfig):
    """Prepare and train on one device (`mesh` None) or as one rank of a
    mesh; returns the best metrics."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    chief = mesh is None or mesh.rank == 0
    data_path = category_path(args.data_dir, args.dataset)
    t0 = time.perf_counter()
    if chief:
        prep = prepare(args.model, data_path, cfg, args.seed,
                       use_cache=None if args.data_cache else False)
    if mesh is not None:  # rank 0 has written the cache entry
        barrier(mesh)
        if not chief:
            prep = prepare(args.model, data_path, cfg, args.seed,
                           use_cache=None if args.data_cache else False)
    prepare_s = time.perf_counter() - t0
    cfg = prep.cfg
    if args.steps_per_call is None:
        tc = dataclasses.replace(tc, steps_per_call=auto_steps_per_call(
            prep.train.n, tc.train_batch_size, tc.eval_freq))
    if chief:
        print(f"model={args.model} dataset={args.dataset} "
              f"train={prep.train.n} test={prep.test.n} "
              f"users={cfg.user_count} items={cfg.item_count} "
              f"cates={cfg.cate_count} steps_per_call={tc.steps_per_call} "
              f"builder={prep.builder} prepare_s={prepare_s:.3f} "
              f"device={device}", flush=True)
    with gather_bwd(args.gather_bwd):
        trainer = Trainer(get_model(args.model), cfg, tc, prep.cate_list,
                          prep.train, prep.test, device=device)
        try:
            if args.profile:
                out = trainer.profile_trace()
                if chief:
                    print(f"profiler trace written to {out}", flush=True)
                    print_spans(os.path.join(out, "spans.json" if trainer.mesh is None
                                             else "spans_rank0.json"))
            best = trainer.train()
        finally:
            trainer.close()
    if chief:
        print(f"best: {best}", flush=True)
    return best


if __name__ == "__main__":
    main()
