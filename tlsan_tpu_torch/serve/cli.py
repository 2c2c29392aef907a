"""Serving CLI — batch top-k recommendations from a trained checkpoint.

  python -m tlsan_tpu_torch.serve.cli --model_dir save_tlsan_Digital_Music \
      --dataset Digital_Music --data_dir Data --k 10 [--device cpu]

Ported from tlsan_tpu/serve/cli.py; it runs on CUDA unless ``--device cpu``
is given.  Loads the best checkpoint (+ config sidecar), rebuilds the
dataset's test batches as request traffic (through the packed cache),
prints the first few users' top-k item ids, and reports serving throughput
(users/s, full-catalog scoring).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from tlsan_tpu_torch.core.config import (
    ModelConfig,
    load_config_json,
    model_config_from_json,
)
from tlsan_tpu_torch.data.remap import category_path
from tlsan_tpu_torch.serve.recommender import Recommender, resolve_device
from tlsan_tpu_torch.train import checkpoint
from tlsan_tpu_torch.train.cli import prepare


def _record(batch, ids, scores, r: int) -> str:
    return json.dumps({
        "user": int(batch["u"][r]) if "u" in batch else r,
        "items": ids[r].tolist(),
        "scores": [round(float(s), 4) for s in scores[r]],
    })


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--model", default=None, help="default: config sidecar")
    p.add_argument("--dataset", default="Digital_Music")
    p.add_argument("--data_dir", default="Data")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--show", type=int, default=3)
    p.add_argument("--exclude_history", action="store_true")
    p.add_argument("--query_mode", choices=["label", "last"], default="label",
                   help="atrank/csan condition their user tower on a query "
                        "item: 'label' keeps the held-out test positive (the "
                        "reference's eval protocol), 'last' uses the user's "
                        "most recent history item (genuine serving)")
    p.add_argument("--out", default=None,
                   help="write ALL users' recommendations as JSONL here "
                        "(bulk/offline inference)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # raise before loading anything
    # the checkpoint's JSON config sidecar drives both the model choice and
    # the request packing (Ls / lspm_k / max_length / ... must match the
    # shapes the model was trained with, not the defaults)
    ckpt_path = checkpoint.best_checkpoint(args.model_dir)
    sidecar = None
    if ckpt_path is not None:
        # a missing/corrupt sidecar must not break an explicit --model run
        try:
            cfg_d = load_config_json(ckpt_path[: -len(".ckpt")] + ".json")
            sidecar = model_config_from_json(cfg_d["ModelConfig"])
        except (OSError, KeyError, ValueError, TypeError):
            sidecar = None
    model_name = args.model or (sidecar.model if sidecar else None)
    if model_name is None:
        if ckpt_path is not None:
            raise SystemExit(
                f"checkpoint {ckpt_path} has no readable config sidecar; "
                "pass --model explicitly")
        raise SystemExit(f"no checkpoint under {args.model_dir}")

    # rebuild the test split as request traffic (same packing as training)
    cfg0 = (sidecar if sidecar is not None and sidecar.model == model_name
            else ModelConfig(model=model_name))
    t0 = time.perf_counter()
    prep = prepare(model_name, category_path(args.data_dir, args.dataset), cfg0)
    prepare_s = time.perf_counter() - t0

    rec = Recommender.from_model_dir(
        args.model_dir, prep.cate_list, model_name, device=device, k=args.k,
        batch_size=args.batch, exclude_history=args.exclude_history)

    # ATRank/CSAN condition the user tower on the candidate item (reference
    # eval quirk, SURVEY.md §2.4) — their eval batch keeps "i" as the query
    drop = ("j", "y") if model_name in ("atrank", "csan") else ("i", "j", "y")
    batch = {k: v for k, v in prep.test.arrays.items() if k not in drop}
    n = len(next(iter(batch.values())))
    if model_name in ("atrank", "csan"):
        if args.query_mode == "last":
            # genuine serving: query = the user's most recent history item
            last = np.maximum(batch["sl"], 1) - 1
            batch["i"] = batch["hist_i"][np.arange(n), last]
        else:
            print("WARNING: --query_mode=label conditions recommendations on "
                  "the held-out test positive (the reference's eval "
                  "protocol); use --query_mode=last for genuine serving",
                  flush=True)

    rec.recommend(batch)  # warm-up
    t0 = time.perf_counter()
    ids, scores = rec.recommend(batch)  # returns numpy: the device is done
    dt = time.perf_counter() - t0

    if args.out:
        with open(args.out, "w") as f:
            for r in range(n):
                f.write(_record(batch, ids, scores, r) + "\n")
        print(f"wrote {n} users to {args.out}")

    for r in range(min(args.show, n)):
        print(_record(batch, ids, scores, r))
    metric = {"metric": "serve_users_per_s", "value": n / dt,
              "unit": "users/s", "k": args.k,
              "catalog": len(prep.cate_list), "device": str(device),
              "builder": prep.builder, "prepare_s": prepare_s}
    print(json.dumps(metric))
    return metric


if __name__ == "__main__":
    main()
