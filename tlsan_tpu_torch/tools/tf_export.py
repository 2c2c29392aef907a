"""Export a checkpoint AS a reference TF checkpoint (migration, the reverse
of tools/tf_import.py).

Ported from tlsan_tpu/tools/tf_export.py.  It reads a port checkpoint
(``torch.save``) or a JAX package one (flax msgpack, through
train/checkpoint.py's reader), without model code, and writes a plain
``tf.train.Saver`` checkpoint whose variable names are exactly the
reference graph's (the per-family maps in tf_import.py), so the
reference's own ``model.restore(sess, path)`` (TLSAN/model.py:309-313)
loads it unchanged.  TensorFlow is needed only to WRITE the file.

Usage:
  python -m tlsan_tpu_torch.tools.tf_export --model shan \\
      --ckpt save_shan_beauty            # model_dir (best→latest pointer)
      --out runs/export/save_path/shan   # TF checkpoint prefix
"""

from __future__ import annotations

import argparse
from typing import Any, Tuple

import numpy as np
import torch

from tlsan_tpu_torch.tools.params import _flatten, _unflatten
from tlsan_tpu_torch.tools.tf_import import to_tf_vars, write_tf_checkpoint
from tlsan_tpu_torch.train import checkpoint as ckpt
from tlsan_tpu_torch.train import msgpack


def load_params_raw(path_or_dir: str) -> Tuple[Any, int]:
    """(parameter tree of numpy arrays, step) from a checkpoint file, the
    port's or the JAX package's, or a model_dir (best→latest pointer),
    without model or optimizer templates."""
    path = path_or_dir
    if not path.endswith(".ckpt"):
        resolved = ckpt.best_checkpoint(path_or_dir)
        if resolved is None:
            raise SystemExit(f"[tf_export] no checkpoint under {path_or_dir}")
        path = resolved
    if ckpt.checkpoint_format(path) == "torch":
        payload = torch.load(path, map_location="cpu", weights_only=True)
        flat = {k: v.numpy() for k, v in payload["params"].items()}
    else:
        with open(path, "rb") as f:
            payload = msgpack.loads(f.read())
        flat = _flatten(payload["params"])
    params = _unflatten({k: np.asarray(v) for k, v in flat.items()})
    return params, int(payload.get("step", 0))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="export a port or JAX package checkpoint as a reference "
                    "TF checkpoint")
    p.add_argument("--model", required=True)
    p.add_argument("--ckpt", required=True,
                   help="a .ckpt file or a model_dir (best→latest)")
    p.add_argument("--out", required=True,
                   help="TF checkpoint prefix to write (e.g. save_path/shan)")
    args = p.parse_args(argv)

    params, step = load_params_raw(args.ckpt)
    tf_vars = to_tf_vars(args.model, params)
    path = write_tf_checkpoint(args.out, tf_vars, step=step)
    print(f"[tf_export] wrote {path} ({len(tf_vars)} variables, step {step})")
    return path


if __name__ == "__main__":
    main()
