"""Persistent packed-dataset cache.

Ported from tlsan_tpu/data/cache.py.  The reference persists each model's
example set as ``dataset.pkl`` next to the builder
(TLSAN/build_dataset.py:80-84) so training never rebuilds it.  This module
is the framework equivalent for the PACKED form: the static-shape arrays
produced by build+pack are stored as one npz, keyed by

  * a content fingerprint of this package's builder/packer code and the
    native sources (``native/builder.cpp``, ``native/pyrandom.h``) — any
    builder change invalidates every cache entry;
  * the identity of the category file (path, size, mtime);
  * the model family, seed, and every config field that shapes the packing
    (Ls, max_length, lspm_k, paca_max_len).

Cache location: $TLSAN_DATA_CACHE ("0" disables it), else
~/.cache/tlsan_packed (the source Data/ directory may be read-only).
Entries are written atomically and hold no pickle.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np

from tlsan_tpu_torch.core.config import ModelConfig, model_config_from_json
from tlsan_tpu_torch.data.batcher import Batches
from tlsan_tpu_torch.data.remap import savez_atomic

# config fields that change the example set or its packed shapes
SHAPE_FIELDS = ("Ls", "max_length", "lspm_k", "paca_kernel_size",
                "paca_max_len")

_FINGERPRINT: Optional[str] = None


def builder_fingerprint() -> str:
    """Content hash over every source that determines builder/packer output."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        pkg = os.path.dirname(os.path.abspath(__file__))
        repo = os.path.dirname(os.path.dirname(pkg))
        files = [os.path.join(pkg, f)
                 for f in ("builders.py", "batcher.py", "remap.py",
                           "native.py")]
        files += [os.path.join(repo, "native", f)
                  for f in ("builder.cpp", "pyrandom.h")]
        h = hashlib.sha256()
        for p in files:
            if os.path.exists(p):
                with open(p, "rb") as f:
                    h.update(f.read())
        _FINGERPRINT = h.hexdigest()[:16]
    return _FINGERPRINT


def enabled() -> bool:
    return os.environ.get("TLSAN_DATA_CACHE", "") != "0"


def cache_dir() -> str:
    d = os.environ.get("TLSAN_DATA_CACHE", "")
    if d and d != "0":  # "0" disables caching (handled by the caller)
        return d
    return os.path.join(os.path.expanduser("~"), ".cache", "tlsan_packed")


def cache_path(model_name: str, data_path: str, cfg: ModelConfig,
               seed: int) -> str:
    st = os.stat(data_path)
    h = hashlib.sha256()
    h.update(builder_fingerprint().encode())
    h.update(f"{os.path.abspath(data_path)}:{st.st_size}:{st.st_mtime_ns}"
             .encode())
    h.update(f"{model_name}:{seed}".encode())
    for f in SHAPE_FIELDS:
        h.update(f"{f}={getattr(cfg, f)}".encode())
    stem = os.path.splitext(os.path.basename(data_path))[0]
    return os.path.join(cache_dir(),
                        f"{stem}.{model_name}.{h.hexdigest()[:16]}.npz")


def store(path: str, train_b: Batches, test_b: Batches,
          cate_list: np.ndarray, cfg: ModelConfig) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {f"train.{k}": np.asarray(v) for k, v in train_b.arrays.items()}
    payload.update({f"test.{k}": np.asarray(v)
                    for k, v in test_b.arrays.items()})
    payload["cate_list"] = np.asarray(cate_list)
    cfg_json = json.dumps(dataclasses.asdict(cfg))
    payload["cfg_json"] = np.frombuffer(cfg_json.encode(), dtype=np.uint8)
    savez_atomic(path, payload)


def load(path: str) -> Optional[Tuple[Batches, Batches, np.ndarray,
                                      ModelConfig]]:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    train = {k[len("train."):]: v for k, v in arrays.items()
             if k.startswith("train.")}
    test = {k[len("test."):]: v for k, v in arrays.items()
            if k.startswith("test.")}
    cfg = model_config_from_json(
        json.loads(bytes(arrays["cfg_json"]).decode()))
    n_train = len(next(iter(train.values())))
    n_test = len(next(iter(test.values())))
    return (Batches(train, n_train), Batches(test, n_test),
            arrays["cate_list"], cfg)
