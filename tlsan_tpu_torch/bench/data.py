"""The packed TLSAN train set the benchmarks run on, and its configs.

The counterpart of ``bench.py:27-43`` (`load_packed`) and ``:75-83``: the
train arrays are cached as ``.bench_cache_<dataset>.npz`` (the same file
and format as bench.py's: ``cate_list`` beside the packed arrays ``u, i,
y, c, hist_i, hist_t, hist_i_new, sl, sl_new``).  The repository tracks
``.bench_cache_Digital_Music.npz``.  Without the file the set is built
with the port's own `train/cli.py::prepare` from the category file
``<data_dir>/<dataset>.npz`` and written.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig


def cache_path(dataset: str) -> str:
    """The cache's path, in the working directory as bench.py's."""
    return f".bench_cache_{dataset}.npz"


def load_packed(dataset: str, data_dir: str) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """(the packed train arrays, cate_list), from the cache or built and
    cached."""
    cache = cache_path(dataset)
    if os.path.exists(cache):
        with np.load(cache) as z:
            return {k: z[k] for k in z.files if k != "cate_list"}, z["cate_list"]

    # imported here: the Trainer's stack is only needed to build the set
    from tlsan_tpu_torch.train.cli import prepare

    prep = prepare("tlsan", os.path.join(data_dir, f"{dataset}.npz"),
                   ModelConfig(model="tlsan"), use_cache=False)
    np.savez(cache, cate_list=prep.cate_list, **prep.train.arrays)
    return prep.train.arrays, prep.cate_list


def counts(arrays: Dict[str, np.ndarray], cate_list: np.ndarray) -> Dict[str, int]:
    """The vocab sizes bench.py derives from the set (``bench.py:75-79``)."""
    return dict(user_count=int(arrays["u"].max()) + 1,
                item_count=len(cate_list),
                cate_count=int(cate_list.max()) + 1)


def configs(arrays: Dict[str, np.ndarray], cate_list: np.ndarray,
            batch: int, steps_per_call: int,
            **train) -> Tuple[ModelConfig, TrainConfig]:
    """bench.py's ModelConfig (TLSAN at the set's Ls, Ts and counts) and
    TrainConfig (``bench.py:80-83``), with `train`'s other fields."""
    cfg = ModelConfig(model="tlsan", Ls=arrays["hist_i"].shape[1],
                      Ts=arrays["hist_i_new"].shape[1],
                      **counts(arrays, cate_list))
    tc = TrainConfig(steps_per_call=steps_per_call, train_batch_size=batch,
                     **train)
    return cfg, tc
