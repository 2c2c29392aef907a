"""Reader of a preprocessed category pickle (reference Data/<Category>.pkl).

A copy of ``load_category`` from tlsan_tpu/data/remap.py.  The pickle holds
pandas DataFrames, so reading a real dataset needs pandas installed; this
module does not import it itself.
"""

from __future__ import annotations

import pickle

import numpy as np

from tlsan_tpu_torch.core.config import DataCounts


def load_category(path: str):
    """Load a preprocessed category pickle: a stream of three objects,
    ((reviews_df, meta_df), item_cate_list, (user, item, cate, example
    counts)).  Only load pickles this project wrote: unpickling runs code.

    Returns (reviews_df, meta_df, item_cate_list, DataCounts).
    """
    with open(path, "rb") as f:
        reviews_df, meta_df = pickle.load(f)
        item_cate_list = pickle.load(f)
        user_count, item_count, cate_count, example_count = pickle.load(f)
    return (
        reviews_df,
        meta_df,
        np.asarray(item_cate_list, dtype=np.int32),
        DataCounts(user_count, item_count, cate_count, example_count),
    )
