"""Raw-data ETL: Amazon review JSON → filtered, densely remapped ID space.

Ported from tlsan_tpu/data/remap.py in numpy and the standard library (the
JAX package's walks pandas DataFrames; the card's machine has no pandas):
  - line-dict → column conversion (reference: utils/1_convert_pd.py:8-26)
  - filtering + dense ID remap     (reference: utils/2_remap_id.py:19-101)

A table is a dict of equal-length numpy columns.  `convert_raw_lines` keeps
the columns the remap reads: reviews (reviewerID, asin, unixReviewTime) and
meta (asin, categories), where a meta row's categories is already its last
leaf (``x[-1][-1]``, the one value `remap_ids` takes of it).

The category file is ``Data/<Category>.npz``: int64 columns ``reviewerID``,
``asin`` and ``unixReviewTime`` (in days, sorted by user then day), the meta
columns ``meta_asin`` and ``meta_categories``, ``item_cate_list`` (int32)
and ``counts`` (user, item, cate, example) — no pickle, so it loads with
``allow_pickle=False``.  `load_category` also reads the reference's
``Data/<Category>.pkl`` (DataFrames) where pandas is installed.
"""

from __future__ import annotations

import ast
import multiprocessing
import os
import pickle
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from tlsan_tpu_torch.core.config import DataCounts

Table = Dict[str, np.ndarray]

# Amazon SNAP per-category dump names (reference: utils/0_download_raw.sh:4-47)
CATEGORIES = [
    "Electronics",
    "CDs_and_Vinyl",
    "Clothing_Shoes_and_Jewelry",
    "Digital_Music",
    "Office_Products",
    "Movies_and_TV",
    "Beauty",
    "Home_and_Kitchen",
    "Video_Games",
    "Toys_and_Games",
    # downloaded by the reference script but unused in its experiments
    # (utils/0_download_raw.sh:44-46)
    "Books",
]

SNAP_URL = "http://snap.stanford.edu/data/amazon/productGraph/categoryFiles"

REVIEW_COLUMNS = ("reviewerID", "asin", "unixReviewTime")
META_COLUMNS = ("asin", "categories")


def raw_urls(category: str) -> Tuple[str, str]:
    """(reviews_url, meta_url) for one category (reference: utils/0_download_raw.sh)."""
    return (
        f"{SNAP_URL}/reviews_{category}_5.json.gz",
        f"{SNAP_URL}/meta_{category}.json.gz",
    )


def _parse_reviews(lines: Sequence[str]) -> Tuple[list, list, list]:
    rows = [ast.literal_eval(line) for line in lines if line.strip()]
    return ([r["reviewerID"] for r in rows], [r["asin"] for r in rows],
            [r["unixReviewTime"] for r in rows])


def convert_raw_lines(
    review_lines: Sequence[str], meta_lines: Iterable[str], workers: int = 1
) -> Tuple[Table, Table]:
    """Parse python-dict-per-line dumps into (reviews, meta) columns.

    The reference `eval()`s each line (utils/1_convert_pd.py:10-13); this
    uses ast.literal_eval (safe, same grammar), over `workers` spawned
    processes for the review lines when there are more than one (each
    parses a contiguous share, so the order is the file's).  Meta is
    filtered to reviewed asins, in file order (utils/1_convert_pd.py:19-22).
    """
    if workers > 1:
        step = -(-len(review_lines) // workers)
        shares = [review_lines[i:i + step] for i in range(0, len(review_lines), step)]
        with ProcessPoolExecutor(len(shares),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            parts = list(pool.map(_parse_reviews, shares))
    else:
        parts = [_parse_reviews(review_lines)]
    reviews = {
        "reviewerID": np.array([u for p in parts for u in p[0]]),
        "asin": np.array([a for p in parts for a in p[1]]),
        "unixReviewTime": np.array([t for p in parts for t in p[2]], np.int64),
    }
    reviewed = set(reviews["asin"].tolist())
    metas = [m for m in (ast.literal_eval(line) for line in meta_lines
                         if line.strip()) if m["asin"] in reviewed]
    meta = {
        "asin": np.array([m["asin"] for m in metas]),
        "categories": np.array([m["categories"][-1][-1] for m in metas]),
    }
    return reviews, meta


def _select(table: Table, keep: np.ndarray) -> Table:
    return {k: v[keep] for k, v in table.items()}


def _dense(values: np.ndarray) -> Tuple[int, np.ndarray]:
    """(number of keys, each value's id) of the map that numbers the
    sorted unique keys 0.. (utils/2_remap_id.py:71-80)."""
    keys, ids = np.unique(values, return_inverse=True)
    return len(keys), ids.reshape(-1).astype(np.int64)


def remap_ids(
    reviews: Table,
    meta: Table,
    min_item_interactions: int = 8,
    min_user_interactions: int = 10,
    min_sessions: int = 4,
    max_sessions: int = 90,
) -> Tuple[Table, Table, np.ndarray, DataCounts]:
    """Filter + dense-remap, matching utils/2_remap_id.py semantics.

    - time → days (``//3600//24``, :19)
    - drop users with fewer than `min_user_interactions` rows, then items
      with fewer than `min_item_interactions` (utils/2_remap_id.py:63-64)
    - keep users whose distinct review-day count ("sessions") is in
      [min_sessions, max_sessions] (:40-56)
    - drop, with a warning, rows whose asin has no meta row (it has no
      category), before the id maps are built
    - dense remap via sorted unique keys (:71-80)
    - rows ordered by (user id, day) with a stable sort: same-day rows keep
      their file order
    - item_cate_list[item_id] → cate_id (:94-95)
    """
    rev = {
        "reviewerID": np.asarray(reviews["reviewerID"]),
        "asin": np.asarray(reviews["asin"]),
        "unixReviewTime": np.asarray(reviews["unixReviewTime"]) // 3600 // 24,
    }

    def at_least(col: str, n: int) -> np.ndarray:
        _, inv, counts = np.unique(rev[col], return_inverse=True,
                                   return_counts=True)
        return counts[inv.reshape(-1)] >= n

    rev = _select(rev, at_least("reviewerID", min_user_interactions))
    rev = _select(rev, at_least("asin", min_item_interactions))

    # session-count filter: distinct review days per user in [mins, maxs]
    n_users, uid = _dense(rev["reviewerID"])
    days = rev["unixReviewTime"]
    span = int(days.max() - days.min()) + 1 if len(days) else 1
    user_days = np.unique(uid * span + (days - (days.min() if len(days) else 0)))
    nsess = np.bincount(user_days // span, minlength=n_users)
    rev = _select(rev, ((nsess >= min_sessions) & (nsess <= max_sessions))[uid])

    meta_asin = np.asarray(meta["asin"])
    meta_cate = np.asarray(meta["categories"])
    keep = np.isin(meta_asin, rev["asin"])
    meta_asin, meta_cate = meta_asin[keep], meta_cate[keep]

    unmapped = ~np.isin(rev["asin"], meta_asin)
    if unmapped.any():
        warnings.warn(
            f"dropping {int(unmapped.sum())} review rows whose asin has no "
            f"metadata entry (no category available)")
        rev = _select(rev, ~unmapped)
        keep = np.isin(meta_asin, rev["asin"])
        meta_asin, meta_cate = meta_asin[keep], meta_cate[keep]

    asin_keys = np.unique(meta_asin)
    item_count, meta_ids = _dense(meta_asin)
    cate_count, cate_ids = _dense(meta_cate)
    user_count, user_ids = _dense(rev["reviewerID"])
    counts = DataCounts(user_count=user_count, item_count=item_count,
                        cate_count=cate_count, example_count=len(user_ids))

    order = np.argsort(meta_ids, kind="stable")
    out_meta = {"asin": meta_ids[order], "categories": cate_ids[order]}
    item_ids = np.searchsorted(asin_keys, rev["asin"]).astype(np.int64)
    days = rev["unixReviewTime"].astype(np.int64)
    order = np.lexsort((days, user_ids))
    out_reviews = {"reviewerID": user_ids[order], "asin": item_ids[order],
                   "unixReviewTime": days[order]}
    item_cate_list = out_meta["categories"].astype(np.int32)
    return out_reviews, out_meta, item_cate_list, counts


def savez_atomic(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """`np.savez` of `arrays` to exactly `path`, through a temporary file
    and a rename, so a reader never sees a partial file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:  # a file object: savez adds no suffix
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_category(path: str, reviews: Table, meta: Table,
                  item_cate_list: np.ndarray, counts: DataCounts) -> None:
    """Write the numpy category file (format above); `path` ends in .npz."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the category file is an .npz")
    arrays = {k: np.asarray(reviews[k], np.int64) for k in REVIEW_COLUMNS}
    arrays.update(
        meta_asin=np.asarray(meta["asin"], np.int64),
        meta_categories=np.asarray(meta["categories"], np.int64),
        item_cate_list=np.asarray(item_cate_list, np.int32),
        counts=np.array([counts.user_count, counts.item_count,
                         counts.cate_count, counts.example_count], np.int64))
    savez_atomic(path, arrays)


def _load_pickle(path: str):
    """The reference's pickle stream of three objects, ((reviews_df,
    meta_df), item_cate_list, counts), as columns.  Only load pickles this
    project wrote: unpickling runs code."""
    try:
        import pandas  # noqa: F401  (the pickle holds DataFrames)
    except ImportError:
        raise RuntimeError(
            f"{path} holds pandas DataFrames and pandas is not installed; "
            "convert it where pandas is: python -c \"from "
            "tlsan_tpu_torch.data.remap import load_category, save_category; "
            f"save_category('{os.path.splitext(path)[0]}.npz', "
            f"*load_category('{path}'))\"") from None
    with open(path, "rb") as f:
        reviews_df, meta_df = pickle.load(f)
        item_cate_list = pickle.load(f)
        counts = pickle.load(f)
    reviews = {k: reviews_df[k].to_numpy() for k in REVIEW_COLUMNS}
    meta = {k: meta_df[k].to_numpy() for k in META_COLUMNS}
    return reviews, meta, item_cate_list, counts


def load_category(path: str) -> Tuple[Table, Table, np.ndarray, DataCounts]:
    """Load a category file: the .npz `save_category` writes, or a
    reference pickle (needs pandas).

    Returns (reviews, meta, item_cate_list, DataCounts).
    """
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            reviews = {k: z[k] for k in REVIEW_COLUMNS}
            meta = {"asin": z["meta_asin"], "categories": z["meta_categories"]}
            item_cate_list = z["item_cate_list"]
            counts = z["counts"].tolist()
    else:
        reviews, meta, item_cate_list, counts = _load_pickle(path)
    return (reviews, meta, np.asarray(item_cate_list, dtype=np.int32),
            DataCounts(*(int(c) for c in counts)))


def category_path(data_dir: str, dataset: str) -> str:
    """``<data_dir>/<dataset>.npz``, else the reference's ``.pkl``."""
    for ext in (".npz", ".pkl"):
        path = os.path.join(data_dir, dataset + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {dataset}.npz or {dataset}.pkl under {data_dir}")
