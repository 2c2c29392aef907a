"""Data-pipeline CLI — download / convert / remap.

Ported from tlsan_tpu/data/cli.py, with numpy files where the JAX
package's writes pickles of DataFrames.  Replaces the reference's utils/
scripts (`0_download_raw.sh`, `1_convert_pd*.py` ×11, `2_remap_id.py`) with
one entry point:

  python -m tlsan_tpu_torch.data.cli download --category Digital_Music --out raw/
  python -m tlsan_tpu_torch.data.cli convert  --reviews raw/reviews_Digital_Music_5.json.gz \
      --meta raw/meta_Digital_Music.json.gz --out raw/
  python -m tlsan_tpu_torch.data.cli remap    --reviews raw/reviews.npz \
      --meta raw/meta.npz --out Data/Digital_Music.npz

`convert` writes ``reviews.npz`` and ``meta.npz`` (unicode and int
columns, no pickle); `remap` writes the category file every model's
builder reads (format: data/remap.py).
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import urllib.request

import numpy as np

from tlsan_tpu_torch.data.remap import (
    CATEGORIES,
    SNAP_URL,
    convert_raw_lines,
    raw_urls,
    remap_ids,
    save_category,
    savez_atomic,
)

PARSE_SHARE = 100_000  # review lines a parsing process takes at least


def cmd_download(args):
    os.makedirs(args.out, exist_ok=True)
    rev_url, meta_url = raw_urls(args.category)
    if args.base_url:
        # mirror / local fixture override (also how the zero-egress tests
        # exercise this path end-to-end with file:// URLs)
        rev_url = rev_url.replace(SNAP_URL, args.base_url.rstrip("/"))
        meta_url = meta_url.replace(SNAP_URL, args.base_url.rstrip("/"))
    for url in (rev_url, meta_url):
        dest = os.path.join(args.out, os.path.basename(url))
        if os.path.exists(dest) or os.path.exists(dest[:-3]):
            print(f"skip {dest} (exists)")
            continue
        print(f"fetching {url} ...", flush=True)
        try:
            urllib.request.urlretrieve(url, dest)
        except OSError as e:
            print(f"download failed ({e}); this environment may have no "
                  f"network egress — fetch manually and re-run convert",
                  file=sys.stderr)
            return 1
    return 0


def _open_lines(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _load_table(path: str):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def cmd_convert(args):
    with _open_lines(args.reviews) as f:
        review_lines = f.readlines()
    with _open_lines(args.meta) as f:
        meta_lines = f.readlines()
    # spawned parsers pay for their start above some 100k lines
    workers = min(os.cpu_count() or 1, len(review_lines) // PARSE_SHARE + 1)
    reviews, meta = convert_raw_lines(review_lines, meta_lines, workers)
    os.makedirs(args.out, exist_ok=True)
    savez_atomic(os.path.join(args.out, "reviews.npz"), reviews)
    savez_atomic(os.path.join(args.out, "meta.npz"), meta)
    print(f"converted: {len(reviews['asin'])} reviews, "
          f"{len(meta['asin'])} meta rows")
    return 0


def cmd_remap(args):
    reviews, meta, item_cate_list, counts = remap_ids(
        _load_table(args.reviews), _load_table(args.meta),
        min_item_interactions=args.min_item,
        min_user_interactions=args.min_user,
        min_sessions=args.min_sessions,
        max_sessions=args.max_sessions,
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_category(args.out, reviews, meta, item_cate_list, counts)
    print(f"user_count: {counts.user_count}\titem_count: {counts.item_count}\t"
          f"cate_count: {counts.cate_count}\texample_count: {counts.example_count}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("download", help="fetch raw Amazon SNAP dumps")
    d.add_argument("--category", choices=CATEGORIES, required=True)
    d.add_argument("--out", default="raw_data")
    d.add_argument("--base_url", default=None,
                   help="mirror/fixture base replacing the SNAP host "
                        "(file:///... works)")
    d.set_defaults(fn=cmd_download)

    c = sub.add_parser("convert", help="JSON-lines → reviews.npz/meta.npz")
    c.add_argument("--reviews", required=True)
    c.add_argument("--meta", required=True)
    c.add_argument("--out", default="raw_data")
    c.set_defaults(fn=cmd_convert)

    r = sub.add_parser("remap", help="filter + dense-remap → Data/<Cat>.npz")
    r.add_argument("--reviews", required=True)
    r.add_argument("--meta", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--min_item", type=int, default=8)
    r.add_argument("--min_user", type=int, default=10)
    r.add_argument("--min_sessions", type=int, default=4)
    r.add_argument("--max_sessions", type=int, default=90)
    r.set_defaults(fn=cmd_remap)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
