"""HTTP serving benchmark: single-request latency and batched throughput.

    python -m tlsan_tpu_torch.bench.http --model_dir DIR [--dataset NAME]
        [--data_dir Data] [--batch 128] [--k 10] [--reqs 2000] [--device cpu]

The counterpart of the JAX package's ``scripts/bench_http.py``.  It
starts the port's `serve/http.py` service in this process on an ephemeral
port of 127.0.0.1, against the checkpoint in ``--model_dir`` and the
category file ``<data_dir>/<dataset>.npz``, and measures end to end
(featurize, scoring on the device, JSON) over real HTTP: a warm batch of
``--batch`` requests, 30 single requests (their median latency), then
``--reqs // --batch`` batched POSTs (requests/s).  The requests are those
of bench_http.py, from ``np.random.default_rng(0)``: 3 to 11 events of
random items on sorted random days, for a user below 100 (and below the
model's user count).  The last line is one JSON object with
bench_http.py's keys, ``device`` (the card's name and power limit) in
place of ``backend``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np

from tlsan_tpu_torch.bench.bounds import device_label
from tlsan_tpu_torch.data.remap import category_path, load_category
from tlsan_tpu_torch.serve.http import RecommendService, serve
from tlsan_tpu_torch.serve.recommender import Recommender, resolve_device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--dataset", default="Digital_Music")
    p.add_argument("--data_dir", default="Data")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--reqs", type=int, default=2000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # raise before loading anything
    _, _, cate_list, _ = load_category(category_path(args.data_dir, args.dataset))
    rec = Recommender.from_model_dir(args.model_dir, cate_list, device=device,
                                     k=args.k, batch_size=args.batch)
    service = RecommendService(rec, rec.cfg.model, rec.cfg, cate_list)
    httpd = serve(service, port=0, host="127.0.0.1")
    stop = threading.Event()
    threads = [threading.Thread(target=httpd.serve_forever, daemon=True),
               service.start_worker_thread(stop)]
    threads[0].start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/recommend"

    rng = np.random.default_rng(0)
    items, users = len(cate_list), min(100, rec.cfg.user_count)

    def mk_req():
        n = int(rng.integers(3, 12))
        days = np.sort(rng.integers(1, 2000, n))
        return {"user": int(rng.integers(0, users)),
                "events": [[int(rng.integers(0, items)), int(d)] for d in days]}

    def post(payload):
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        post({"requests": [mk_req() for _ in range(args.batch)]})  # warm
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            post(mk_req())
            lat.append(time.perf_counter() - t0)
        lat_ms = sorted(lat)[len(lat) // 2] * 1e3

        n_batches = max(1, args.reqs // args.batch)
        batches = [{"requests": [mk_req() for _ in range(args.batch)]}
                   for _ in range(n_batches)]
        t0 = time.perf_counter()
        for b in batches:
            post(b)
        dt = time.perf_counter() - t0
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()
        for t in threads:
            t.join(timeout=30)
    line = {"metric": "serve_http_requests_per_sec",
            "value": round(n_batches * args.batch / dt, 1), "unit": "requests/s",
            "p50_single_request_ms": round(lat_ms, 2),
            "batch": args.batch, "k": args.k, "catalog": items,
            "device": device_label(device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
