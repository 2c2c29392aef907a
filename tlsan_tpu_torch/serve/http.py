"""HTTP serving endpoint — live top-k recommendations over HTTP.

  python -m tlsan_tpu_torch.serve.http --model_dir save_tlsan_Digital_Music \
      --dataset Digital_Music --data_dir Data --port 8080 [--device cpu]

Ported from tlsan_tpu/serve/http.py; it runs on CUDA unless ``--device cpu``
is given.  The category file is ``<data_dir>/<dataset>.npz`` (else the
reference's ``.pkl``, which needs pandas; data/remap.py).

Endpoints:
  GET  /healthz        → {"status": "ok", model/catalog info}
  POST /v1/recommend   → body: {"requests": [{"user": int?,
                           "events": [[item_id, day], ...], "now": day?},
                           ...], "k": int?}
                         (or a single request object at the top level)
                         → {"results": [{"items": [...], "scores": [...]}]}

Raw events are featurized online with the exact offline feature code
(serve/featurize.py), scored by the full-catalog Recommender
(serve/recommender.py), and the top-k ids returned.  Stdlib-only
(http.server); all device work runs on one executor thread.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from tlsan_tpu_torch.data.remap import category_path, load_category
from tlsan_tpu_torch.serve.featurize import featurize_many
from tlsan_tpu_torch.serve.recommender import Recommender, resolve_device


class RecommendService:
    """Featurize → score → top-k.

    ALL device work runs on ONE executor loop (HTTP handler threads
    enqueue and wait), so batches reach the device one at a time.  The CLI
    runs the HTTP server in a background thread and `run_worker()` on
    main; tests and embedders use `start_worker_thread()`."""

    def __init__(self, rec, model_name: str, cfg, cate_list):
        self.rec = rec
        self.model_name = model_name
        self.cfg = cfg
        self.cate_list = np.asarray(cate_list)
        self._q: "queue.Queue" = queue.Queue()

    def run_worker(self, stop: Optional[threading.Event] = None):
        """Blocking executor loop, until `stop` is set."""
        while stop is None or not stop.is_set():
            try:
                batch, box, done = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                box.append(self.rec.recommend(batch))
            except Exception as e:  # surfaced to the waiting handler
                box.append(e)
            done.set()

    def start_worker_thread(self, stop: Optional[threading.Event] = None):
        t = threading.Thread(target=self.run_worker, args=(stop,), daemon=True)
        t.start()
        return t

    def info(self):
        return {"status": "ok", "model": self.model_name,
                "catalog_items": int(len(self.cate_list)),
                "k": int(self.rec.k)}

    def recommend(self, requests, k: Optional[int] = None):
        batch = featurize_many(self.model_name, self.cfg, requests,
                               cate_list=self.cate_list)
        box: list = []
        done = threading.Event()
        self._q.put((batch, box, done))
        done.wait()
        if isinstance(box[0], Exception):
            raise box[0]
        ids, scores = box[0]
        k = min(k or self.rec.k, ids.shape[1])
        return [{"items": ids[r, :k].tolist(),
                 "scores": [round(float(s), 4) for s in scores[r, :k]]}
                for r in range(len(ids))]


def make_handler(service: RecommendService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._send(200, service.info())
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/recommend":
                return self._send(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                reqs = body.get("requests")
                if reqs is None:  # single-request shorthand
                    reqs = [body]
                results = service.recommend(reqs, k=body.get("k"))
                return self._send(200, {"results": results})
            except (ValueError, KeyError, AssertionError, TypeError,
                    IndexError) as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:  # a device or model fault: report, keep serving
                traceback.print_exc()
                return self._send(500, {"error": repr(e)})

    return Handler


def serve(service: RecommendService, port: int = 8080, host: str = "0.0.0.0"):
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    return httpd


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--model", default=None, help="default: config sidecar")
    p.add_argument("--dataset", default="Digital_Music")
    p.add_argument("--data_dir", default="Data")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--exclude_history", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # raise before loading anything
    _, _, cate_list, _ = load_category(category_path(args.data_dir, args.dataset))
    rec = Recommender.from_model_dir(
        args.model_dir, cate_list, args.model, device=device, k=args.k,
        batch_size=args.batch, exclude_history=args.exclude_history)
    service = RecommendService(rec, args.model or rec.cfg.model, rec.cfg,
                               cate_list)
    httpd = serve(service, args.port, args.host)
    print(f"serving {service.info()} on {args.host}:{args.port}", flush=True)
    # HTTP accept loop in the background; the device executor on this thread
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        service.run_worker()
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()
