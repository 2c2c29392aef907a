"""Observability: JSONL metric stream + stdout, and training-curve dumps.

Replaces the reference's TensorBoard FileWriters (TLSAN/model.py:17-19,
:174-183) and `(time_line, auc_value)` curve pickles (BPR/train.py:96-97;
TLSAN's own dump at TLSAN/train.py:256-258 is dead code) with an append-only
JSONL stream — one object per event with wall-clock, global step, and the
metric dict — plus, matching the reference's on-disk contract, real
`events.out.tfevents.*` files under `model_dir/train` and `model_dir/eval`
(scalar summaries, stock-TensorBoard readable; see train/tensorboard.py).

A copy of tlsan_tpu/train/metrics.py.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from tlsan_tpu_torch.train.tensorboard import TBEventWriter


class MetricWriter:
    def __init__(self, model_dir: str, name: str = "metrics",
                 echo: bool = True, tensorboard: bool = True):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self.echo = echo
        self.t0 = time.time()
        # two sub-writers like the reference (TLSAN/model.py:17-19):
        # kind "train"/"epoch" → train/, everything else → eval/
        self._tb: Dict[str, TBEventWriter] = {}
        self._tensorboard = tensorboard
        self._model_dir = model_dir

    def _tb_writer(self, kind: str) -> Optional[TBEventWriter]:
        if not self._tensorboard:
            return None
        sub = "train" if kind in ("train", "epoch") else "eval"
        if sub not in self._tb:
            self._tb[sub] = TBEventWriter(os.path.join(self._model_dir, sub))
        return self._tb[sub]

    def write(self, kind: str, step: int, metrics: Dict[str, float]) -> None:
        rec = {
            "kind": kind,
            "step": int(step),
            "wall_s": round(time.time() - self.t0, 3),
            **{k: (float(v) if isinstance(v, (int, float)) else v)
               for k, v in metrics.items()},
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        tb = self._tb_writer(kind)
        if tb is not None:
            tb.add_scalars(step, metrics)
        if self.echo:
            body = ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in metrics.items())
            print(f"[{kind}] step={step} {body}", flush=True)

    def write_histograms(self, step: int, histos: Dict,
                         scalars: Optional[Dict[str, float]] = None) -> None:
        """Histogram summaries (+ companion scalars) to the train event file
        only — the reference's train_summary set (TLSAN/model.py:173-183);
        digests per tensorboard.TBEventWriter.add_histograms."""
        tb = self._tb_writer("train")
        if tb is None:
            return
        tb.add_histograms(step, histos)
        if scalars:
            tb.add_scalars(step, scalars)

    def close(self) -> None:
        self._f.close()
        for tb in self._tb.values():
            tb.close()
