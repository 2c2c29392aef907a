"""The PyTorch port imports torch, numpy and the standard library only.

A subprocess imports every module of tlsan_tpu_torch and chip_smoke.py (a
subprocess, because this test process has JAX loaded by conftest.py) and
lists what got loaded: no jax, flax, optax, msgpack, tensorflow, pandas or
tlsan_tpu module may be among them.  The migration tools (tools/tf_import.py,
tools/tf_export.py) import TensorFlow only inside the functions that read or
write a TF checkpoint, and the JAX checkpoint reader (train/msgpack.py) is
the port's own.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import tlsan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tlsan_tpu_torch.__path__,
                                               "tlsan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print(json.dumps({"imported": names,
                  "preloaded": sorted(before),
                  "loaded": sorted(set(sys.modules) - before)}))
"""

BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "tensorflow", "pandas",
          "tlsan_tpu")


def test_port_imports_no_jax_pandas_or_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in report["preloaded"] if m.split(".")[0] in BANNED]
    bad = [m for m in report["loaded"] if m.split(".")[0] in BANNED]
    assert not bad, bad
    # every module of the slice was imported
    for name in ("serve.http", "serve.recommender", "ops.cuda.fwa",
                 "tools.params", "train.checkpoint", "data.remap",
                 "train.loop", "train.state", "train.evaluate",
                 "train.metrics", "train.tensorboard", "nn.layers",
                 "data.batcher", "ops.multihead_attention", "ops.cuda.mha",
                 "models.atrank", "parallel.mesh", "parallel.multihost",
                 "parallel.api", "parallel.sharded_embedding",
                 "parallel.topk", "parallel.programs", "data.builders",
                 "data.native", "data.cache", "data.cli", "train.cli",
                 "serve.cli", "tools.snap_fixture", "train.ensemble",
                 "train.msgpack", "tools.tf_import", "tools.tf_export",
                 "bench.data", "bench.bounds", "bench.train", "bench.kernels",
                 "bench.roofline", "bench.http"):
        assert f"tlsan_tpu_torch.{name}" in report["imported"]
