"""Build the CUDA sources under ``csrc/`` into plain C-ABI shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``_build/<name>-<hash>.so``, where the hash covers the source, the
headers under ``csrc/`` and the flags, and is loaded with ``ctypes``.  A
library is built at its first use; `build` starts one ``nvcc`` per source,
all at once.  The build reads only
the package's own sources and needs the CUDA toolkit (``$CUDA_HOME`` or
``/usr/local/cuda``, else ``nvcc`` on ``PATH``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the kernels hold f32 parity with the plain versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives.  The hash
    covers every header under ``csrc/`` too, since a source may include
    any of them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Build every library in `names` that is not built yet, one ``nvcc``
    per source, all started together.  Returns each new build's compiler
    report (registers, shared memory, spills); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{report}")
            continue
        os.replace(tmp, out)
        reports[name] = report
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
