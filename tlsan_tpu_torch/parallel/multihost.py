"""Process-group bring-up, the batch rows of a rank, and a local launcher.

Ported from tlsan_tpu/parallel/multihost.py.  The JAX package scales past
one host with ``jax.distributed.initialize`` and one controller a host;
torch has one process a rank, so `init_distributed` joins this process to
the world, with the backend named by the caller: NCCL for one card a rank,
Gloo for ranks that share a card (or run on the CPU).  Nothing picks a
backend or a device on its own.

`run_local` starts a whole world on this machine, one spawned process a
rank, runs a function on every rank and returns each rank's result; the
mesh tests and chip_smoke.py use it.  A rank that fails, or a world that
outlives its time limit, fails the call and every rank is stopped.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from tlsan_tpu_torch.parallel.mesh import Mesh, make_mesh


def init_distributed(backend: str, init_method: Optional[str],
                     world_size: int, rank: int,
                     timeout_s: float = 600.0) -> int:
    """Join the default process group; returns the world size.  A world of
    one process needs no group: a no-op."""
    if world_size <= 1:
        return 1
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return dist.get_world_size()


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """The rows of a globally indexed batch that this rank's dp index
    holds: [d·B/dp, (d+1)·B/dp); the mp ranks of one dp index hold the
    same rows."""
    if global_batch % mesh.dp:
        raise ValueError(f"global batch {global_batch} must divide evenly "
                         f"over dp={mesh.dp}")
    per = global_batch // mesh.dp
    return slice(mesh.d * per, (mesh.d + 1) * per)


def rank_device(device: str, rank: int) -> torch.device:
    """`device` for every rank ("cpu", or "cuda:N": ranks share card N),
    or, for "cuda", card `rank`: one card a rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _rank_main(rank, dp, mp, backend, device, init_method, timeout_s, fn,
               args, kwargs, results) -> None:
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # ranks share the host's cores
            torch.set_num_threads(1)
        init_distributed(backend, init_method, dp * mp, rank, timeout_s)
        out = fn(make_mesh(dp, mp, dev), *args, **kwargs)
        results.put((rank, True, out))
    except Exception:  # the boundary: report, and the parent stops the world
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn: Callable[..., Any], dp: int, mp: int, backend: str,
              device: str, timeout_s: float, *args,
              init_method: Optional[str] = None, **kwargs) -> List[Any]:
    """Run ``fn(mesh, *args, **kwargs)`` on every rank of a dp·mp world of
    spawned processes on this machine; returns the results by rank.

    `fn` must be importable by the children (a module-level function), and
    its arguments and result picklable.  `backend` is "gloo" or "nccl";
    `device` as `rank_device` reads it; NCCL needs a card a rank.  The
    rendezvous is a file in a fresh temporary directory unless
    `init_method` names one.  Raises RuntimeError, after stopping every
    rank, if a rank raises, dies, or the world runs past `timeout_s`."""
    world = dp * mp
    if backend == "nccl" and torch.device(device).index is not None:
        raise ValueError("NCCL takes one card a rank (device='cuda'); ranks "
                         "that share a card run over gloo")
    ctx = multiprocessing.get_context("spawn")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="tlsan_mesh_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, dp, mp, backend, device, init_method,
                               timeout_s, fn, args, kwargs, results))
             for rank in range(world)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"mesh {dp}x{mp}: ranks {sorted(set(range(world)) - set(out))} "
                    f"did not finish within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"mesh {dp}x{mp}: ranks {dead} exited "
                        f"({[procs[r].exitcode for r in dead]}) without a result")
                continue
            if not ok:
                raise RuntimeError(f"mesh {dp}x{mp}: rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
