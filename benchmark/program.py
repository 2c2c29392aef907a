"""The benchmark's one door into the system under test, `tlsan_tpu_torch`:
its model and train configs, the CUDA libraries' build (into the
checkout's own `tlsan_tpu_torch/_build/`, so only a checkout's first run
builds), the weights put into its parameters, and its launch counters.
Nothing here is used by the references."""

from __future__ import annotations

from typing import Dict

import torch

LIBRARIES = ("fwa_fwd", "fwa_bwd", "mha_fwd", "mha_bwd")


def build(device) -> None:
    """Build every CUDA library the cells use, one nvcc each in parallel
    (a no-op once built)."""
    if device.type == "cuda":
        from tlsan_tpu_torch.ops.cuda import build as cuda_build
        cuda_build.build(LIBRARIES)


def model_config(config: dict):
    from tlsan_tpu_torch.core.config import ModelConfig
    cat = config["catalog"]
    return ModelConfig(model=config["family"], user_count=cat["users"],
                       item_count=cat["items"], cate_count=cat["cates"],
                       **config["model"])


def model_class(config: dict):
    from tlsan_tpu_torch.models import get_model
    return get_model(config["family"])


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the model's parameters, name for
    name; raises where the two sets of names differ."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: program only {sorted(set(params) - set(weights))}, "
                         f"benchmark only {sorted(set(weights) - set(params))}")
    for name, p in params.items():
        p.copy_(weights[name])


def counters() -> Dict[str, int]:
    """The CUDA kernels' launch counters (calls of K1, K2, K3, K3b)."""
    from tlsan_tpu_torch.ops.cuda import fwa, mha
    return {"fwa": fwa.launches, "fwa_bwd": fwa.bwd_launches,
            "mha": mha.launches, "mha_bwd": mha.bwd_launches}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
