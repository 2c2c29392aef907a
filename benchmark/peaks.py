"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name`` gives.

NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense rates): 3.35 TB/s of HBM3,
67 TFLOP/s in float32 outside the tensor cores (the configurations state
float32 with TF32 off), at the full 700 W power limit.
"""

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def peaks(device_name: str) -> Optional[dict]:
    """The card's peaks, or None for a card the table does not hold (the
    metrics that need them are then left out)."""
    return PEAKS.get(device_name)


def bound_s(nbytes: float, ops: float, p: dict) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the f32 peak."""
    return max(nbytes / p["hbm_bytes_per_s"], ops / p["f32_flops_per_s"])
