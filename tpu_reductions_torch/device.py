"""Device resolution: the card unless the caller asks for the CPU.

With no CUDA device and no explicit CPU request, `resolve` raises; the
port never drops quietly to the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_reductions_torch.config import PLATFORMS


def resolve(platform: str = "gpu", index: Optional[int] = None
            ) -> torch.device:
    """`cuda` / `cuda:<index>` for platform gpu, `cpu` on request."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "gpu":
        raise ValueError(f"platform must be one of {PLATFORMS}, "
                         f"got {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "--platform=cpu (or device='cpu') to run on "
                           "the CPU")
    return torch.device("cuda" if index is None else f"cuda:{index}")


def count(platform: str) -> int:
    """Number of devices of the platform (the CPU counts as one)."""
    if platform == "cpu":
        return 1
    return torch.cuda.device_count()


def name(device: torch.device) -> str:
    """`torch.cuda.get_device_name()` of a card, `cpu` for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU, which runs
    eagerly)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
