"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The GPU unless the caller names another device. There is no
    fallback: without CUDA the default (or a CUDA device named) raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sirius_tpu_torch runs on the GPU by default and CUDA is not "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host clock read after it covers that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
