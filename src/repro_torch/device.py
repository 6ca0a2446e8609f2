"""Device resolution shared by every entry point of the port.

The port's arithmetic is written for the CUDA device. An entry point
given no ``device`` runs there, and raises when there is none: it never
carries on quietly on the CPU. The CPU is reached only on request
(``device="cpu"``), where each kernel's plain PyTorch version runs.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (RuntimeError without one);
    anything else → ``torch.device(device)`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read after it measures the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
