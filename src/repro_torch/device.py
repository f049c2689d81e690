"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never the CPU in place of a card that is missing."""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={name!r}: the port runs on 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} was asked for but torch sees no CUDA device; "
            f"pass device='cpu' to run the plain versions on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
