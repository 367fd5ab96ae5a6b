"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
Asking for the card where there is none raises: nothing carries on quietly
on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """-> torch.device, raising when a CUDA device is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev
