"""Device selection for the port's entry points.

Every entry point takes an explicit `device`, "cuda" by default.  Asking for
the card where there is none raises: the port never falls back to the CPU
on its own.  Tests and CPU runs pass `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
