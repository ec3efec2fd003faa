"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
card and no explicit ``"cpu"`` they raise instead of carrying on quietly on
the host.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` / ``"cuda"`` -> the current card (raises without one);
    ``"cpu"`` -> the host (the CPU tests' choice)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
