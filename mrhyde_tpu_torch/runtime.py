"""Device and dtype selection.

Every entry point of the port takes an explicit `device` and `dtype`.
The reference decks are double precision, so f64 is the default; f32 is
an option. Asking for "cuda" on a machine without a usable card raises:
nothing falls back to the CPU silently.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_dtype"]

def resolve_device(device=None) -> torch.device:
    """torch.device for `device` (None: "cuda" when a card is present,
    else "cpu"). Raises if "cuda" is asked for and unavailable."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """torch.float64 (default) or torch.float32."""
    if dtype is None:
        return torch.float64
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype!r}")
    return dtype
