"""Device and dtype selection.

Every entry point of the port runs on the card unless the caller asks
for the CPU: `device=None` means "cuda", and asking for "cuda" on a
machine without a usable card raises. Nothing falls back to the CPU
silently; the tests and the CPU tools pass `device="cpu"`. The reference
decks are double precision, so f64 is the default; f32 is an option.
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "resolve_dtype", "free_bytes"]


def resolve_device(device=None) -> torch.device:
    """torch.device for `device` (None: "cuda"). Raises if "cuda" is
    asked for, or implied, and no card is usable."""
    dev = torch.device("cuda" if device is None else device)
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


def free_bytes(device) -> int:
    """The memory a computation on `device` can still take: the card's
    free bytes plus what PyTorch's allocator holds unused, or the host's
    available pages."""
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return free + torch.cuda.memory_reserved(dev) \
            - torch.cuda.memory_allocated(dev)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
