"""Device resolution for the port's entry points.

Every entry point takes ``device=`` (default ``"cuda"``). A CUDA request on
a machine without a CUDA device raises: the port never quietly runs on the
CPU. The CPU is used only when the caller names it, and the ``meta``
device (shapes without storage) only by the dry run.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises if it cannot be used."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: a CUDA device was requested (the default) but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu' (or 'meta' "
                         f"for the dry run's shapes), got {dev}")
    return dev


def check_device(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless tensor ``t`` lies on ``device`` (type and index)."""
    d = t.device
    same = d.type == device.type and (
        device.index is None or d.index is None or d.index == device.index)
    if not same:
        raise ValueError(f"{what} lies on {d}, expected {device}")
