"""The device an entry point runs on: named by the caller, never guessed."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in ("cuda"
    -> the current CUDA device); raises when CUDA is asked for and this
    process has none (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A copy of host array ``a`` as a tensor on ``device``. To a CUDA
    device it goes through pinned memory with ``non_blocking=True``: a copy
    from pageable memory would block the host until the stream drains, and
    the engine's async tick and the control plane's stream rely on the host
    running ahead of the card. The copy is C-contiguous whatever ``a``'s
    layout (the kernels take contiguous inputs)."""
    t = torch.from_numpy(np.array(a, order="C"))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t
