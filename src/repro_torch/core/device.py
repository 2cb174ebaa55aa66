"""Where the port runs: device resolution and payload checks.

Every entry point (``SFComm``, ``ParCSR``) runs on the card unless the
caller asks for the CPU with ``device="cpu"``.  Without a CUDA device and
without that request, :func:`resolve_device` raises: nothing carries on
quietly on the CPU.  A payload on another device than the one an object
was built for raises as well; nothing is moved silently.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "check_payload", "index_tensor"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; a CUDA request without a
    card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_payload(t, device: torch.device, what: str) -> torch.Tensor:
    """Raise unless ``t`` is a tensor on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor on {device}, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device} but this object runs on "
                         f"{device}; move it there explicitly")
    return t


def index_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A setup-time index array as an int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
