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

from ..kernels._index import device_index

__all__ = ["resolve_device", "check_payload", "index_tensor", "kernel_index",
           "is_fake"]


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


def kernel_index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A setup-time index list as the int32 device tensor the kernels take,
    bounds-checked now so that every later launch skips the check."""
    a = np.asarray(a, dtype=np.int64)
    if a.size and (a.min() < -2 ** 31 or a.max() >= 2 ** 31):
        raise ValueError("index list does not fit in int32")
    t = torch.as_tensor(a.astype(np.int32), device=device)
    device_index(t, device)
    return t


def is_fake(t) -> bool:
    """True for a ``FakeTensor`` (the dry run's tensors: shapes, dtypes and
    devices without data)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)
