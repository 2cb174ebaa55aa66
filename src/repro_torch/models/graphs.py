"""Captured CUDA graphs for the models' recurrences: hymba's SSM scan
(``models.ssm``) and xlstm's checkpointed cell chunks (``models.xlstm``)
replay a fixed run of small operations on static buffers, one host launch
where there were hundreds.  Off the card the same protocol runs with the
operations launched one by one (:class:`Eager`), so the buffers' copies,
padding and read-back are exercised by the CPU tests."""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["Eager", "capture"]


class Eager:
    """A stand-in for a captured graph off the card: ``replay()`` runs the
    operations one by one."""

    def __init__(self, run: Callable[[], None]):
        self.replay = run


def capture(run: Callable[[], None], device: torch.device,
            warm: Optional[Callable[[], None]] = None):
    """``warm()`` (default ``run()``) once, then ``run()`` captured as a CUDA
    graph on a CUDA device (warmed on a side stream; a capture that fails
    raises), else an :class:`Eager` of ``run``."""
    warm = warm or run
    if device.type != "cuda":
        warm()
        return Eager(run)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return graph
