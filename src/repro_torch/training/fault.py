"""Fault tolerance: restartable training loop + straggler detection (the
port of ``repro/training/fault.py``).

Synchronous data-parallel training fails loudly (a dead host kills the
program), so the recovery loop is: detect -> restart from the newest
complete checkpoint -> resume the deterministic data stream at the restored
step, possibly on a different device count (elastic — checkpoints hold
whole tensors, ``training/checkpoint.py``).

``run_with_restarts`` implements that loop in-process, treating any
exception from the step function (or an injected ``SimulatedFailure``) as a
node failure.  ``StragglerDetector`` does z-score outlier detection on step
wall-times; on a real fleet its signal feeds the scheduler's
checkpoint-and-exclude flow, here it is surfaced in metrics and unit-tested.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import sflog
from .checkpoint import CheckpointManager

__all__ = ["SimulatedFailure", "StragglerDetector", "run_with_restarts"]


class SimulatedFailure(RuntimeError):
    """Injected node failure for fault-tolerance tests."""


@dataclasses.dataclass
class StragglerDetector:
    """Flags steps whose duration is a z-score outlier vs a trailing window.

    On a multi-host fleet each host reports its step time; a persistent
    outlier host is a straggler candidate for exclusion at the next restart.

    The z-score denominator is floored at ``max(min_rel_sd * mean,
    min_abs_sd)``: a cold-start burst of near-identical step times yields
    sd ≈ 0, and a bare epsilon would flag the very next *normal* step as a
    straggler (any deviation divided by 1e-9 clears any threshold).  The
    relative floor says "a step is never an outlier unless it deviates by
    at least ``z_threshold * min_rel_sd`` of the typical step time".
    """
    window: int = 50
    z_threshold: float = 4.0
    min_rel_sd: float = 0.05     # sd floor as a fraction of the window mean
    min_abs_sd: float = 1e-6     # absolute sd floor, seconds
    _times: List[float] = dataclasses.field(default_factory=list)

    def observe(self, dt: float) -> bool:
        hist = self._times[-self.window:]
        self._times.append(dt)
        if len(hist) < 10:
            return False
        mu = float(np.mean(hist))
        sd = max(float(np.std(hist)), self.min_rel_sd * abs(mu),
                 self.min_abs_sd)
        return (dt - mu) / sd > self.z_threshold

    @property
    def history(self) -> List[float]:
        return list(self._times)


def run_with_restarts(step_fn: Callable[[int, Dict], Dict],
                      state: Dict,
                      ckpt: CheckpointManager,
                      *,
                      total_steps: int,
                      max_restarts: int = 3,
                      on_restore: Optional[Callable[[Dict], Dict]] = None,
                      elastic_worlds: Optional[List[int]] = None,
                      comm_metrics: Optional[Callable[[], Dict]] = None,
                      ) -> Dict:
    """Run ``step_fn(step, state) -> state`` with checkpoint/restart.

    On an exception: reload the newest complete checkpoint (state template =
    current state tree), call ``on_restore`` (e.g. to re-establish
    shardings), and continue from the restored step.  Raises after
    ``max_restarts`` failures — matching fleet policy where repeated crashes
    need human eyes.

    **Elastic shrink/grow:** ``elastic_worlds[r-1]`` (last entry repeating)
    is written into ``state["world"]`` before ``on_restore`` at the r-th
    restart — the fleet handing the restarted job a different device count.
    ``on_restore`` is where the job rebuilds its step function for the new
    world; with the DDP layer that re-derives the bucket SF plans through
    :func:`repro_torch.training.ddp.ddp_plan_cache` (a cache *miss* for an unseen
    world, a *hit* for a revisited one).

    **Comm metrics:** when ``comm_metrics`` is given (e.g.
    ``reducer.metrics``), its dict is snapshotted into
    ``state["comm_metrics"]`` after every successful step — surfacing the
    plan-cache hit/miss counters alongside the training metrics.
    """
    detector = StragglerDetector()
    restarts = 0
    step = int(state.get("step", 0))
    while step < total_steps:
        try:
            t0 = time.perf_counter()
            lt0 = sflog.op_begin() if sflog.enabled() else None
            state = step_fn(step, state)
            if lt0 is not None:
                sflog.op_end("TrainStep", lt0, None,
                             tags={"step": step,
                                   "world": state.get("world"),
                                   "restarts": restarts})
            dt = time.perf_counter() - t0
            state["straggler_flag"] = detector.observe(dt)
            if comm_metrics is not None:
                state["comm_metrics"] = dict(comm_metrics())
            step += 1
            state["step"] = step
            ckpt.maybe_save(step, state["tree"],
                            extra={"step": step,
                                   "data_state": state.get("data_state", {})})
        except Exception as e:  # noqa: BLE001 — any failure = node failure
            restarts += 1
            if restarts > max_restarts:
                raise
            if elastic_worlds:
                state["world"] = int(
                    elastic_worlds[min(restarts - 1,
                                       len(elastic_worlds) - 1)])
            s, tree, extra = ckpt.restore_latest(state["tree"])
            if s is None:
                # no checkpoint yet: restart from scratch
                step = 0
                if on_restore is not None:
                    state = on_restore(state)
                continue
            state["tree"] = tree
            step = int(extra.get("step", s))
            state["step"] = step
            if on_restore is not None:
                state = on_restore(state)
    return state
