"""Kernel autotuning for the SF hot path (the port of
``repro/kernels/tuning.py``).

PetscSF picks its implementation "based on the characteristics of the
application or the target architecture" (paper abstract, §4–5).  Here the
candidates are the hand kernels' own variants: the wide gather against the
blocked gather at several CTA tiles (``pack``), one segment per CTA against
several segments per CTA (``segred``), and the fused local bcast's routes
(``localbcast``).  A library lowering is never a candidate.  The first call
of a problem *signature* times every candidate on the call's own inputs,
memoizes the winner, and every later call of that signature takes it.

Cache scope: process-level, keyed ``(kind, *signature)``; the signature
holds the shapes, dtypes, device type and the caller's plan key, so
repeated exchanges on one plan never sweep again.

Environment knobs (as in the reference):

``REPRO_SF_AUTOTUNE``
    ``0`` never sweep (every kind takes its default, the fixed rule of
    ``kernels/ops.py``), ``1`` always sweep, unset = auto (sweep only at
    ``work >= 4096`` payload elements; smaller problems take the default).
``REPRO_SF_IMPL_<KIND>``
    Pin the lowering of one kind (``PACK``, ``SEGRED``, ``LOCALBCAST``),
    e.g. ``REPRO_SF_IMPL_PACK=block:128``; a name that is not a candidate
    of the signature raises ``ValueError``.
``REPRO_SF_TUNE_ITERS``
    Timed calls per candidate per round (default 3).
``REPRO_SF_TUNE_ROUNDS``
    Interleaved rounds per sweep (default 3); a candidate scores its best
    round, and before a candidate dethrones the default the two are timed
    again head to head, the default keeping a tie.

Differences from the reference, each deliberate:

* A candidate that raises fails the call.  The reference disqualifies it
  and counts it in ``candidate_errors``; here every candidate is a hand
  kernel, and swallowing its error would hide a broken kernel behind its
  sibling.  ``candidate_errors`` stays 0.
* A sweep times on the call's own tensors (the kinds are pure functions of
  them), not on a synthetic sorted index: sorted rows read several times
  faster than random ones on the card, which would rank gathers wrongly.
* A sweep synchronizes, so none runs while the current stream is being
  captured into a CUDA graph, under ``torch.cuda.set_sync_debug_mode``, or
  inside a torch.profiler window, and none runs on the CPU, where every
  candidate is the same plain version.  There a signature without a winner
  takes the default and counts it in ``defaults`` (the CPU memoizes it,
  as the reference does when sweeping is off; the other three cases do
  not, so a later eager call still sweeps).
* Time is taken with CUDA events on the current stream, around replays
  of the candidate's calls captured into a CUDA graph: the device's time,
  where a host-timed loop measures the launch cost (about 0.03 ms a call
  on the card, more than most of these kernels take).

The reference's ``compiled_supported`` and ``resolve_interpret`` are the
Pallas interpret-mode policy and have no counterpart: the port's wrappers
take the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["autotune", "lookup", "winners", "stats", "clear_cache",
           "register_cache", "can_sweep", "on_sweep"]

Key = Tuple
_WINNERS: Dict[Key, str] = {}
_LINKED_CACHES = []

# Below this many payload elements the lowering choice is noise: take the
# default instead of paying a sweep (override with REPRO_SF_AUTOTUNE=1).
_MIN_TUNE_WORK = 4096
# a timing window on the card replays a candidate's captured calls until
# it lasts this long (CUDA events resolve about half a microsecond)
_WINDOW_MS = 0.5
_MAX_REPLAYS = 256

# ``on_sweep(full_key, candidates, args, times, default, winner)``, when
# set, is called after every sweep with each candidate's best-round ms
# (``chip_smoke.py`` records the sweeps and checks each candidate against
# the plain version with it).
on_sweep: Optional[Callable] = None


class _StatCounters:
    """Mapping facade over the sflog registry's ``tuning.*`` counters, so
    ``sflog.counters()`` reports autotune activity as the reference's
    registry does.  The sflog import is deferred to first use."""

    _KEYS = ("sweeps", "hits", "defaults", "pinned", "candidate_errors")

    def __init__(self):
        self._c = None

    def _counters(self):
        if self._c is None:
            from ..core import sflog
            self._c = {k: sflog.counter(f"tuning.{k}") for k in self._KEYS}
        return self._c

    def __getitem__(self, k: str) -> int:
        return self._counters()[k].value

    def __setitem__(self, k: str, v: int) -> None:
        self._counters()[k].value = int(v)

    def __iter__(self):
        return iter(self._KEYS)

    def keys(self):
        return self._KEYS


_STATS = _StatCounters()


def stats() -> Dict[str, int]:
    """Counters for tests and diagnostics (sweeps run, cache hits, ...)."""
    return dict(_STATS)


def register_cache(cache: dict) -> None:
    """Link a winner-derived cache so ``clear_cache`` empties it too."""
    _LINKED_CACHES.append(cache)


def clear_cache() -> None:
    """Drop every memoized winner, empty the linked caches and reset the
    counters (test isolation)."""
    _WINNERS.clear()
    for c in _LINKED_CACHES:
        c.clear()
    for k in _STATS:
        _STATS[k] = 0


def lookup(key: Key) -> Optional[str]:
    return _WINNERS.get(key)


def winners() -> Dict[Key, str]:
    """A copy of the winner cache ``(kind, *signature) -> candidate``."""
    return dict(_WINNERS)


def _profiling() -> bool:
    return bool(torch._C._autograd._profiler_enabled())


def can_sweep(device: Optional[torch.device]) -> bool:
    """Whether a sweep may run now for tensors on ``device``: on a CUDA
    device, unless its stream is being captured, a sync debug mode is set
    or a profiler window is open; never on the CPU.  ``None`` (host-side
    stand-in candidates, as the tests use) may always sweep."""
    if device is None:
        return True
    if device.type != "cuda":
        return False
    return not (torch.cuda.is_current_stream_capturing()
                or torch.cuda.get_sync_debug_mode() != 0 or _profiling())


def _time_candidate(fn: Callable, args: tuple, iters: int,
                    device: Optional[torch.device]) -> float:
    """Milliseconds per call of ``fn(*args)``, one untimed call first (it
    builds the kernels and prepares the index caches).  On the card:
    ``iters`` calls captured into a CUDA graph, its replays timed with
    CUDA events on the current stream, as many back to back as fill
    ``_WINDOW_MS``; so the device time is measured, not the host's launch
    cost, which every candidate of a signature pays alike.  With
    ``device=None``: the host clock."""
    fn(*args)
    if device is None:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) * 1e3 / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 1
    while True:
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms >= _WINDOW_MS or reps >= _MAX_REPLAYS:
            return ms / (reps * iters)
        grow = max(2, int(_WINDOW_MS / max(ms, 1e-3)))
        reps = min(_MAX_REPLAYS, reps * grow)


def autotune(kind: str, key: Key, candidates: Dict[str, Callable],
             args: tuple, *, default: str, work: Optional[int] = None,
             device: Optional[torch.device] = None) -> str:
    """Return the winning candidate name for ``key``, sweeping if needed.

    ``candidates`` maps a name to a callable taking ``*args`` (the call's
    own tensors); ``default`` must be one of them.  ``work`` (payload
    elements) gates the sweep in auto mode; ``device`` is where ``args``
    live (see :func:`can_sweep`; ``None`` for host-side stand-ins, timed
    on the host clock).  A candidate that raises fails the call.
    """
    if default not in candidates:
        raise ValueError(f"default {default!r} is not a candidate of "
                         f"{sorted(candidates)}")
    full_key = (kind,) + tuple(key)
    winner = _WINNERS.get(full_key)
    if winner is not None:
        _STATS["hits"] += 1
        return winner

    pinned = os.environ.get(f"REPRO_SF_IMPL_{kind.upper()}", "").strip()
    if pinned:
        if pinned not in candidates:
            raise ValueError(
                f"REPRO_SF_IMPL_{kind.upper()}={pinned!r} is not a candidate "
                f"for this problem; have {sorted(candidates)}")
        _STATS["pinned"] += 1
        _WINNERS[full_key] = pinned
        return pinned

    mode = os.environ.get("REPRO_SF_AUTOTUNE", "auto").strip().lower()
    sweep = len(candidates) > 1 and mode not in ("0", "false", "no") and (
        mode in ("1", "true", "yes")
        or work is None or work >= _MIN_TUNE_WORK)
    if not sweep or not can_sweep(device):
        _STATS["defaults"] += 1
        if not sweep or device.type == "cpu":
            _WINNERS[full_key] = default
        return default

    iters = int(os.environ.get("REPRO_SF_TUNE_ITERS", "3"))
    rounds = max(int(os.environ.get("REPRO_SF_TUNE_ROUNDS", "3")), 1)
    # interleaved best-of-rounds: a load spike lands in one window at most
    best: Dict[str, float] = {}
    for _ in range(rounds):
        for name, fn in candidates.items():
            best[name] = min(best.get(name, float("inf")),
                             _time_candidate(fn, args, iters, device))
    winner = min(best, key=best.get)
    if winner != default:
        # runoff: a mis-crowned winner is sticky for the whole process, so
        # the two are timed again head to head before the default goes
        tw = td = float("inf")
        for _ in range(rounds):
            tw = min(tw, _time_candidate(candidates[winner], args, iters,
                                         device))
            td = min(td, _time_candidate(candidates[default], args, iters,
                                         device))
        if td <= tw:
            winner = default
    _STATS["sweeps"] += 1
    _WINNERS[full_key] = winner
    if on_sweep is not None:
        on_sweep(full_key, candidates, args, dict(best), default, winner)
    return winner
