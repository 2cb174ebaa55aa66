"""Open-loop synthetic load generator for the serving engine (a copy of
``repro/serving/loadgen.py``: numpy only, so a trace and its fingerprint
are bit for bit the reference's).

Open-loop means arrivals follow their own clock (a Poisson process at
``rate_rps``) regardless of how fast the engine drains — the measurement
regime where queueing delay shows up in TTFT instead of being hidden by
closed-loop backpressure.  ``synthesize`` draws a reproducible trace of
``(arrival_time, Request)``; ``drive`` replays it against a
:class:`repro_torch.serving.engine.ServeEngine` on the wall clock: at each
iteration it submits every request whose arrival time has passed, then runs
one engine step (so admission interleaves with decode exactly as live
traffic would).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .engine import Request, ServeEngine

__all__ = ["LoadSpec", "synthesize", "trace_fingerprint", "drive"]


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """A synthetic multi-tenant workload.

    ``rate_rps`` is the mean Poisson arrival rate; prompt lengths and
    output budgets are drawn uniformly from the inclusive ranges (varied
    prompt lengths are the point — they exercise the engine's length
    buckets).
    """

    rate_rps: float = 50.0
    n_requests: int = 32
    prompt_len: Tuple[int, int] = (4, 64)
    max_new: Tuple[int, int] = (4, 24)
    vocab: int = 256
    seed: int = 0


def synthesize(spec: LoadSpec) -> List[Tuple[float, Request]]:
    """-> [(arrival_time_s, Request)] sorted by arrival, arrivals at the
    cumsum of exponential inter-arrival gaps (a Poisson process)."""
    rng = np.random.default_rng(spec.seed)
    gaps = rng.exponential(1.0 / spec.rate_rps, spec.n_requests)
    arrivals = np.cumsum(gaps)
    trace = []
    for i, t in enumerate(arrivals):
        plen = int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1))
        mnew = int(rng.integers(spec.max_new[0], spec.max_new[1] + 1))
        toks = rng.integers(0, spec.vocab, plen).tolist()
        trace.append((float(t), Request(rid=i, tokens=toks, max_new=mnew)))
    return trace


def trace_fingerprint(trace: List[Tuple[float, Request]]) -> str:
    """Content hash of a synthesized trace: arrival times (float64 bits),
    prompt tokens, and output budgets.  Two processes that synthesize the
    same :class:`LoadSpec` must produce the same fingerprint, and so must
    this package and the reference — the bit-identical-arrivals guarantee
    that keeps runs comparable across machines and repeats."""
    h = hashlib.sha256()
    for t, req in trace:
        h.update(np.float64(t).tobytes())
        h.update(np.asarray(req.tokens, np.int64).tobytes())
        h.update(np.int64(req.max_new).tobytes())
    return h.hexdigest()


def drive(engine: ServeEngine, trace: List[Tuple[float, Request]],
          clock=time.perf_counter) -> Dict:
    """Replay an arrival trace open-loop and return ``engine.metrics()``.

    Wall-clock loop: submit everything whose arrival time has passed, step
    the engine once, repeat until the trace is exhausted and the engine is
    drained.  When all pending arrivals are in the future and the engine is
    idle, sleep until the next arrival instead of spinning.
    """
    t0 = clock()
    i = 0
    while True:
        now = clock() - t0
        while i < len(trace) and trace[i][0] <= now:
            engine.submit(trace[i][1])
            i += 1
        pending = engine.step()
        if pending == 0:
            if i >= len(trace):
                break
            wait = trace[i][0] - (clock() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    return engine.metrics()
