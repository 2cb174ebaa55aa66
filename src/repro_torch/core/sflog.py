"""``-log_view`` for star forests: event tracing, comm volume, ``SFView``.

PETSc answers "what did this run actually communicate?" with two tools the
paper leans on throughout §5-§6: ``PetscLogEvent`` begin/end pairs rendered
by ``-log_view`` (count, time, message volume per event) and ``PetscSFView``
(the structural dump of one SF).  This module is both, ported from
``repro/core/sflog.py`` — a process-wide registry every consumer reports
into:

* **Events** (:class:`EventRecord`): named begin/end pairs with wall time,
  exchange counts, and per-event *comm volume* in bytes derived from the
  plan's edge count and the payload's unit row (``core/unit.py``).  Split
  phases additionally accumulate the *overlap window* — the wall time the
  caller kept an exchange in flight between ``*_begin`` and ``*_end``.
* **Counters**: plain named integers.  ``PlanCache`` hit/miss and the
  serving engine's tallies are registry-backed, so one dump carries all of
  them.
* **SFView** (:func:`sf_view` / :func:`format_sf_view`): nroots/nleaves,
  local-vs-remote edge split, root-degree histogram, backend and cached-plan
  signatures for any ``StarForest`` / ``SFComm``; sizes, unit and label
  for a ``DynPlan``.
* **Spans** (:func:`span`): named ranges in a ``torch.profiler`` trace, on
  the clock of the device's kernels, nested by the profiler per thread.
  They record nothing in the registry.

Call sites in this port: every operation of ``SFComm`` (so ``ParCSR``'s
SpMV, the DMDA halo, the multigrid transfers and the stash flush), the
fused multi-field exchange of ``FieldBundle``, ``DynPlan``'s runtime-routed
``SFDynReduce`` / ``SFDynBcast`` (bytes: leaves x row bytes; MoE dispatch
and combine) and the serving engine.  Each SF exchange also opens a span
under its event's name, the End a token's own ``end`` records included
(``ParCSR.spmv``'s halo shows as ``SFBcastBegin`` / ``SFBcastEnd``; a
split fused exchange's per-group backend Ends nest in its
``SF*MultiEnd``).  Spans without a registry event mark the layers above:
``cg.solve`` / ``cg.prepare`` / ``cg.capture`` / ``cg.loop`` /
``cg.flag`` / ``cg.result`` (``solvers/cg.py``), ``train.step`` /
``train.forward`` / ``train.backward`` (``training/train_loop.py``),
``optim.update`` (``training/optimizer.py``) and ``moe.route`` /
``moe.dispatch`` / ``moe.experts`` / ``moe.combine`` (``models/moe.py``).

Rendering: :func:`log_view` (the PETSc-style text table) and
:func:`dump_json` (a JSON-ready dict benchmarks stamp into artifacts).

**Trace safety.**  Instrumentation hooks fire at *dispatch* time — Python
call boundaries.  A hook that fires while ``torch.compile`` traces or while
a CUDA graph is being captured increments the event's ``traced`` counter
and records nothing else: wall time under a trace is meaningless, and the
captured work replays arbitrarily many times later.
``count``/``time``/``bytes`` are therefore *eager-execution* totals.  A
span opened during a capture marks the capture's host time; replays open
none.

**Gating.**  ``REPRO_SF_LOG`` selects the registry's mode at import: ``0``
(default) off, ``1`` on, ``fence`` on + ``torch.cuda.synchronize`` on the
device of every event's result, so times are true wall times rather than
dispatch times.  When off, every hook is a single integer test.  Counters
are always live: they are bare integer adds.  Spans do not read the mode:
a span is a ``record_function`` range while a profiler records, and
otherwise one call and one test that return a shared no-op.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = [
    "enabled", "mode", "set_mode", "reset",
    "Counter", "counter", "counters",
    "EventRecord", "event", "events",
    "op_begin", "op_end", "stash_pending", "claim_pending", "pending_end",
    "timed", "context", "span",
    "log_view", "dump_json", "events_snapshot", "events_delta",
    "overlap_efficiency", "exchange_totals",
    "sf_view", "format_sf_view",
]

# --------------------------------------------------------------------------
# mode gate (REPRO_SF_LOG = 0 | 1 | fence)
# --------------------------------------------------------------------------
_OFF, _ON, _FENCE = 0, 1, 2
_MODE_NAMES = {_OFF: "off", _ON: "on", _FENCE: "fence"}


def _parse_mode(value) -> int:
    if value is None or isinstance(value, bool):
        return _ON if value else _OFF
    v = str(value).strip().lower()
    if v in ("fence", "2"):
        return _FENCE
    if v in ("1", "true", "yes", "on"):
        return _ON
    if v in ("", "0", "false", "no", "off"):
        return _OFF
    raise ValueError(f"REPRO_SF_LOG={value!r}: use 0, 1 or fence")


_MODE = _parse_mode(os.environ.get("REPRO_SF_LOG"))


def enabled() -> bool:
    """True when event recording is on (the one test every hook makes)."""
    return _MODE != _OFF


def mode() -> str:
    return _MODE_NAMES[_MODE]


def set_mode(value) -> str:
    """Set the logging mode programmatically (``"off"``/``"on"``/``"fence"``
    or anything ``REPRO_SF_LOG`` accepts); returns the previous mode."""
    global _MODE
    old = _MODE_NAMES[_MODE]
    _MODE = _parse_mode(value)
    return old


def _tracing() -> bool:
    """Is ``torch.compile`` tracing, or is a CUDA graph being captured, right
    now?  Hooks must never record wall time or execution counts from inside
    either."""
    if torch.compiler.is_compiling():
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _fence(out) -> None:
    """Wait until the card has produced ``out`` (a tensor, or a tuple, list
    or dict of them)."""
    stack, devices = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


# --------------------------------------------------------------------------
# counters
# --------------------------------------------------------------------------
class Counter:
    """A named registry integer.  ``add``/``value`` only — cheap enough to
    stay live even when event logging is off (the ``PlanCache`` and serving
    tallies sit on these)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> int:
        self.value += n
        return self.value

    def __repr__(self) -> str:    # pragma: no cover - debugging aid
        return f"Counter({self.name}={self.value})"


_COUNTERS: Dict[str, Counter] = {}
_UNIQ: Dict[str, int] = {}


def counter(name: str, *, unique: bool = False) -> Counter:
    """Get-or-create the counter ``name``.  ``unique=True`` mints a fresh
    ``name#k`` instance instead — per-object counters (one PlanCache, one
    ServeEngine) must not alias across instances."""
    if unique:
        _UNIQ[name] = _UNIQ.get(name, 0) + 1
        name = f"{name}#{_UNIQ[name]}"
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = Counter(name)
    return c


def counters() -> Dict[str, int]:
    """Snapshot of every registered counter value."""
    return {n: c.value for n, c in sorted(_COUNTERS.items())}


# --------------------------------------------------------------------------
# events
# --------------------------------------------------------------------------
_MAX_TAG_VALUES = 8


class EventRecord:
    """Aggregate for one named event.

    ``count``/``time``/``bytes``/``overlap`` accumulate over *eager*
    executions only; ``traced`` counts how many times the hook fired while
    ``torch.compile`` traced or a CUDA graph was captured.  ``tags`` holds
    bounded value->occurrence maps for context keys (backend, op, pattern,
    request id, step, ...)."""

    __slots__ = ("name", "count", "traced", "time", "bytes", "overlap",
                 "tags")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.traced = 0
        self.time = 0.0
        self.bytes = 0.0
        self.overlap = 0.0
        self.tags: Dict[str, Dict[str, int]] = {}

    def tag(self, key: str, value) -> None:
        vals = self.tags.setdefault(key, {})
        v = str(value)
        if v in vals:
            vals[v] += 1
        elif len(vals) < _MAX_TAG_VALUES:
            vals[v] = 1
        else:                      # bounded: overflow bucket, never unbounded
            vals["..."] = vals.get("...", 0) + 1

    def as_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "traced": self.traced,
                "time_s": self.time, "bytes": self.bytes,
                "overlap_s": self.overlap,
                "tags": {k: dict(v) for k, v in self.tags.items()}}


_EVENTS: Dict[str, EventRecord] = {}
_CONTEXT: Dict[str, Any] = {}


def event(name: str) -> EventRecord:
    ev = _EVENTS.get(name)
    if ev is None:
        ev = _EVENTS[name] = EventRecord(name)
    return ev


def events() -> Dict[str, EventRecord]:
    return dict(_EVENTS)


def reset(*, counters: bool = False) -> None:
    """Clear every event aggregate (and zero counter values when asked —
    counter *objects* survive, live references are everywhere)."""
    _EVENTS.clear()
    if counters:
        for c in _COUNTERS.values():
            c.value = 0


@contextlib.contextmanager
def context(**kv) -> Iterator[None]:
    """Tag every event recorded in this scope with ``kv`` (request id, train
    step, ...).  Values land in the events' bounded tag maps."""
    old = dict(_CONTEXT)
    _CONTEXT.update(kv)
    try:
        yield
    finally:
        _CONTEXT.clear()
        _CONTEXT.update(old)


# --------------------------------------------------------------------------
# hooks (call sites: SFComm, FieldBundle, the serving engine)
# --------------------------------------------------------------------------
def op_begin() -> float:
    """Start one event window.  Returns the start timestamp, or ``-1.0``
    when a trace or a capture is active (the end hook then counts
    ``traced`` only).  Callers must have checked :func:`enabled` first."""
    if _tracing():
        return -1.0
    return time.perf_counter()


def op_end(name: str, t0: float, out=None, *, nbytes: float = 0.0,
           tags: Optional[Dict[str, Any]] = None) -> None:
    """Close the window opened by :func:`op_begin` for event ``name``.

    ``out``'s device is synchronized in fence mode so the recorded time is
    wall time, not dispatch time.  ``nbytes`` is the comm
    volume this execution moved (plan edges x unit row bytes)."""
    if _MODE == _OFF:
        return
    ev = event(name)
    if t0 < 0.0 or _tracing():
        ev.traced += 1
        return
    if _MODE == _FENCE and out is not None:
        _fence(out)
    ev.count += 1
    ev.time += time.perf_counter() - t0
    ev.bytes += float(nbytes)
    if tags:
        for k, v in tags.items():
            ev.tag(k, v)
    for k, v in _CONTEXT.items():
        ev.tag(k, v)


def stash_pending(tok, end_name: str, nbytes: float,
                  tags: Optional[Dict[str, Any]] = None, *,
                  tracing: bool = False) -> None:
    """Attach end-event bookkeeping to an in-flight token (``PendingComm``
    and ``PendingMulti`` are mutable).  Whoever completes the token first —
    ``SFComm.*_end`` or ``pending.end`` — claims it exactly once, so both
    completion styles record one End event and never two."""
    info = (end_name, -1.0 if tracing else time.perf_counter(),
            float(nbytes), tags)
    try:
        setattr(tok, "_sflog", info)
    except (AttributeError, TypeError):   # frozen/slotted token: no window
        pass


def claim_pending(tok):
    """Pop the stashed end-event info off a token (None if absent or
    already claimed)."""
    info = getattr(tok, "_sflog", None)
    if info is not None:
        setattr(tok, "_sflog", None)
    return info


def pending_end(info, t0: float, out=None) -> None:
    """Record the End half of a split-phase pair: ``overlap`` is the window
    the exchange stayed in flight (begin return -> end call), ``time`` is
    the end call itself (wait + unpack)."""
    if _MODE == _OFF:
        return
    end_name, t_begin, nbytes, tags = info
    ev = event(end_name)
    if t_begin < 0.0 or t0 < 0.0 or _tracing():
        ev.traced += 1
        return
    if _MODE == _FENCE and out is not None:
        _fence(out)
    now = time.perf_counter()
    ev.count += 1
    ev.overlap += max(t0 - t_begin, 0.0)
    ev.time += now - t0
    ev.bytes += float(nbytes)
    if tags:
        for k, v in tags.items():
            ev.tag(k, v)
    for k, v in _CONTEXT.items():
        ev.tag(k, v)


@contextlib.contextmanager
def timed(name: str, *, nbytes: float = 0.0,
          tags: Optional[Dict[str, Any]] = None) -> Iterator[None]:
    """Record the body as one event execution (no fencing of a result —
    fence inside the body if needed)."""
    if _MODE == _OFF:
        yield
        return
    t0 = op_begin()
    try:
        yield
    finally:
        op_end(name, t0, None, nbytes=nbytes, tags=tags)


# --------------------------------------------------------------------------
# spans: ranges on the profiler's clock
# --------------------------------------------------------------------------
class _NoSpan:
    """The span while no profiler records: enters and leaves, nothing
    else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A range named ``name`` for ``with``: while a ``torch.profiler``
    records, a ``record_function`` range (a ``user_annotation`` in its
    trace, on the clock of the device's kernels); otherwise the shared
    no-op.  Writes nothing to the event registry, whatever the mode."""
    if _profiling():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


# --------------------------------------------------------------------------
# reporting
# --------------------------------------------------------------------------
def dump_json() -> Dict[str, Any]:
    """JSON-ready structured dump: mode, every event aggregate, every
    counter.  Benchmarks stamp this into their artifacts; CI uploads it."""
    return {"mode": mode(),
            "events": {n: ev.as_dict()
                       for n, ev in sorted(_EVENTS.items())},
            "counters": counters()}


def dumps_json(**kw) -> str:
    return json.dumps(dump_json(), indent=2, sort_keys=True, **kw)


def log_view() -> str:
    """The PETSc ``-log_view`` table: one row per event with count, traced
    count, wall time, comm volume, bandwidth and share of logged time,
    followed by split-phase overlap windows and the counter registry."""
    total_t = sum(ev.time for ev in _EVENTS.values()) or 1.0
    width = max([len(n) for n in _EVENTS] + [20])
    bar = "-" * (width + 58)
    lines = [f"SF log_view  (mode={mode()})", bar,
             f"{'Event'.ljust(width)} {'Count':>7} {'Traced':>7} "
             f"{'Time (s)':>12} {'MBytes':>10} {'MB/s':>8} {'%T':>4}",
             bar]
    for name in sorted(_EVENTS):
        ev = _EVENTS[name]
        mb = ev.bytes / 1e6
        rate = mb / ev.time if ev.time > 0 else 0.0
        pct = 100.0 * ev.time / total_t
        lines.append(f"{name.ljust(width)} {ev.count:>7d} {ev.traced:>7d} "
                     f"{ev.time:>12.4e} {mb:>10.4f} {rate:>8.1f} "
                     f"{pct:>4.0f}")
    lines.append(bar)
    ovl = [(n, ev) for n, ev in sorted(_EVENTS.items()) if ev.overlap > 0]
    if ovl:
        lines.append("Split-phase overlap windows (begin->end in-flight "
                     "time):")
        for n, ev in ovl:
            hidden = ev.overlap / (ev.overlap + ev.time) \
                if ev.overlap + ev.time > 0 else 0.0
            lines.append(f"  {n}: window {ev.overlap:.4e} s over "
                         f"{ev.count} pairs (window fraction "
                         f"{hidden:.2f})")
        lines.append(bar)
    live = {n: v for n, v in counters().items() if v}
    if live:
        lines.append("Counters:")
        for n, v in live.items():
            lines.append(f"  {n} = {v}")
        lines.append(bar)
    return "\n".join(lines)


def events_snapshot() -> Dict[str, Dict[str, float]]:
    """Count/traced/bytes snapshot per event — the diffable part (times are
    machine-dependent; counts and bytes are exact)."""
    return {n: {"count": ev.count, "traced": ev.traced, "bytes": ev.bytes}
            for n, ev in _EVENTS.items()}


def events_delta(before: Dict[str, Dict[str, float]],
                 after: Optional[Dict[str, Dict[str, float]]] = None
                 ) -> Dict[str, Dict[str, float]]:
    """Per-event growth between two snapshots (events absent from
    ``before`` count from zero); zero rows are dropped."""
    after = events_snapshot() if after is None else after
    out: Dict[str, Dict[str, float]] = {}
    for n, a in after.items():
        b = before.get(n, {})
        d = {k: a[k] - b.get(k, 0) for k in a}
        if any(d.values()):
            out[n] = d
    return out


def exchange_totals(snap: Optional[Dict[str, Dict[str, float]]] = None
                    ) -> Dict[str, float]:
    """Total SF exchange activity in a snapshot: summed ``count + traced``
    and bytes over every ``SF*`` event.  ``traced`` is included so
    exchanges that live inside compiled programs (one trace per program,
    executions invisible to Python) still witness structural growth — the
    perf-guard regression signal."""
    snap = events_snapshot() if snap is None else snap
    n = sum(d["count"] + d["traced"] for name, d in snap.items()
            if name.startswith("SF"))
    b = sum(d["bytes"] for name, d in snap.items()
            if name.startswith("SF"))
    return {"exchanges": float(n), "bytes": float(b)}


def overlap_efficiency(sync_event: str, split_event: str) -> Optional[float]:
    """Mean-time ratio ``t(sync) / t(split)`` between two recorded events —
    the paper's Fig 5/9 figure of merit (>1: the split-phase formulation is
    winning), derived from registry aggregates instead of hand-rolled
    timers."""
    a, b = _EVENTS.get(sync_event), _EVENTS.get(split_event)
    if not a or not b or not a.count or not b.count or b.time <= 0:
        return None
    return (a.time / a.count) / (b.time / b.count)


# --------------------------------------------------------------------------
# SFView
# --------------------------------------------------------------------------
def sf_view(obj) -> Dict[str, Any]:
    """Structured ``PetscSFView`` analogue for a ``StarForest``, ``SFComm``
    or ``DynPlan``: sizes, local/remote edge split, root-degree histogram,
    pattern kind, and (for a comm) backend + cached-plan signature."""
    from .graph import StarForest
    from .dynplan import DynPlan
    from . import patterns as pat

    backend_name = plan = None
    if isinstance(obj, DynPlan):
        return {"type": "DynPlan", "nroots": obj.nroots,
                "nleaves": obj.nleaves, "unit": repr(obj.unit),
                "label": repr(obj.label), "tune_key": repr(obj.tune_key)}
    sf = obj
    if not isinstance(obj, StarForest):          # SFComm-shaped
        sf = obj.sf
        backend_name = getattr(obj, "backend_name", None)
        backend = getattr(obj, "backend", obj)
        plan = getattr(backend, "plan", None)
        if plan is None:
            plan = getattr(getattr(backend, "dist", None), "plan", None)
    sf.setup()
    edges = sf.edges_global()
    rep = pat.analyze(sf)
    degrees = np.bincount(edges[:, 0].astype(np.int64),
                          minlength=sf.nroots_total) \
        if sf.nroots_total else np.zeros(0, np.int64)
    dv, dc = np.unique(degrees, return_counts=True) \
        if degrees.size else (np.zeros(0), np.zeros(0))
    out = {
        "type": "StarForest",
        "nranks": sf.nranks,
        "nroots": int(sf.nroots_total),
        "nleaves": int(sf.nedges_total),
        "nleafspace": int(sf.nleafspace_total),
        "edges": {"total": int(sf.nedges_total),
                  "local": int(rep.n_local_edges),
                  "remote": int(rep.n_remote_edges)},
        "pattern": rep.kind,
        "root_degree_histogram": {int(d): int(c) for d, c in zip(dv, dc)},
    }
    if backend_name is not None:
        out["backend"] = backend_name
    if plan is not None and hasattr(plan, "comm_signature"):
        out["plan_signature"] = repr(plan.comm_signature())
        out["unit"] = repr(getattr(plan, "unit", None))
    return out


def format_sf_view(obj) -> str:
    """The human-readable SFView block (``PetscSFView`` to stdout)."""
    v = sf_view(obj)
    if v["type"] == "DynPlan":
        return (f"SFView: DynPlan {v['label']}: {v['nroots']} roots, "
                f"{v['nleaves']} leaves, unit {v['unit']}")
    e = v["edges"]
    hist = " ".join(f"{d}x{c}" for d, c in
                    sorted(v["root_degree_histogram"].items()))
    lines = [f"SFView: StarForest ({v['nranks']} ranks): {v['nroots']} "
             f"roots, {v['nleaves']} leaves over {v['nleafspace']} slots",
             f"  pattern: {v['pattern']}  edges: {e['total']} "
             f"({e['local']} local / {e['remote']} remote)",
             f"  root degree histogram (degree x count): {hist or '-'}"]
    if "backend" in v:
        lines.append(f"  backend: {v['backend']}  plan: "
                     f"{v.get('plan_signature', '-')}")
    return "\n".join(lines)
