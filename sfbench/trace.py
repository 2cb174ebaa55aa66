"""The traced window: one ``torch.profiler`` window around a fixed amount of
the cell's work, its chrome trace written under ``TMPDIR`` and read back
into device operations, the busy time as the union of their intervals, and
the breakdown the result line carries.

A device operation is a kernel, a memory copy or a memory set, as
``(name, start_us, duration_us)`` on the trace's clock.  The busy time is
the length of the union of their intervals (overlapping kernels count
once), so the idle share ``1 - busy / window`` is the share of the window
in which nothing ran on the device.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW_MARK = "sfbench_window"
TOP = 10


def read_chrome_trace(path: Path) -> Tuple[list, list, tuple]:
    """(device ops, host ops, window (start_us, end_us)) of a chrome trace
    written by ``export_chrome_trace``; the window is the span of the
    ``sfbench_window`` annotation."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        item = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            dev.append(item)
        elif cat in HOST_CATS:
            if item[0] == WINDOW_MARK and cat == "user_annotation":
                window = (item[1], item[1] + item[2])
            else:
                host.append(item)
    return dev, host, window


def union_us(ops: List[tuple]) -> float:
    """The length of the union of the ops' intervals."""
    total, end = 0.0, None
    for _, t0, d in sorted(ops, key=lambda o: o[1]):
        t1 = t0 + d
        if end is None or t0 >= end:
            total += d
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def gaps_us(ops: List[tuple], window: tuple) -> List[tuple]:
    """The idle intervals ``(start, end)`` of the window: before the first
    operation, between the merged intervals, after the last."""
    lo, hi = window
    out, cur = [], lo
    for _, t0, d in sorted(ops, key=lambda o: o[1]):
        if t0 > cur:
            out.append((cur, min(t0, hi)))
        cur = max(cur, t0 + d)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def host_at(host: List[tuple], t: float) -> str:
    """The innermost host operation running at ``t`` (the latest started
    of those that cover it), or ``"host"``."""
    best = None
    for name, t0, d in host:
        if t0 <= t < t0 + d and (best is None or t0 > best[1]):
            best = (name, t0)
    return best[0] if best else "host"


def breakdown(dev: List[tuple], host: List[tuple], window: tuple) -> dict:
    """The device operations that took most time (seconds, summed by
    name) and the longest idle gaps, each named by what the host was
    doing as it began."""
    by_name: Dict[str, float] = {}
    for name, _, d in dev:
        by_name[name] = by_name.get(name, 0.0) + d * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(gaps_us(dev, window), key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[host_at(host, a)[:160], (b - a) * 1e-6]
                          for a, b in gaps]}


def profiled(fn: Callable, path: Path, cuda: bool = True) -> dict:
    """Run ``fn()`` once inside a profiler window and read the trace back:
    ``{"result", "ops", "host", "window_s", "busy_s", "breakdown"}``.
    Device operations outside the window's annotation are left out; with
    ``cuda`` false (the CPU rehearsal) only the host is traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_MARK):
            t0 = time.perf_counter()
            result = fn()
            sync()
            wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(path))
    dev, host, window = read_chrome_trace(path)
    if window is None:
        raise RuntimeError(f"{path}: the trace holds no {WINDOW_MARK} span")
    lo, hi = window
    dev = [(n, max(t, lo), min(t + d, hi) - max(t, lo)) for n, t, d in dev
           if t < hi and t + d > lo]
    return {"result": result, "ops": dev, "host": host,
            "window_s": wall, "busy_s": union_us(dev) * 1e-6,
            "breakdown": breakdown(dev, host, window)}


def whole_names(names) -> List[str]:
    """Patterns matching each of ``names`` as a whole identifier
    (``spmv_ell_kernel`` matches ``void spmv_ell_kernel<4>(...)``)."""
    return [r"\b%s\b" % re.escape(n) for n in names]


def kernel_seconds(ops: List[tuple], patterns) -> Tuple[float, int]:
    """(seconds, launches) of the ops whose name matches one of the
    regular expressions ``patterns``."""
    if not patterns:
        return 0.0, 0
    pat = re.compile("|".join(f"(?:{p})" for p in patterns))
    hit = [d for n, _, d in ops if pat.search(n)]
    return sum(hit) * 1e-6, len(hit)
