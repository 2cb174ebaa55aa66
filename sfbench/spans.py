"""What the per-layer metrics that read the program's spans share.

The program marks its layers with ``torch.profiler`` ranges
(``repro_torch.core.sflog.span``), which the traced window's chrome trace
holds as ``user_annotation`` events, on the clock of the device's
operations, in the host list a reader gets as ``ctx["host"]``.  An "idle
under S" metric is the part of the device's idle time during which the
host was inside a span named S, over the window.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from sfbench import trace


def intervals(host: List[tuple], names: Iterable[str]
              ) -> List[Tuple[float, float]]:
    """The union of the host's spans named one of ``names`` as sorted
    disjoint intervals ``(start_us, end_us)``: nested and overlapping
    instances, on one thread or several, count once."""
    names = set(names)
    out: List[List[float]] = []
    for a, b in sorted((t0, t0 + d) for n, t0, d in host if n in names):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_us(xs: List[Tuple[float, float]],
               ys: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(ctx: dict, *names: str) -> Optional[float]:
    """The share of the window, in %, in which no operation ran on the
    device while the host was inside a span named one of ``names``: the
    idle intervals as ``trace.gaps_us`` gives them from ``ctx["ops"]``
    over the spans' extent, intersected with the spans' union, over
    ``ctx["window_s"]`` (as ``device_idle.*`` divides).  None without
    device operations (the CPU rehearsal) or without such a span (a
    program that opens none)."""
    ops, window_s = ctx.get("ops"), ctx.get("window_s")
    inside = intervals(ctx.get("host", []), names)
    if not ops or not window_s or not inside:
        return None
    idle = trace.gaps_us(ops, (inside[0][0], inside[-1][1]))
    return 100.0 * overlap_us(idle, inside) * 1e-6 / window_s
