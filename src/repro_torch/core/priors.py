"""Measurement-driven backend selection priors (paper abstract, §4–§5).

PetscSF picks its implementation "based on the characteristics of the
application or the target architecture".  The static rule in
``select_backend`` encodes the *architecture* half (device type, process
group); this module adds the *measurement* half: the port's benchmark
artifacts (``BENCH_torch_pingpong.json``, ``BENCH_torch_halo.json`` at the
repository root) are parsed into a priors table mapping ``message bytes ->
per-backend µs``, and ``select_backend`` consults it to pick the backend the
measurements favour at the SF's message size.

Artifacts are trusted only when their ``meta`` stamp matches the running
environment: same platform (``"gpu"`` / ``"cpu"``), same torch and CUDA
major.minor, same device name and device count.  Stale, cross-device or
unstamped numbers are refused, as are the JAX package's artifacts (stamped
``jax_version``), and selection falls back to the static rule.

``REPRO_SF_PRIORS=0`` disables priors entirely; setting it to a directory
path loads the artifacts from there instead of the repository root.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PriorsTable", "current_env", "stamp_compatible",
           "default_priors", "invalidate_priors_cache",
           "PRIOR_ARTIFACTS"]

PRIOR_ARTIFACTS = ("BENCH_torch_pingpong.json", "BENCH_torch_halo.json")


def current_env() -> Dict[str, object]:
    """The stamp the current process would write on an artifact."""
    gpu = torch.cuda.is_available()
    return {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "platform": "gpu" if gpu else "cpu",
            "device_name": torch.cuda.get_device_name(0) if gpu else "cpu",
            "device_count": torch.cuda.device_count() if gpu else 1}


def _major_minor(version) -> Optional[List[str]]:
    return None if version is None else str(version).split(".")[:2]


def stamp_compatible(meta: Optional[dict], env: Optional[dict] = None
                     ) -> bool:
    """True when an artifact's ``meta`` stamp matches the current
    environment closely enough for its timings to be trusted: same
    platform, torch and CUDA major.minor, device name and device count.
    Unstamped artifacts, and the JAX package's stamps (``jax_version``, no
    ``torch_version``), are refused."""
    if not isinstance(meta, dict):
        return False
    env = env or current_env()
    if meta.get("platform") != env["platform"]:
        return False
    if _major_minor(meta.get("torch_version")) != \
            _major_minor(env["torch_version"]):
        return False
    if _major_minor(meta.get("cuda_version")) != \
            _major_minor(env["cuda_version"]):
        return False
    if meta.get("device_name") != env["device_name"]:
        return False
    try:
        if int(meta.get("device_count", -1)) != int(env["device_count"]):
            return False
    except (TypeError, ValueError):
        return False
    return True


@dataclasses.dataclass
class PriorsTable:
    """``(backend, message bytes) -> µs`` measurements + lookup.

    ``best_backend`` interpolates each backend's measured curve in
    log-byte space (clamped to the measured range) and returns the argmin,
    but only when at least two candidate backends have data, so a
    single-backend artifact can never force a choice.
    """

    records: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)              # (backend, nbytes, us)
    meta: Optional[dict] = None
    sources: List[str] = dataclasses.field(default_factory=list)

    def record(self, backend: str, nbytes: float, us: float) -> None:
        if nbytes > 0 and us > 0:
            self.records.append((str(backend), float(nbytes), float(us)))

    def backends(self) -> set:
        return {b for b, _, _ in self.records}

    def _curve(self, backend: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        pts = sorted((nb, us) for b, nb, us in self.records if b == backend)
        if not pts:
            return None
        x = np.log2(np.array([p[0] for p in pts]))
        y = np.array([p[1] for p in pts])
        # collapse duplicate sizes to their mean
        ux = np.unique(x)
        uy = np.array([y[x == v].mean() for v in ux])
        return ux, uy

    def predict_us(self, backend: str, nbytes: float) -> Optional[float]:
        curve = self._curve(backend)
        if curve is None or nbytes <= 0:
            return None
        ux, uy = curve
        return float(np.interp(np.log2(nbytes), ux, uy))

    def best_backend(self, nbytes: float, candidates=None
                     ) -> Optional[str]:
        """The measured-fastest backend at ``nbytes``, or None when fewer
        than two candidates have measurements (no basis for a choice)."""
        names = sorted(self.backends() if candidates is None
                       else set(candidates) & self.backends())
        preds = [(self.predict_us(b, nbytes), b) for b in names]
        preds = [(us, b) for us, b in preds if us is not None]
        if len(preds) < 2:
            return None
        return min(preds)[1]

    # -------------------------------------------------------- construction
    def ingest_artifact(self, obj: dict, source: str = "") -> int:
        """Parse one artifact payload; returns records added.  Knows the
        pingpong schema (backends -> {bytes: us}) and the halo grid-sweep
        schema (grids -> {halo_edges, backends -> unit_us}, bytes =
        halo_edges x unit x 4)."""
        added = 0
        bench = obj.get("bench")
        if bench == "pingpong":
            for bk, sizes in obj.get("backends", {}).items():
                for nbytes, us in sizes.items():
                    self.record(bk, float(nbytes), us)
                    added += 1
        elif bench == "halo":
            grids = obj.get("grids")
            if grids is None:       # pre-sweep schema: one grid at top level
                grids = {"default": obj}
            for g in grids.values():
                edges = float(g.get("halo_edges", 0))
                for bk, series in g.get("backends", {}).items():
                    if bk == "auto":
                        continue    # derived row, not a fixed-backend prior
                    for u, us in series.get("unit_us", {}).items():
                        self.record(bk, edges * float(u) * 4, us)
                        added += 1
        if added and source:
            self.sources.append(source)
        return added

    @classmethod
    def load(cls, root: Optional[str] = None, env: Optional[dict] = None
             ) -> Optional["PriorsTable"]:
        """Load every compatible artifact under ``root`` (default: the
        repository root above this package).  Returns None when nothing
        usable exists."""
        if root is None:
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        table = cls()
        for name in PRIOR_ARTIFACTS:
            path = os.path.join(root, name)
            try:
                with open(path) as f:
                    obj = json.load(f)
            except (OSError, ValueError):
                continue
            if not stamp_compatible(obj.get("meta"), env):
                continue
            table.ingest_artifact(obj, source=path)
            if table.meta is None:
                table.meta = obj.get("meta")
        return table if table.records else None


_CACHE: Dict[str, Optional[PriorsTable]] = {}


def default_priors() -> Optional[PriorsTable]:
    """The memoized artifact priors table (or None).  Honours
    ``REPRO_SF_PRIORS``: ``0`` disables, a path loads from that directory."""
    env = os.environ.get("REPRO_SF_PRIORS", "").strip()
    if env in ("0", "false", "no"):
        return None
    root = env if env and os.path.isdir(env) else None
    key = root or "<repo>"
    if key not in _CACHE:
        _CACHE[key] = PriorsTable.load(root)
    return _CACHE[key]


def invalidate_priors_cache() -> None:
    """Drop the memoized table (tests; after regenerating artifacts)."""
    _CACHE.clear()
