"""Signature-keyed caches of plans and prepared programs (the ``PlanCache``
of ``repro/core/dynplan.py``).

``DynPlan``, the star forest whose edge list the router writes every step,
comes with the MoE slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from . import sflog

__all__ = ["PlanCache"]


class PlanCache:
    """Signature-keyed cache for plan skeletons and prepared programs.

    Callers hash the *static* part of a problem (for the serving engine:
    ``("prefill", bucket)`` / ``("decode", batch)``) and get back the cached
    entry, so repeated steps never rebuild it.  Hit/miss counters live in
    the sflog registry (one pair per cache instance), so ``log_view`` and
    ``dump_json`` report them; ``.hits`` / ``.misses`` stay readable and
    assignable.
    """

    def __init__(self, name: str = "plans"):
        self.name = name
        self._entries: Dict[Any, Any] = {}
        self._c_hits = sflog.counter(f"plancache.{name}.hits", unique=True)
        self._c_misses = sflog.counter(f"plancache.{name}.misses",
                                       unique=True)

    @property
    def hits(self) -> int:
        return self._c_hits.value

    @hits.setter
    def hits(self, v: int) -> None:
        self._c_hits.value = int(v)

    @property
    def misses(self) -> int:
        return self._c_misses.value

    @misses.setter
    def misses(self, v: int) -> None:
        self._c_misses.value = int(v)

    def get_or_build(self, key, make: Callable[[], Any]):
        try:
            out = self._entries[key]
        except KeyError:
            self._c_misses.add(1)
            out = self._entries[key] = make()
            return out
        self._c_hits.add(1)
        return out

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"name": self.name, "entries": len(self._entries),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0}

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0
