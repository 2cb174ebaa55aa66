"""Mesh distribution on star forests (paper §2): DMDA structured grids.

The port of ``repro.meshdist``'s DMDA; ``Section`` and the Plex functions
follow with their consumers."""

from .dmda import DMDA, default_proc_grid

__all__ = ["DMDA", "default_proc_grid"]
