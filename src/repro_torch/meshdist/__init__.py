"""Mesh distribution on star forests (paper §2/§6.3): DMDA structured
grids, Plex-style unstructured distribution, Sections, and §2 composed-SF
overlap growth — the port of ``repro.meshdist``."""

from .dmda import DMDA, default_proc_grid
from .plex import (DistributedMesh, HexMesh, Overlap, distribute,
                   grow_overlap, initial_distribution, make_vertex_sf)
from .section import Section, apply_section

__all__ = [
    "DMDA",
    "DistributedMesh",
    "HexMesh",
    "Overlap",
    "Section",
    "apply_section",
    "default_proc_grid",
    "distribute",
    "grow_overlap",
    "initial_distribution",
    "make_vertex_sf",
]
