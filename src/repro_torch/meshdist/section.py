"""PetscSection analogue: map points to variable-size data, derive dof-SFs
(the port of ``repro/meshdist/section.py``).

Paper §4.2: "with an initial mesh point PetscSF, applying a PetscSection
mapping mesh points to degrees-of-freedom generates a new dof-PetscSF".
This module implements that *mechanical* derivation: given a point SF and
per-root data sizes, build the SF relating the packed dof arrays.  The same
mechanism routes variable-length sparse-matrix rows
(:mod:`repro_torch.sparse.parmat`) and mesh fields
(:mod:`repro_torch.meshdist.plex`).

The root sizes and offsets reach the leaves through ``SFComm.bcast`` on the
device (the card unless ``device="cpu"``), as PETSc bcasts the section; the
expansion into dof edges is numpy on whole arrays, edge for edge the graph
the reference's per-dof loop builds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import SFComm, StarForest, ragged_arange, ragged_offsets

__all__ = ["Section", "apply_section"]


@dataclasses.dataclass
class Section:
    """Packed layout: point p owns ``sizes[p]`` dofs at ``offsets[p]``."""
    sizes: np.ndarray
    offsets: np.ndarray   # exclusive prefix, len = npoints + 1

    @staticmethod
    def from_sizes(sizes: Sequence[int]) -> "Section":
        sizes = np.asarray(sizes, dtype=np.int64)
        return Section(sizes, ragged_offsets(sizes))

    @property
    def total(self) -> int:
        return int(self.offsets[-1])


def apply_section(point_sf: StarForest, root_sections: List[Section],
                  leaf_sections: Optional[List[Section]] = None, *,
                  backend: Optional[str] = None, device=None) -> StarForest:
    """Derive the dof-SF from a point-SF and per-rank root sections.

    Every point edge (root point -> leaf point) expands into ``size`` dof
    edges.  Leaf dof layout: if ``leaf_sections`` is None, leaf dofs are
    packed in point-edge order on each rank (the layout a fetch of
    variable-size records produces); otherwise the given leaf sections give
    each leaf point's dof offsets (ghost updates into existing layouts).

    The root dof sizes and offsets first reach the leaves through one
    ``SFComm.bcast`` each on ``device``, as PETSc bcasts the section.
    """
    point_sf.setup()
    R = point_sf.nranks
    comm = SFComm(point_sf, backend=backend, device=device)
    root_sizes = np.concatenate([s.sizes for s in root_sections]) \
        if root_sections else np.zeros(0, np.int64)
    root_offs = np.concatenate([s.offsets[:-1] for s in root_sections]) \
        if root_sections else np.zeros(0, np.int64)
    zeros = torch.zeros(point_sf.nleafspace_total, dtype=torch.int64,
                        device=comm.device)

    def bcast(a):
        return comm.bcast(torch.as_tensor(a, dtype=torch.int64,
                                          device=comm.device),
                          zeros, "replace").cpu().numpy()
    leaf_sizes, leaf_offs = bcast(root_sizes), bcast(root_offs)

    lo = point_sf.leaf_offsets()
    dof_sf = StarForest(R)
    for q in range(R):
        g = point_sf.graph(q)
        sz = leaf_sizes[lo[q] + g.local]
        edge, d = ragged_arange(sz)
        remote = np.stack([g.remote_rank[edge],
                           leaf_offs[lo[q] + g.local][edge] + d], axis=1)
        if leaf_sections is None:
            # leaf dofs packed in edge order
            local = np.arange(edge.size, dtype=np.int64)
            nleafspace = max(edge.size, 1)
        else:
            lsec = leaf_sections[q]
            if (lsec.sizes[g.local] != sz).any():
                raise ValueError("leaf section size mismatch with root")
            local = lsec.offsets[g.local][edge] + d
            nleafspace = max(lsec.total, 1)
        dof_sf.set_graph(q, root_sections[q].total, local, remote,
                         nleafspace=nleafspace)
    return dof_sf.setup()
