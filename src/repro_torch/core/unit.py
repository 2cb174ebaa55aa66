"""Unit specification — the ``MPI_Datatype unit`` of every SF operation.

The paper's API takes a datatype on each ``PetscSFBcast``/``Reduce``: SF
payloads are dof *blocks*, not scalars (a vertex carries 3 coordinates, a
cell 8 corner ids, a multi-RHS column block k values).  ``UnitSpec`` is that
concept for the port: the trailing shape (and optionally dtype) of every
payload row.  Plans carry one (:mod:`repro_torch.core.plan`), backends
validate against it, and the kernels copy or reduce whole rows of it
(:mod:`repro_torch.kernels.sf_pack` / ``sf_unpack``).

``shape=()`` with ``dtype=None`` is the unconstrained default: any payload
passes.  Pinning a shape/dtype turns shape mismatches into setup-style
errors at the SF boundary instead of opaque kernel failures downstream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["UnitSpec", "check_plan_unit", "resolve_unit"]


def _np_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy or torch dtype (torch's bfloat16, which numpy
    lacks, maps to a 2-byte void so that its row size still counts)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype("V2")
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


@dataclasses.dataclass(frozen=True)
class UnitSpec:
    """Trailing per-row block shape (and optional dtype) of SF payloads.

    ``shape=None`` leaves the row shape free (the unconstrained default);
    ``shape=()`` pins scalar rows; ``shape=(3,)`` pins 3-vectors, etc.
    ``dtype=None`` leaves the element type free (the same plan serves f32
    coordinates and i32 labels, as one ``MPI_Datatype`` map serves many
    buffers in the paper).
    """

    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[Any] = None

    def __post_init__(self):
        if self.shape is not None:
            object.__setattr__(self, "shape",
                               tuple(int(d) for d in self.shape))
        if self.dtype is not None:
            object.__setattr__(self, "dtype", _np_dtype(self.dtype))

    @property
    def size(self) -> int:
        """Elements per row (flat width of the unit block)."""
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> Optional[int]:
        """Bytes per row when shape and dtype are pinned, else None."""
        if self.dtype is None or self.shape is None:
            return None
        return self.size * np.dtype(self.dtype).itemsize

    @property
    def constrained(self) -> bool:
        return self.shape is not None or self.dtype is not None

    @staticmethod
    def of(data) -> "UnitSpec":
        """The unit an array implies: its trailing dims and dtype."""
        return UnitSpec(tuple(int(d) for d in data.shape[1:]),
                        _np_dtype(data.dtype))

    def check(self, data, what: str = "data") -> None:
        """Validate ``data`` rows against the pinned parts of this unit
        (no-op when unconstrained)."""
        if self.shape is not None \
                and tuple(int(d) for d in data.shape[1:]) != self.shape:
            raise ValueError(
                f"{what} rows have unit shape "
                f"{tuple(data.shape[1:])}, plan unit is {self.shape}")
        if self.dtype is not None and _np_dtype(data.dtype) != self.dtype:
            raise ValueError(
                f"{what} dtype {data.dtype} != plan unit dtype "
                f"{self.dtype}")


def check_plan_unit(plan, unit) -> None:
    """An explicit ``plan=`` carries its own unit; a *different* explicit
    ``unit=`` alongside it would be silently ignored — refuse instead."""
    if unit is None:
        return
    want = resolve_unit(unit)
    if want != plan.unit:
        raise ValueError(
            f"explicit plan carries unit {plan.unit}, but unit={want} was "
            f"also requested; rebuild the plan with that unit or drop one "
            f"of the two arguments")


def resolve_unit(unit) -> UnitSpec:
    """Coerce ``None`` / shape tuple / int / UnitSpec to a UnitSpec."""
    if unit is None:
        return UnitSpec()
    if isinstance(unit, UnitSpec):
        return unit
    if isinstance(unit, (int, np.integer)):
        return UnitSpec((int(unit),))
    return UnitSpec(tuple(unit))
