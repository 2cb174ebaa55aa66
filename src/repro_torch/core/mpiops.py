"""Reduction-op registry: the ``MPI_Op`` analogue for SF operations.

Each op provides the pieces every execution path needs:
  * ``combine(a, b)``     elementwise combine of torch tensors,
  * ``np_combine(a, b)``  the same on numpy arrays (oracles, host code),
  * ``identity_of(dtype)`` identity element (torch or numpy dtype) as a
                           Python scalar,
  * ``segment(data, seg_ids, num)`` plain-torch segment reduction,
  * ``at_update``         the method of the duplicate-free scatter that
                          finishes an unpack: ``set``, ``add``,
                          ``multiply``, ``max`` or ``min``
                          (:func:`repro_torch.core.ops._apply_unique`).

``REPLACE`` overwrites the destination (paper: MPI_REPLACE); with duplicate
destinations PETSc leaves the winner unspecified — it is *defined* here as
the last edge in the deterministic (leaf rank, edge index) order and the
winner is precomputed at plan-build time, so results are reproducible
across backends.  ``LOR``/``LAND`` reduce as max/min over the int32 view.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

__all__ = ["Op", "get_op", "REPLACE", "SUM", "PROD", "MAX", "MIN", "LOR",
           "LAND", "torch_dtype", "expand_rows"]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def expand_rows(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Row index ``idx`` broadcast over the unit dims of ``vals``, as
    ``scatter_reduce_`` takes it."""
    return idx.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    combine: Callable          # (a, b) -> a ⊕ b
    np_combine: Callable
    identity_of: Callable      # dtype -> scalar identity
    segment: Callable          # (data, segment_ids, num_segments) -> reduced
    at_update: str             # duplicate-free scatter method
    commutative: bool = True


def _ident_sum(dtype):
    return False if torch_dtype(dtype) == torch.bool else 0


def _ident_prod(dtype):
    return True if torch_dtype(dtype) == torch.bool else 1


def _ident_max(dtype):
    dt = torch_dtype(dtype)
    if dt.is_floating_point:
        return -math.inf
    if dt == torch.bool:
        return False
    return torch.iinfo(dt).min


def _ident_min(dtype):
    dt = torch_dtype(dtype)
    if dt.is_floating_point:
        return math.inf
    if dt == torch.bool:
        return True
    return torch.iinfo(dt).max


def _segment(reduce: str, ident: Callable) -> Callable:
    """Plain segment reduction: ``out[s[i]] ⊕= d[i]`` over identity rows."""
    def seg(d, s, n):
        out = torch.full((n,) + tuple(d.shape[1:]), ident(d.dtype),
                         dtype=d.dtype, device=d.device)
        if reduce == "sum":
            return out.index_add_(0, s, d)
        return out.scatter_reduce_(0, expand_rows(s, d), d, reduce,
                                   include_self=True)
    return seg


def _logical_segment(reduce: str, ident: Callable) -> Callable:
    inner = _segment(reduce, ident)
    return lambda d, s, n: inner(d.to(torch.int32), s, n).to(d.dtype)


SUM = Op(
    "sum",
    combine=lambda a, b: a + b,
    np_combine=lambda a, b: a + b,
    identity_of=_ident_sum,
    segment=_segment("sum", _ident_sum),
    at_update="add",
)

PROD = Op(
    "prod",
    combine=lambda a, b: a * b,
    np_combine=lambda a, b: a * b,
    identity_of=_ident_prod,
    segment=_segment("prod", _ident_prod),
    at_update="multiply",
)

MAX = Op(
    "max",
    combine=torch.maximum,
    np_combine=np.maximum,
    identity_of=_ident_max,
    segment=_segment("amax", _ident_max),
    at_update="max",
)

MIN = Op(
    "min",
    combine=torch.minimum,
    np_combine=np.minimum,
    identity_of=_ident_min,
    segment=_segment("amin", _ident_min),
    at_update="min",
)

LOR = Op(
    "lor",
    combine=lambda a, b: torch.logical_or(a, b).to(a.dtype),
    np_combine=lambda a, b: np.logical_or(a, b).astype(np.asarray(a).dtype),
    identity_of=lambda dt: 0,
    segment=_logical_segment("amax", _ident_max),
    at_update="max",
)

LAND = Op(
    "land",
    combine=lambda a, b: torch.logical_and(a, b).to(a.dtype),
    np_combine=lambda a, b: np.logical_and(a, b).astype(np.asarray(a).dtype),
    identity_of=lambda dt: 1,
    segment=_logical_segment("amin", _ident_min),
    at_update="min",
)

# REPLACE: combine(a, b) = b; reductions take the precomputed last writer.
REPLACE = Op(
    "replace",
    combine=lambda a, b: b,
    np_combine=lambda a, b: b,
    identity_of=lambda dt: 0,
    segment=None,  # handled specially via precomputed winners
    at_update="set",
    commutative=False,
)

_OPS = {o.name: o for o in [SUM, PROD, MAX, MIN, LOR, LAND, REPLACE]}
# MPI-flavored aliases.
_OPS.update({
    "mpi_sum": SUM, "mpi_replace": REPLACE, "mpi_max": MAX, "mpi_min": MIN,
    "mpi_prod": PROD, "mpi_lor": LOR, "mpi_land": LAND,
})


def get_op(op) -> Op:
    if isinstance(op, Op):
        return op
    try:
        return _OPS[str(op).lower()]
    except KeyError:
        raise ValueError(f"unknown SF op: {op!r}; have {sorted(set(_OPS))}")
