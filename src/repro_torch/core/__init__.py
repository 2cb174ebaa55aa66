"""repro_torch.core — the star-forest (PetscSF) communication layer.

Public API:

  StarForest, RankGraph      graph template + setup (two-sided info)
  SFComm                     user-facing facade over the backend registry
  select_backend, register_backend, available_backends
                             §4–§5 implementation selection (-sf_backend)
  UnitSpec                   §3.2 MPI_Datatype unit: payload rows are
                             (n, *unit) dof blocks on every path
  SFOps                      plain torch ops on global tensors
  patterns.analyze           §5.2 pattern discovery
  redplan                    shared sort-segment reduction machinery (§3.3)
  PlanCache                  signature-keyed cache of plans / programs
  sflog                      -log_view analogue: event/counter registry,
                             SFView introspection
"""

from .graph import PairInfo, RankGraph, StarForest, ragged_offsets
from .mpiops import Op, get_op
from .unit import UnitSpec, resolve_unit
from .ops import PendingComm, SFOps
from .plan import GlobalPlan, build_global_plan
from .redplan import ReductionPlan, build_reduction_plan
from .backend import (CudaBackend, GlobalBackend, SFBackend, SFComm,
                      available_backends, make_backend, register_backend,
                      select_backend)
from .device import resolve_device
from .dynplan import PlanCache
from . import patterns, redplan, sflog

__all__ = [
    "PairInfo", "RankGraph", "StarForest", "ragged_offsets",
    "Op", "get_op",
    "UnitSpec", "resolve_unit",
    "PendingComm", "SFOps",
    "GlobalPlan", "build_global_plan",
    "ReductionPlan", "build_reduction_plan",
    "SFBackend", "SFComm", "GlobalBackend", "CudaBackend",
    "available_backends", "make_backend", "register_backend",
    "select_backend", "resolve_device", "PlanCache",
    "patterns", "redplan", "sflog",
]
