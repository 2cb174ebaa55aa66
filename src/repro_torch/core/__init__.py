"""repro_torch.core — the star-forest (PetscSF) communication layer.

Public API:

  StarForest, RankGraph      graph template + setup (two-sided info)
  SFComm                     user-facing facade over the backend registry
  select_backend, register_backend, available_backends
                             §4–§5 implementation selection (-sf_backend)
  UnitSpec                   §3.2 MPI_Datatype unit: payload rows are
                             (n, *unit) dof blocks on every path
  SFOps                      plain torch ops on global tensors
  DistSF, DistPending, PaddedPlan
                             per-rank SF ops over a torch.distributed group
                             (the "dist" backend, DistBackend)
  FieldBundle, FieldSpec     fused multi-field exchange (SFComm.*_multi)
  patterns.analyze           §5.2 pattern discovery
  redplan                    shared sort-segment reduction machinery (§3.3)
  DynPlan, star_forest_from_assignment
                             runtime-routed SFs (MoE dispatch): the edge
                             list is a device tensor given to each op
  PlanCache                  signature-keyed cache of plans / programs
  sflog                      -log_view analogue: event/counter registry,
                             SFView introspection
  compose, compose_inverse, embed_roots, embed_leaves, identity_sf,
  make_multi_sf              §2 derived SFs (host-side graph algebra)
  simulate                   numpy edge-semantics oracle of every op
"""

from .graph import (PairInfo, RankGraph, StarForest, ragged_arange,
                    ragged_offsets)
from .compose import (compose, compose_inverse, embed_leaves, embed_roots,
                      identity_sf, make_multi_sf)
from .mpiops import Op, get_op
from .unit import UnitSpec, resolve_unit
from .ops import PendingComm, SFOps
from .fields import FieldBundle, FieldSpec, PendingMulti
from .plan import GlobalPlan, PaddedPlan, build_global_plan, \
    build_padded_plan
from .distributed import DistPending, DistSF, pad_ragged, unpad_ragged
from .redplan import ReductionPlan, build_reduction_plan
from .backend import (CudaBackend, DistBackend, GlobalBackend, SFBackend,
                      SFComm,
                      available_backends, estimate_message_bytes,
                      make_backend, register_backend, select_backend)
from .device import resolve_device
from .dynplan import (BoundDynSF, DynPlan, PlanCache,
                      star_forest_from_assignment)
from . import patterns, redplan, sflog, simulate

__all__ = [
    "PairInfo", "RankGraph", "StarForest", "ragged_arange", "ragged_offsets",
    "compose", "compose_inverse", "embed_leaves", "embed_roots",
    "identity_sf", "make_multi_sf",
    "Op", "get_op",
    "UnitSpec", "resolve_unit",
    "PendingComm", "SFOps",
    "FieldBundle", "FieldSpec", "PendingMulti",
    "GlobalPlan", "PaddedPlan", "build_global_plan", "build_padded_plan",
    "DistSF", "DistPending", "pad_ragged", "unpad_ragged",
    "ReductionPlan", "build_reduction_plan",
    "SFBackend", "SFComm", "GlobalBackend", "CudaBackend", "DistBackend",
    "available_backends", "make_backend", "register_backend",
    "select_backend", "estimate_message_bytes", "resolve_device",
    "PlanCache",
    "DynPlan", "BoundDynSF", "star_forest_from_assignment",
    "patterns", "redplan", "sflog", "simulate",
]
