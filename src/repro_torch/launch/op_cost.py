"""Per-device cost of one step, counted op by op (the port's counterpart of
``repro/launch/hlo_cost.py``).

The reference parses the compiled, SPMD-partitioned HLO module.  The port
runs eagerly, so :func:`analyze_step` runs the step once under a
``TorchDispatchMode`` and counts what each rank executes.  The mode lets a
DTensor op pass (``NotImplemented``, as ``CommDebugMode`` does), so it sees
the op after DTensor has split it: the local computation at each rank's
shard shapes and the collectives that redistribute between layouts.  Every
count is therefore per device, and equals the plain count at world 1.

  flops             ``torch.utils.flop_counter``'s formulas (matrix
                    products, convolutions, attention, and the flash
                    kernel's operator, ``kernels.flash_attention``), at
                    local shapes
  bytes_accessed    each non-view op's local inputs read once and its
                    outputs written once, an expanded operand at its
                    storage's size (eager: no fusion, so elementwise chains
                    count each intermediate, where XLA's fusions would not)
  collective_*      functional collectives: the bytes of each one's local
                    input (all-reduce, all-to-all, reduce-scatter) or
                    output (all-gather), by kind
  peak_bytes        the most bytes of storage alive at once: the tracked
                    arguments' (:meth:`CostMode.track`) and every op
                    output's, each storage counted once from the op that
                    made it until it is freed (the caching allocator's
                    rounding and fragmentation are not modelled)

DTensor works out an op's output shape by running the op once more on
fake tensors at its global shapes the first time it meets that op and
layout (``ShardingPropagator._propagate_tensor_meta_non_cached``); the
mode counts nothing while that runs, so a count does not depend on what
ran before it.

Eager execution runs every loop iteration, except the recurrences'
time loops (hymba's SSM scan, xlstm's cells), which on the dry run's fake
tensors run one step under :func:`trips`: its counts are multiplied by
the number of steps, as the reference multiplies a while loop's body by
``while_trip_counts`` (an eager count of xlstm's 4,096-step train cell
would take hours of host time).  What the steps not run would keep alive
at once (xlstm's per-step outputs until they are stacked, and the
activations a chunk's recompute saves for its backward) is added to the
live bytes by :func:`held`.  Ops made once per loop (stacking the steps'
outputs, the gradients of the whole sequences) are counted once, so the
select backward of each step's slice, which eager autograd pays at every
step, is not counted.
``unresolved_whiles`` has no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, Iterable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpCost", "analyze_step", "CostMode", "trips", "held"]

# functional collectives (c10d functional and its legacy wrappers) by kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}
_GATHERS = ("all-gather",)
_SKIP = ("wait_tensor",)

_TRIPS = [1]           # the product of the active trips() counts
_ACTIVE = []           # the CostModes entered, innermost last


@contextlib.contextmanager
def trips(n: int) -> Iterator[None]:
    """Within the block every op counts as run ``n`` times more (the one
    trip of a loop of ``n`` identical trips that is run)."""
    _TRIPS.append(_TRIPS[-1] * int(n))
    try:
        yield
    finally:
        _TRIPS.pop()


@contextlib.contextmanager
def held(nbytes: int) -> Iterator[None]:
    """Within the block ``nbytes`` more bytes count as live in the
    innermost :class:`CostMode` (none outside one): storage that the trips
    a loop does not run would hold at once."""
    mode = _ACTIVE[-1] if _ACTIVE else None
    n = int(nbytes) if mode is not None else 0
    if n > 0:
        mode.live_bytes += n
        mode.cost.peak_bytes = max(mode.cost.peak_bytes, mode.live_bytes)
    try:
        yield
    finally:
        if n > 0:
            mode.live_bytes -= n


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    peak_bytes: int = 0


def _nbytes(tree) -> int:
    """The bytes of the tensors of ``tree``: each one's elements, or its
    storage where that is smaller (an expanded, stride-0 operand)."""
    leaves, _ = tree_flatten(tree)
    return sum(min(t.numel() * t.element_size(),
                   t.untyped_storage().nbytes())
               for t in leaves if isinstance(t, torch.Tensor))


def _aliases(func) -> tuple:
    """(returns a view, writes in place) from the op's schema."""
    infos = [r.alias_info for r in func._schema.returns
             if r.alias_info is not None]
    return (any(not a.is_write for a in infos),
            any(a.is_write for a in infos))


class CostMode(TorchDispatchMode):
    """Counts an :class:`OpCost` over the ops run under it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.cost = OpCost()
        self.live: Dict[int, int] = {}      # storage -> bytes
        self.live_bytes = 0
        self.paused = 0                     # inside DTensor's propagation
        self._unpatch = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        mode = self

        def propagate(prop, *args, **kwargs):
            mode.paused += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                mode.paused -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate

        def unpatch():
            ShardingPropagator._propagate_tensor_meta_non_cached = orig
        self._unpatch = unpatch
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            self._unpatch()

    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count these tensors' storages (a DTensor's local shard) as live
        until they are freed: the step's arguments."""
        from torch.distributed.tensor import DTensor
        for t in tensors:
            self._hold(t.to_local() if isinstance(t, DTensor) else t)

    def _hold(self, t: torch.Tensor) -> None:
        # a storage's Python object lives as long as the storage (a
        # tensor's may die first while autograd keeps the storage)
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.live_bytes += self.live[key]
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented       # count it once DTensor has split it
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(t)
        packet = func._overloadpacket
        name = packet.__name__
        c = self.cost
        n = _TRIPS[-1]
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            nb = _nbytes(out if kind in _GATHERS else args[0]) * n
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + n
            c.collective_bytes_by_kind[kind] = \
                c.collective_bytes_by_kind.get(kind, 0) + nb
            c.collective_bytes += nb
            return out
        if name in _SKIP:
            return out
        if packet in self.registry:
            c.flops += n * self.registry[packet](*args, **kwargs,
                                                 out_val=out)
        view, inplace = _aliases(func)
        if not view:
            # an in-place op's output is its first operand, read once and
            # written once
            c.bytes_accessed += n * (_nbytes(args) + _nbytes(kwargs) + (
                _nbytes(args[0]) if inplace else _nbytes(out)))
        return out


def analyze_step(fn: Callable, args) -> OpCost:
    """Run ``fn(*args)`` once under :class:`CostMode` and return its
    per-device cost; ``peak_bytes`` counts the arguments and everything the
    step makes (its outputs too, which are alive at its end)."""
    from ..training.pytree import tree_leaves
    mode = CostMode()
    mode.track(t for t in tree_leaves(args) if isinstance(t, torch.Tensor))
    with mode:
        out = fn(*args)
    del out
    return mode.cost
