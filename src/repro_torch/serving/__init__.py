"""repro_torch.serving — continuous-batching serving on the port's dense
transformer (``engine``) and the open-loop load generator (``loadgen``)."""

from .engine import Request, ServeEngine, next_pow2
from .loadgen import LoadSpec, drive, synthesize, trace_fingerprint

__all__ = ["Request", "ServeEngine", "next_pow2", "LoadSpec", "drive",
           "synthesize", "trace_fingerprint"]
