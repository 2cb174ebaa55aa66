"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file has a plain C interface.  At first use, each is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``build/repro_torch/`` at the repository root, one ``nvcc`` per source
and all of them started together, then loaded with ``ctypes``.  A library's
file name carries a hash of its source, the ``csrc/*.cuh`` headers it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.

A build or load failure raises; nothing falls back to the plain versions.
Kernels launch on ``torch.cuda.current_stream()``; every C entry point
returns ``cudaGetLastError()`` after its launch and :func:`launch` raises
on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "launch", "stream_of",
           "ptxas_report"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sf_pack", "sf_unpack", "spmv_ell", "flash_attention",
           "flash_attention_sm90", "flash_attention_bwd")
# -Xptxas=-v: registers, spills and shared memory of every kernel go into
# the build log beside each library (ptxas_report reads them)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C entry point -> (library, argtypes); every one returns int.
_SIGNATURES = {
    "sf_gather_rows": ("sf_pack", [_P, _P, _P, _L, _L, _I, _L, _P]),
    "sf_gather_strided": ("sf_pack", [_P, _P, _L, _L, _I, _L, _L, _L, _L,
                                      _L, _P]),
    "sf_bcast_fused_copy": ("sf_pack", [_P, _P, _P, _P, _L, _L, _I, _P]),
    "sf_bcast_fused_cast": ("sf_pack", [_P, _P, _P, _P, _L, _L, _I, _I, _I,
                                        _P]),
    "sf_gather_wide": ("sf_pack", [_P, _P, _P, _I, _L, _I, _I, _I, _I, _I,
                                   _L, _P]),
    "sf_gather_narrow": ("sf_pack", [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _P]),
    "sf_bcast_narrow_copy": ("sf_pack", [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _P]),
    "sf_bcast_narrow_cast": ("sf_pack", [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _I, _I, _P]),
    "sf_strided_panels": ("sf_pack", [_P, _P, _L, _L, _L, _I, _I, _I, _I,
                                      _I, _I, _P]),
    "sf_strided_lanes": ("sf_pack", [_P, _P, _I, _I, _L, _L, _L, _I, _I, _I,
                                     _I, _P]),
    "sf_segment_reduce": ("sf_unpack", [_P, _P, _P, _P, _L, _L, _I, _I, _I,
                                        _I, _L, _I, _I, _I, _P]),
    "sf_segment_reduce_vec": ("sf_unpack", [_P, _P, _P, _P, _L, _L, _I, _I,
                                            _I, _I, _I, _I, _I, _I, _I, _I,
                                            _P]),
    "sf_segment_reduce_long": ("sf_unpack", [_P, _P, _P, _P, _P, _P, _P, _P,
                                             _L, _L, _L, _I, _I, _P]),
    "sf_spmv_ell": ("spmv_ell", [_P, _P, _P, _P, _L, _I, _I, _P]),
    "flash_attention_fwd": ("flash_attention", [_P, _P, _P, _P, _I, _I, _I,
                                                _I, _I, _I, _I, _I, _I, _F,
                                                _I, _P]),
    "flash_attention_sm90_fwd": ("flash_attention_sm90",
                                 [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _F, _I, _I, _P]),
    "flash_attention_split_fwd": ("flash_attention",
                                  [_P] * 7 + [_I] * 9 + [_F] + [_I] * 5
                                  + [_P]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            [_P] * 14 + [_I] * 11 + [_F, _I, _P]),
    "flash_attention_bwd_sm90": ("flash_attention_bwd",
                                 [_P] * 14 + [_I] * 11 + [_F, _I, _I, _P]),
}

_LOCK = threading.Lock()
_FUNCS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin "
                       "or /usr/local/cuda/bin); it is needed to build the "
                       "CUDA kernels")


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the headers a source includes by quotes (csrc/*.cuh) are part of it
    heads = b"".join((CSRC / h.decode()).read_bytes() for h in
                     sorted(set(re.findall(rb'#include "([^"]+)"', src))))
    digest = hashlib.sha1(src + heads
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel, and
    return the seconds it took.  Raises with the compiler's output if any
    build fails."""
    t0 = time.perf_counter()
    todo = [(n, _library_path(n)) for n in SOURCES]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, out in todo:
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp,
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})"
                              f"\n{log}")
            else:
                os.replace(tmp, out)
                out.with_suffix(".log").write_text(log)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(errors))
    return time.perf_counter() - t0


def _load() -> None:
    build_all()
    libs = {n: ctypes.CDLL(str(_library_path(n))) for n in SOURCES}
    for fn, (lib, argtypes) in _SIGNATURES.items():
        f = getattr(libs[lib], fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FUNCS[fn] = f
    err = libs["sf_pack"].sf_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _FUNCS["sf_cuda_error_string"] = err


def _func(name: str):
    f = _FUNCS.get(name)
    if f is None:
        with _LOCK:
            if not _FUNCS:
                _load()
        f = _FUNCS[name]
    return f


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of torch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptxas_report(name: str) -> list:
    """Registers, spills and shared memory of each kernel in source
    ``name`` as ``ptxas -v`` printed them when its library was built:
    ``[{"function", "registers", "spill_stores", "spill_loads",
    "smem_bytes"}]`` (empty if the library was built without a log)."""
    log = _library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    out, fn = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = {"function": m.group(1)}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            fn["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            fn["smem_bytes"] = int(m.group(1)) if m else 0
            out.append(fn)
            fn = None
    return out


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` and raise if it reports an error."""
    rc = _func(name)(*args)
    if rc == -1:
        raise RuntimeError(f"{name}: unsupported dtype, op code, row width "
                           f"or launch plan")
    if rc == -2:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a "
                           f"tensor map")
    if rc != 0:
        msg = _func("sf_cuda_error_string")(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")
