#!/usr/bin/env python3
"""Time variants of the Hopper flash-attention backward on one NVIDIA GPU.

    python3 flash_bwd_variants.py

The readings behind the fixed choices of ``csrc/flash_attention_bwd.cu``'s
sm90 route and ``kernels/flash_attention.py::bwd_tiles``:

  * tiles: the committed kernels at every (dq rows, split) that
    ``bwd_tiles`` may pick (``_launch_backward_sm90(tiles=)``);
  * source constants: the backward rebuilt, by text substitution into a
    copy under ``build/flash_bwd_variants/``, with a ring of three slots
    (``RING``), with one dkdv CTA an SM allowed its registers at head size
    64 (``__launch_bounds__`` of dkdv), and with two dq CTAs an SM
    (``__launch_bounds__`` of dq); ptxas's registers and spills of each
    build are printed.

Every source variant is held against the committed kernels' bits (the
sums are taken in the same order, so the gradients must be identical),
every tile choice within chip_smoke's FLASH_BWD_REL of them, and each is
timed (device ms, graph replays, two readings each) at the training
path's bf16 shapes, beside the mma.sync route's kernels on the same
inputs.  Prints
one JSON line per build and per shape and writes only under
``build/flash_bwd_variants/``.  Exits non-zero without a CUDA device or
on a failed check.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "flash_bwd_variants")

DKDV_LB = ("__launch_bounds__(128, D == 64 ? 3 : 2)\n"
           "    flash_bwd_dkdv_sm90_kernel")
DQ_LB = "__launch_bounds__(NC * 128, 1)\n    flash_bwd_dq_sm90_kernel"
RING = "constexpr int RING = 2;"
VARIANTS = {  # name -> (text, replacement)
    "ring3": (RING, "constexpr int RING = 3;"),
    "dkdv_one_cta": (DKDV_LB, DKDV_LB.replace("D == 64 ? 3 : 2", "1")),
    "dq_two_ctas": (DQ_LB, DQ_LB.replace("(NC * 128, 1)", "(NC * 128, 2)")),
}
SHAPES = [  # name, B, Sq, Skv, H, Hkv, D, causal, window
    ("qwen3-4b step", 4, 1024, 1024, 32, 8, 128, True, None),
    ("DDP grain", 1, 1024, 1024, 32, 8, 128, True, None),
    ("hymba window", 2, 3072, 3072, 25, 5, 64, True, 2048),
    ("hymba global", 2, 3072, 3072, 25, 5, 64, True, None),
    ("whisper encoder", 8, 1500, 1500, 8, 8, 64, False, None),
    ("whisper cross", 8, 448, 1500, 8, 8, 64, False, None),
    ("whisper decoder", 8, 448, 448, 8, 8, 64, True, None),
]
TILES = [(64, False), (128, False), (64, True), (128, True)]


def build(nvcc, flags, src, csrc):
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (a, b) in VARIANTS.items():
        if a not in src:
            raise SystemExit(f"flash_bwd_variants: the source no longer "
                             f"has {a!r}; update the variant edits")
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src.replace(a, b))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", csrc, "-o", os.path.join(OUT, f"{name}.so"),
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    funcs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_bwd_variants: {name} did not build:\n"
                             f"{log}")
        ptxas = [{"kernel": k, "registers": int(r), "spill_stores": int(sp)}
                 for k, sp, r in re.findall(
                     r"Function properties for \S*(flash_bwd_\w+_sm90_kernel"
                     r"ILi\d+ELi\d+E|flash_bwd_\w+_sm90_kernelILi\d+E)\S*\n"
                     r".*?(\d+) bytes spill stores.*?\n.*?Used (\d+) "
                     r"registers", log)]
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        funcs[name] = getattr(ctypes.CDLL(os.path.join(OUT, f"{name}.so")),
                              "flash_attention_bwd_sm90")
    return funcs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention as fa
    _build.build_all()
    src = open(os.path.join(_build.CSRC, "flash_attention_bwd.cu")).read()
    funcs = build(_build._nvcc(), _build.NVCC_FLAGS, src, str(_build.CSRC))
    argtypes = _build._SIGNATURES["flash_attention_bwd_sm90"][1]
    for f in funcs.values():
        f.argtypes, f.restype = argtypes, ctypes.c_int
    committed = _build._func("flash_attention_bwd_sm90")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    for name, B, Sq, Skv, H, Hkv, D, causal, window in SHAPES:
        q, do = (torch.randn(B, Sq, H, D, generator=g, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=dev)
                .bfloat16() for _ in range(2))
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        want = fa._launch_backward_sm90(q, k, v, o, do, lse, **kw)
        row = {"shape": name, "tiles": fa.bwd_tiles(
            B, Sq, Skv, H, Hkv, D, fa._sm_count(dev.index)), "ms": {}}

        def timed(label, run, exact):
            got = run()
            ok = all(cs.same_raw_bits(a, b) if exact else
                     cs.grad_rel(a, b) <= cs.FLASH_BWD_REL
                     for a, b in zip(got, want))
            cs.check(ok, f"{label} at {name}: gradients differ from the "
                     f"committed kernels'")
            row["ms"][label] = [cs.graph_ms(run, dev, 20) for _ in range(2)]
        timed("committed", lambda: fa._launch_backward_sm90(
            q, k, v, o, do, lse, **kw), True)
        for tiles in TILES:
            if tiles[1] and H == Hkv:
                continue
            # another walk: held within FLASH_BWD_REL, not bitwise
            timed(f"tiles {tiles}", lambda: fa._launch_backward_sm90(
                q, k, v, o, do, lse, tiles=tiles, **kw), False)
        try:
            for vname, f in funcs.items():
                _build._FUNCS["flash_attention_bwd_sm90"] = f
                timed(vname, lambda: fa._launch_backward_sm90(
                    q, k, v, o, do, lse, **kw), True)
        finally:
            _build._FUNCS["flash_attention_bwd_sm90"] = committed
        row["ms"]["mma.sync route"] = [cs.graph_ms(
            lambda: fa._launch_backward_mma(q, k, v, o, do, **kw), dev, 20)
            for _ in range(2)]
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
