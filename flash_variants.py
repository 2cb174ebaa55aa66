#!/usr/bin/env python3
"""Time variants of the Hopper flash-attention kernel on one NVIDIA GPU.

    python3 flash_variants.py

The readings behind the fixed choices of ``csrc/flash_attention_sm90.cu``
and ``kernels/flash_attention.py::tile_height``:

  * tile width and ring depth: the source is rebuilt with other values of
    ``BC`` (keys per K/V tile) and ``STAGES``, each variant by text
    substitution into a copy under ``build/flash_variants/``; ptxas's
    registers and spills of each instance are printed with the build;
  * tile height: the committed kernel at 64 and 128 query rows per CTA.

Every variant is held against the plain version within chip_smoke's
``FLASH_TOL`` and timed (device ms, two readings each, in turns) at the
serving prefill's shapes (bf16, 32 query / 8 KV heads of 128, causal)
beside SDPA.  Prints one JSON line per build and per shape and writes only
under ``build/flash_variants/``.  Exits non-zero without a CUDA device or
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
OUT = os.path.join(HERE, "build", "flash_variants")


def ss_wrapper(n: int) -> str:
    """The m64n{n}k16 shared x shared wgmma wrapper of the source's style,
    for a tile width the committed source does not carry."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    head = (f"__device__ __forceinline__ void wgmma_ss_n{n}(float (&d)[{r}], "
            "uint64_t da, uint64_t db, int scale_d) {\n")
    ptx = ("{\\n.reg .pred p;\\nsetp.ne.b32 p, %" + str(r + 2) + ", 0;\\n"
           f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
           "{" + regs + "}, %" + str(r) + ", %" + str(r + 1)
           + ", p, 1, 1, 0, 0;\\n}\\n")
    return (head + '  asm volatile("' + ptx + '" : ' + outs
            + ' : "l"(da), "l"(db), "r"(scale_d));\n}\n')


def variant_source(src: str, bc: int, stages: int) -> str:
    edits = [("constexpr int BC = 64;", f"constexpr int BC = {bc};"),
             ("constexpr int STAGES = 2;", f"constexpr int STAGES = {stages};")]
    if bc != 64:
        edits.append(("      wgmma_ss_n64(\n", f"      wgmma_ss_n{bc}(\n"))
    for a, b in edits:
        if a not in src:
            raise SystemExit(f"flash_variants: the source no longer has "
                             f"{a!r}; update the variant edits")
        src = src.replace(a, b)
    if bc != 64:
        anchor = "// ------------------------------------------------------------------ kernel"
        src = src.replace(anchor, ss_wrapper(bc) + anchor)
    return src


VARIANTS = {  # name -> (BC, STAGES); the first is the committed one
    "bc64_s2": (64, 2), "bc64_s4": (64, 4), "bc96_s2": (96, 2),
    "bc128_s2": (128, 2)}


def build(nvcc, flags, src, csrc):
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (bc, stages) in VARIANTS.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, bc, stages))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", csrc, "-o", os.path.join(OUT, f"{name}.so"),
             path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    funcs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_variants: {name} did not build:\n{log}")
        ptxas = [{"D": int(d), "rows": 64 * int(nc), "registers": int(r),
                  "spill_stores": int(sp)}
                 for d, nc, sp, r in re.findall(
                     r"Function properties for \S*kernelILi(\d+)ELi(\d)E\S*\n"
                     r".*?(\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
                     log)]
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        f = getattr(ctypes.CDLL(os.path.join(OUT, f"{name}.so")),
                    "flash_attention_sm90_fwd")
        funcs[name] = f
    return funcs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention as fa
    src = open(os.path.join(_build.CSRC, "flash_attention_sm90.cu")).read()
    funcs = build(_build._nvcc(), _build.NVCC_FLAGS, src, str(_build.CSRC))
    argtypes = _build._SIGNATURES["flash_attention_sm90_fwd"][1]
    for f in funcs.values():
        f.argtypes, f.restype = argtypes, ctypes.c_int
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi()}), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def run(f, q, k, v, br):
        Sq, H, D = q.shape
        Skv, Hkv = k.shape[:2]
        o = torch.empty_like(q)
        order = fa._order_tensor((Sq, Skv, True, 0, 0, br), dev)
        rc = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               None, order.data_ptr(), 1, Sq, Skv, H, Hkv, D, 1, 0, 0,
               1.0 / D ** 0.5, br, order.numel(), _build.stream_of(q))
        cs.check(rc == 0, f"launch failed: {rc}")
        return o

    base = funcs[next(iter(VARIANTS))]
    for S in (128, 256, 512, 1024, 2048):
        q = torch.randn(S, 32, 128, generator=g, device=dev).bfloat16()
        k = torch.randn(S, 8, 128, generator=g, device=dev).bfloat16()
        v = torch.randn(S, 8, 128, generator=g, device=dev).bfloat16()
        want = fa.flash_attention_plain(q, k, v)
        br = fa.tile_height(1, S, 32, fa._sm_count(dev.index))
        row = {"S": S, "tile_height": br, "ms": {}}
        for name, f in funcs.items():
            cs.flash_check(run(f, q, k, v, br), want, f"{name} S={S}")
            row["ms"][name] = [cs.device_ms(lambda: run(f, q, k, v, br),
                                            dev, 20) for _ in range(2)]
        for rows in (64, 128):
            cs.flash_check(run(base, q, k, v, rows), want, f"rows={rows}")
            row["ms"][f"rows{rows}"] = [
                cs.device_ms(lambda: run(base, q, k, v, rows), dev, 20)
                for _ in range(2)]
        qt, kt, vt = (x.transpose(0, 1)[None] for x in (q, k, v))
        row["sdpa_ms"] = cs.device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), dev, 20)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
