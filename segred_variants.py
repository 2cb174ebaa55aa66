#!/usr/bin/env python3
"""Time layouts of the segment reduce's vector kernel on one NVIDIA GPU.

    python3 segred_variants.py

The readings behind the rule of ``kernels/sf_unpack.py::short_plan`` (K,
warps a CTA, items a CTA): at the paths' four row-5 shapes -- the wide-row
SF's reduce (65,536 rows of 256 f32 onto the roots of ``chip_smoke``'s
wide-row SF), a DDP bucket (one segment of 4 x 10,485,760 bf16), qwen3-4b's
token lookup transposed (4,096 random tokens onto 151,936 rows of 2,560
bf16) and a two-slot MoE transpose (8,192 rows onto 4,096 rows of 4,096
bf16) -- the committed kernel is launched with K in {1, 2, 4}, 2 or 4
warps a CTA and 1, 2 or 4 items a warp, each bitwise the plain fold, and
timed (device ms, CUDA events around CUDA-graph replays) beside the plan's
own choice and the scalar kernel.  Prints one JSON line per shape and
writes nothing.  Exits non-zero without a CUDA device or on a failed check.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS = 20


def shapes(dev, rng, g):
    """(name, buf, seg_start, seg_len) of the four shapes, made from seeds."""
    import torch
    import chip_smoke as C
    from repro_torch.core import CudaBackend
    from repro_torch.kernels import sf_pack
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    cuts = lambda ln: np.concatenate([[0], np.cumsum(ln)[:-1]])
    wide = C.random_sf(8, 1 << 14, 1 << 16, rng)
    be = CudaBackend(wide, device=dev)
    leaf = torch.randn(wide.nleafspace_total, 256, generator=g, device=dev)
    yield ("wide-row SF, 256 f32", sf_pack.pack_plain(leaf, be._k_gl_sorted),
           be._unpack.seg_first, be._unpack.seg_len)
    yield ("DDP bucket, 4 x 10,485,760 bf16",
           torch.randn(4, 10_485_760, generator=g, device=dev).to(
               torch.bfloat16), i32([0]), i32([4]))
    for what, S, M, U in (("token transpose, 2,560 bf16", 151_936, 4096,
                           2560),
                          ("MoE transpose, 4,096 bf16", 4096, 8192, 4096)):
        lens = np.bincount(rng.integers(0, S, M), minlength=S)
        yield (what, torch.randn(M, U, generator=g, device=dev).to(
            torch.bfloat16), i32(cuts(lens)), i32(lens))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("segred_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import chip_smoke as C
    from repro_torch.kernels import _build, sf_unpack as su
    _build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": C.nvidia_smi()}), flush=True)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(1)
    for what, buf, st, ln in shapes(dev, rng, g):
        S = st.numel()
        out = torch.empty((S,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                          device=dev)
        want = su.segment_reduce_plain(buf, st, ln, "sum")
        UV = buf[:1].numel() * buf.element_size() // 16
        rec = {"shape": what, "rows": int(buf.shape[0]), "segments": S,
               "plan": {k: v for k, v in dataclasses.asdict(
                   su.plan_of(buf, out, 1)).items()
                        if k in ("K", "threads", "per_cta")},
               "variants": []}

        def launch(K, W, m):
            chunks = -(-UV // (32 * K))
            items = S * chunks
            _build.launch("sf_segment_reduce_vec", buf.data_ptr(),
                          out.data_ptr(), st.data_ptr(), ln.data_ptr(), S,
                          UV, su._DTYPE_CODES[buf.dtype], 0, su.LONG_SEG,
                          items, chunks, W * m, K, 5, W,
                          -(-items // (W * m)), _build.stream_of(buf))
        for K in (1, 2, 4):
            for W in (2, 4):
                for m in (1, 2, 4):
                    run = lambda: launch(K, W, m)
                    run()
                    C.check(C.same_raw_bits(out, want),
                            f"{what} K={K} W={W} m={m} != plain")
                    rec["variants"].append(
                        {"K": K, "warps": W, "items_a_warp": m,
                         "ms": C.graph_ms(run, dev, ITERS)})
        plan_run = lambda: su.segment_reduce_sorted(buf, st, ln)
        scalar = lambda: su.short_variant(buf, st, ln, segs_per_block=1,
                                          route="scalar")
        C.check(C.same_raw_bits(plan_run(), want)
                and C.same_raw_bits(scalar(), want), f"{what} != plain")
        (rec["plan_ms"], _), (rec["scalar_ms"], _) = C.in_turns(
            plan_run, scalar, dev, ITERS, C.graph_ms)
        rb = UV * 16
        rec["bound_ms"] = C.bound(int(ln.sum()) * rb + S * (8 + rb))[0]
        best = min(rec["variants"], key=lambda r: r["ms"])
        rec["best"] = best
        print(json.dumps(rec), flush=True)
        del buf, out, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
