#!/usr/bin/env python3
"""Time variants of the Hopper flash-attention forward on one NVIDIA GPU.

    python3 flash_variants.py [d128] [d64] [split] [cut]

The readings behind the fixed choices of ``csrc/flash_attention_sm90.cu``,
of the split-KV kernels of ``csrc/flash_attention.cu`` and of
``kernels/flash_attention.py`` (``tile_height``, ``SPLIT_WAVES``,
``SPLIT_ROWS``), one section each (all four by default):

  * tile width, ring depth and ping-pong of each head size at 128-row
    tiles: the source is rebuilt with other values of ``Tiles<D, 2>``
    (``BC`` keys per K/V tile, ``STAGES``, ``PINGPONG``: the two consumer
    warpgroups issuing their wgmmas in turns), each variant by text
    substitution into a copy under
    ``build/flash_variants/``; ptxas's registers and spills of each
    instance are printed with the build.  D = 128 at the serving
    prefill's shapes (bf16, 32 query / 8 KV heads, causal); D = 64 at
    whisper's encoder (8 x 1,500, 8 heads, unmasked), hymba's prefill
    (2,750 and 512 rows, 25 / 5 heads, causal, window 2,048 and global)
    and the train path's hymba, whisper decoder and cross-attention
    shapes, beside the parent's D = 64 build (BC 64, STAGES 2, no
    ping-pong);
  * tile height: the committed kernel at 64 and 128 query rows per CTA;
  * the split-KV kernels (``split``): ``flash_attention.cu`` rebuilt with
    other ring depths (``split::STAGES``) and without the combine's
    programmatic dependent launch (``split::PDL``), and with 128-key
    tiles (``split::BC``), each at 1, 2 and 3 waves of CTAs (``split_plan``'s ``waves``), at whisper's
    cross-attention (decode and 4-token prefill), at head size 128 and
    under GQA over 1,500 and 4,096 keys;
  * the split-KV route's cut (``cut``): ``flash_attention_split`` against the wgmma
    kernel on the same inputs at Sq x H / Hkv = 1, 4, 16, 32 and 64 query
    rows per KV head over 4 to 1,500 keys (and 1,500 and 4,096 under
    GQA).

Every variant is held against the plain version within chip_smoke's
``FLASH_TOL`` and timed (device ms of CUDA-graph replays, two readings
each, in turns) beside SDPA.  Prints one JSON line per build and per shape
and writes only under ``build/flash_variants/``.  Exits non-zero without a
CUDA device or on a failed check.
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
TILES = re.compile(r"struct Tiles<(\d+), (\d)> \{\n  static constexpr int "
                   r"BC = (\d+), STAGES = (\d+);\n  static constexpr bool "
                   r"PINGPONG = (true|false);\n\};")

SPLIT = re.compile(r"constexpr int BC = (\d+);      // keys per K/V tile\n"
                   r"constexpr int STAGES = (\d+);   // cp.async ring depth"
                   r"(.*?)constexpr bool PDL = (true|false);", re.S)
# the split kernels' alternatives: (BC, STAGES, PDL), and the waves of CTAs
SPLIT_VARIANTS = [(64, 3, True), (64, 4, True), (128, 2, True),
                  (128, 3, True), (128, 3, False)]
SPLIT_WAVES = (1, 2, 3)

# alternatives per head size at 128-row tiles (Tiles<D, 2>): (BC, STAGES,
# PINGPONG); a D = 128 variant also edits Tiles<128, 1>, which has always
# had D = 128's tiles.  The committed source is timed as "committed";
# (64, 2, False) at D = 64 is the parent's build (whose Tiles<64, 1> are
# the committed ones).
VARIANTS = {128: [(64, 4, False), (128, 2, False)],
            64: [(64, 2, False), (64, 2, True), (128, 2, False),
                 (128, 3, False), (128, 2, True), (128, 4, True),
                 (128, 3, True)]}
EDITS = {128: (1, 2), 64: (2,)}     # the Tiles<D, NC> a variant edits


def committed(src: str) -> dict:
    """{(D, NC): (BC, STAGES, PINGPONG)} of the source's Tiles<D, NC>."""
    got = {(int(d), int(nc)): (int(bc), int(st), pp == "true")
           for d, nc, bc, st, pp in TILES.findall(src)}
    if set(got) != {(D, nc) for D in VARIANTS for nc in (1, 2)}:
        raise SystemExit(f"flash_variants: the source's Tiles<D, NC> are "
                         f"{sorted(got)}; update the variant edits")
    return got


def name_of(tiles) -> str:
    bc, st, pp = tiles
    return f"bc{bc}_s{st}" + ("_pp" if pp else "")


def variant_source(src: str, D: int, tiles) -> str:
    bc, st, pp = tiles

    def edit(m):
        nc = int(m.group(2))
        if int(m.group(1)) != D or nc not in EDITS[D]:
            return m.group(0)
        return (f"struct Tiles<{D}, {nc}> {{\n  static constexpr int BC = "
                f"{bc}, STAGES = {st};\n  static constexpr bool PINGPONG = "
                f"{'true' if pp else 'false'};\n}};")
    return TILES.sub(edit, src)


def builds(src: str) -> dict:
    """{build name: (D, tiles)}: the committed source, then each
    alternative that differs from it."""
    have = committed(src)
    out = {"committed": (None, None)}
    for D, alts in VARIANTS.items():
        for tiles in alts:
            if tiles != have[(D, 2)]:
                out[f"d{D}_{name_of(tiles)}"] = (D, tiles)
    return out


def split_source(src: str, bc: int, stages: int, pdl: bool) -> str:
    if not SPLIT.search(src):
        raise SystemExit("flash_variants: flash_attention.cu no longer has "
                         "split::BC, STAGES and PDL; update the edits")
    return SPLIT.sub(lambda m: f"constexpr int BC = {bc};      // keys per "
                     f"K/V tile\nconstexpr int STAGES = {stages};   // "
                     f"cp.async ring depth{m.group(3)}constexpr bool PDL = "
                     f"{'true' if pdl else 'false'};", src, count=1)


def split_builds(src: str) -> dict:
    """{build name: (BC, STAGES, PDL)}, the committed values first."""
    m = SPLIT.search(src)
    have = (int(m.group(1)), int(m.group(2)), m.group(4) == "true")
    return {f"split_bc{bc}_s{st}" + ("_pdl" if pdl else ""): (bc, st, pdl)
            for bc, st, pdl in [have] + [v for v in SPLIT_VARIANTS
                                         if v != have]}


def build(nvcc, flags, src, csrc, split_src=None) -> dict:
    """Every variant library, built in parallel: the sm90 source's (entry
    ``flash_attention_sm90_fwd``) and, given ``split_src``, the split
    kernels' (``flash_attention_split_fwd``)."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {name: (src if D is None else variant_source(src, D, tiles),
                   "flash_attention_sm90_fwd")
            for name, (D, tiles) in builds(src).items()}
    if split_src is not None:
        jobs.update({name: (split_source(split_src, *v),
                            "flash_attention_split_fwd")
                     for name, v in split_builds(split_src).items()})
    procs = {}
    for name, (text, _) in jobs.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
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
        funcs[name] = getattr(ctypes.CDLL(os.path.join(OUT, f"{name}.so")),
                              jobs[name][1])
    return funcs


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention as fa
    sections = sys.argv[1:] or ["d128", "d64", "split", "cut"]
    src = open(os.path.join(_build.CSRC, "flash_attention_sm90.cu")).read()
    split_src = open(os.path.join(_build.CSRC, "flash_attention.cu")).read()
    have = committed(src)
    funcs = build(_build._nvcc(), _build.NVCC_FLAGS, src, str(_build.CSRC),
                  split_src if "split" in sections else None)
    for name, f in funcs.items():
        entry = "flash_attention_split_fwd" if name.startswith("split_") \
            else "flash_attention_sm90_fwd"
        f.argtypes, f.restype = _build._SIGNATURES[entry][1], ctypes.c_int
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi(),
                      "committed": {f"{D}/{64 * nc}": name_of(t)
                                    for (D, nc), t in have.items()}}),
          flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    ms = lambda fn: [cs.graph_ms(fn, dev, 20) for _ in range(2)]

    # keys per K/V tile of each build at each (head size, NC): orders its
    # q tiles
    bc_of = {name: {key: (tiles if d == key[0] and key[1] in EDITS[d]
                          else have[key])[0] for key in have}
             for name, (d, tiles) in builds(src).items()}

    def run(name, q, k, v, br, causal, window):
        B, Sq, H, D = q.shape
        Skv, Hkv = k.shape[1:3]
        o = torch.empty_like(q)
        has_window, win = fa._window_arg(window, Sq, Skv)
        order = fa._order_tensor((Sq, Skv, causal, has_window, win, br,
                                  bc_of[name][(D, br // 64)]), dev)
        rc = funcs[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), None, order.data_ptr(), B, Sq, Skv, H,
                         Hkv, D, int(causal), has_window, win, 1.0 / D ** 0.5,
                         br, order.numel(), _build.stream_of(q))
        cs.check(rc == 0, f"launch failed: {rc}")
        return o

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    def sdpa_ms(q, k, v, causal, window):
        Sq, Skv = q.shape[1], k.shape[1]
        mask = None
        if window is not None:
            qpos = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
            kpos = torch.arange(Skv, device=dev)[None, :]
            mask = kpos > qpos - window
            if causal:
                mask &= kpos <= qpos
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return min(ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)))

    def time_shape(what, D, B, Sq, Skv, H, Hkv, causal, window):
        q, k, v = rand(B, Sq, H, D), rand(B, Skv, Hkv, D), rand(B, Skv, Hkv, D)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        br = fa.tile_height(B, Sq, H, fa._sm_count(dev.index))
        row = {"shape": what, "D": D, "B": B, "Sq": Sq, "Skv": Skv, "H": H,
               "Hkv": Hkv, "causal": causal, "window": window,
               "tile_height": br, "ms": {}}
        names = [n for n, (d, _) in builds(src).items() if d in (None, D)]
        for name in names:
            cs.flash_check(run(name, q, k, v, br, causal, window), want,
                           f"{name} {what}")
        # in turns: each build once, then again in reverse order
        for name in names + names[::-1]:
            row["ms"].setdefault(name, []).append(min(ms(
                lambda: run(name, q, k, v, br, causal, window))))
        for rows in (64, 128):
            cs.flash_check(run("committed", q, k, v, rows, causal, window),
                           want, f"rows={rows} {what}")
            row["ms"][f"rows{rows}"] = ms(
                lambda: run("committed", q, k, v, rows, causal, window))
        row["sdpa_ms"] = sdpa_ms(q, k, v, causal, window)
        print(json.dumps(row), flush=True)

    if "d128" in sections:
        for S in (128, 256, 512, 1024, 2048):
            time_shape(f"serving prefill S={S}", 128, 1, S, S, 32, 8, True,
                       None)
    if "d64" in sections:
        time_shape("whisper encoder", 64, 8, 1500, 1500, 8, 8, False, None)
        time_shape("hymba prefill, window 2048", 64, 1, 2750, 2750, 25, 5,
                   True, 2048)
        time_shape("hymba prefill, global", 64, 1, 2750, 2750, 25, 5, True,
                   None)
        # the other head-size-64 calls of the serving and training paths
        time_shape("hymba prefill of 512, global", 64, 1, 512, 512, 25, 5,
                   True, None)
        time_shape("hymba train step, window 2048", 64, 2, 3072, 3072, 25,
                   5, True, 2048)
        time_shape("whisper decoder, train", 64, 8, 448, 448, 8, 8, True,
                   None)
        time_shape("whisper cross-attention, train", 64, 8, 448, 1500, 8, 8,
                   False, None)

    sms = fa._sm_count(dev.index)

    split_bc = {n: v[0] for n, v in split_builds(split_src).items()}

    def run_split(name, q, k, v, waves):
        B, Sq, H, D = q.shape
        Skv, Hkv = k.shape[1:3]
        plan = fa.split_plan(B, Sq, Skv, H, Hkv, D, False, None, sms, waves,
                             split_bc[name])
        n = B * Hkv * plan.row_blocks * plan.n_split * 16 * plan.mt \
            if plan.n_split > 1 else 0
        part_o = torch.empty(n * D, dtype=torch.float32, device=dev)
        part_ml = torch.empty(2 * n, dtype=torch.float32, device=dev)
        o = torch.empty_like(q)
        rc = funcs[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), None, part_o.data_ptr() or None,
                         part_ml.data_ptr() or None, B, Sq, Skv, H, Hkv, D,
                         0, 0, 0,
                         1.0 / D ** 0.5, plan.j0, plan.n_tiles, plan.n_split,
                         plan.mt, plan.row_blocks, _build.stream_of(q))
        cs.check(rc == 0, f"{name} launch failed: {rc}")
        return o

    if "split" in sections:
        names = list(split_builds(split_src))
        for what, D, B, Sq, Skv, H, Hkv in (
                ("whisper cross, decode", 64, 8, 1, 1500, 8, 8),
                ("whisper cross, prefill", 64, 8, 4, 1500, 8, 8),
                ("D 128, 8 x 8 heads, decode", 128, 8, 1, 1500, 8, 8),
                ("D 128, 8 x 8 heads, 4 rows", 128, 8, 4, 1500, 8, 8),
                ("GQA decode, 1,500 keys", 128, 1, 1, 1500, 32, 8),
                ("GQA decode, 4,096 keys", 128, 1, 1, 4096, 32, 8)):
            q, k, v = (rand(B, Sq, H, D), rand(B, Skv, Hkv, D),
                       rand(B, Skv, Hkv, D))
            want = fa.flash_attention_plain(q, k, v, causal=False)
            keys = [(n, w) for n in names for w in SPLIT_WAVES]
            for n, w in keys:
                cs.flash_check(run_split(n, q, k, v, w), want,
                               f"{n} waves {w} {what}")
            row = {"split_shape": what, "D": D, "B": B, "Sq": Sq, "Skv": Skv,
                   "H": H, "Hkv": Hkv, "ms": {},
                   "n_split": {f"{n}_w{w}": fa.split_plan(
                       B, Sq, Skv, H, Hkv, D, False, None, sms, w,
                       split_bc[n]).n_split for n, w in keys}}
            # in turns: every (build, waves) once, then in reverse order
            for n, w in keys + keys[::-1]:
                row["ms"].setdefault(f"{n}_w{w}", []).append(min(ms(
                    lambda: run_split(n, q, k, v, w))))
            row["sm90_ms"] = min(ms(lambda: fa.launch_kernel(
                fa.SM90, q, k, v, causal=False)))
            row["sdpa_ms"] = sdpa_ms(q, k, v, False, None)
            print(json.dumps(row), flush=True)

    # the split route's cut: split KV against the wgmma kernel, in turns
    for D, B, H, Hkv, Skv, sqs in ((64, 8, 8, 8, 4, (1, 4)),
                                   (64, 8, 8, 8, 64, (1, 4, 16)),
                                   (64, 8, 8, 8, 448, (1, 4, 16)),
                                   (64, 8, 8, 8, 1500, (1, 4, 16, 32, 64)),
                                   (128, 8, 8, 8, 1500, (1, 4, 16, 32, 64)),
                                   (128, 1, 32, 8, 1500, (1, 4, 8, 16)),
                                   (128, 1, 32, 8, 4096, (1, 4, 8, 16))):
        for Sq in sqs if "cut" in sections else ():
            q, k, v = (rand(B, Sq, H, D), rand(B, Skv, Hkv, D),
                       rand(B, Skv, Hkv, D))
            want, want_lse = fa.flash_attention_plain(q, k, v, causal=False,
                                                      with_lse=True)
            split = lambda: fa.launch_kernel(fa.SPLIT, q, k, v, causal=False)
            sm90 = lambda: fa.launch_kernel(fa.SM90, q, k, v, causal=False)
            cs.flash_check(split(), want, f"split D{D} Sq{Sq}")
            cs.flash_check(sm90(), want, f"sm90 D{D} Sq{Sq}")
            o, lse = fa.launch_kernel(fa.SPLIT, q, k, v, causal=False,
                                      with_lse=True)
            cs.check(cs.same_raw_bits(o, split()), "split o differs with "
                     "the LSE")
            lse_err = float((lse - want_lse).abs().max())
            cs.check(lse_err <= cs.FLASH_LSE_ATOL, f"split LSE {lse_err}")
            (s_ms, s_runs), (w_ms, w_runs) = cs.in_turns(split, sm90, dev,
                                                         20, cs.graph_ms)
            plan = fa.split_plan(B, Sq, Skv, H, Hkv, D, False, None,
                                 fa._sm_count(dev.index))
            print(json.dumps({
                "split_cut": True, "D": D, "B": B, "Sq": Sq, "Skv": Skv,
                "H": H, "Hkv": Hkv, "rows": Sq * H // Hkv,
                "n_split": plan.n_split, "mt": plan.mt,
                "split_ms": s_ms, "split_runs": s_runs, "sm90_ms": w_ms,
                "sm90_runs": w_runs, "lse_max_abs_err": lse_err,
                "route": fa.call_route(q, k),
                "sdpa_ms": sdpa_ms(q, k, v, False, None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
