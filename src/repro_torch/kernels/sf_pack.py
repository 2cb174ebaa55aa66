"""SF pack: gather rows into a contiguous send buffer, and the fused local
bcast — the Hopper port of ``repro/kernels/sf_pack.py``.

Paper §5.2/§5.3: ``rootbuf[i] = rootdata[rootidx[i]]`` executed as a device
kernel.  The CUDA kernels (``csrc/sf_pack.cu``) copy rows as raw bits, so
every dtype and every unit shape ``(n, *unit)`` goes through the same code;
the source row comes from an int32 index list or is computed from a 3D box.
The source's note gives the bound (bytes) and the design.

Entry points (each counts its launches in ``<function>.launches``):
  * ``pack``          — one row per CTA (Pallas ``pack``, one row per step);
  * ``pack_blocked``  — the blocked gather (Pallas ``pack_blocked``): rows
                        of 1–4 32-bit words take the narrow kernel, 4 rows
                        per thread, walked as :func:`row_plan` says; other
                        rows the generic loop, ``block_rows`` rows per CTA;
  * ``pack_strided``  — paper §5.2 ¶3 parametric pack: rows
                        ``start + i + j*sy + k*sz`` for (i,j,k) < dims, k
                        outer, then j, then i; no index array exists: the
                        ``dy * dz`` panels of ``dx`` rows are copied as
                        :func:`strided_plan` says;
  * ``bcast_fused``   — ``out[l] = cast(root[src_of_leaf[l]])`` where the
                        inverse map is set, else ``leaf[l]``: the local
                        pack→unpack of paper §5.2's local/remote split in
                        one race-free pass (``inverse_map`` builds the map
                        at setup); narrow rows as ``pack_blocked``.

Each has a plain PyTorch version (``*_plain``).  A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import _build
from ._index import device_index, require_cuda_tensor

__all__ = ["pack", "pack_blocked", "pack_strided", "bcast_fused",
           "inverse_map", "pack_plain", "pack_strided_plain",
           "bcast_fused_plain", "RowPlan", "row_plan",
           "gather_generic", "bcast_variant", "StridedPlan", "strided_plan",
           "box_plan", "strided_variant"]

# dtype codes of the cast kernels (csrc/sf_pack.cu)
_CAST_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 3}

ROWS_PER_THREAD = 4     # csrc/sf_pack.cu kRows
MIN_THREADS = 128       # narrow CTAs: 128-256 threads (kMaxThreads)
MAX_THREADS = 256
NARROW_WORDS = 4        # widest narrow row: 4 words (copy) / elements (cast)
THREADS_PER_SM = 2048   # Hopper: resident threads per SM
H100_SMS = 132
BCAST_BLOCK_ROWS = 64   # bcast_fused's block_rows (its generic loop's rows
                        # per CTA, as first built)
_FLAG_IDX_VEC, _FLAG_STREAMING, _FLAG_LANES, _FLAG_STREAM_LOADS = 1, 2, 4, 8
_FLAG_CHECK_IDX = 16    # the checked gather: traps on an index out of range


def _row_bytes(t: torch.Tensor) -> int:
    # math.prod, not np.prod: this runs on every launch, where numpy's call
    # overhead showed in the host time per call (PERF.md)
    return math.prod(t.shape[1:]) * t.element_size()


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ------------------------------------------------------------ launch plan
@dataclasses.dataclass(frozen=True)
class RowPlan:
    """How one ``pack_blocked`` / ``bcast_fused`` launch walks its ``M``
    output rows of ``row_bytes`` bytes.

    Narrow (``narrow``): rows of ``words`` units of ``unit_bytes`` (32-bit
    words for a copy, leaf elements for a cast); a CTA of ``threads``
    threads takes tiles of ``tile_rows`` rows, CTA ``c`` of ``grid`` the
    tiles ``c, c + grid, ...`` of ``tiles``, ``ROWS_PER_THREAD`` rows' worth
    of units per thread.  Rows layout (``lanes`` false, one load of
    ``load_words`` words carries a row): a thread owns 4 consecutive rows,
    their indices in one 16-byte load when ``idx_vec``.  Lanes layout: a
    warp owns 128 consecutive rows and lane ``l`` moves units ``l, l + 32,
    ...`` of them.  ``streaming``: evict-first output stores;
    ``stream_loads``: evict-first index and leaf loads.  Generic: the first
    kernels' loop, ``rows_per_cta`` rows per CTA in ``word_bytes``-byte
    words."""
    M: int
    row_bytes: int
    narrow: bool
    words: int = 0
    unit_bytes: int = 4
    load_words: int = 1
    idx_vec: bool = False
    lanes: bool = False
    threads: int = 0
    tile_rows: int = 0
    tiles: int = 0
    grid: int = 0
    rows_per_cta: int = 0
    word_bytes: int = 0
    streaming: bool = False
    stream_loads: bool = False

    @property
    def flags(self) -> int:
        return (_FLAG_IDX_VEC if self.idx_vec else 0) | \
            (_FLAG_STREAMING if self.streaming else 0) | \
            (_FLAG_LANES if self.lanes else 0) | \
            (_FLAG_STREAM_LOADS if self.stream_loads else 0)

    @property
    def store_bytes(self) -> int:
        """Width of the narrow kernel's vector stores (``store_words``)."""
        chunk = ROWS_PER_THREAD * self.row_bytes
        return 16 if chunk % 16 == 0 else 8 if chunk % 8 == 0 else 4

    def walk(self) -> dict:
        """The launch's memory accesses as the kernel computes them, in
        numpy: ``stores`` (byte offset, width) of every store into the
        output, ``index_loads`` (byte offset, width) of every index load,
        and ``row_load_bytes``, the width of a source-row load."""
        if not self.narrow:
            return self._walk_generic()
        return self._walk_lanes() if self.lanes else self._walk_rows()

    def _tile_starts(self) -> np.ndarray:
        """The first row of every tile, in the order the CTAs walk them."""
        if not self.tiles:
            return np.zeros(0, np.int64)
        return np.concatenate([np.arange(c, self.tiles, self.grid)
                               for c in range(self.grid)]) * self.tile_rows

    def _walk_lanes(self) -> dict:
        M, W, ub = self.M, self.words, self.unit_bytes
        tid = np.arange(self.threads)
        # unit k of a thread: position lane + 32 k of its warp's 128 rows
        warp_row0 = (tid // 32) * 32 * ROWS_PER_THREAD
        p = (tid % 32)[:, None] + 32 * np.arange(ROWS_PER_THREAD * W)[None, :]
        row0 = self._tile_starts()[:, None, None] + warp_row0[None, :, None]
        rows = row0 + p // W
        live = rows < M
        starts = ((row0 * W + p) * ub)[live]
        return {"stores": (starts, np.full(starts.size, ub)),
                "index_loads": (rows[live] * 4, np.full(starts.size, 4)),
                "row_load_bytes": ub}

    def _walk_rows(self) -> dict:
        R, M, rb = ROWS_PER_THREAD, self.M, self.row_bytes
        row0 = (self._tile_starts()[:, None]
                + np.arange(self.threads)[None, :] * R).reshape(-1)
        full = row0[row0 + R <= M]
        tail = row0[(row0 < M) & (row0 + R > M)]
        sb = self.store_bytes
        starts = [full * rb + k * sb for k in range(R * rb // sb)]
        tail_rows = np.concatenate([np.arange(r, M) for r in tail]) \
            if tail.size else np.zeros(0, np.int64)
        ub = self.unit_bytes
        starts += [tail_rows * rb + k * ub for k in range(rb // ub)]
        widths = [np.full(full.size, sb)] * (R * rb // sb) + \
            [np.full(tail_rows.size, ub)] * (rb // ub)
        if self.idx_vec:
            idx = [(full * 4, np.full(full.size, 16))]
        else:
            idx = [((full + j) * 4, np.full(full.size, 4)) for j in range(R)]
        idx.append((tail_rows * 4, np.full(tail_rows.size, 4)))
        return {"stores": (np.concatenate(starts), np.concatenate(widths)),
                "index_loads": (np.concatenate([a for a, _ in idx]),
                                np.concatenate([w for _, w in idx])),
                "row_load_bytes": self.load_words * self.unit_bytes}

    def _walk_generic(self) -> dict:
        M, rb, rpc, wb = self.M, self.row_bytes, self.rows_per_cta, \
            self.word_bytes
        wpr = rb // wb
        r0 = np.arange(0, M, rpc)
        nrows = np.minimum(rpc, M - r0)
        # CTA c, thread-stride item t < nrows * wpr: row r0 + t // wpr,
        # word t % wpr
        cta = np.repeat(np.arange(r0.size), nrows * wpr)
        t = np.arange(cta.size) - np.repeat(np.cumsum(nrows * wpr)
                                            - nrows * wpr, nrows * wpr)
        rows = r0[cta] + t // wpr
        starts = rows * rb + (t % wpr) * wb
        item_rows = np.unique(rows)
        return {"stores": (starts, np.full(starts.size, wb)),
                "index_loads": (item_rows * 4, np.full(item_rows.size, 4)),
                "row_load_bytes": wb}


def _generic_word_bytes(ptrs, row_bytes: int) -> int:
    """The generic kernels' word: the widest of 16/8/4/2/1 bytes dividing
    the row size and every base pointer (csrc/sf_pack.cu word_bytes); the
    pointers' offsets from 16-byte alignment decide it."""
    p = int(row_bytes)
    for q in ptrs:
        p |= int(q)
    return next(w for w in (16, 8, 4, 2, 1) if p % w == 0)


def row_plan(M: int, row_bytes: int, block_rows: int, *, src_ptrs,
             out_ptr: int, idx_ptr: int, cast_unit_bytes=None,
             sms: int = H100_SMS) -> RowPlan:
    """The launch plan of ``M`` rows of ``row_bytes`` bytes read from the
    arrays at ``src_ptrs`` (the gather's data; the bcast's root and leaf)
    into ``out_ptr``, indices at ``idx_ptr``.  ``cast_unit_bytes``: the
    leaf element size of a casting bcast (rows of elements, not words).

    Narrow rows — 1 to 4 words (or cast elements), 32-bit-aligned sources,
    a 16-byte-aligned output — take the narrow kernels (the rows layout
    where one load carries a row, else the lanes layout): threads
    ``ceil(block_rows / 4)`` rounded up to a whole warp and held to
    128–256, a tile of 4 rows per thread, and as many CTAs as give each
    the same number of tiles within ``sms`` times the CTAs an SM holds
    (one tile each while the tiles fit: one short wave).  Other rows take
    the generic loop at ``block_rows`` rows per CTA.  Only the pointers'
    offsets from 16-byte alignment matter, and plans are memoized on them:
    the path asks for one on every launch."""
    if int(block_rows) < 1:
        raise ValueError("block_rows must be >= 1")
    return _row_plan(int(M), int(row_bytes), int(block_rows),
                     tuple(int(p) % 16 for p in src_ptrs), int(out_ptr) % 16,
                     int(idx_ptr) % 16, cast_unit_bytes, int(sms))


@functools.lru_cache(maxsize=1024)
def _row_plan(M: int, rb: int, block_rows: int, src_mod: tuple, out_mod: int,
              idx_mod: int, cast_unit_bytes, sms: int) -> RowPlan:
    threads = -(-block_rows // ROWS_PER_THREAD)
    threads = min(MAX_THREADS, max(MIN_THREADS, -(-threads // 32) * 32))
    tile = threads * ROWS_PER_THREAD
    if cast_unit_bytes is None:
        unit = 4
        ok = rb % 4 == 0 and all(p % 4 == 0 for p in src_mod)
    else:
        unit = int(cast_unit_bytes)
        ok = rb % unit == 0
    words = rb // unit if ok else 0
    narrow = ok and 1 <= words <= NARROW_WORDS and out_mod == 0 \
        and M + tile < 2 ** 31
    if not narrow:
        wb = unit if cast_unit_bytes is not None \
            else _generic_word_bytes(src_mod + (out_mod,), rb)
        return RowPlan(M=M, row_bytes=rb, narrow=False,
                       rows_per_cta=block_rows, word_bytes=wb)
    lw = 1
    if cast_unit_bytes is None:
        lw = next(w for w in (4, 2, 1) if words % w == 0
                  and all(p % (4 * w) == 0 for p in src_mod))
    # one load per row: the rows layout; else neighbouring lanes take
    # neighbouring words of a row (the cast keeps the rows layout, which
    # measured no slower than the lanes one on the card)
    lanes = cast_unit_bytes is None and lw < words
    tiles = -(-M // tile)
    # every CTA walks the same number of tiles, as few as the resident
    # CTAs (sms x CTAs per SM) allow
    per_cta = -(-tiles // (sms * (THREADS_PER_SM // threads)))
    grid = -(-tiles // per_cta) if tiles else 0
    return RowPlan(M=M, row_bytes=rb, narrow=True, words=words,
                   unit_bytes=unit, load_words=lw, lanes=lanes,
                   idx_vec=not lanes and idx_mod == 0,
                   threads=threads, tile_rows=tile, tiles=tiles, grid=grid)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_sms(t: torch.Tensor) -> int:
    """The SMs of ``t``'s card (an H100's 132 for a CPU tensor, whose plan
    is only read, never launched)."""
    return H100_SMS if _on_cpu(t) else _sm_count(t.device.index)


# ---------------------------------------------------- strided pack plan
STRIDED_ROUTES = ("panel", "lanes", "generic")
PANEL_THREADS = 128     # csrc/sf_pack.cu kPanelThreads: 4 warps
PANEL_MAX_K = 4         # aligned vectors a lane moves per item (the K of
                        # csrc/sf_pack.cu launch_panels: 1-4)
LANES_MAX_WORDS = 4     # panels of 1-4 words take the lanes route
LANES_THREADS = 128
STRIDED_BLOCK_ROWS = 64  # the generic loop's rows per CTA


@dataclasses.dataclass(frozen=True)
class StridedPlan:
    """How one ``pack_strided`` launch copies the ``dy * dz`` panels of a
    box: panel ``(j, k)`` is ``dx`` rows of ``row_bytes`` bytes,
    contiguous in the source (from row ``start + j*sy + k*sz``) and in the
    output (from row ``dx * (j + dy*k)``).  ``src_mod`` / ``out_mod``: the
    bases' offsets from 16-byte alignment.  Routes:

    * ``panel`` — a warp owns an item: up to ``32 * K`` aligned 16-byte
      output vectors of one panel (``per_panel`` items a panel), plus the
      0–3 words before and after them; ``items`` in all, ``per_cta`` per
      CTA of ``threads``, ``grid`` CTAs; a source skew mod 16 is shifted
      through warp shuffles;
    * ``lanes`` — panels of 1–4 words as rows of the lanes layout, one
      panel's words a lane (a warp owns 32 panels, a tile of ``tile_rows``
      panels a CTA, ``items`` tiles);
    * ``generic`` — the first kernel's loop: rows that are not whole 32-bit
      words or bases off 4-byte alignment, ``rows_per_cta`` rows per CTA
      in ``word_bytes``-byte words.
    """
    route: str
    dims: tuple
    strides: tuple
    start: int
    row_bytes: int
    src_mod: int = 0
    out_mod: int = 0
    vec_bytes: int = 0
    threads: int = 0
    items: int = 0
    per_panel: int = 0
    K: int = 0
    per_cta: int = 0
    grid: int = 0
    tile_rows: int = 0
    rows_per_cta: int = 0
    word_bytes: int = 0

    @property
    def M(self) -> int:
        return math.prod(self.dims)

    @property
    def panels(self) -> int:
        return self.dims[1] * self.dims[2]

    @property
    def panel_words(self) -> int:
        return self.dims[0] * self.row_bytes // 4

    def walk(self) -> dict:
        """The launch's global memory accesses as the kernel computes them,
        in numpy, as byte offsets from the source and output base pointers:
        ``loads`` and ``stores`` (offset, width) and ``moves`` (output
        offset, source offset, bytes) — which source bytes each output byte
        is copied from."""
        return {"panel": self._walk_panel, "lanes": self._walk_lanes,
                "generic": self._walk_generic,
                "none": lambda: _walk_result([], [], [], [], [], [])
                }[self.route]()

    def _source_words(self, j, k):
        return (self.start + j * self.strides[1]
                + k * self.strides[2]) * (self.row_bytes // 4)

    def _walk_panel(self) -> dict:
        dy = self.dims[1]
        lw, N = self.panel_words, 32 * self.K
        it = np.arange(self.items, dtype=np.int64)
        p, c = it // self.per_panel, it % self.per_panel
        s = self._source_words(p % dy, p // dy) + self.src_mod // 4
        d = p * lw + self.out_mod // 4
        h = np.minimum(-d % 4, lw)
        nb = (lw - h) // 4
        delta = s - d
        r = delta % 4
        v0 = (d + h) // 4 + c * N
        a0 = v0 + delta // 4
        n = np.clip(nb - c * N, 0, N)
        nl = np.where(n > 0, n + (r != 0), 0)
        pos = np.arange(N + 1)
        # lanes load positions < nl (position N: lane 0's extra vector)
        loads = [(a0[:, None] + pos)[pos < nl[:, None]] * 16 - self.src_mod]
        lw_ = [np.full(loads[0].size, 16)]
        live = pos[:N] < n[:, None]
        vec = (v0[:, None] + pos[:N])[live]
        src_vec = (a0[:, None] + pos[:N])[live]
        rr = np.broadcast_to(r[:, None], live.shape)[live]
        stores, sw = [vec * 16 - self.out_mod], [np.full(vec.size, 16)]
        moves = [((4 * vec + i) * 4 - self.out_mod,
                  (4 * src_vec + rr + i) * 4 - self.src_mod)
                 for i in range(4)]
        # the head words (item 0) and the tail words (the last item)
        at = h + 4 * nb
        for off, count, sel in ((np.zeros_like(d), h, c == 0),
                                (at, lw - at, c == self.per_panel - 1)):
            for lane in range(3):
                m = sel & (lane < count)
                dst = (d[m] + off[m] + lane) * 4 - self.out_mod
                src = (s[m] + off[m] + lane) * 4 - self.src_mod
                loads.append(src)
                lw_.append(np.full(src.size, 4))
                stores.append(dst)
                sw.append(np.full(dst.size, 4))
                moves.append((dst, src))
        return _walk_result(loads, lw_, stores, sw, moves,
                            [np.full(a.size, 4) for a, _ in moves])

    def _walk_lanes(self) -> dict:
        dy = self.dims[1]
        W, M = self.panel_words, self.panels
        tid = np.arange(self.threads)
        p = (tid % 32)[:, None] + 32 * np.arange(W)[None, :]
        tiles = np.concatenate([np.arange(c, self.items, self.grid)
                                for c in range(self.grid)]) * self.tile_rows
        row0 = tiles[:, None, None] + ((tid // 32) * 32)[None, :, None]
        rows = row0 + p // W
        live = rows < M
        dst = ((row0 * W + p) * 4)[live]
        src = ((self._source_words(rows % dy, rows // dy) + p % W) * 4)[live]
        four = np.full(dst.size, 4)
        return _walk_result([src], [four], [dst], [four], [(dst, src)],
                            [four])

    def _walk_generic(self) -> dict:
        dx, dy, _ = self.dims
        M, rb, wb = self.M, self.row_bytes, self.word_bytes
        wpr = rb // wb
        r = np.arange(M)
        i, jk = r % dx, r // dx
        srow = self.start + i + (jk % dy) * self.strides[1] \
            + (jk // dy) * self.strides[2]
        dst = (r[:, None] * rb + np.arange(wpr) * wb).reshape(-1)
        src = (srow[:, None] * rb + np.arange(wpr) * wb).reshape(-1)
        w = np.full(dst.size, wb)
        return _walk_result([src], [w], [dst], [w], [(dst, src)], [w])


def _walk_result(loads, load_w, stores, store_w, moves, move_w) -> dict:
    cat = lambda a: np.concatenate(a).astype(np.int64) if a else \
        np.zeros(0, np.int64)
    return {"loads": (cat(loads), cat(load_w)),
            "stores": (cat(stores), cat(store_w)),
            "moves": (cat([m[0] for m in moves]), cat([m[1] for m in moves]),
                      cat(move_w))}


def strided_plan(dims, strides, row_bytes: int, *, start: int, src_ptr: int,
                 out_ptr: int, sms: int = H100_SMS,
                 route=None) -> StridedPlan:
    """The launch plan of ``pack_strided`` for rows of ``row_bytes`` bytes
    read from ``src_ptr`` into ``out_ptr``.  Routes:

    * rows that are not whole 32-bit words, bases off 4-byte alignment, or
      counts past the kernels' 32-bit item indices: ``generic`` at
      ``STRIDED_BLOCK_ROWS`` rows per CTA;
    * panels of 1–4 words (x-faces of rows of 1–4 words): ``lanes``;
    * otherwise ``panel``: 4 warps a CTA, the card's resident warps each
      given the same number of items.

    ``route`` forces a route (for comparisons on the card; a forced route
    that cannot copy the box raises).  Only the pointers' offsets from 16-byte alignment matter,
    and plans are memoised on them: the path asks for one every launch."""
    return _strided_plan(tuple(int(d) for d in dims),
                         tuple(int(s) for s in strides), int(row_bytes),
                         int(start), int(src_ptr) % 16, int(out_ptr) % 16,
                         int(sms), route)


@functools.lru_cache(maxsize=1024)
def _strided_plan(dims, strides, rb, start, src_mod, out_mod, sms,
                  route) -> StridedPlan:
    if route is not None and route not in STRIDED_ROUTES:
        raise ValueError(f"route must be one of {STRIDED_ROUTES}")
    base = StridedPlan(route="none", dims=dims, strides=strides, start=start,
                       row_bytes=rb, src_mod=src_mod, out_mod=out_mod)
    M, P = math.prod(dims), dims[1] * dims[2]
    if M == 0 or rb == 0:
        return base
    lw = dims[0] * rb // 4
    # whole words on 4-byte bases; item, panel and row counts in 32 bits
    # with room for a grid stride
    words = rb % 4 == 0 and src_mod % 4 == 0 and out_mod % 4 == 0 \
        and P * max(1, -(-lw // (128 * PANEL_MAX_K))) < 2 ** 30 \
        and lw < 2 ** 30
    if route is None:
        route = "generic" if not words else \
            "lanes" if lw <= LANES_MAX_WORDS else "panel"
    elif route != "generic" and (not words or (route == "lanes"
                                               and lw > LANES_MAX_WORDS)):
        raise ValueError(f"the {route} route cannot copy this box")
    if route == "generic":
        return dataclasses.replace(
            base, route="generic", rows_per_cta=STRIDED_BLOCK_ROWS,
            word_bytes=_generic_word_bytes((src_mod, out_mod), rb),
            grid=-(-M // STRIDED_BLOCK_ROWS))
    if route == "lanes":
        tiles = -(-P // LANES_THREADS)
        per_cta = -(-tiles // (sms * (THREADS_PER_SM // LANES_THREADS)))
        return dataclasses.replace(
            base, route="lanes", vec_bytes=4, threads=LANES_THREADS,
            items=tiles, per_cta=per_cta, grid=-(-tiles // per_cta),
            tile_rows=LANES_THREADS)
    nbmax = lw // 4
    per_panel = max(1, -(-nbmax // (32 * PANEL_MAX_K)))
    K = max(1, -(-nbmax // (32 * per_panel)))
    items = P * per_panel
    warps = PANEL_THREADS // 32
    per_warp = -(-items // (sms * THREADS_PER_SM // 32))
    return dataclasses.replace(
        base, route="panel", vec_bytes=16, threads=PANEL_THREADS,
        items=items, per_panel=per_panel, K=K,
        per_cta=warps * per_warp, grid=-(-items // (warps * per_warp)))


# ------------------------------------------------------------------ plain
def pack_plain(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = data[idx[i]]."""
    return data[idx.long()]


def strided_rows(start: int, dims, strides, device=None) -> torch.Tensor:
    """The rows a strided pack reads, k outer, then j, then i."""
    dx, dy, dz = (int(d) for d in dims)
    sx, sy, sz = (int(s) for s in strides)
    i = torch.arange(dx, device=device)[None, None, :] * sx
    j = torch.arange(dy, device=device)[None, :, None] * sy
    k = torch.arange(dz, device=device)[:, None, None] * sz
    return (int(start) + (i + j + k)).reshape(-1)


def pack_strided_plain(data: torch.Tensor, start: int, dims,
                       strides) -> torch.Tensor:
    return data[strided_rows(start, dims, strides, data.device)]


def bcast_fused_plain(rootdata: torch.Tensor, leafdata: torch.Tensor,
                      src_of_leaf: torch.Tensor) -> torch.Tensor:
    src = src_of_leaf.long()
    hit = src >= 0
    out = leafdata.clone()
    out[hit] = rootdata[src[hit]].to(leafdata.dtype)
    return out


# ---------------------------------------------------------------- kernels
def _runtime_index(data: torch.Tensor, idx) -> torch.Tensor:
    """A row index written on the device this step, used as it is: no host
    read, no cache entry.  The checked kernels test every index against
    data's rows on the device; an int64 index is narrowed with its
    out-of-range values pinned to -1 or N, which that test rejects, so none
    can wrap into range.  On the CPU the range is checked here and
    raises."""
    if not isinstance(idx, torch.Tensor) or idx.device != data.device:
        raise ValueError(f"a dynamic index must be a tensor on "
                         f"{data.device}, got "
                         f"{getattr(idx, 'device', type(idx).__name__)}")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    N = int(data.shape[0])
    if _on_cpu(data):
        if idx.numel():
            lo, hi = (int(v) for v in torch.aminmax(idx.reshape(-1)))
            if lo < 0 or hi >= N:
                raise IndexError(f"pack index range [{lo}, {hi}] outside "
                                 f"the {N} rows of data")
        return idx.long()
    if idx.dtype != torch.int32:
        idx = idx.clamp(-1, N).to(torch.int32)
    return idx.contiguous()


def _gather_args(data: torch.Tensor, idx, dynamic: bool = False):
    """idx as an int32 tensor on data's device, after the bounds and device
    checks (``dynamic``: see :func:`_runtime_index`)."""
    N = int(data.shape[0])
    if dynamic:
        idx = _runtime_index(data, idx)
    else:
        idx, lo, hi = device_index(idx, data.device, "idx")
        if idx.numel() and (lo < 0 or hi >= N):
            raise IndexError(f"pack index range [{lo}, {hi}] outside the "
                             f"{N} rows of data")
    if idx.numel() >= 2 ** 31:
        raise ValueError(f"{idx.numel()} rows exceed the kernels' int32 "
                         f"row count")
    if not _on_cpu(data):
        require_cuda_tensor(data, "data")
    return idx


def _empty_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(idx.shape) + tuple(data.shape[1:]),
                       dtype=data.dtype, device=data.device)


def _launch_generic_gather(data, idx, out, rows_per_cta: int,
                           checked: bool = False) -> None:
    """The generic loop; ``checked``: its instance that tests every index
    against data's rows on the device (traps on one outside them)."""
    _build.launch("sf_gather_rows", data.data_ptr(), out.data_ptr(),
                  idx.data_ptr(), idx.numel(), _row_bytes(data),
                  int(rows_per_cta), int(data.shape[0]) if checked else -1,
                  _build.stream_of(data))


def _generic_gather(data: torch.Tensor, idx, rows_per_cta: int,
                    dynamic: bool = False):
    """(out, launched): the generic gather loop at ``rows_per_cta`` rows
    per CTA (the plain version on the CPU)."""
    idx = _gather_args(data, idx, dynamic)
    if _on_cpu(data):
        return pack_plain(data, idx), False
    out = _empty_rows(data, idx)
    if idx.numel() == 0 or _row_bytes(data) == 0:
        return out, False
    _launch_generic_gather(data, idx, out, rows_per_cta, dynamic)
    return out, True


def pack(data: torch.Tensor, idx, *, dynamic: bool = False
         ) -> torch.Tensor:
    """out[i] = data[idx[i]], one row per CTA.  data: (N, *unit) of any
    dtype; idx: (M,) integers (tensor on data's device, or numpy).
    ``dynamic``: idx is a tensor written on the device this step, checked
    on the device instead of prepared and cached (:func:`_runtime_index`).
    """
    out, launched = _generic_gather(data, idx, 1, dynamic)
    pack.launches += launched
    return out


def gather_plan(data: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                block_rows: int) -> RowPlan:
    """The :func:`row_plan` of ``pack_blocked`` on these tensors."""
    return row_plan(idx.numel(), _row_bytes(data), block_rows,
                    src_ptrs=(data.data_ptr(),), out_ptr=out.data_ptr(),
                    idx_ptr=idx.data_ptr(), sms=_device_sms(data))


def pack_blocked(data: torch.Tensor, idx, *, block_rows: int,
                 dynamic: bool = False) -> torch.Tensor:
    """out[i] = data[idx[i]].  Rows of 1–4 32-bit words take the narrow
    kernel, whose CTA tile ``block_rows`` sets (``ceil(block_rows / 4)``
    threads rounded up to a warp, held to 128–256, 4 rows each); other
    rows the generic loop at ``block_rows`` rows per CTA.  The output is
    the same for every ``block_rows >= 1``.  ``dynamic`` as for
    :func:`pack`."""
    if int(block_rows) < 1:
        raise ValueError("block_rows must be >= 1")
    idx = _gather_args(data, idx, dynamic)
    if _on_cpu(data):
        return pack_plain(data, idx)
    out = _empty_rows(data, idx)
    if idx.numel() == 0 or _row_bytes(data) == 0:
        return out
    plan = gather_plan(data, idx, out, block_rows)
    if plan.narrow:
        flags = plan.flags | (_FLAG_CHECK_IDX if dynamic else 0)
        _build.launch("sf_gather_narrow", data.data_ptr(), out.data_ptr(),
                      idx.data_ptr(), plan.M, plan.words, plan.tile_rows,
                      plan.tiles, plan.grid, flags,
                      min(int(data.shape[0]), 2 ** 31 - 1),
                      _build.stream_of(data))
    else:
        _launch_generic_gather(data, idx, out, plan.rows_per_cta, dynamic)
    pack_blocked.launches += 1
    return out


def gather_generic(data: torch.Tensor, idx, *, rows_per_cta: int
                   ) -> torch.Tensor:
    """The generic gather loop (the first blocked kernel) at
    ``rows_per_cta`` rows per CTA on a CUDA tensor, whatever the row
    width: the yardstick ``chip_smoke.py`` times the narrow kernel
    against (the plain version on the CPU).  Counts no launch (it is on no
    path)."""
    return _generic_gather(data, idx, rows_per_cta)[0]


def _strided_args(data: torch.Tensor, start: int, dims, strides):
    """(start, dims, strides) as ints after the contract's checks."""
    dx, dy, dz = (int(d) for d in dims)
    sx, sy, sz = (int(s) for s in strides)
    if sx != 1:
        raise ValueError("pack_strided requires unit inner stride")
    if min(dx, dy, dz) < 0 or min(sy, sz) < 0 or int(start) < 0:
        raise ValueError("pack_strided needs non-negative start, dims and "
                         "strides")
    N = int(data.shape[0])
    if dx * dy * dz and int(start) + (dx - 1) + (dy - 1) * sy \
            + (dz - 1) * sz >= N:
        raise IndexError(f"strided box reaches past the {N} rows of data")
    if not _on_cpu(data):
        require_cuda_tensor(data, "data")
    return int(start), (dx, dy, dz), (sx, sy, sz)


def box_plan(data: torch.Tensor, out: torch.Tensor, start: int, dims,
             strides, route=None) -> StridedPlan:
    """The :func:`strided_plan` of ``pack_strided`` on these tensors, for
    ``start``, ``dims`` and ``strides`` of Python ints in tuples (as
    ``_strided_args`` gives them): the memoised plan is looked up with no
    conversion, since the path asks for one every launch."""
    return _strided_plan(dims, strides, _row_bytes(data), start,
                         data.data_ptr() % 16, out.data_ptr() % 16,
                         _device_sms(data), route)


def _launch_strided(data, out, plan: StridedPlan) -> None:
    dx, dy, _ = plan.dims
    _, sy, sz = plan.strides
    rbw = plan.row_bytes // 4
    args = (data.data_ptr(), out.data_ptr())
    stream = _build.stream_of(data)
    if plan.route == "panel":
        _build.launch("sf_strided_panels", *args, plan.start * rbw, sy * rbw,
                      sz * rbw, plan.panel_words, dy, plan.per_panel,
                      plan.items, plan.K, plan.grid, stream)
    elif plan.route == "lanes":
        _build.launch("sf_strided_lanes", *args, plan.panels,
                      plan.panel_words, plan.start * rbw, sy * rbw, sz * rbw,
                      dy, plan.tile_rows, plan.items, plan.grid, stream)
    else:
        _build.launch("sf_gather_strided", *args, plan.M, plan.row_bytes,
                      plan.rows_per_cta, plan.start, dx, dy, sy, sz, stream)


def pack_strided(data: torch.Tensor, *, start: int, dims, strides
                 ) -> torch.Tensor:
    """Pack rows ``start + i + j*sy + k*sz`` for (i,j,k) < dims (sx == 1);
    output k outer, then j, then i.  Each ``(j, k)`` panel of ``dx`` rows
    is contiguous in the source and in the output, so the kernels copy
    panels, with no index: the route is :func:`strided_plan`'s (aligned
    16-byte vectors, a warp per panel item, or the lanes layout for panels
    of 1–4 words); rows that are not whole 32-bit words, or bases off
    4-byte alignment, take the first kernel's loop.  Counts its launches in
    ``pack_strided.launches`` and, by route, in ``pack_strided.routes``."""
    start, dims, strides = _strided_args(data, start, dims, strides)
    if _on_cpu(data):
        return pack_strided_plain(data, start, dims, strides)
    out = torch.empty((math.prod(dims),) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if out.shape[0] == 0 or _row_bytes(data) == 0:
        return out
    plan = box_plan(data, out, start, dims, strides)
    _launch_strided(data, out, plan)
    pack_strided.launches += 1
    pack_strided.routes[plan.route] += 1
    return out


def strided_variant(data: torch.Tensor, *, start: int, dims, strides,
                    route: str) -> torch.Tensor:
    """``pack_strided`` on a CUDA tensor by a chosen route, for
    comparisons in ``chip_smoke.py``: ``"panel"``, ``"lanes"``, or
    ``"generic"``, the first kernel's loop at ``STRIDED_BLOCK_ROWS`` rows
    per CTA (the plain version on the CPU).  A route that cannot copy the
    box raises.  Counts no launch (it is on no path)."""
    start, dims, strides = _strided_args(data, start, dims, strides)
    if _on_cpu(data):
        return pack_strided_plain(data, start, dims, strides)
    out = torch.empty((math.prod(dims),) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if out.shape[0] == 0 or _row_bytes(data) == 0:
        return out
    _launch_strided(data, out, box_plan(data, out, start, dims, strides,
                                        route=route))
    return out


def inverse_map(gr: np.ndarray, gl: np.ndarray, nleaf: int) -> np.ndarray:
    """``src_of_leaf[l]`` = root row feeding leaf ``l``, or -1: the setup
    product of the fused bcast.  ``gl`` must be duplicate-free."""
    gr = np.asarray(gr, dtype=np.int64)
    gl = np.asarray(gl, dtype=np.int64)
    if np.unique(gl).size != gl.size:
        raise ValueError("bcast_fused needs duplicate-free leaf indices")
    src = np.full(int(nleaf), -1, dtype=np.int32)
    src[gl] = gr
    return src


def _bcast_args(rootdata, leafdata, src_of_leaf):
    """src_of_leaf as int32 on the leaf's device, after every check."""
    Nl, Nr = int(leafdata.shape[0]), int(rootdata.shape[0])
    if tuple(rootdata.shape[1:]) != tuple(leafdata.shape[1:]):
        raise ValueError(f"root rows {tuple(rootdata.shape[1:])} and leaf "
                         f"rows {tuple(leafdata.shape[1:])} differ")
    src, lo, hi = device_index(src_of_leaf, leafdata.device, "src_of_leaf")
    if src.shape != (Nl,):
        raise ValueError(f"src_of_leaf has shape {tuple(src.shape)}, want "
                         f"({Nl},)")
    if Nl and (lo < -1 or hi >= Nr):
        raise IndexError(f"src_of_leaf range [{lo}, {hi}] outside the {Nr} "
                         f"root rows")
    if rootdata.dtype != leafdata.dtype and (
            rootdata.dtype not in _CAST_CODES
            or leafdata.dtype not in _CAST_CODES):
        raise TypeError(f"bcast_fused casts only between float32, float64 "
                        f"and bfloat16, not {rootdata.dtype} -> "
                        f"{leafdata.dtype}")
    if rootdata.device != leafdata.device:
        raise ValueError(f"rootdata on {rootdata.device}, leafdata on "
                         f"{leafdata.device}")
    if Nl >= 2 ** 31:
        raise ValueError(f"{Nl} leaves exceed the kernels' int32 row count")
    if not _on_cpu(leafdata):
        require_cuda_tensor(rootdata, "rootdata")
        require_cuda_tensor(leafdata, "leafdata")
    return src


def bcast_plan(rootdata, leafdata, src, out) -> RowPlan:
    """The :func:`row_plan` of ``bcast_fused`` on these tensors."""
    cast = None if rootdata.dtype == leafdata.dtype \
        else leafdata.element_size()
    plan = row_plan(leafdata.shape[0], _row_bytes(leafdata), BCAST_BLOCK_ROWS,
                    src_ptrs=(rootdata.data_ptr(), leafdata.data_ptr()),
                    out_ptr=out.data_ptr(), idx_ptr=src.data_ptr(),
                    cast_unit_bytes=cast, sms=_device_sms(leafdata))
    return _bcast_policy(plan) if cast is None else plan


@functools.lru_cache(maxsize=1024)
def _bcast_policy(plan: RowPlan) -> RowPlan:
    """A copy bcast reads src_of_leaf and the leaf rows evict-first, so
    that the root rows it reads at random stay in L2 from call to call."""
    return dataclasses.replace(plan, stream_loads=plan.narrow)


def _launch_bcast(rootdata, leafdata, src, out, plan: RowPlan) -> None:
    ptrs = (rootdata.data_ptr(), leafdata.data_ptr(), out.data_ptr(),
            src.data_ptr())
    stream = _build.stream_of(leafdata)
    same = rootdata.dtype == leafdata.dtype
    codes = (_CAST_CODES.get(rootdata.dtype), _CAST_CODES.get(leafdata.dtype))
    if plan.narrow:
        tail = (plan.tile_rows, plan.tiles, plan.grid, plan.flags, stream)
        if same:
            _build.launch("sf_bcast_narrow_copy", *ptrs, plan.M, plan.words,
                          *tail)
        else:
            _build.launch("sf_bcast_narrow_cast", *ptrs, plan.M, plan.words,
                          *codes, *tail)
    elif same:
        _build.launch("sf_bcast_fused_copy", *ptrs, plan.M, plan.row_bytes,
                      plan.rows_per_cta, stream)
    else:
        _build.launch("sf_bcast_fused_cast", *ptrs, plan.M,
                      plan.row_bytes // leafdata.element_size(), *codes,
                      plan.rows_per_cta, stream)


def bcast_fused(rootdata: torch.Tensor, leafdata: torch.Tensor,
                src_of_leaf) -> torch.Tensor:
    """A copy of ``leafdata`` with row ``l`` replaced by
    ``rootdata[src_of_leaf[l]]`` cast to the leaf dtype wherever the map is
    >= 0.  Same dtypes copy bits (any dtype); float32 / float64 / bfloat16
    pairs cast; other pairs raise.  Rows of 1–4 words (elements, for a
    cast) take the narrow kernel, others the generic loop."""
    src = _bcast_args(rootdata, leafdata, src_of_leaf)
    if _on_cpu(leafdata):
        return bcast_fused_plain(rootdata, leafdata, src)
    out = torch.empty_like(leafdata)
    if leafdata.shape[0] == 0 or _row_bytes(leafdata) == 0:
        return out
    _launch_bcast(rootdata, leafdata, src, out,
                  bcast_plan(rootdata, leafdata, src, out))
    bcast_fused.launches += 1
    return out


def bcast_variant(rootdata: torch.Tensor, leafdata: torch.Tensor,
                  src_of_leaf, *, route: str = "generic", out=None,
                  streaming: bool = False, stream_loads=None
                  ) -> torch.Tensor:
    """``bcast_fused`` on CUDA tensors by a chosen route, for comparisons in
    ``chip_smoke.py``: ``"generic"``, the generic loop (the first kernel,
    64 rows per CTA), or ``"narrow"``, with evict-first output stores when
    ``streaming`` and its evict-first loads as ``stream_loads`` says (None:
    as ``bcast_fused``); into ``out`` when given, else a new tensor (the
    plain version on the CPU).  Counts no launch (it is on no path)."""
    if route not in ("generic", "narrow"):
        raise ValueError(f"route must be 'generic' or 'narrow', not {route!r}")
    src = _bcast_args(rootdata, leafdata, src_of_leaf)
    if _on_cpu(leafdata):
        return bcast_fused_plain(rootdata, leafdata, src)
    out = torch.empty_like(leafdata) if out is None else out
    require_cuda_tensor(out, "out")
    if out.shape != leafdata.shape or out.dtype != leafdata.dtype:
        raise ValueError("out must match leafdata")
    if leafdata.shape[0] == 0 or _row_bytes(leafdata) == 0:
        return out
    plan = bcast_plan(rootdata, leafdata, src, out)
    if route == "narrow":
        if not plan.narrow:
            raise ValueError("these rows take the generic loop")
        plan = dataclasses.replace(plan, streaming=bool(streaming))
        if stream_loads is not None:
            plan = dataclasses.replace(plan, stream_loads=bool(stream_loads))
    else:
        plan = RowPlan(M=plan.M, row_bytes=plan.row_bytes, narrow=False,
                       rows_per_cta=BCAST_BLOCK_ROWS)
    _launch_bcast(rootdata, leafdata, src, out, plan)
    return out


for _f in (pack, pack_blocked, pack_strided, bcast_fused):
    _f.launches = 0
pack_strided.routes = dict.fromkeys(STRIDED_ROUTES, 0)
