"""Port parity and launch plan of the strided pack (``pack_strided``).

``sf_pack.strided_plan`` picks the route of every launch (a warp per panel
item in aligned 16-byte vectors, the lanes layout for panels of 1–4 words,
or the first kernel's loop).  Its ``walk`` lists the
launch's global loads, stores and byte moves as the kernel computes them;
the tests here replay that walk in numpy and check that every output byte
is written exactly once, from the source byte the contract names
(``out[i + dx*(j + dy*k)] = data[start + i + j*sy + k*sz]``), that every
vector access is aligned, and that no load leaves the box: the lanes and
generic routes read only the box's panels, the panel route only the
16-byte granules its panels touch (its aligned vectors round each panel's
ends out to 16 bytes).  The plain version (what the wrapper runs for CPU
tensors) is held against the reference's ``ref.pack_strided_ref`` bitwise;
the Pallas ``pack_strided`` does not run on this jax (``pl.unblocked``).
The ``cuda``-marked tests hold every route against the plain version on
the card and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:
    import jax.numpy as jnp
    from repro.kernels import ref as R
    HAVE_JAX = True
except ImportError:          # the card's machine has no JAX
    HAVE_JAX = False
needs_reference = pytest.mark.skipif(
    not HAVE_JAX, reason="needs jax and the JAX package (the reference)")

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import sf_pack  # noqa: E402

# The timed shapes: the main path's box halo (a 100x100x8 box of a 128^3
# grid at 3 + 5g + 7g^2), the 256^3 interior of a 258^3 ghosted local
# array, and that array's x-face.
G = 128
MAIN = ((100, 100, 8), (1, G, G * G), 3 + 5 * G + 7 * G * G)
GHOST = ((256, 256, 256), (1, 258, 258 * 258), 1 + 258 + 258 * 258)
XFACE = ((1, 256, 256), (1, 258, 258 * 258), 1 + 258 + 258 * 258)

# Small boxes for the walks: (dims, strides, start).
BOXES = {
    "halo": ((4, 6, 3), (1, 16, 256), 3 + 5 * 16 + 7 * 256),
    "ghosted": ((6, 6, 6), (1, 10, 100), 111),
    "xface": ((1, 6, 6), (1, 10, 100), 111),
    "dx1": ((1, 7, 1), (1, 3, 21), 2),
    "dy1": ((7, 1, 4), (1, 9, 30), 5),
    "dz1": ((7, 5, 1), (1, 9, 45), 5),
    "contiguous": ((50, 1, 1), (1, 50, 50), 3),
    "long_panels": ((300, 2, 2), (1, 400, 1000), 5),
    "empty": ((0, 3, 3), (1, 4, 16), 0),
}


def _rows(dims, strides, start):
    dx, dy, dz = dims
    return (start + np.arange(dx)[None, None, :]
            + np.arange(dy)[None, :, None] * strides[1]
            + np.arange(dz)[:, None, None] * strides[2]).reshape(-1)


def _expand(off, width):
    """Every byte of the accesses (off, width)."""
    if off.size == 0:
        return np.zeros(0, np.int64)
    rep = np.repeat(off, width)
    return rep + (np.arange(rep.size) - np.repeat(np.cumsum(width) - width,
                                                  width))


def _check_walk(plan, dims, strides, start, rb, src_mod, out_mod):
    rows = _rows(dims, strides, start)
    M = rows.size
    w = plan.walk()
    # every output byte exactly once
    so, sw = w["stores"]
    hits = np.bincount(_expand(so, sw), minlength=M * rb)
    assert hits.size == M * rb and (hits == 1).all()
    # ... from the source byte the contract names
    dst, src, n = w["moves"]
    got = np.full(M * rb, -1, np.int64)
    got[_expand(dst, n)] = _expand(src, n)
    want = (rows[:, None] * rb + np.arange(rb)).reshape(-1)
    np.testing.assert_array_equal(got, want)
    # loads stay in the box (the panel route: in its panels' granules)
    lo, lw = w["loads"]
    read = _expand(lo, lw)
    box = set(want.tolist())
    if plan.route == "panel":
        granules = {(src_mod + b) // 16 for b in box}
        assert all((src_mod + b) // 16 in granules for b in read.tolist())
    else:
        assert set(read.tolist()) <= box
    # vector accesses aligned
    assert ((out_mod + so) % sw == 0).all()
    assert ((src_mod + lo) % lw == 0).all()
    if plan.route == "panel":
        assert set(np.unique(sw).tolist()) <= {4, 16}
        assert 1 <= plan.K <= sf_pack.PANEL_MAX_K
        assert plan.per_cta * plan.grid >= plan.items
        assert plan.per_cta * (plan.grid - 1) < plan.items


def _routes(plan_route, rb, src_mod, dims):
    """The routes that can copy the box, for forced plans."""
    out = {plan_route, "generic"}
    if rb % 4 == 0 and src_mod % 4 == 0:
        out.add("panel")
        if dims[0] * rb // 4 <= sf_pack.LANES_MAX_WORDS:
            out.add("lanes")
    return sorted(out - {"none"})


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("rb", [4, 8, 12, 16, 20, 2, 3])
def test_strided_plan_walk_copies_the_box(box, rb):
    """Every route the box can take, at every base offset from 16-byte
    alignment the row size allows (data[1:], data[2:], ...), on one SM
    and on 132: each output byte written once, from the right source byte,
    every vector access aligned, every load within the box."""
    dims, strides, start = BOXES[box]
    for src_mod in sorted({(q * rb) % 16 for q in range(4)}):
        for sms in (1, 132):
            plan = sf_pack.strided_plan(dims, strides, rb, start=start,
                                        src_ptr=(1 << 20) + src_mod,
                                        out_ptr=1 << 24, sms=sms)
            if 0 in dims:
                assert plan.route == "none"
                _check_walk(plan, dims, strides, start, rb, src_mod, 0)
                continue
            for route in _routes(plan.route, rb, src_mod, dims):
                forced = sf_pack.strided_plan(
                    dims, strides, rb, start=start,
                    src_ptr=(1 << 20) + src_mod, out_ptr=1 << 24, sms=sms,
                    route=route)
                assert forced.route == route
                _check_walk(forced, dims, strides, start, rb, src_mod, 0)


def test_strided_plan_walk_on_an_unaligned_output():
    """Panels whose output starts off the 16-byte alignment (an odd panel
    of 5 words, an output base 4 bytes in) take head and tail words."""
    dims, strides, start = (5, 7, 3), (1, 11, 90), 13
    for out_mod in (0, 4, 8, 12):
        for src_mod in (0, 4, 12):
            plan = sf_pack.strided_plan(dims, strides, 4, start=start,
                                        src_ptr=src_mod, out_ptr=out_mod,
                                        route="panel")
            _check_walk(plan, dims, strides, start, 4, src_mod, out_mod)


def test_strided_plan_picks_routes():
    """Rows of whole words on 4-byte bases avoid the generic loop; panels
    of 1-4 words take the lanes layout; odd rows and odd bases the loop."""
    def route(dims, rb, src=0, strides=(1, 41, 410), start=1):
        return sf_pack.strided_plan(dims, strides, rb, start=start,
                                    src_ptr=src, out_ptr=0).route
    assert route((1, 6, 6), 12) == "lanes"
    assert route((2, 6, 6), 8) == "lanes"
    assert route((5, 6, 6), 4) == "panel"
    assert route((30, 6, 6), 2) == "generic"      # 2-byte rows
    assert route((30, 6, 6), 3) == "generic"
    assert route((30, 6, 6), 4, src=2) == "generic"
    assert route((0, 6, 6), 4) == "none"
    with pytest.raises(ValueError, match="cannot copy"):
        sf_pack.strided_plan((30, 6, 6), (1, 40, 400), 2, start=1,
                             src_ptr=0, out_ptr=0, route="panel")
    with pytest.raises(ValueError, match="cannot copy"):
        sf_pack.strided_plan((30, 6, 6), (1, 40, 400), 4, start=1,
                             src_ptr=0, out_ptr=0, route="lanes")
    with pytest.raises(ValueError, match="route must be"):
        sf_pack.strided_plan((30, 6, 6), (1, 40, 400), 4, start=1,
                             src_ptr=0, out_ptr=0, route="tma")


def test_block_rows_reaches_only_the_generic_loop():
    """Rows per CTA is the generic loop's alone, the constant
    ``STRIDED_BLOCK_ROWS`` (``pack_strided`` takes no ``block_rows``);
    the other routes' plans carry none."""
    kw = dict(start=3, src_ptr=0, out_ptr=0)
    odd = sf_pack.strided_plan((9, 4, 2), (1, 12, 60), 2, **kw)
    assert odd.route == "generic"
    assert odd.rows_per_cta == sf_pack.STRIDED_BLOCK_ROWS == 64
    assert odd.grid == -(-72 // 64)
    for dims, rb in (((9, 4, 2), 12), ((1, 4, 2), 12)):
        plan = sf_pack.strided_plan(dims, (1, 12, 60), rb, **kw)
        assert plan.route != "generic" and plan.rows_per_cta == 0
    with pytest.raises(TypeError):
        sf_pack.pack_strided(torch.zeros(80, 3), start=3, dims=(9, 4, 2),
                             strides=(1, 12, 60), block_rows=64)


def test_routes_at_the_timed_shapes():
    """The five timed shapes: the main-path box (f32 rows of 3 and of 1)
    and the ghosted interior on the panel route, the x-face on the lanes
    layout."""
    want = {(MAIN, 12): "panel", (MAIN, 4): "panel", (GHOST, 12): "panel",
            (GHOST, 4): "panel", (XFACE, 12): "lanes"}
    for ((dims, strides, start), rb), route in want.items():
        plan = sf_pack.strided_plan(dims, strides, rb, start=start,
                                    src_ptr=0, out_ptr=0)
        assert plan.route == route, (dims, rb)
    ghost = sf_pack.strided_plan(*GHOST[:2], 12, start=GHOST[2], src_ptr=0,
                                 out_ptr=0)
    # 192 vectors a panel: 2 items of 32 lanes x 3; 16 items a warp
    assert (ghost.per_panel, ghost.K, ghost.items) == (2, 3, 131072)
    assert ghost.grid == 2048
    main = sf_pack.strided_plan(*MAIN[:2], 12, start=MAIN[2], src_ptr=0,
                                out_ptr=0)
    # 75 vectors a panel: one item of 32 lanes x 3, one short wave
    assert (main.per_panel, main.K, main.items, main.grid) == (1, 3, 800,
                                                               200)
    face = sf_pack.strided_plan(*XFACE[:2], 12, start=XFACE[2], src_ptr=0,
                                out_ptr=0)
    assert (face.tile_rows, face.items, face.grid) == (128, 512, 512)


@needs_reference
@pytest.mark.parametrize("unit", [(), (3,), (2, 2)])
@pytest.mark.parametrize("dt", [np.float32, np.int32, np.int8])
@pytest.mark.parametrize("case", ["halo", "ghosted", "xface", "skew",
                                  "dy1", "dz1", "contiguous"])
def test_pack_strided_matches_ref_at_scaled_shapes(case, unit, dt):
    """The timed shapes scaled down (a 10x10x3 box of a 16^3 grid at
    3 + 5g + 7g^2; the 8^3 interior of a 10^3 ghosted array and its
    x-face), skewed starts and degenerate boxes, against the reference.
    On the CPU both entry points take the plain version; the kernel routes
    are held against it by the ``cuda`` tests below and by the plan's
    walk."""
    g = 16
    dims, strides, start = {
        "halo": ((10, 10, 3), (1, g, g * g), 3 + 5 * g + 7 * g * g),
        "ghosted": ((8, 8, 8), (1, 10, 100), 111),
        "xface": ((1, 8, 8), (1, 10, 100), 111),
        "skew": ((7, 3, 2), (1, 10, 100), 6),
        "dy1": ((7, 1, 4), (1, 9, 30), 5),
        "dz1": ((7, 5, 1), (1, 9, 45), 5),
        "contiguous": ((50, 1, 1), (1, 50, 50), 3)}[case]
    n = start + dims[0] + (dims[1] - 1) * strides[1] \
        + (dims[2] - 1) * strides[2] + 2
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((n,) + unit) * 100).astype(dt)
    want = np.asarray(R.pack_strided_ref(jnp.asarray(data), start, dims,
                                         strides))
    td = torch.as_tensor(data)
    for got in (sf_pack.pack_strided(td, start=start, dims=dims,
                                     strides=strides),
                kops.sf_pack_strided(td, start=start, dims=dims,
                                     strides=strides)):
        assert got.dtype == td.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_pack_strided_empty_and_cpu_counts():
    """An empty box packs to no rows; CPU tensors count no launch."""
    kops.reset_launch_counts()
    data = torch.arange(40.0).reshape(20, 2)
    out = sf_pack.pack_strided(data, start=0, dims=(0, 3, 2),
                               strides=(1, 4, 12))
    assert out.shape == (0, 2)
    sf_pack.pack_strided(data, start=1, dims=(2, 3, 2), strides=(1, 4, 8))
    assert sf_pack.pack_strided.launches == 0
    assert set(sf_pack.pack_strided.routes.values()) == {0}
    assert sorted(sf_pack.pack_strided.routes) == sorted(
        sf_pack.STRIDED_ROUTES)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on "
                    "the card")
    return torch.device("cuda")


_CARD_DTYPES = [torch.float32, torch.bfloat16, torch.float64, torch.int8,
                torch.bool]


def _card_data(n, unit, dt, device, rng):
    a = torch.as_tensor(rng.standard_normal((n,) + unit) * 100,
                        device=device)
    return a > 0 if dt == torch.bool else a.to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [(), (2,), (3,), (4,), (5,), (64,)])
@pytest.mark.parametrize("dt", _CARD_DTYPES)
def test_cuda_pack_strided_every_route_bitwise(cuda_device, dt, unit):
    """Every route that can copy each box, bitwise against the plain
    version: starts skewed 0-3 rows, a base off the 16-byte alignment
    (data[1:]), a 258-pitch plane and x-faces."""
    rng = np.random.default_rng(6)
    data = _card_data(258 * 258 * 3 + 64, unit, dt, cuda_device, rng)
    rb = data[:1].numel() * data.element_size()
    boxes = [((30, 7, 3), (1, 64, 64 * 64), s) for s in range(4)]
    boxes += [((256, 4, 2), (1, 258, 258 * 258), 1 + 258),
              ((1, 40, 3), (1, 258, 258 * 258), 1 + 258),
              ((5, 7, 3), (1, 11, 90), 13)]
    for d in (data, data[1:]):
        for dims, strides, start in boxes:
            want = sf_pack.pack_strided_plain(d, start, dims, strides)
            got = sf_pack.pack_strided(d, start=start, dims=dims,
                                       strides=strides)
            assert torch.equal(got, want), (dims, start)
            plan = sf_pack.strided_plan(dims, strides, rb, start=start,
                                        src_ptr=d.data_ptr(), out_ptr=0)
            forced = [dict(route="generic")]
            if plan.route != "generic":
                forced.append(dict(route="panel"))
                if dims[0] * rb // 4 <= sf_pack.LANES_MAX_WORDS:
                    forced.append(dict(route="lanes"))
            for kw in forced:
                got = sf_pack.strided_variant(d, start=start, dims=dims,
                                              strides=strides, **kw)
                assert torch.equal(got, want), (kw, dims)
