"""The launch geometry and pre-pass scratch of the two wide-d φ kernels,
checked without a card: the constants the wrapper
(dist_svgd_torch/ops/cuda_svgd.py) cuts d into slices, splits the m axis
and sizes the scratch with are the ones the CUDA sources declare
(csrc/phi_wide_d.cu, csrc/phi_wide_d_bf16x3.cu); the A/B tool reads the same
from the tree's sources and the first version's; the split covers every
column once on a faked 132-SM card; and a float32 numpy model of the exact
tier's pre-pass norms and of its Gram's summation order (two half-slice FMA
chains a slice, summed, then the slices in order) gives d²_ii = 0 exactly
where y_i and x_i are the same bits."""

import re

import numpy as np
import pytest

from dist_svgd_torch.ops import _build, cuda_svgd
from dist_svgd_torch.tools import ot_ab
from test_torch_ot_geometry import card_132  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCES = {"phi_wide_d": _build.CSRC / "phi_wide_d.cu",
           "phi_wide_d_bf16x3": _build.CSRC / "phi_wide_d_bf16x3.cu"}
NAMES = tuple(SOURCES)
PREFIX = {"phi_wide_d": "WD", "phi_wide_d_bf16x3": "WX"}
DIMS = (129, 753, 1024, 1025, 2432)


def _const(name, constant):
    found = re.search(rf"constexpr int {constant} = (\d+);", SOURCES[name].read_text())
    assert found, f"{SOURCES[name].name} defines no {constant}"
    return int(found.group(1))


@pytest.mark.parametrize("name, source, wrapper", [
    ("phi_wide_d", "WD_COLS", "_WD_COLS"),
    ("phi_wide_d", "WD_BLOCKS_PER_SM", "_WD_BLOCKS_PER_SM"),
    ("phi_wide_d", "WD_ROWS", "_WD_ROWS"),
    ("phi_wide_d", "WD_SLICE", "_WD_SLICE"),
    ("phi_wide_d", "WD_WIDE_ROWS", "_WD_WIDE_ROWS"),
    ("phi_wide_d", "WD_WIDE_SLICE", "_WD_WIDE_SLICE"),
    ("phi_wide_d", "WD_NARROW_MAX_D", "_WD_NARROW_MAX_D"),
    ("phi_wide_d", "WD_MAX_D", "WIDE_D_MAX"),
    ("phi_wide_d_bf16x3", "WX_COLS", "_WX_COLS"),
    ("phi_wide_d_bf16x3", "WX_BLOCKS_PER_SM", "_WX_BLOCKS_PER_SM"),
    ("phi_wide_d_bf16x3", "WX_ROWS", "_WX_ROWS"),
    ("phi_wide_d_bf16x3", "WX_SLICE", "_WX_SLICE"),
    ("phi_wide_d_bf16x3", "WX_WIDE_ROWS", "_WX_WIDE_ROWS"),
    ("phi_wide_d_bf16x3", "WX_WIDE_SLICE", "_WX_WIDE_SLICE"),
    ("phi_wide_d_bf16x3", "WX_NARROW_MAX_D", "_WX_NARROW_MAX_D"),
    ("phi_wide_d_bf16x3", "WX_MAX_D", "WIDE_D_MAX")])
def test_wrapper_geometry_matches_source(name, source, wrapper):
    assert getattr(cuda_svgd, wrapper) == _const(name, source)


def test_exact_slice_rows_are_padded_as_the_wrapper_pads_them():
    """``WdSlices``' row stride ls = ws + 4 (``_WD_ROW_PAD``): with ws/4 even
    (the source's static_assert) ls/4 is odd."""
    text = SOURCES["phi_wide_d"].read_text()
    assert re.search(rf"ls = ws \+ {cuda_svgd._WD_ROW_PAD};", text)
    for ws in (cuda_svgd._WD_SLICE, cuda_svgd._WD_WIDE_SLICE):
        assert (ws // 4) % 2 == 0 and ((ws + cuda_svgd._WD_ROW_PAD) // 4) % 2 == 1


@pytest.mark.parametrize("name", NAMES)
def test_kernel_table_and_ab_tool_read_the_source(name):
    """``_KERNELS``'s rows a block (the narrow geometry's), columns a tile,
    norms (none: the pre-pass takes them) and blocks an SM, and ``ot_ab``'s
    readers of the same constants, d by d."""
    p = PREFIX[name]
    library, symbol, rows, tile, norms, bps = cuda_svgd._KERNELS[name]
    assert (library, symbol) == (name, f"{name}_launch")
    assert (rows, tile, norms, bps) == (_const(name, f"{p}_ROWS"), _const(name, f"{p}_COLS"),
                                        False, _const(name, f"{p}_BLOCKS_PER_SM"))
    assert cuda_svgd.blocks_per_sm(name) == bps
    assert name in cuda_svgd._SCRATCH
    assert ot_ab.blocks_per_sm(_build.CSRC, name) == bps
    assert ot_ab.tile_of(_build.CSRC, name) == tile
    assert ot_ab.takes_scratch(_build.CSRC, name)
    assert ot_ab.takes_scores(_build.CSRC, name)
    for d in DIMS:
        rows_d, slices, _ = cuda_svgd.wide_d_slices(name, d)
        assert ot_ab.rows_per_block(_build.CSRC, name, d) == rows_d
        assert ot_ab.wide_geometry(_build.CSRC, name, d) == (rows_d, slices)


# The first versions' declarations (csrc at the parent of the redesign):
# no rows a block, slices or blocks an SM recorded; xs and the norms in
# place of the scores and a scratch.
FIRST = {
    "phi_wide_d": (
        "constexpr int WD_COLS = 64;            // interaction rows per tile\n"
        "constexpr int WD_WIDE_ROWS_MAX_D = 1024;  // 32 rows a block up to here, 16 above\n"
        'extern "C" int phi_wide_d_launch(const void* y, const void* x, const void* xs,\n'
        "                                 const void* y2, const void* x2, void* part,\n"
        "                                 void* out, int S, int k, int m, int d,\n"
        "                                 int x_lane_stride, int chunk, int nsplit,\n"
        "                                 float inv_h, int device, void* stream) {\n"),
    "phi_wide_d_bf16x3": (
        "constexpr int BW_ROWS = 16;              // output rows per block: one m16 tile\n"
        "constexpr int BW_COLS = 64;              // interaction rows per tile\n"
        'extern "C" int phi_wide_d_bf16x3_launch(const void* y, const void* x,\n'
        "                                        const void* xs, const void* y2,\n"
        "                                        const void* x2, void* part, void* out,\n"
        "                                        int S, int k, int m, int d,\n"
        "                                        int x_lane_stride, int chunk, int nsplit,\n"
        "                                        float inv_h, int device, void* stream) {\n"),
}


@pytest.mark.parametrize("name", NAMES)
def test_ab_tool_reads_the_first_version(tmp_path, name):
    """The parent's sources: 32 rows a block for the exact tier (16 beyond
    d = 1024) and 16 for bf16x3, one block a row block (no clusters),
    64-column tiles, the φ's 8 blocks an SM, xs and the norms (seven
    pointers) and no scratch."""
    (tmp_path / SOURCES[name].name).write_text(FIRST[name])
    narrow, wide = (32, 16) if name == "phi_wide_d" else (16, 16)
    for d, rows in ((129, narrow), (753, narrow), (1024, narrow), (1025, wide), (2432, wide)):
        assert ot_ab.rows_per_block(tmp_path, name, d) == rows
        assert ot_ab.wide_geometry(tmp_path, name, d) == (rows, 1)
    assert ot_ab.tile_of(tmp_path, name) == 64
    assert ot_ab.blocks_per_sm(tmp_path, name) == cuda_svgd.SPLIT_BLOCKS_PER_SM == 8
    assert not ot_ab.takes_scratch(tmp_path, name)
    assert not ot_ab.takes_scores(tmp_path, name)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("d", DIMS)
def test_slices_cover_d(name, d):
    """d in at most WX/WD_MAX_SLICES slices (a portable cluster), the last
    one short by less than a slice; the narrow geometry up to
    WX/WD_NARROW_MAX_D."""
    p = PREFIX[name]
    rows, slices, ws = cuda_svgd.wide_d_slices(name, d)
    narrow = d <= _const(name, f"{p}_NARROW_MAX_D")
    assert ws == _const(name, f"{p}_SLICE" if narrow else f"{p}_WIDE_SLICE")
    assert rows == _const(name, f"{p}_ROWS" if narrow else f"{p}_WIDE_ROWS")
    assert 1 <= slices <= _const(name, f"{p}_MAX_SLICES")
    assert (slices - 1) * ws < d <= slices * ws


def test_slices_of_the_paths():
    """The BNN's d = 753: six slices of 128 in both tiers (the last holds
    113 features); the widest d = 2432: eight of 320; the ragged d = 129:
    two of 128."""
    for name in NAMES:
        assert cuda_svgd.wide_d_slices(name, 753) == (128, 6, 128)
        assert cuda_svgd.wide_d_slices(name, 129)[1:] == (2, 128)
        assert cuda_svgd.wide_d_slices(name, 2432)[1:] == (8, 320)
    assert cuda_svgd.wide_d_slices("phi_wide_d", 2432)[0] == 32
    assert cuda_svgd.wide_d_slices("phi_wide_d_bf16x3", 2432)[0] == 64


def _ceil_to(n, q):
    return -(-n // q) * q


def _declared_bytes(name, S, k, m, d, x_lanes):
    """The scratch the sources lay out (``WdScratch``, ``WxScratch``), from
    their constants: slice-major rows of y, x and xs (f32 rows padded by 4,
    or bf16 hi and lo planes of ws a row), then the norms (the exact tier's
    a slice)."""
    p = PREFIX[name]
    narrow = d <= _const(name, f"{p}_NARROW_MAX_D")
    rows = _const(name, f"{p}_ROWS" if narrow else f"{p}_WIDE_ROWS")
    ws = _const(name, f"{p}_SLICE" if narrow else f"{p}_WIDE_SLICE")
    c = -(-d // ws)
    k_pad = _ceil_to(k, rows)
    m_pad = _ceil_to(m, _const(name, f"{p}_COLS"))
    padded = S * k_pad + x_lanes * m_pad + S * m_pad  # y, x, xs rows a slice
    if name == "phi_wide_d":
        return 4 * c * (padded * (ws + 4) + S * k_pad + x_lanes * m_pad)
    return 2 * 2 * c * ws * padded + 4 * (S * k_pad + x_lanes * m_pad)


SHAPES = [(1, 500, 500), (8, 62, 496), (8, 1250, 10_000), (1, 300, 517), (2, 200, 333),
          (3, 100, 200), (1, 1, 1)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("S, k, m", SHAPES)
@pytest.mark.parametrize("per_lane_x", [False, True])
def test_wrapper_scratch_matches_the_source(name, d, S, k, m, per_lane_x):
    x_lanes = S if per_lane_x else 1
    got = cuda_svgd._SCRATCH[name](S, k, m, d, x_lanes)
    assert got == _declared_bytes(name, S, k, m, d, x_lanes)
    assert got % 16 == 0  # every region starts 16-byte aligned


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("S, k, m, d", [
    (1, 500, 500, 753),        # the BNN's Sampler lane
    (8, 62, 496, 753),         # its 8-shard lanes
    (8, 1250, 10_000, 753),    # the throughput shape
    (1, 300, 517, 129),        # ragged
    (2, 200, 333, 2432),       # widest
    (3, 100, 200, 1025),       # the wide geometry's narrowest
    (1, 1, 1, 1024),
])
def test_split_covers_m_in_whole_tiles(card_132, name, S, k, m, d):
    """Every block of a cluster counted: the split asks for the kernel's
    blocks an SM over all of them and takes equal chunks of whole tiles (at
    least half the chunks asked for where the tiles allow), none empty."""
    _, tile = cuda_svgd._KERNELS[name][2:4]
    rows, slices, _ = cuda_svgd.wide_d_slices(name, d)
    nsplit, chunk = cuda_svgd._split_of(name, S, k, m, card_132, d=d)
    assert chunk % tile == 0
    assert (nsplit - 1) * chunk < m <= nsplit * chunk
    blocks = S * -(-k // rows) * slices
    assert 2 * blocks * nsplit >= min(cuda_svgd.blocks_per_sm(name) * 132,
                                      blocks * -(-m // tile))
    assert cuda_svgd.split_count(name, S, k, m, card_132, d=d) == nsplit


@pytest.mark.parametrize("name", NAMES)
def test_split_needs_d(card_132, name):
    with pytest.raises(ValueError, match="feature dim"):
        cuda_svgd._split_of(name, 1, 500, 500, card_132)


def test_split_of_the_paths(card_132):
    """At one block an SM, 132 blocks asked for.  The BNN lane: 4 row blocks
    of 128 × 6 slices = 24 blocks, so ⌈132/24⌉ = 6 splits asked — the exact
    tier's 8 tiles of 64 columns two a split (4 splits: 96 blocks, one wave
    of 16 clusters), the bf16x3 tier's 16 tiles of 32 three a split (6
    splits).  The throughput shape: 80 row blocks × 6 = 480 blocks, one
    split of every tile."""
    assert cuda_svgd._split_of("phi_wide_d", 1, 500, 500, card_132, d=753) == (4, 128)
    assert cuda_svgd._split_of("phi_wide_d_bf16x3", 1, 500, 500, card_132, d=753) == (6, 96)
    assert cuda_svgd._split_of("phi_wide_d", 8, 1250, 10_000, card_132, d=753) == (1, 157 * 64)
    assert cuda_svgd._split_of("phi_wide_d_bf16x3", 8, 1250, 10_000, card_132,
                               d=753) == (1, 313 * 32)


def _fmaf(a, b, c):
    """float32 a·b + c with the product exact (float64 holds it) and one
    rounding of the sum to float32 (through float64: both chains below use
    the same emulation, which is all the bitwise comparison needs)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(
        np.float32)


def _slice_order_dot(a, b, d):
    """The exact tier's y·x over d, as its Gram sums it: each slice of ws
    features (``WdSlices``) in two halves, each an FMA chain in feature order
    from 0 (the block's two halves of threads), the halves added (the first
    half's first), then the slices' partials added in slice order (the
    owner's sum); zero padding past d."""
    _, slices, ws = cuda_svgd.wide_d_slices("phi_wide_d", d)
    pad = slices * ws - d
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, 0), (0, pad)))
    total = None
    for c in range(slices):
        halves = []
        for h in range(2):
            acc = np.zeros(a.shape[0], np.float32)
            lo = c * ws + h * ws // 2
            for f in range(lo, lo + ws // 2):
                acc = _fmaf(a[:, f], b[:, f], acc)
            halves.append(acc)
        part = (halves[0] + halves[1]).astype(np.float32)
        total = part if total is None else (total + part).astype(np.float32)
    return total


def test_model_follows_the_source_halves():
    """The model's halves are the source's: the Gram's half hs runs over the
    float4s [hs·Q/2, (hs + 1)·Q/2) of the slice's Q = W/4, the pre-pass's
    norm chain hv over the features [hv·ws/2, (hv + 1)·ws/2), and the halves
    are summed the first one first."""
    text = SOURCES["phi_wide_d"].read_text()
    assert "for (int c4 = hs * Q / 2; c4 < (hs + 1) * Q / 2; ++c4)" in text
    assert ("for (int f = hv * ws / 2; f < (hv + 1) * ws / 2; ++f) "
            "s2 = fmaf(tile[rr][f], tile[rr][f], s2);") in text
    assert "halves[threadIdx.x][0] + halves[threadIdx.x][1]" in text
    assert "make_float4(dot[a][4 * v] + o4.x" in text  # the first half's first


@pytest.mark.parametrize("d", [753, 2432])
def test_norm_chain_gives_an_exact_diagonal(d):
    """y = x (the BNN Sampler's lane at h = 1): the pre-pass norms, summed
    as the Gram is, make d²_ii = (‖y_i‖² + ‖x_i‖²) − 2·y_i·x_i exactly 0 in
    float32; norms summed in another order (numpy's) do not."""
    rng = np.random.default_rng(d)
    y = (rng.standard_normal((64, d)) / np.sqrt(14.0)).astype(np.float32)
    dot = _slice_order_dot(y, y, d)
    norm = _slice_order_dot(y, y, d)  # the pre-pass: the same chains and order
    d2 = _fmaf(np.full_like(dot, -2.0), dot, (norm + norm).astype(np.float32))
    assert np.all(np.maximum(d2, 0.0) == 0.0)
    other = np.sum(y * y, axis=1, dtype=np.float32)
    d2_other = _fmaf(np.full_like(dot, -2.0), dot, (other + other).astype(np.float32))
    assert np.any(d2_other != 0.0)

