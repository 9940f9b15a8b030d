"""The launch geometry and pre-pass scratch of the two big-d φ kernels,
checked without a card: the constants the wrapper
(dist_svgd_torch/ops/cuda_svgd.py) splits the m axis by and sizes the
scratch with are the ones the CUDA sources declare (csrc/phi_big_d.cu,
csrc/phi_big_d_bf16x3.cu), the A/B tool reads the same, and the split covers
every column once in whole tiles at the paths' shapes and at ragged ones,
on a faked 132-SM card."""

import re

import pytest

from dist_svgd_torch.ops import _build, cuda_svgd
from dist_svgd_torch.tools import ot_ab
from test_torch_ot_geometry import card_132  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCES = {"phi_big_d": _build.CSRC / "phi_big_d.cu",
           "phi_big_d_bf16x3": _build.CSRC / "phi_big_d_bf16x3.cu"}
NAMES = tuple(SOURCES)


def _const(name, constant):
    found = re.search(rf"constexpr int {constant} = (\d+);", SOURCES[name].read_text())
    assert found, f"{SOURCES[name].name} defines no {constant}"
    return int(found.group(1))


@pytest.mark.parametrize("name, source, wrapper", [
    ("phi_big_d", "BD_ROWS", "_BD_ROWS"),
    ("phi_big_d", "BD_COLS", "_BD_COLS"),
    ("phi_big_d", "BD_BLOCKS_PER_SM", "_BD_BLOCKS_PER_SM"),
    ("phi_big_d", "BD_TD", "_BD_TD"),
    ("phi_big_d_bf16x3", "BX_ROWS", "_BX_ROWS"),
    ("phi_big_d_bf16x3", "BX_COLS", "_BX_COLS"),
    ("phi_big_d_bf16x3", "BX_BLOCKS_PER_SM", "_BX_BLOCKS_PER_SM"),
    ("phi_big_d_bf16x3", "BX_DP_ALIGN", "_BX_DP_ALIGN"),
    ("phi_big_d_bf16x3", "BX_ROW_PAD", "_BX_ROW_PAD")])
def test_wrapper_geometry_matches_source(name, source, wrapper):
    assert getattr(cuda_svgd, wrapper) == _const(name, source)


@pytest.mark.parametrize("name, rows, cols, bps", [
    ("phi_big_d", "BD_ROWS", "BD_COLS", "BD_BLOCKS_PER_SM"),
    ("phi_big_d_bf16x3", "BX_ROWS", "BX_COLS", "BX_BLOCKS_PER_SM")])
def test_kernel_table_and_ab_tool_read_the_source(name, rows, cols, bps):
    """``_KERNELS``'s rows a block, columns a tile and blocks an SM, and
    ``ot_ab``'s readers of the same constants."""
    k_rows, k_tile, _, k_bps = cuda_svgd._KERNELS[name][2:]
    assert (k_rows, k_tile, k_bps) == (_const(name, rows), _const(name, cols),
                                       _const(name, bps))
    assert cuda_svgd.blocks_per_sm(name) == k_bps
    assert ot_ab.rows_per_block(_build.CSRC, name) == k_rows
    assert ot_ab.blocks_per_sm(_build.CSRC, name) == k_bps
    assert ot_ab.source_const(_build.CSRC, name, ot_ab.GEOMETRY[name][4]) == k_tile
    assert ot_ab.takes_scratch(_build.CSRC, name)
    assert ot_ab.takes_scores(_build.CSRC, name)


def test_rows_a_block_are_the_thread_maps():
    """The exact kernel's BD_TR-row × BD_TC-column thread tiles: BD_THREADS
    threads cover BD_ROWS rows of BD_COLS / BD_TC column groups; the bf16x3
    kernel's warps own BX_WARP_ROWS rows each, in whole m16 tiles."""
    threads = _const("phi_big_d", "BD_THREADS")
    groups = _const("phi_big_d", "BD_COLS") // _const("phi_big_d", "BD_TC")
    assert _const("phi_big_d", "BD_ROWS") == threads // groups * _const("phi_big_d", "BD_TR")
    warp_rows = _const("phi_big_d_bf16x3", "BX_WARP_ROWS")
    assert warp_rows % 16 == 0
    assert _const("phi_big_d_bf16x3", "BX_ROWS") == _const("phi_big_d_bf16x3", "BX_WARPS") * warp_rows
    assert _const("phi_big_d_bf16x3", "BX_COLS") % 16 == 0


@pytest.mark.parametrize("name", NAMES)
def test_ab_tool_reads_a_source_before_the_pre_pass(tmp_path, name):
    """The first version: its recorded rows a block, the φ's blocks an SM
    where it records none, no scratch pointer, and xs in place of s."""
    source, rows, _, _, tile = ot_ab.GEOMETRY[name]
    (tmp_path / source).write_text(
        f"constexpr int {rows} = 64;\nconstexpr int {tile} = 64;\n"
        f'extern "C" int {name}_launch(const void* y, const void* x,\n'
        "    const void* xs, void* part, void* out, int S);\n")
    assert ot_ab.rows_per_block(tmp_path, name) == 64
    assert ot_ab.blocks_per_sm(tmp_path, name) == cuda_svgd.SPLIT_BLOCKS_PER_SM
    assert not ot_ab.takes_scratch(tmp_path, name)
    assert not ot_ab.takes_scores(tmp_path, name)
    (tmp_path / source).write_text(f"constexpr int {tile} = 64;\n")
    assert ot_ab.rows_per_block(tmp_path, name) == ot_ab.BIG_D_ROWS == 64


def _ceil_to(n, q):
    return -(-n // q) * q


def _declared_bytes(name, S, k, m, d, x_lanes):
    """The scratch the sources lay out (``BdScratch``, ``BxScratch``), from
    their constants: padded rows of y, x and xs, and the norms."""
    if name == "phi_big_d":
        k_pad = _ceil_to(k, _const(name, "BD_ROWS"))
        m_pad = _ceil_to(m, _const(name, "BD_COLS"))
        dp = _ceil_to(d, _const(name, "BD_TD"))
        ld = dp if (dp // 4) % 2 else dp + 4  # bd_ld: an odd count of float4s
        rows = S * k_pad + x_lanes * m_pad + S * m_pad
        return 4 * (rows * ld + S * k_pad + x_lanes * m_pad)
    k_pad = _ceil_to(k, _const(name, "BX_ROWS"))
    m_pad = _ceil_to(m, _const(name, "BX_COLS"))
    lb = _ceil_to(d, _const(name, "BX_DP_ALIGN")) + _const(name, "BX_ROW_PAD")
    return 2 * 2 * lb * (S * k_pad + x_lanes * m_pad + S * m_pad) + 4 * x_lanes * m_pad


SHAPES = [(8, 1250, 10_000, 61), (8, 1250, 10_000, 55), (1, 10_000, 10_000, 55),
          (1, 300, 517, 9), (3, 1000, 777, 13), (2, 200, 333, 128), (1, 1, 1, 9),
          (8, 62, 496, 16), (5, 129, 65, 17)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("S, k, m, d", SHAPES)
@pytest.mark.parametrize("per_lane_x", [False, True])
def test_wrapper_scratch_matches_the_source(name, S, k, m, d, per_lane_x):
    x_lanes = S if per_lane_x else 1
    got = cuda_svgd._SCRATCH[name](S, k, m, d, x_lanes)
    assert got == _declared_bytes(name, S, k, m, d, x_lanes)
    assert got % 16 == 0  # every region starts 16-byte aligned


def test_scratch_of_the_paths():
    """Splice's exact call: rows of 61 floats padded to 64 + 4 (17
    float4s), 10 row blocks of 128 and 157 tiles of 64 a lane.  Covertype's
    bf16x3 call: rows of 55 padded to 64 + 8 bf16, 313 tiles of 32 a lane."""
    rows = 8 * 1280 + 10_048 + 8 * 10_048
    assert cuda_svgd.big_d_scratch_bytes(8, 1250, 10_000, 61, 1) == \
        4 * (rows * 68 + 8 * 1280 + 10_048)
    rows = 8 * 1280 + 10_016 + 8 * 10_016
    assert cuda_svgd.big_d_bf16x3_scratch_bytes(8, 1250, 10_000, 55, 1) == \
        4 * 72 * rows + 4 * 10_016


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("S, k, m", [
    (8, 1250, 10_000),   # splice and Covertype, 8 lanes
    (1, 10_000, 10_000),  # Covertype through Sampler
    (8, 62, 496),        # a small distributed call
    (3, 1000, 777),      # ragged
    (2, 333, 517),
    (1, 300, 517),
    (1, 1, 1),
])
def test_split_covers_m_in_whole_tiles(card_132, name, S, k, m):
    rows, tile = cuda_svgd._KERNELS[name][2:4]
    nsplit, chunk = cuda_svgd._split_of(name, S, k, m, card_132)
    assert chunk % tile == 0
    assert (nsplit - 1) * chunk < m <= nsplit * chunk  # no empty split, none short
    row_blocks = S * -(-k // rows)
    assert row_blocks * nsplit >= min(132, row_blocks * -(-m // tile))
    assert cuda_svgd.split_count(name, S, k, m, card_132) == nsplit


def test_split_of_the_paths(card_132):
    """At 8 blocks an SM, 1056 blocks asked for.  8 × 1250 rows at 128 a
    block are 80 row blocks, so ⌈1056/80⌉ = 14 splits asked: of the exact
    kernel's 157 tiles of 64 columns, 14 of 12 tiles (the last of one); of
    the bf16x3 kernel's 313 tiles of 32, 14 of 23 (the last of 14).  One
    lane of 10,000 rows (79 row blocks) takes the same."""
    for S, k in ((8, 1250), (1, 10_000)):
        assert cuda_svgd._split_of("phi_big_d", S, k, 10_000, card_132) == (14, 12 * 64)
        assert cuda_svgd._split_of("phi_big_d_bf16x3", S, k, 10_000, card_132) == (14, 23 * 32)
