"""The launch geometry of the Sinkhorn row kernels and of the small-d φ,
checked without a card: the constants the wrappers
(dist_svgd_torch/ops/cuda_ot.py, cuda_svgd.py) split the m axis by are the
ones the CUDA sources launch with (csrc/ot_common.cuh, csrc/phi_small_d.cu),
and the split covers every column once in whole tiles at the streaming
route's shapes and at ragged ones, on a faked 132-SM card."""

import re

import pytest
import torch

from dist_svgd_torch.ops import _build, cuda_ot, cuda_svgd
from dist_svgd_torch.tools import ot_ab
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADER = _build.CSRC / "ot_common.cuh"
SMALL_D = _build.CSRC / "phi_small_d.cu"


def _const(name, path=HEADER):
    found = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert found, f"{path.name} defines no {name}"
    return int(found.group(1))


@pytest.mark.parametrize("header, wrapper", [
    ("OT_THREADS", "_ROWS"), ("OT_TILE", "_TILE"),
    ("OT_KMV_ROWS_PER_THREAD", "_KMV_ROWS_PER_THREAD"),
    ("OT_PG_ROWS_PER_THREAD", "_PG_ROWS_PER_THREAD"),
    ("OT_CT_ROWS_PER_THREAD", "_CT_ROWS_PER_THREAD"),
    ("OT_STREAMING_BLOCKS_PER_SM", "_STREAMING_BLOCKS_PER_SM"),
    ("OT_CT_BLOCKS_PER_SM", "_CT_BLOCKS_PER_SM")])
def test_wrapper_geometry_matches_header(header, wrapper):
    assert getattr(cuda_ot, wrapper) == _const(header)


@pytest.mark.parametrize("source, wrapper", [
    ("SD_THREADS", "_SD_THREADS"), ("SD_ROWS_PER_THREAD", "_SD_ROWS_PER_THREAD"),
    ("SD_BLOCKS_PER_SM", "_SD_BLOCKS_PER_SM")])
def test_small_d_wrapper_geometry_matches_source(source, wrapper):
    assert getattr(cuda_svgd, wrapper) == _const(source, SMALL_D)


@pytest.mark.parametrize("name", ["phi_small_d", "phi_small_d_bf16", "phi_small_d_noexp"])
def test_small_d_modes_share_the_geometry(name):
    """Every mode is the same loop: the same rows a block, columns a tile
    and blocks an SM."""
    rows, tile, _, bps = cuda_svgd._KERNELS[name][2:]
    assert rows == _const("SD_THREADS", SMALL_D) * _const("SD_ROWS_PER_THREAD", SMALL_D)
    assert tile == _const("SD_TILE", SMALL_D)
    assert bps == cuda_svgd.blocks_per_sm(name) == _const("SD_BLOCKS_PER_SM", SMALL_D)


@pytest.mark.parametrize("name, per_block", [
    ("ot_kmat_vec", cuda_ot._ROWS * cuda_ot._KMV_ROWS_PER_THREAD),
    ("ot_plan_grad", cuda_ot._ROWS * cuda_ot._PG_ROWS_PER_THREAD),
    ("ot_ctransform", cuda_ot._ROWS * cuda_ot._CT_ROWS_PER_THREAD),
    ("phi_small_d", cuda_svgd._SD_THREADS * cuda_svgd._SD_ROWS_PER_THREAD)])
def test_ab_tool_reads_the_rows_a_block(name, per_block):
    assert ot_ab.rows_per_block(_build.CSRC, name) == per_block


@pytest.mark.parametrize("name, target", [
    ("ot_kmat_vec", cuda_ot._STREAMING_BLOCKS_PER_SM),
    ("ot_plan_grad", cuda_ot._STREAMING_BLOCKS_PER_SM),
    ("ot_ctransform", cuda_ot._CT_BLOCKS_PER_SM),
    ("phi_small_d", cuda_svgd.blocks_per_sm("phi_small_d"))])
def test_ab_tool_reads_the_blocks_an_sm(name, target):
    assert ot_ab.blocks_per_sm(_build.CSRC, name) == target


@pytest.mark.parametrize("name", ot_ab.NAMES)
def test_ab_tool_takes_one_row_a_thread_where_the_header_has_no_count(tmp_path, name):
    """A source before the redesign: one output row a thread, and the φ's
    blocks an SM (or the one asked for) where it records none."""
    source, threads, _, _, tile = ot_ab.GEOMETRY[name]
    (tmp_path / source).write_text(
        f"constexpr int {threads} = 128;\nconstexpr int {tile} = 256;\n")
    assert ot_ab.rows_per_block(tmp_path, name) == 128
    assert ot_ab.blocks_per_sm(tmp_path, name) == cuda_svgd.SPLIT_BLOCKS_PER_SM
    assert ot_ab.blocks_per_sm(tmp_path, name, 32) == 32


@pytest.fixture
def card_132(monkeypatch):
    """A CUDA device index with 132 SMs, no card needed (the SM-count seam)."""
    monkeypatch.setitem(cuda_svgd._SM_COUNTS, 0, 132)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("S, k, m", [
    (8, 12_500, 100_000),   # the streaming route's P·v
    (8, 100_000, 12_500),   # its Pᵀu
    (1, 12_500, 100_000),   # one lane of each
    (1, 100_000, 12_500),
    (3, 1001, 777),         # ragged
    (2, 333, 517),
    (1, 1, 1),
])
@pytest.mark.parametrize("per_thread, blocks_per_sm", [
    (1, None),                                   # ot_ctransform before its redesign
    (cuda_ot._CT_ROWS_PER_THREAD, cuda_ot._CT_BLOCKS_PER_SM),
    (cuda_ot._KMV_ROWS_PER_THREAD, cuda_ot._STREAMING_BLOCKS_PER_SM),
    (cuda_ot._PG_ROWS_PER_THREAD, cuda_ot._STREAMING_BLOCKS_PER_SM)])
def test_split_covers_m_in_whole_tiles(card_132, S, k, m, per_thread, blocks_per_sm):
    nsplit, chunk = cuda_ot._split(S, k, m, card_132, cuda_ot._ROWS * per_thread,
                                   blocks_per_sm)
    assert chunk % cuda_ot._TILE == 0
    assert (nsplit - 1) * chunk < m <= nsplit * chunk  # no empty split, none short
    row_blocks = S * -(-k // (cuda_ot._ROWS * per_thread))
    tiles = -(-m // cuda_ot._TILE)
    # the grid fills the card unless the m axis has too few tiles to split
    assert row_blocks * nsplit >= min(132, row_blocks * tiles)


def test_split_of_the_streaming_lanes(card_132):
    """At 32 blocks an SM, 4224 blocks asked for.  kmat_vec: 8 × 12,500
    rows at 1024 a block are 104 row blocks, so ⌈4224/104⌉ = 41 splits
    asked of the 391 tiles of 100,000 columns: 40 of 10 tiles (2560
    columns); Pᵀu's 8 × 98 row blocks take 6 of 9 of its 49 tiles.
    plan_grad: 512 rows a block, 200 row blocks, 22 splits of 18 tiles."""
    kmv = cuda_ot._ROWS * cuda_ot._KMV_ROWS_PER_THREAD
    pg = cuda_ot._ROWS * cuda_ot._PG_ROWS_PER_THREAD
    bps = cuda_ot._STREAMING_BLOCKS_PER_SM
    assert (kmv, pg, bps) == (1024, 512, 32)
    assert cuda_ot._split(8, 12_500, 100_000, card_132, kmv, bps) == (40, 10 * 256)
    assert cuda_ot._split(8, 100_000, 12_500, card_132, kmv, bps) == (6, 9 * 256)
    assert cuda_ot._split(8, 12_500, 100_000, card_132, pg, bps) == (22, 18 * 256)


@pytest.mark.parametrize("S, k, m", [
    (8, 12_500, 100_000),   # the W2 streaming route's φ lanes
    (8, 1250, 10_000),      # the north star's
    (1, 10_000, 10_000),    # the autotune tool's
    (3, 1001, 777),         # ragged
    (2, 333, 517),
    (1, 1, 1),
])
def test_small_d_split_covers_m_in_whole_tiles(card_132, S, k, m):
    tile = cuda_svgd._KERNELS["phi_small_d"][3]
    nsplit, chunk = cuda_svgd._split_of("phi_small_d", S, k, m, card_132)
    assert chunk % tile == 0
    assert (nsplit - 1) * chunk < m <= nsplit * chunk
    row_blocks = S * -(-k // cuda_svgd._KERNELS["phi_small_d"][2])
    assert row_blocks * nsplit >= min(132, row_blocks * -(-m // tile))
    assert cuda_svgd.split_count("phi_small_d", S, k, m, card_132) == nsplit


def test_split_of_the_redesigned_kernels(card_132):
    """At 32 blocks an SM, 4224 blocks asked for, 512 rows a block for
    both.  Soft c-transform: 8 × 12,500 rows are 200 row blocks, so 22
    splits asked of 391 tiles of 100,000 columns: 22 of 18 tiles; the other
    way round, 8 × 196 row blocks take 3 splits of 17 of 49 tiles.  The
    small-d φ at the same 100k lanes as the c-transform; at the north
    star's 8 × 1250 rows (24 row blocks) every one of the 40 tiles is its
    own split."""
    ct = cuda_ot._ROWS * cuda_ot._CT_ROWS_PER_THREAD
    assert (ct, cuda_ot._CT_BLOCKS_PER_SM) == (512, 32)
    assert cuda_ot._split(8, 12_500, 100_000, card_132, ct, 32) == (22, 18 * 256)
    assert cuda_ot._split(8, 100_000, 12_500, card_132, ct, 32) == (3, 17 * 256)
    assert cuda_svgd._split_of("phi_small_d", 8, 12_500, 100_000, card_132) == (22, 18 * 256)
    assert cuda_svgd._split_of("phi_small_d", 8, 1250, 10_000, card_132) == (40, 256)
