"""The launch geometry of the Sinkhorn row kernels, checked without a card:
the constants the wrapper (dist_svgd_torch/ops/cuda_ot.py) splits the m
axis by are the ones the CUDA sources launch with (csrc/ot_common.cuh), and
the split covers every column once in whole tiles at the streaming route's
shapes and at ragged ones, on a faked 132-SM card."""

import re

import pytest
import torch

from dist_svgd_torch.ops import _build, cuda_ot, cuda_svgd
from dist_svgd_torch.tools import ot_ab
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADER = _build.CSRC / "ot_common.cuh"


def _const(name):
    found = re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text())
    assert found, f"ot_common.cuh defines no {name}"
    return int(found.group(1))


@pytest.mark.parametrize("header, wrapper", [
    ("OT_THREADS", "_ROWS"), ("OT_TILE", "_TILE"),
    ("OT_KMV_ROWS_PER_THREAD", "_KMV_ROWS_PER_THREAD"),
    ("OT_PG_ROWS_PER_THREAD", "_PG_ROWS_PER_THREAD")])
def test_wrapper_geometry_matches_header(header, wrapper):
    assert getattr(cuda_ot, wrapper) == _const(header)


@pytest.mark.parametrize("name, per_thread", [
    ("ot_kmat_vec", cuda_ot._KMV_ROWS_PER_THREAD),
    ("ot_plan_grad", cuda_ot._PG_ROWS_PER_THREAD)])
def test_ab_tool_reads_the_rows_a_block(name, per_thread):
    assert ot_ab.rows_per_block(_build.CSRC, name) == cuda_ot._ROWS * per_thread


@pytest.mark.parametrize("name", ot_ab.NAMES)
def test_ab_tool_takes_one_row_a_thread_where_the_header_has_no_count(tmp_path, name):
    """The header before the redesign: one output row a thread."""
    (tmp_path / "ot_common.cuh").write_text(
        "constexpr int OT_THREADS = 128;\nconstexpr int OT_TILE = 256;\n")
    assert ot_ab.rows_per_block(tmp_path, name) == 128


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
    (1, None),                                   # ot_ctransform
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
