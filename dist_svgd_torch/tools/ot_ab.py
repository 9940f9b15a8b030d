"""Old against new on the card: the streaming route's row kernels
(``ot_kmat_vec``, ``ot_plan_grad``, ``ot_ctransform``) and the φ kernels
(``phi_small_d``, ``phi_big_d``, ``phi_big_d_bf16x3``, ``phi_wide_d``,
``phi_wide_d_bf16x3``) of this tree against the same kernels built from
another version of their sources, timed in turns in one process.

    mkdir -p build/base && git archive <commit> dist_svgd_torch/csrc | tar -x -C build/base
    python -m dist_svgd_torch.tools.ot_ab build/base/dist_svgd_torch/csrc [DIR ...] \\
        [--kernels ot_ctransform phi_big_d] [--reps 20]

Each ``DIR`` holds the sources of the kernels it is timed for
(``ot_common.cuh`` with ``ot_kmat_vec.cu``, ``ot_plan_grad.cu``,
``ot_ctransform.cu``; ``phi_common.cuh`` and ``ot_common.cuh`` with the
``phi_*.cu``); they are compiled with this tree's flags (``ops/_build.py``).
A version's C interface is this tree's, except that a big-d or wide-d φ
takes a scratch pointer after its inputs only where its source's launch
function names one (its size from the library's ``<name>_scratch_bytes``),
the scores ``s`` in place of ``xs = s − (2/h)·x`` only where it names
``s``, and a wide-d φ the row norms ‖y‖², ‖x‖² (summed in torch) only
where it takes no scratch.  A version's launch geometry is read from its
own sources (:data:`GEOMETRY`): its rows a block are its threads times its
rows a thread (one row a thread where the source defines no count; the
big-d φ record their rows a block, 64 where a source records none; the
wide-d φ their rows a block and d-slices by d, :func:`wide_geometry`, and
the first version's where a source records none), and its blocks an SM
the m-split's target (every block of a cluster counted), so a variant is a
copy of the sources with one constant edited.  A version whose source defines no blocks an SM
runs at ``--base-blocks-per-sm`` (by default the φ's
``SPLIT_BLOCKS_PER_SM``, 8: the split every kernel took before the
streaming ones recorded their own; a version that gave ``ot_kmat_vec`` /
``ot_plan_grad`` 32 without recording it needs ``--base-blocks-per-sm 32``).
At each shape of :data:`SHAPES` the versions run in turns — base, tree,
tree, base for each ``DIR`` — each turn the mean of ``reps`` launches timed
with CUDA events; one JSON row a shape gives every turn, the largest
``|Δ|`` between the tree's output and each base's, the SM clock and the
card's name and power limit.  Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from dist_svgd_torch.models import bnn
from dist_svgd_torch.ops import _build, cuda_ot, cuda_svgd
from dist_svgd_torch.ops.cuda_svgd import SPLIT_BLOCKS_PER_SM, _split_m
from dist_svgd_torch.ops.kernels import median_bandwidth
from dist_svgd_torch.utils.datasets import UCI_REGRESSION_DIMS

#: (kernel, (S, k, m, d), role, options): the 100k streaming route's shapes
#: — its 8 lanes, one lane and one lane the other way round — for
#: kmat_vec (r = 1) and plan_grad; both directions of the soft c-transform
#: at the 8 lanes (the solve's warm start), its fused-route 10k shape, and
#: the hard form (a cold start) at the 8 lanes; the small-d φ at the
#: streaming lanes (h = 10, that path's) and at the north star's; the big-d
#: φ at the splice and Covertype lanes; the wide-d φ at the BNN's one lane
#: (y = x = the driver's initial particles at h = 1, and the inputs'
#: median h), the 8-shard BNN lanes and 8 lanes × 1250 × 10,000 at h = 2d.
SHAPES = [("ot_kmat_vec", (8, 12_500, 100_000, 3), "main", {}),
          ("ot_kmat_vec", (1, 12_500, 100_000, 3), "100k lane", {}),
          ("ot_kmat_vec", (1, 100_000, 12_500, 3), "100k lane transposed", {}),
          ("ot_plan_grad", (8, 12_500, 100_000, 3), "main", {}),
          ("ot_plan_grad", (1, 12_500, 100_000, 3), "100k lane", {}),
          ("ot_ctransform", (8, 12_500, 100_000, 3), "main", {"soft": True}),
          ("ot_ctransform", (8, 100_000, 12_500, 3), "100k lanes transposed", {"soft": True}),
          ("ot_ctransform", (8, 1250, 10_000, 3), "10k main", {"soft": True}),
          ("ot_ctransform", (8, 12_500, 100_000, 3), "hard", {"soft": False}),
          ("ot_ctransform", (8, 100_000, 12_500, 3), "hard transposed", {"soft": False}),
          ("phi_small_d", (8, 12_500, 100_000, 3), "w2 streaming lanes h=10", {"h": 10.0}),
          ("phi_small_d", (8, 1250, 10_000, 3), "north-star lanes", {"h": 1.0}),
          ("phi_big_d", (8, 1250, 10_000, 61), "splice lanes h=1", {"h": 1.0}),
          ("phi_big_d", (8, 1250, 10_000, 61), "splice lanes h=2d", {"h": 122.0}),
          ("phi_big_d", (8, 1250, 10_000, 55), "covertype lanes h=1", {"h": 1.0}),
          ("phi_big_d_bf16x3", (8, 1250, 10_000, 55), "covertype lanes h=1", {"h": 1.0}),
          ("phi_big_d_bf16x3", (8, 1250, 10_000, 55), "covertype lanes h=2d", {"h": 110.0}),
          ("phi_big_d_bf16x3", (1, 10_000, 10_000, 55), "sampler lane h=1", {"h": 1.0})]
WIDE_D = ("phi_wide_d", "phi_wide_d_bf16x3")
for _name in WIDE_D:
    SHAPES += [(_name, (1, 500, 500, 753), "bnn lane self h=1", {"h": 1.0, "self": True}),
               (_name, (1, 500, 500, 753), "bnn lane median h", {"h": "median"}),
               (_name, (8, 62, 496, 753), "bnn dist lanes", {"h": "median"}),
               (_name, (8, 1250, 10_000, 753), "throughput h=2d", {"h": 1506.0})]
NAMES = ("ot_kmat_vec", "ot_plan_grad", "ot_ctransform", "phi_small_d", "phi_big_d",
         "phi_big_d_bf16x3") + WIDE_D
BIG_D = ("phi_big_d", "phi_big_d_bf16x3")
PHI = ("phi_small_d",) + BIG_D + WIDE_D

#: Each kernel's geometry in its sources: (file, threads a block, rows a
#: thread, blocks an SM, columns a tile) — the constants' names; the big-d
#: φ name their rows a block in place of the threads, and no rows a thread.
GEOMETRY = {
    "ot_kmat_vec": ("ot_common.cuh", "OT_THREADS", "OT_KMV_ROWS_PER_THREAD",
                    "OT_STREAMING_BLOCKS_PER_SM", "OT_TILE"),
    "ot_plan_grad": ("ot_common.cuh", "OT_THREADS", "OT_PG_ROWS_PER_THREAD",
                     "OT_STREAMING_BLOCKS_PER_SM", "OT_TILE"),
    "ot_ctransform": ("ot_common.cuh", "OT_THREADS", "OT_CT_ROWS_PER_THREAD",
                      "OT_CT_BLOCKS_PER_SM", "OT_TILE"),
    "phi_small_d": ("phi_small_d.cu", "SD_THREADS", "SD_ROWS_PER_THREAD",
                    "SD_BLOCKS_PER_SM", "SD_TILE"),
    "phi_big_d": ("phi_big_d.cu", "BD_ROWS", None, "BD_BLOCKS_PER_SM", "BD_COLS"),
    "phi_big_d_bf16x3": ("phi_big_d_bf16x3.cu", "BX_ROWS", None, "BX_BLOCKS_PER_SM",
                         "BX_COLS"),
    "phi_wide_d": ("phi_wide_d.cu", "WD_ROWS", None, "WD_BLOCKS_PER_SM", "WD_COLS"),
    "phi_wide_d_bf16x3": ("phi_wide_d_bf16x3.cu", "WX_ROWS", None, "WX_BLOCKS_PER_SM",
                          "WX_COLS"),
}
#: Rows a block of a big-d φ whose source records none (the first version's).
BIG_D_ROWS = 64
#: The first wide-d versions, whose sources record no geometry: rows a block
#: up to d = 1024 and beyond, columns a tile; no d-slices.
FIRST_WIDE_D = {"phi_wide_d": (32, 16, 64), "phi_wide_d_bf16x3": (16, 16, 64)}



@functools.lru_cache(maxsize=None)
def source_const(csrc: Path, name: str, constant: str,
                 default: Optional[int] = None) -> int:
    """``constexpr int <constant>`` of kernel ``name``'s geometry file in a
    version's sources; ``default`` where it defines none."""
    path = csrc / GEOMETRY[name][0]
    found = re.search(rf"constexpr int {constant} = (\d+);", path.read_text())
    if found is None and default is None:
        raise ValueError(f"{path} defines no {constant}")
    return int(found.group(1)) if found else default


@functools.lru_cache(maxsize=None)
def _records(csrc: Path, name: str, constant: str) -> bool:
    path = csrc / GEOMETRY[name][0]
    return re.search(rf"constexpr int {constant} = \d+;", path.read_text()) is not None


def wide_geometry(csrc: Path, name: str, d: int):
    """``(rows, blocks)`` of a version's wide-d kernel ``name`` at feature
    dim ``d``: its output rows a block and the blocks of a cluster (its
    d-slices, as ``WdSlices`` / ``WxSlices`` cut them), read from its
    constants; the first version's rows and one block where it records
    none."""
    p = GEOMETRY[name][1].split("_")[0]  # WD or WX
    if not _records(csrc, name, f"{p}_ROWS"):
        narrow, wide, _ = FIRST_WIDE_D[name]
        return (narrow if d <= 1024 else wide), 1
    narrow = d <= source_const(csrc, name, f"{p}_NARROW_MAX_D")
    rows = source_const(csrc, name, f"{p}_ROWS" if narrow else f"{p}_WIDE_ROWS")
    ws = source_const(csrc, name, f"{p}_SLICE" if narrow else f"{p}_WIDE_SLICE")
    return rows, -(-d // ws)


def rows_per_block(csrc: Path, name: str, d: Optional[int] = None) -> int:
    """A version's output rows a block of kernel ``name`` (a wide-d φ's at
    feature dim ``d``; its narrow geometry's where no d is given)."""
    _, threads, rows, _, _ = GEOMETRY[name]
    if name in WIDE_D:
        if d is None:
            return source_const(csrc, name, threads, FIRST_WIDE_D[name][0])
        return wide_geometry(csrc, name, d)[0]
    if rows is None:  # a big-d φ: its rows a block
        return source_const(csrc, name, threads, BIG_D_ROWS)
    return source_const(csrc, name, threads) * source_const(csrc, name, rows, 1)


def tile_of(csrc: Path, name: str) -> int:
    """A version's interaction columns a tile of kernel ``name``."""
    if name in WIDE_D and not _records(csrc, name, GEOMETRY[name][4]):
        return FIRST_WIDE_D[name][2]
    return source_const(csrc, name, GEOMETRY[name][4])


def _launch_params(csrc: Path, name: str) -> str:
    path = csrc / GEOMETRY[name][0]
    found = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', path.read_text())
    if found is None:
        raise ValueError(f"{path} defines no {name}_launch")
    return found.group(1)


def takes_scratch(csrc: Path, name: str) -> bool:
    """Whether a version's launch function of kernel ``name`` takes a
    scratch pointer (the big-d φ since their pre-passes)."""
    return "scratch" in _launch_params(csrc, name)


def takes_scores(csrc: Path, name: str) -> bool:
    """Whether a version's launch function of kernel ``name`` takes the
    scores ``s`` (its pre-pass forms ``xs = s − (2/h)·x``) rather than
    ``xs``."""
    return re.search(r"\bconst void\* s\b", _launch_params(csrc, name)) is not None


def blocks_per_sm(csrc: Path, name: str, default: Optional[int] = None) -> int:
    """A version's m-split target of kernel ``name``, ``default`` (the φ's
    ``SPLIT_BLOCKS_PER_SM`` when None) where its sources record none."""
    return source_const(csrc, name, GEOMETRY[name][3],
                        SPLIT_BLOCKS_PER_SM if default is None else default)


def _phi_argtypes(pointers: int):
    return [ctypes.c_void_p] * pointers + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def base_kernel(csrc: Path, name: str, default_blocks_per_sm: Optional[int] = None):
    """A callable with the tree's wrapper's arguments (``kmat_vec_cuda``,
    ``plan_grad_cuda``, ``ctransform_reduce_cuda``, ``phi_*_cuda``) that
    launches the kernel built from ``csrc`` at that version's rows a block
    and blocks an SM (:func:`_split_m`)."""
    lib = ctypes.CDLL(str(_build.build([name], csrc=csrc)[name].path))
    fn = getattr(lib, f"{name}_launch")
    scratch = name in BIG_D + WIDE_D and takes_scratch(csrc, name)
    scores = name in BIG_D + WIDE_D and takes_scores(csrc, name)
    norms = name == "phi_big_d_bf16x3" or (name in WIDE_D and not scratch)
    if name in PHI:
        fn.argtypes = _phi_argtypes(5 + 2 * norms + scratch)
    else:
        fn.argtypes = cuda_ot._ARGTYPES[name]
    fn.restype = ctypes.c_int
    if scratch:
        size = getattr(lib, f"{name}_scratch_bytes")
        size.argtypes = [ctypes.c_int] * 5
        size.restype = ctypes.c_longlong
    target = blocks_per_sm(csrc, name, default_blocks_per_sm)
    tile = tile_of(csrc, name)

    def launch(tensors, *ints, scale):
        dev = tensors[0].device
        err = fn(*[t.data_ptr() for t in tensors], *ints, scale, dev.index or 0,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} from {csrc} failed with CUDA error {err}")

    def call(rows, cols, *rest):
        S, k, d = rows.shape
        m = cols.shape[-2]
        block, blocks = (wide_geometry(csrc, name, d) if name in WIDE_D
                         else (rows_per_block(csrc, name), 1))
        nsplit, chunk = _split_m(m, tile, S * -(-k // block) * blocks, rows.device, target)
        if name in PHI:  # rest: the scores and h
            s, h = rest
            inv_h = 1.0 / float(h)
            lane_stride = m * d if cols.dim() == 3 else 0
            ptrs = [rows, cols, s if scores else (s - (2.0 * inv_h) * cols).contiguous()]
            if norms:
                ptrs += [torch.sum(rows * rows, dim=-1), torch.sum(cols * cols, dim=-1)]
            if scratch:
                ptrs.append(torch.empty(size(S, k, m, d, lane_stride), dtype=torch.uint8,
                                        device=rows.device))
            part = torch.empty((nsplit, S, k, d + 1), device=rows.device)
            out = torch.empty((S, k, d), device=rows.device)
            launch((*ptrs, part, out), S, k, m, d, lane_stride, chunk, nsplit, scale=inv_h)
        elif name == "ot_ctransform":  # rest: the potential and soft
            pot, soft = rest
            part = torch.empty((nsplit, S, k, 2), device=rows.device)
            out = torch.empty((S, k), device=rows.device)
            launch((rows, cols, pot, part, out), S, k, m, d, chunk, nsplit, int(soft),
                   scale=1.0)
        elif name == "ot_kmat_vec":  # rest: f, g and an (S, m) right-hand side
            f, g, rhs = rest
            part = torch.empty((nsplit, S, k, 1), device=rows.device)
            out = torch.empty((S, k), device=rows.device)
            launch((rows, cols, f, g, rhs, part, out), S, k, m, d, 1, chunk, nsplit,
                   scale=1.0)
        else:  # ot_plan_grad: f, g; partials of d sums a row (d + 1 before
            # it summed P·(y − x) directly; the larger serves both)
            f, g = rest
            part = torch.empty((nsplit, S, k, d + 1), device=rows.device)
            out = torch.empty((S, k, d), device=rows.device)
            launch((rows, cols, f, g, part, out), S, k, m, d, chunk, nsplit, scale=1.0)
        return out

    return call


TREE = {"ot_kmat_vec": cuda_ot.kmat_vec_cuda, "ot_plan_grad": cuda_ot.plan_grad_cuda,
        "ot_ctransform": cuda_ot.ctransform_reduce_cuda,
        "phi_small_d": cuda_svgd.phi_small_d_cuda, "phi_big_d": cuda_svgd.phi_big_d_cuda,
        "phi_big_d_bf16x3": cuda_svgd.phi_big_d_bf16x3_cuda,
        "phi_wide_d": cuda_svgd.phi_wide_d_cuda,
        "phi_wide_d_bf16x3": cuda_svgd.phi_wide_d_bf16x3_cuda}


def inputs(name: str, S: int, k: int, m: int, d: int, opts: Dict, seed: int):
    """The operands of one call.  Sinkhorn kernels: lanes in the solve's
    reg-rescaled units (mean C ≈ 20), f and g the cold start's hard
    c-transform pair, a positive right-hand side, the c-transform taking g —
    the inputs of ``chip_smoke.py``'s Sinkhorn parity rows.  φ: particle-like
    lanes, y the lanes' blocks of the shared x, s score-like; with
    ``opts["self"]`` the BNN driver's one lane, y = x = its initial
    particles (d = 753); an ``opts["h"]`` of "median" is the inputs' median
    heuristic."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if name in PHI:
        x = torch.randn(m, d, generator=gen)
        y = x[torch.randint(0, m, (S, k), generator=gen)]
        s = torch.randn(S, m, d, generator=gen)
        if opts.get("self"):
            x = bnn.init_particles(seed, m, UCI_REGRESSION_DIMS["boston"])
            y = x[None].clone()
        h = float(median_bandwidth(x)) if opts["h"] == "median" else opts["h"]
        return (y.cuda(), x.cuda(), s.cuda(), h)
    scale = (20.0 / (2 * d)) ** 0.5
    rows = (scale * torch.randn(S, k, d, generator=gen)).cuda()
    cols = (scale * torch.randn(S, m, d, generator=gen)).cuda()
    f = cuda_ot.ctransform_reduce(rows, cols, torch.zeros(S, m, device="cuda"), soft=False)
    g = cuda_ot.ctransform_reduce(cols, rows, f, soft=False)
    if name == "ot_ctransform":
        return (rows, cols, g, opts["soft"])
    if name == "ot_plan_grad":
        return (rows, cols, f, g)
    return (rows, cols, f, g, (0.5 + torch.rand(S, m, generator=gen)).cuda())


def event_ms(fn, reps: int) -> float:
    """Mean ms a call over ``reps`` warmed calls, timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=30).stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bases", nargs="+", type=Path,
                    help="directories with another version of the kernels' sources")
    ap.add_argument("--kernels", nargs="+", choices=NAMES, default=list(NAMES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--base-blocks-per-sm", type=int, default=None,
                    help="the m-split of a base whose sources record none "
                         "(default: the φ's SPLIT_BLOCKS_PER_SM)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ot_ab times kernels on a CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    bases = {str(b): {name: base_kernel(b.resolve(), name, args.base_blocks_per_sm)
                      for name in args.kernels}
             for b in args.bases}
    rows_out = []
    for seed, (name, (S, k, m, d), role, opts) in enumerate(SHAPES):
        if name not in args.kernels:
            continue
        operands = inputs(name, S, k, m, d, opts, 200 + seed)
        tree = TREE[name]
        want = tree(*operands)
        row = {"kernel": name, "role": role, "shape": [S, k, m, d], **opts,
               "reps": args.reps,
               "tree": {"rows_per_block": rows_per_block(_build.CSRC, name, d),
                        "blocks_per_sm": blocks_per_sm(_build.CSRC, name)}}
        if name in PHI:
            row["h"] = operands[3]
        for label, kernels in bases.items():
            got = kernels[name](*operands)
            torch.cuda.synchronize()
            base = Path(label).resolve()
            row[label] = {"rows_per_block": rows_per_block(base, name, d),
                          "blocks_per_sm": blocks_per_sm(base, name,
                                                         args.base_blocks_per_sm),
                          "max_abs_diff_vs_tree": float((got - want).abs().max()),
                          "max_abs_tree": float(want.abs().max())}
            turns = {"base": [], "tree": []}
            for who in ("base", "tree", "tree", "base"):
                fn = kernels[name] if who == "base" else tree
                turns[who].append(event_ms(lambda: fn(*operands), args.reps))
            row[label].update(base_ms=turns["base"], tree_ms=turns["tree"])
        row.update(clocks_sm=smi("clocks.sm"), card=card)
        print(json.dumps(row), flush=True)
        rows_out.append(row)
        del operands, want
    return rows_out


if __name__ == "__main__":
    main()
