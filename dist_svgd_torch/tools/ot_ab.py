"""Old against new on the card: the streaming route's two Sinkhorn kernels
(``ot_kmat_vec``, ``ot_plan_grad``) of this tree against the same kernels
built from another version of their sources, timed in turns in one process.

    mkdir -p build/base && git archive <commit> dist_svgd_torch/csrc | tar -x -C build/base
    python -m dist_svgd_torch.tools.ot_ab build/base/dist_svgd_torch/csrc [DIR ...] [--reps 20]

Each ``DIR`` holds ``ot_common.cuh``, ``ot_kmat_vec.cu`` and
``ot_plan_grad.cu`` (their C interfaces as this tree's); they are compiled
with this tree's flags (``ops/_build.py``).  A version's rows a block is read
from its ``ot_common.cuh`` (``OT_THREADS`` × ``OT_KMV_ROWS_PER_THREAD`` or
``OT_PG_ROWS_PER_THREAD``, the latter 1 where the header has none), and it
runs at ``--base-blocks-per-sm`` blocks an SM (by default the φ's
``SPLIT_BLOCKS_PER_SM``, the split every Sinkhorn kernel took before the
streaming ones had their own), so a parent runs at the m-split its own
wrapper made.  At each shape of :data:`SHAPES` the versions run in turns —
base, tree, tree, base for each ``DIR`` — each turn the mean of ``reps``
launches timed with CUDA events; one JSON row a shape gives every turn, the
largest ``|Δ|`` between the tree's output and each base's, the SM clock and
the card's name and power limit.  Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from dist_svgd_torch.ops import _build, cuda_ot
from dist_svgd_torch.ops.cuda_svgd import _split_m

#: (kernel, (S, k, m, d), role): the 100k streaming route's shapes — its 8
#: lanes, one lane and one lane of Pᵀu — at r = 1.
SHAPES = [("ot_kmat_vec", (8, 12_500, 100_000, 3), "main"),
          ("ot_kmat_vec", (1, 12_500, 100_000, 3), "100k lane"),
          ("ot_kmat_vec", (1, 100_000, 12_500, 3), "100k lane transposed"),
          ("ot_plan_grad", (8, 12_500, 100_000, 3), "main"),
          ("ot_plan_grad", (1, 12_500, 100_000, 3), "100k lane")]
NAMES = ("ot_kmat_vec", "ot_plan_grad")


#: Each kernel's rows-a-thread constant in ``ot_common.cuh``.
ROWS_PER_THREAD = {"ot_kmat_vec": "OT_KMV_ROWS_PER_THREAD",
                   "ot_plan_grad": "OT_PG_ROWS_PER_THREAD"}


def header_const(csrc: Path, name: str, default: Optional[int] = None) -> int:
    """``constexpr int <name>`` of a version's ``ot_common.cuh``."""
    found = re.search(rf"constexpr int {name} = (\d+);", (csrc / "ot_common.cuh").read_text())
    if found is None and default is None:
        raise ValueError(f"{csrc / 'ot_common.cuh'} defines no {name}")
    return int(found.group(1)) if found else default


def rows_per_block(csrc: Path, name: str) -> int:
    """A version's output rows a block of kernel ``name``."""
    return header_const(csrc, "OT_THREADS") * header_const(csrc, ROWS_PER_THREAD[name], 1)


def base_kernel(csrc: Path, name: str, blocks_per_sm: Optional[int] = None):
    """A callable with ``kmat_vec_cuda`` / ``plan_grad_cuda``'s arguments
    that launches the kernel built from ``csrc`` at that version's rows a
    block and ``blocks_per_sm`` (:func:`_split_m`)."""
    import ctypes

    fn = getattr(ctypes.CDLL(str(_build.build([name], csrc=csrc)[name].path)),
                 f"{name}_launch")
    fn.argtypes = cuda_ot._ARGTYPES[name]
    fn.restype = ctypes.c_int
    block = rows_per_block(csrc, name)

    def call(rows, cols, f, g, rhs=None):
        S, k, d = rows.shape
        m = cols.shape[1]
        nsplit, chunk = _split_m(m, cuda_ot._TILE, S * -(-k // block), rows.device,
                                 blocks_per_sm)
        # partials of r = 1 sums a row, or of plan_grad's d (d + 1 before it
        # summed P·(y − x) directly; the larger serves both)
        width = 1 if name == "ot_kmat_vec" else d + 1
        part = torch.empty((nsplit, S, k, width), device=rows.device)
        out = torch.empty((S, k) if name == "ot_kmat_vec" else (S, k, d), device=rows.device)
        ptrs = [t.data_ptr() for t in (rows, cols, f, g)]
        ints = [S, k, m, d] + ([1] if name == "ot_kmat_vec" else []) + [chunk, nsplit]
        if name == "ot_kmat_vec":
            ptrs.append(rhs.data_ptr())
        err = fn(*ptrs, part.data_ptr(), out.data_ptr(), *ints, 1.0,
                 rows.device.index or 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} from {csrc} failed with CUDA error {err}")
        return out

    return call


def inputs(S: int, k: int, m: int, d: int, seed: int):
    """Lanes in the solve's reg-rescaled units (mean C ≈ 20), f and g the
    cold start's hard c-transform pair, a positive right-hand side — the
    inputs of ``chip_smoke.py``'s Sinkhorn parity rows."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    scale = (20.0 / (2 * d)) ** 0.5
    rows = (scale * torch.randn(S, k, d, generator=gen)).cuda()
    cols = (scale * torch.randn(S, m, d, generator=gen)).cuda()
    f = cuda_ot.ctransform_reduce(rows, cols, torch.zeros(S, m, device="cuda"), soft=False)
    g = cuda_ot.ctransform_reduce(cols, rows, f, soft=False)
    rhs = (0.5 + torch.rand(S, m, generator=gen)).cuda()
    return rows, cols, f, g, rhs


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
                    help="directories with another version's ot_common.cuh, "
                         "ot_kmat_vec.cu and ot_plan_grad.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--base-blocks-per-sm", type=int, default=None,
                    help="the bases' m-split (default: the φ's SPLIT_BLOCKS_PER_SM)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ot_ab times kernels on a CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    tree = {"ot_kmat_vec": cuda_ot.kmat_vec_cuda, "ot_plan_grad": cuda_ot.plan_grad_cuda}
    bases = {str(b): {name: base_kernel(b.resolve(), name, args.base_blocks_per_sm)
                      for name in NAMES}
             for b in args.bases}
    rows_out = []
    for seed, (name, (S, k, m, d), role) in enumerate(SHAPES):
        rows, cols, f, g, rhs = inputs(S, k, m, d, 200 + seed)
        operands = (rows, cols, f, g, rhs) if name == "ot_kmat_vec" else (rows, cols, f, g)
        want = tree[name](*operands)
        row = {"kernel": name, "role": role, "shape": [S, k, m, d], "reps": args.reps,
               "tree": {"rows_per_block": rows_per_block(_build.CSRC, name)}}
        for label, kernels in bases.items():
            got = kernels[name](*operands)
            torch.cuda.synchronize()
            row[label] = {"rows_per_block": rows_per_block(Path(label).resolve(), name),
                          "max_abs_diff_vs_tree": float((got - want).abs().max()),
                          "max_abs_tree": float(want.abs().max())}
            turns = {"base": [], "tree": []}
            for who in ("base", "tree", "tree", "base"):
                fn = kernels[name] if who == "base" else tree[name]
                turns[who].append(event_ms(lambda: fn(*operands), args.reps))
            row[label].update(base_ms=turns["base"], tree_ms=turns["tree"])
        row.update(clocks_sm=smi("clocks.sm"), card=card)
        print(json.dumps(row), flush=True)
        rows_out.append(row)
        del rows, cols, f, g, rhs, operands, want
    return rows_out


if __name__ == "__main__":
    main()
