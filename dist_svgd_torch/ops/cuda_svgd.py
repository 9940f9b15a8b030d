"""The fused SVGD φ on the card: hand-written CUDA kernels, their plain
PyTorch versions, and the φ-backend policy.

Counterpart of ``dist_svgd_tpu/ops/pallas_svgd.py``.  The math is the TPU
kernels' (reference Algorithm 1 with the closed-form repulsive term):

    K_ij   = exp(−‖y_i − x_j‖² / h)
    φ(y_i) = (1/m) [ Σ_j K_ij·(s_j − (2/h)·x_j)  +  (2/h)·y_i·Σ_j K_ij ]

Kernels chosen on the feature dim d, each in two precision tiers:

- ``csrc/phi_small_d.cu`` (d ≤ :data:`SMALL_D`), replacing
  ``_phi_kernel_small_d``: distances as direct per-dim differences; the
  bf16 tier (``phi_small_d_bf16``, a template flag of the same kernel)
  rounds the exponent to bf16 and takes its f32 exp;
- ``csrc/phi_big_d.cu`` (:data:`SMALL_D` < d ≤ :data:`BIG_D_MAX`),
  replacing ``_phi_kernel`` in its exact f32 tier: distances as
  ``y² + x² − 2·y·xᵀ`` clamped at 0, on the FP32 CUDA cores, both
  contractions as register-tiled small GEMMs;
- ``csrc/phi_big_d_bf16x3.cu``, the same kernel's bf16x3 tier
  (``_dot3``): both contractions as three bf16 tensor-core products
  ``hi·hi + hi·lo + lo·hi`` of the split operands, the exp in f32;
  both big-d kernels start with a pre-pass (same launch) that pads, and
  for the bf16x3 tier splits, y, x and ``xs`` once a call into a scratch
  buffer the wrapper allocates (:data:`_SCRATCH`), so that the wrapper
  issues no torch op before the launch (the big-d bf16x3 tier's norms
  aside, which it sums in torch);
- ``csrc/phi_wide_d.cu`` and ``csrc/phi_wide_d_bf16x3.cu``
  (:data:`BIG_D_MAX` < d ≤ :data:`WIDE_D_MAX`), the same ``_phi_kernel``
  in both tiers — the d range of the BNN's weight vectors (d = 753) — with
  the feature axis cut into slices (:func:`wide_d_slices`), one a block,
  the blocks of a row block forming a thread-block cluster that sums the
  slices' Gram partials through distributed shared memory, each block's
  drive in registers; a pre-pass as the big-d kernels'.  Their plain
  versions are the big-d ones: one function at every d, as
  ``_phi_kernel`` is.

The bf16 tiers are JAX's ``phi_impl='pallas_bf16'`` (here
``'cuda_bf16'``): opt-in, never chosen by ``'auto'``.

A third mode of ``csrc/phi_small_d.cu``, ``phi_small_d_noexp``, replaces
the timing probe ``_noexp_kernel`` of ``tools/pallas_autotune.py``: the
small-d φ with K replaced by ``−min(d², 1e30)``, no exp, at h = 1.  Only
``dist_svgd_torch.tools.cuda_autotune`` launches it, to isolate the exp's
share of the exact kernel's time; no ``phi_impl`` reaches it.

Each kernel has a plain PyTorch version here with the same distance form,
the same splits and the same ``xs = s − (2/h)·x`` drive operand (formed by
the wrapper, or by the big-d kernels' pre-pass with the same roundings),
so that holding a kernel against its plain version on the card measures
the kernel, not the form.

Batched interface: ``y`` is ``(S, k, d)`` — S lanes, the emulated shards —
``x`` is ``(m, d)`` shared by every lane or ``(S, m, d)``, ``s`` is
``(S, m, d)``; all lanes run in one launch.  Computation is float32
whatever the input dtype (f64 is cast down and back, as ``phi_pallas``
does).

Device rule: a wrapper uses its kernel's plain version only because the
tensor it was given lies on the CPU; on a CUDA tensor it launches the
kernel or raises.  Nothing catches a failed build or launch.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from dist_svgd_torch.ops import _build
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF, median_bandwidth_approx
from dist_svgd_torch.ops.svgd import phi, phi_blockwise

#: Feature dims up to this use the direct-difference kernel.
SMALL_D = 8

#: Largest feature dim the big-d kernels take (their register tiles hold a
#: row's drive accumulators); larger d goes to the wide-d kernels.
BIG_D_MAX = 128

#: Largest feature dim the wide-d kernels take: the d ≤ 2432 that the TPU
#: kernel admits (``fits_vmem_big_d``: the 128×256 floor tile in 14 MB of
#: VMEM).  Beyond it ``'auto'`` takes the plain φ, as JAX's ``'auto'`` takes
#: the XLA φ, and the kernels raise ``ValueError``.
WIDE_D_MAX = 2432

#: The no-exp probe's clamp of d² (``pallas_svgd.py:_D2_CAP``, copied).
_D2_CAP = 1e30

#: Launches of each kernel since the last :func:`reset_launch_counts` — one
#: per wrapper call that launched it (a call is a partial-sum kernel plus
#: the finalize kernel of the same source), so a run can show that its φ
#: went through the hand kernels.
launch_counts: Dict[str, int] = {"phi_small_d": 0, "phi_big_d": 0,
                                 "phi_small_d_bf16": 0, "phi_big_d_bf16x3": 0,
                                 "phi_wide_d": 0, "phi_wide_d_bf16x3": 0,
                                 "phi_small_d_noexp": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_shapes(y: torch.Tensor, x: torch.Tensor, s: torch.Tensor) -> None:
    if y.dim() != 3:
        raise ValueError(f"updated must be (S, k, d), got {tuple(y.shape)}")
    S, _, d = y.shape
    if x.dim() not in (2, 3) or x.shape[-1] != d or (x.dim() == 3 and x.shape[0] != S):
        raise ValueError(
            f"interacting must be (m, {d}) or ({S}, m, {d}), got {tuple(x.shape)}")
    if tuple(s.shape) != (S, x.shape[-2], d):
        raise ValueError(
            f"scores must be ({S}, {x.shape[-2]}, {d}), got {tuple(s.shape)}")
    if not (y.device == x.device == s.device):
        raise ValueError("updated, interacting and scores must share one device")


def _drive_operand(x: torch.Tensor, s: torch.Tensor, inv_h: float) -> torch.Tensor:
    """``s − (2/h)·x``, formed once per call (``pallas_svgd.py:351``)."""
    return (s - (2.0 * inv_h) * x).contiguous()


def _epilogue(y, acc, ksum, inv_h: float, m: int) -> torch.Tensor:
    """``_phi_tail``: ``(acc + (2/h)·y·ksum) / m``."""
    return (acc + (2.0 * inv_h) * y * ksum) / m


def _direct_d2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Σ_c (y_c − x_c)²`` as per-dim differences (exact, no clamp),
    ``(S, k, m)``."""
    d2 = None
    for c in range(y.shape[-1]):
        diff = y[..., :, c, None] - x[..., None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _small_d_plain(y, x, s, bandwidth, gram) -> torch.Tensor:
    """Both small-d plain versions; ``gram(neg)`` turns the exponent
    ``−d²/h`` into K."""
    _check_shapes(y, x, s)
    inv_h = 1.0 / float(bandwidth)
    xs = _drive_operand(x, s, inv_h)
    K = gram(-_direct_d2(y, x) * inv_h)  # (S, k, m)
    return _epilogue(y, torch.matmul(K, xs), K.sum(-1, keepdim=True), inv_h,
                     x.shape[-2])


def _big_d_plain(y, x, s, bandwidth, dot) -> torch.Tensor:
    """Both big-d plain versions; ``dot`` forms the two contractions."""
    _check_shapes(y, x, s)
    inv_h = 1.0 / float(bandwidth)
    xs = _drive_operand(x, s, inv_h)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)  # (S, k, 1)
    x2 = torch.sum(x * x, dim=-1)[..., None, :]  # (1, m) or (S, 1, m)
    yx = dot(y, x.transpose(-1, -2))  # (S, k, m)
    K = torch.exp(-torch.clamp(y2 + x2 - 2.0 * yx, min=0.0) * inv_h)
    return _epilogue(y, dot(K, xs), K.sum(-1, keepdim=True), inv_h, x.shape[-2])


def phi_small_d_plain(y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                      bandwidth: float = 1.0) -> torch.Tensor:
    """Plain version of the small-d kernel: distances as direct per-dim
    differences ``Σ_c (y_c − x_c)²`` (exact, no clamp), in the dtype given."""
    return _small_d_plain(y, x, s, bandwidth, torch.exp)


def phi_big_d_plain(y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                    bandwidth: float = 1.0) -> torch.Tensor:
    """Plain version of the big-d kernel: distances as ``y² + x² − 2·y·xᵀ``
    clamped at 0, in the dtype given (TF32 must be off on the card:
    :func:`dist_svgd_torch.utils.platform.resolve_device` pins it)."""
    return _big_d_plain(y, x, s, bandwidth, torch.matmul)


def _bf16_split(a: torch.Tensor):
    """``_dot3``'s split of an f32 tensor into bf16 ``hi`` and the bf16
    residual ``lo = bf16(a − hi)``, both returned as f32 values."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as ``_dot3`` forms it: ``hi·hi + hi·lo + lo·hi`` of the
    bf16 splits, each an f32 matmul of bf16-valued operands (their
    products are exact in f32; TF32 is off)."""
    a_hi, a_lo = _bf16_split(a)
    b_hi, b_lo = _bf16_split(b)
    return (torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_lo, b_hi))


def phi_small_d_bf16_plain(y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                           bandwidth: float = 1.0) -> torch.Tensor:
    """Plain version of the small-d kernel's bf16 tier, float32: per-dim
    distances in f32, the exponent ``−d²/h`` rounded to bf16 and its exp in
    f32; the drive and the row-sum take that K.

    The TPU kernel writes ``exp(neg.astype(bfloat16))``, a bf16 K, but the
    JAX program it runs in keeps that K in f32: XLA's default excess
    precision drops the rounding of an exp whose every consumer is f32
    (measured: K rounded to bf16 moves φ 1.6e-3 of max|φ| away from
    ``phi_pallas(gram_dtype=bfloat16)`` at (50, 37, 3), the exponent-only
    rounding 4e-8).  The port follows the program as it runs."""
    return _small_d_plain(y, x, s, bandwidth,
                          lambda neg: torch.exp(neg.to(torch.bfloat16).float()))


def phi_small_d_noexp_plain(y: torch.Tensor, x: torch.Tensor,
                            s: torch.Tensor) -> torch.Tensor:
    """Plain version of the no-exp probe: the small-d φ at h = 1 with
    ``K' = −min(d², _D2_CAP)`` in place of the exp — JAX's ``phi_noexp``,
    ``(Σ_j K'_ij·(s_j − 2·x_j) + 2·y_i·Σ_j K'_ij) / m``, on every shape
    (JAX's probe sums its ``_FAR`` padding columns where m is not a multiple
    of its column tile)."""
    return _small_d_plain(y, x, s, 1.0, lambda neg: -torch.clamp(-neg, max=_D2_CAP))


def phi_big_d_bf16x3_plain(y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                           bandwidth: float = 1.0) -> torch.Tensor:
    """Plain version of the big-d kernel's bf16x3 tier, float32:
    ``y·xᵀ`` and ``K·xs`` through :func:`_dot3`, ``y²`` and ``x²`` as plain
    f32 sums, ``K = exp(−max(y² + x² − 2·y·xᵀ, 0)/h)`` in f32 and the
    row-sum over that unsplit K."""
    return _big_d_plain(y, x, s, bandwidth, _dot3)


_SM_COUNTS: Dict[int, int] = {}


#: The m-split's target of blocks per SM (:func:`_split_m`).
SPLIT_BLOCKS_PER_SM = 8


def _split_m(m: int, tile: int, row_blocks: int, device: torch.device,
             blocks_per_sm: Optional[int] = None) -> Tuple[int, int]:
    """``(nsplit, chunk)``: split the m axis into ``nsplit`` chunks of
    ``chunk`` columns (a multiple of ``tile``) so that the grid holds about
    ``blocks_per_sm`` (default :data:`SPLIT_BLOCKS_PER_SM`) blocks per SM —
    the output alone (``row_blocks`` blocks) is too few rows to fill the
    card at the north-star shapes."""
    if blocks_per_sm is None:
        blocks_per_sm = SPLIT_BLOCKS_PER_SM
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNTS[index] = sms
    tiles = -(-m // tile)
    want = max(1, min(tiles, -(-blocks_per_sm * sms // max(row_blocks, 1))))
    per = -(-tiles // want)
    return -(-tiles // per), per * tile


#: The small-d kernel's output rows a block (``SD_THREADS`` ×
#: ``SD_ROWS_PER_THREAD`` in csrc/phi_small_d.cu) and the m-split's blocks an
#: SM (``SD_BLOCKS_PER_SM``), the same in its three modes.
_SD_THREADS, _SD_ROWS_PER_THREAD = 128, 4
_SD_ROWS = _SD_THREADS * _SD_ROWS_PER_THREAD
_SD_BLOCKS_PER_SM = 32

#: The big-d kernels' output rows a block, interaction columns a tile and
#: the m-split's blocks an SM (``BD_ROWS``, ``BD_COLS``, ``BD_BLOCKS_PER_SM``
#: in csrc/phi_big_d.cu; ``BX_*`` in csrc/phi_big_d_bf16x3.cu).
_BD_ROWS, _BD_COLS, _BD_BLOCKS_PER_SM = 128, 64, 8
#: The exact big-d kernel's drive tile width (``BD_TD``): d is padded to a
#: multiple of it.
_BD_TD = 8
_BX_ROWS, _BX_COLS, _BX_BLOCKS_PER_SM = 128, 32, 8
#: The bf16x3 kernel's padded rows: d rounded up to a multiple of
#: ``BX_DP_ALIGN``, plus ``BX_ROW_PAD`` bf16 (csrc/phi_big_d_bf16x3.cu).
_BX_DP_ALIGN, _BX_ROW_PAD = 16, 8

#: The wide-d kernels' geometry (``WD_*`` in csrc/phi_wide_d.cu, ``WX_*`` in
#: csrc/phi_wide_d_bf16x3.cu): interaction columns a tile, the m-split's
#: blocks an SM (every block of a cluster counted), the largest d of the
#: narrow geometry, and for the narrow and the wide geometry the rows a
#: block and the slice width; the exact tier pads a slice row by
#: ``_WD_ROW_PAD`` floats beyond its features.
_WD_COLS, _WD_BLOCKS_PER_SM, _WD_ROW_PAD, _WD_NARROW_MAX_D = 64, 1, 4, 1024
_WD_ROWS, _WD_SLICE, _WD_WIDE_ROWS, _WD_WIDE_SLICE = 128, 128, 32, 320
_WX_COLS, _WX_BLOCKS_PER_SM, _WX_NARROW_MAX_D = 32, 1, 1024
_WX_ROWS, _WX_SLICE, _WX_WIDE_ROWS, _WX_WIDE_SLICE = 128, 128, 64, 320

#: name → (rows a block and slice width up to the narrow geometry's largest
#: d, the same beyond it, that d)
_WIDE_GEOMETRY = {
    "phi_wide_d": ((_WD_ROWS, _WD_SLICE), (_WD_WIDE_ROWS, _WD_WIDE_SLICE),
                   _WD_NARROW_MAX_D),
    "phi_wide_d_bf16x3": ((_WX_ROWS, _WX_SLICE), (_WX_WIDE_ROWS, _WX_WIDE_SLICE),
                          _WX_NARROW_MAX_D),
}


def _ceil_to(n: int, q: int) -> int:
    return -(-n // q) * q


def big_d_scratch_bytes(S: int, k: int, m: int, d: int, x_lanes: int) -> int:
    """Bytes of the exact big-d kernel's pre-pass scratch (``BdScratch`` in
    csrc/phi_big_d.cu): y, x and xs in float32 rows padded to a stride L
    (d rounded up to a multiple of ``BD_TD``, plus one float4 where its
    count of float4s is even), row counts padded to whole row blocks and
    column tiles, and the norms of the padded y and x rows.  ``x_lanes`` is
    1 for a shared x."""
    k_pad, m_pad = _ceil_to(k, _BD_ROWS), _ceil_to(m, _BD_COLS)
    dp = _ceil_to(d, _BD_TD)
    ld = dp if (dp // 4) % 2 else dp + 4
    normed = S * k_pad + x_lanes * m_pad  # the y and x rows
    return 4 * ((normed + S * m_pad) * ld + normed)


def big_d_bf16x3_scratch_bytes(S: int, k: int, m: int, d: int, x_lanes: int) -> int:
    """Bytes of the bf16x3 kernel's pre-pass scratch (``BxScratch`` in
    csrc/phi_big_d_bf16x3.cu): the bf16 hi and lo planes of y, x and xs in
    rows of ``⌈d/BX_DP_ALIGN⌉·BX_DP_ALIGN + BX_ROW_PAD``, row counts padded
    to whole row blocks and column tiles, and ‖x‖² (float32) on the padded
    x rows."""
    k_pad, m_pad = _ceil_to(k, _BX_ROWS), _ceil_to(m, _BX_COLS)
    lb = _ceil_to(d, _BX_DP_ALIGN) + _BX_ROW_PAD
    return 2 * 2 * lb * (S * k_pad + x_lanes * m_pad + S * m_pad) + 4 * x_lanes * m_pad


def wide_d_slices(name: str, d: int) -> Tuple[int, int, int]:
    """``(rows, slices, ws)`` of wide-d kernel ``name`` at feature dim ``d``
    (``WdSlices`` / ``WxSlices`` in its source): its output rows a block,
    and d cut into ``slices`` d-slices of ``ws`` features (the last padded
    with zeros), one a block of a cluster."""
    rows, ws = _WIDE_GEOMETRY[name][0 if d <= _WIDE_GEOMETRY[name][2] else 1]
    return rows, -(-d // ws), ws


def wide_d_scratch_bytes(S: int, k: int, m: int, d: int, x_lanes: int) -> int:
    """Bytes of the exact wide-d kernel's pre-pass scratch (``WdScratch`` in
    csrc/phi_wide_d.cu): y, x and xs slice by slice in float32 rows of
    ws + 4 floats, row counts padded to whole row blocks and column tiles,
    and each padded y and x row's norm over each slice."""
    rows, slices, ws = wide_d_slices("phi_wide_d", d)
    k_pad, m_pad = _ceil_to(k, rows), _ceil_to(m, _WD_COLS)
    normed = S * k_pad + x_lanes * m_pad  # the y and x rows
    return 4 * slices * ((normed + S * m_pad) * (ws + _WD_ROW_PAD) + normed)


def wide_d_bf16x3_scratch_bytes(S: int, k: int, m: int, d: int, x_lanes: int) -> int:
    """Bytes of the bf16x3 wide-d kernel's pre-pass scratch (``WxScratch`` in
    csrc/phi_wide_d_bf16x3.cu): the bf16 hi and lo planes of y, x and xs
    slice by slice in rows of ws bf16, row counts padded to whole row blocks
    and column tiles, and ‖y‖², ‖x‖² (float32) on the padded rows."""
    rows, slices, ws = wide_d_slices("phi_wide_d_bf16x3", d)
    k_pad, m_pad = _ceil_to(k, rows), _ceil_to(m, _WX_COLS)
    normed = S * k_pad + x_lanes * m_pad
    return 2 * 2 * slices * ws * (normed + S * m_pad) + 4 * normed


# name → (library, C symbol, output rows per block, interaction columns per
# tile, takes the row norms ‖y‖², ‖x‖², the m-split's blocks an SM (None:
# SPLIT_BLOCKS_PER_SM)); a library is csrc/<library>.cu.  A wide-d kernel's
# rows a block are its narrow geometry's (wide_d_slices gives them by d).
_KERNELS = {
    "phi_small_d": ("phi_small_d", "phi_small_d_launch", _SD_ROWS, 256, False,
                    _SD_BLOCKS_PER_SM),
    "phi_big_d": ("phi_big_d", "phi_big_d_launch", _BD_ROWS, _BD_COLS, False,
                  _BD_BLOCKS_PER_SM),
    "phi_small_d_bf16": ("phi_small_d", "phi_small_d_bf16_launch", _SD_ROWS, 256, False,
                         _SD_BLOCKS_PER_SM),
    "phi_big_d_bf16x3": ("phi_big_d_bf16x3", "phi_big_d_bf16x3_launch", _BX_ROWS,
                         _BX_COLS, True, _BX_BLOCKS_PER_SM),
    "phi_wide_d": ("phi_wide_d", "phi_wide_d_launch", _WD_ROWS, _WD_COLS, False,
                   _WD_BLOCKS_PER_SM),
    "phi_wide_d_bf16x3": ("phi_wide_d_bf16x3", "phi_wide_d_bf16x3_launch", _WX_ROWS,
                          _WX_COLS, False, _WX_BLOCKS_PER_SM),
    "phi_small_d_noexp": ("phi_small_d", "phi_small_d_noexp_launch", _SD_ROWS, 256, False,
                          _SD_BLOCKS_PER_SM),
}

#: Kernels with a pre-pass, by the size in bytes of the scratch buffer it
#: fills (a pointer after their inputs), ``f(S, k, m, d, x_lanes)``.  They
#: take the scores ``s`` where the others take ``xs = s − (2/h)·x``: their
#: pre-pass forms ``xs``, rounded as :func:`_drive_operand` rounds it.
_SCRATCH: Dict[str, Callable[..., int]] = {
    "phi_big_d": big_d_scratch_bytes,
    "phi_big_d_bf16x3": big_d_bf16x3_scratch_bytes,
    "phi_wide_d": wide_d_scratch_bytes,
    "phi_wide_d_bf16x3": wide_d_bf16x3_scratch_bytes,
}


def blocks_per_sm(name: str) -> int:
    """Kernel ``name``'s own m-split target of blocks per SM."""
    own = _KERNELS[name][5]
    return SPLIT_BLOCKS_PER_SM if own is None else own


def _split_of(name: str, S: int, k: int, m: int, device: torch.device,
              target: Optional[int] = None, d: Optional[int] = None) -> Tuple[int, int]:
    """``(nsplit, chunk)`` of kernel ``name``'s m axis at ``target`` blocks
    an SM (``None``: the kernel's own, :func:`blocks_per_sm`).  A wide-d
    kernel needs the feature dim ``d``: its rows a block and its blocks a
    cluster (every one counted) follow it."""
    rows, tile = _KERNELS[name][2:4]
    blocks = 1
    if name in _WIDE_GEOMETRY:
        if d is None:
            raise ValueError(f"{name}'s split needs the feature dim d")
        rows, blocks, _ = wide_d_slices(name, d)
    return _split_m(m, tile, S * -(-k // rows) * blocks, device,
                    blocks_per_sm(name) if target is None else target)


_FUNCS: Dict[str, Callable] = {}


def _kernel_fn(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        library, symbol, _, _, norms, _ = _KERNELS[name]
        fn = getattr(_build.library(library), symbol)
        pointers = (7 if norms else 5) + (name in _SCRATCH)
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def _launch(name: str, y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
            bandwidth: float, *, _blocks_per_sm: Optional[int] = None) -> torch.Tensor:
    """Launch one φ kernel on the current stream (no synchronise).
    ``_blocks_per_sm`` overrides the kernel's m-split target of blocks per
    SM (:data:`_KERNELS`, :func:`_split_m`) — the autotune tool's split
    sweep, the counterpart of ``phi_pallas``'s ``block_k``/``block_m``; no
    sampler path passes it."""
    _check_shapes(y, x, s)
    for t, label in ((y, "updated"), (x, "interacting"), (s, "scores")):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    S, k, d = y.shape
    m = x.shape[-2]
    if max(S * k * d, S * m * d) >= 2 ** 31:
        raise ValueError(f"{name}: shape {(S, k, m, d)} overflows the kernel's int indexing")
    inv_h = 1.0 / float(bandwidth)
    norms = _KERNELS[name][4]
    nsplit, chunk = _split_of(name, S, k, m, y.device, _blocks_per_sm, d)
    part = torch.empty((nsplit, S, k, d + 1), dtype=torch.float32, device=y.device)
    out = torch.empty((S, k, d), dtype=torch.float32, device=y.device)
    inputs = [y, x, s if name in _SCRATCH else _drive_operand(x, s, inv_h)]
    if norms:  # summed as the plain version sums them
        inputs += [torch.sum(y * y, dim=-1), torch.sum(x * x, dim=-1)]
    if name in _SCRATCH:
        inputs.append(torch.empty(_SCRATCH[name](S, k, m, d, S if x.dim() == 3 else 1),
                                  dtype=torch.uint8, device=y.device))
    err = _kernel_fn(name)(
        *(t.data_ptr() for t in inputs), part.data_ptr(), out.data_ptr(),
        S, k, m, d, m * d if x.dim() == 3 else 0, chunk, nsplit,
        inv_h, y.device.index if y.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launch_counts[name] += 1
    return out


def phi_small_d_cuda(y, x, s, bandwidth: float = 1.0) -> torch.Tensor:
    """The small-d kernel (``csrc/phi_small_d.cu``) on CUDA f32 tensors."""
    if y.shape[-1] > SMALL_D:
        raise ValueError(f"phi_small_d takes d <= {SMALL_D}, got {y.shape[-1]}")
    return _launch("phi_small_d", y, x, s, bandwidth)


def phi_big_d_cuda(y, x, s, bandwidth: float = 1.0) -> torch.Tensor:
    """The big-d kernel (``csrc/phi_big_d.cu``) on CUDA f32 tensors."""
    _check_d("phi_big_d", y, SMALL_D, BIG_D_MAX)
    return _launch("phi_big_d", y, x, s, bandwidth)


def phi_small_d_bf16_cuda(y, x, s, bandwidth: float = 1.0) -> torch.Tensor:
    """The small-d kernel's bf16 tier (``csrc/phi_small_d.cu``) on CUDA f32
    tensors."""
    if y.shape[-1] > SMALL_D:
        raise ValueError(f"phi_small_d_bf16 takes d <= {SMALL_D}, got {y.shape[-1]}")
    return _launch("phi_small_d_bf16", y, x, s, bandwidth)


def phi_small_d_noexp_cuda(y, x, s) -> torch.Tensor:
    """The no-exp probe (``csrc/phi_small_d.cu``, its third mode) on CUDA
    f32 tensors, at h = 1; its plain version on CPU tensors.  Launched only
    by the autotune tool."""
    if y.shape[-1] > SMALL_D:
        raise ValueError(f"phi_small_d_noexp takes d <= {SMALL_D}, got {y.shape[-1]}")
    if y.device.type == "cpu":
        return phi_small_d_noexp_plain(y, x, s)
    return _launch("phi_small_d_noexp", y, x, s, 1.0)


def phi_big_d_bf16x3_cuda(y, x, s, bandwidth: float = 1.0) -> torch.Tensor:
    """The big-d kernel's bf16x3 tier (``csrc/phi_big_d_bf16x3.cu``, tensor
    cores) on CUDA f32 tensors."""
    _check_d("phi_big_d_bf16x3", y, SMALL_D, BIG_D_MAX)
    return _launch("phi_big_d_bf16x3", y, x, s, bandwidth)


def phi_wide_d_cuda(y, x, s, bandwidth: float = 1.0) -> torch.Tensor:
    """The wide-d kernel (``csrc/phi_wide_d.cu``) on CUDA f32 tensors; its
    plain version is :func:`phi_big_d_plain`."""
    _check_d("phi_wide_d", y, BIG_D_MAX, WIDE_D_MAX)
    return _launch("phi_wide_d", y, x, s, bandwidth)


def phi_wide_d_bf16x3_cuda(y, x, s, bandwidth: float = 1.0) -> torch.Tensor:
    """The wide-d kernel's bf16x3 tier (``csrc/phi_wide_d_bf16x3.cu``, tensor
    cores) on CUDA f32 tensors; its plain version is
    :func:`phi_big_d_bf16x3_plain`."""
    _check_d("phi_wide_d_bf16x3", y, BIG_D_MAX, WIDE_D_MAX)
    return _launch("phi_wide_d_bf16x3", y, x, s, bandwidth)


def _check_d(name: str, y: torch.Tensor, lo: int, hi: int) -> None:
    if not lo < y.shape[-1] <= hi:
        raise ValueError(f"{name} takes {lo} < d <= {hi}, got {y.shape[-1]}")


# (small d, big d, wide d) → (kernel name, kernel wrapper, plain version), by tier
_TIERS = {
    "f32": (("phi_small_d", phi_small_d_cuda, phi_small_d_plain),
            ("phi_big_d", phi_big_d_cuda, phi_big_d_plain),
            ("phi_wide_d", phi_wide_d_cuda, phi_big_d_plain)),
    "bf16": (("phi_small_d_bf16", phi_small_d_bf16_cuda, phi_small_d_bf16_plain),
             ("phi_big_d_bf16x3", phi_big_d_bf16x3_cuda, phi_big_d_bf16x3_plain),
             ("phi_wide_d_bf16x3", phi_wide_d_bf16x3_cuda, phi_big_d_bf16x3_plain)),
}


# kernel name → its plain version, ``plain(y, x, s, bandwidth)``; the probe
# runs at h = 1 whatever bandwidth it is given
_PLAINS: Dict[str, Callable] = {
    name: plain for tier in _TIERS.values() for name, _, plain in tier}
_PLAINS["phi_small_d_noexp"] = lambda y, x, s, bandwidth=1.0: phi_small_d_noexp_plain(y, x, s)


def _band(d: int) -> int:
    """Index of the kernel that takes feature dim ``d``: small, big, wide."""
    return 0 if d <= SMALL_D else 1 if d <= BIG_D_MAX else 2


def kernel_for(d: int, tier: str = "f32") -> str:
    """Name of the φ kernel that takes feature dim ``d`` in ``tier``."""
    return _TIERS[tier][_band(d)][0]


def plain_of(name: str) -> Callable:
    """Kernel ``name``'s plain version, ``plain(y, x, s, bandwidth)``."""
    return _PLAINS[name]


def launch(name: str, y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
           bandwidth: float = 1.0, blocks_per_sm: Optional[int] = None) -> torch.Tensor:
    """Kernel ``name`` (a key of :data:`launch_counts`) on CUDA f32 tensors
    at an m-split target of ``blocks_per_sm`` blocks per SM (``None``: the
    kernel's own, :data:`_KERNELS`), its plain version on CPU tensors.  The
    autotune tool's entry to every φ kernel; no sampler path calls it."""
    if y.device.type == "cpu":
        return plain_of(name)(y, x, s, bandwidth)
    return _launch(name, y, x, s, 1.0 if name == "phi_small_d_noexp" else bandwidth,
                   _blocks_per_sm=blocks_per_sm)


def split_count(name: str, S: int, k: int, m: int, device: torch.device,
                blocks_per_sm: Optional[int] = None, d: Optional[int] = None) -> int:
    """The number of m-splits :func:`launch` takes for kernel ``name`` on
    ``S`` lanes of ``k`` rows against ``m`` columns on a card (a wide-d
    kernel's at feature dim ``d``)."""
    return _split_of(name, S, k, m, device, blocks_per_sm, d)[0]


def load_kernel(d: int, phi_impl: str = "auto") -> None:
    """Build (at first use) and load the hand kernel that the ``phi_impl``
    backend of :func:`resolve_phi_fn` launches for feature dim ``d`` on
    CUDA tensors, without launching it, so that a timed run can leave the
    build out.  Nothing for ``'torch'`` and ``'torch_bf16'``, which launch
    none, nor for d above :data:`WIDE_D_MAX`, where ``'auto'`` takes the
    plain φ."""
    if phi_impl not in PHI_IMPLS:
        raise ValueError(f"unknown phi_impl {phi_impl!r}; the port has {PHI_IMPLS}")
    if phi_impl in ("auto", "cuda", "cuda_bf16") and d <= WIDE_D_MAX:
        _kernel_fn(_TIERS["bf16" if phi_impl == "cuda_bf16" else "f32"][_band(d)][0])


def phi_cuda(updated: torch.Tensor, interacting: torch.Tensor,
             scores: torch.Tensor, bandwidth: float = 1.0,
             tier: str = "f32", plain: bool = False) -> torch.Tensor:
    """Fused-kernel φ̂* — drop-in for ``ops.svgd.phi(..., RBF(bandwidth))``
    on batched lanes (module docstring).  CUDA tensors launch the hand
    kernel for their d and ``tier`` (``'f32'``, exact, or ``'bf16'``); CPU
    tensors take that kernel's plain version, as any tensor does with
    ``plain=True`` (the reference a kernel is held against on the card).
    Raises ``ValueError`` for d > :data:`WIDE_D_MAX`."""
    if tier not in _TIERS:
        raise ValueError(f"unknown tier {tier!r}; have {tuple(_TIERS)}")
    _check_shapes(updated, interacting, scores)
    d = updated.shape[-1]
    if d > WIDE_D_MAX:
        raise ValueError(
            f"phi_cuda: d={d} is above the wide-d kernels' cap of {WIDE_D_MAX}; "
            "use phi_impl='auto' or 'torch' for this shape"
        )
    _, kern, plain_fn = _TIERS[tier][_band(d)]
    if plain or updated.device.type == "cpu":
        kern = plain_fn
    y, x, s = (t.to(torch.float32).contiguous() for t in (updated, interacting, scores))
    return kern(y, x, s, bandwidth).to(updated.dtype)


PHI_IMPLS = ("auto", "torch", "cuda", "cuda_bf16", "torch_bf16")

#: ``'auto'`` with d ≤ :data:`SMALL_D` launches the kernel at or above this
#: many pairs S·k·m, and takes the plain ``ops.svgd.phi`` below it (JAX's
#: ``PALLAS_MIN_PAIRS``).  Measured on an NVIDIA H100 80GB HBM3 at a 700 W
#: power limit by ``python -m dist_svgd_torch.tools.cuda_autotune --harvest``
#: (S = 1, n² pairs for n = 1, 2, 4, …, 4096, d = 3): the kernel is faster
#: than the torch φ at every rung — 0.0602 against 0.1938 ms at one pair,
#: 0.1038 against 0.5889 ms at 4096² (both dispatch-bound below ~2048²) —
#: so there is no line: 0.
CUDA_MIN_PAIRS = 0

#: ``'auto'``'s line for d > :data:`SMALL_D` (JAX's
#: ``PALLAS_MIN_PAIRS_BIG_D``): the larger of the lines at d = 55 and
#: d = 753, measured as :data:`CUDA_MIN_PAIRS`.  At d = 55 the kernel is
#: faster at every rung (0.0601 against 0.1763 ms at one pair, 0.3245
#: against 0.6124 at 4096²).  At d = 753 it is faster from one pair (0.0912
#: against 0.1643 ms) to 512² (0.1661 against 0.3468) and slower from 1024²
#: (0.5875 against 0.2412 ms; 7.332 against 2.072 at 4096²): no lower line,
#: and no upper one, as JAX has none — the wide-d kernel's loss at large
#: shapes is kernel work (ROADMAP, rule 2), not routing.
CUDA_MIN_PAIRS_BIG_D = 0

#: ``'torch'``, and ``'auto'`` where it takes the plain φ, switch from the
#: one-shot ``phi`` (the whole ``(S, m, k)`` Gram in memory) to
#: ``phi_blockwise`` at or above this many pairs S·k·m: 2³¹ pairs is an
#: 8.6 GB f32 Gram.  A memory rule, not a timing, so JAX's
#: ``XLA_BLOCKWISE_MIN_PAIRS`` carries over as it is.
TORCH_BLOCKWISE_MIN_PAIRS = 1 << 31


def _pairs(y: torch.Tensor, x: torch.Tensor) -> int:
    """The call's pair count S·k·m: JAX's ``k·m·batch_hint``, with the
    lanes read from the batched shapes."""
    return y.numel() // y.shape[-1] * x.shape[-2]


def _plain_phi_fn(kernel) -> Callable:
    """The plain φ of ``'torch'``: ``phi``, or ``phi_blockwise`` at or
    above :data:`TORCH_BLOCKWISE_MIN_PAIRS` (an RBF or any kernel
    callable)."""

    def torch_fn(y, x, s):
        if _pairs(y, x) >= TORCH_BLOCKWISE_MIN_PAIRS:
            return phi_blockwise(y, x, s, kernel)
        return phi(y, x, s, kernel)

    return torch_fn


#: JAX's φ-backend names → the port's.
_JAX_NAMES = {"xla": "torch", "pallas": "cuda", "pallas_bf16": "cuda_bf16"}


def resolve_phi_fn(kernel, phi_impl: str) -> Callable:
    """The φ-backend policy: returns ``phi_fn(updated, interacting,
    scores)`` on batched lanes.

    - ``'auto'``  — :func:`phi_cuda` at or above a pair-count line:
      the hand kernel for the tensors' d on CUDA tensors, that kernel's
      plain version on CPU tensors.  The line is :data:`CUDA_MIN_PAIRS`
      for d ≤ :data:`SMALL_D` and :data:`CUDA_MIN_PAIRS_BIG_D` above,
      compared with the call's S·k·m, as JAX's ``PALLAS_MIN_PAIRS*`` with
      ``k·m·batch_hint``; their values were measured on the H100 by
      ``python -m dist_svgd_torch.tools.cuda_autotune --harvest``, and
      both are 0 there: the kernels win from one pair.  Below the line,
      and beyond :data:`WIDE_D_MAX` (as JAX's ``'auto'`` beyond
      ``fits_vmem_big_d``), it takes the plain φ of ``'torch'``.
    - ``'torch'`` — the plain ``ops.svgd.phi`` (the JAX ``'xla'`` program's
      arithmetic) on any device; ``ops.svgd.phi_blockwise`` at or above
      :data:`TORCH_BLOCKWISE_MIN_PAIRS`.
    - ``'cuda'``  — force the hand kernel; raises on CPU tensors and beyond
      :data:`WIDE_D_MAX`.
    - ``'cuda_bf16'`` — the bf16 tiers (JAX's ``'pallas_bf16'``): the bf16
      kernel for the tensors' d on CUDA tensors, its plain version on CPU
      tensors.  Never chosen by ``'auto'``; meant for runs whose score is
      already stochastic (minibatches).
    - ``'torch_bf16'`` — the bf16 tiers' plain versions on any device.

    ``kernel`` is an :class:`~dist_svgd_torch.ops.kernels.RBF`, an
    :class:`~dist_svgd_torch.ops.kernels.AdaptiveRBF` or any scalar kernel
    callable ``kernel(a, b)`` in torch.  Any other kernel than the RBF has
    no hand kernel: ``'auto'`` and ``'torch'`` take the plain φ's generic
    form (:func:`~dist_svgd_torch.ops.svgd.phi`), as JAX's ``'auto'`` takes
    its ``'xla'`` φ, and the kernel tiers raise ``ValueError``, as JAX's
    ``'pallas'`` does.  For an :class:`AdaptiveRBF` the
    returned function estimates the median bandwidth h from the interaction
    set on every call (:func:`~dist_svgd_torch.ops.kernels.
    median_bandwidth_approx`; a lane with its own ``(S, m, d)`` set takes its
    own h) and runs the bandwidth-1 backend through the rescaling identity
    ``φ_h(y; x, s) = φ₁(y/√h; x/√h, √h·s)/√h``.

    JAX's names ``'xla'``, ``'pallas'`` and ``'pallas_bf16'`` raise
    ``ValueError`` naming the port's.
    """
    if phi_impl in _JAX_NAMES:
        raise ValueError(
            f"unknown phi_impl {phi_impl!r}: that is the JAX package's name; "
            f"the port's is {_JAX_NAMES[phi_impl]!r}")
    if phi_impl not in PHI_IMPLS:
        raise ValueError(f"unknown phi_impl {phi_impl!r}; the port has {PHI_IMPLS}")
    if isinstance(kernel, AdaptiveRBF):
        base = resolve_phi_fn(RBF(1.0), phi_impl)
        max_points = kernel.max_points

        def adaptive_fn(y, x, s):
            h = median_bandwidth_approx(x, max_points)  # () or (S,)
            sh = torch.sqrt(h.to(y.dtype))[..., None, None]
            sx = sh if x.dim() == 3 else sh[..., 0, 0]
            return base(y / sh, x / sx, s * sh) / sh

        return adaptive_fn
    if not isinstance(kernel, RBF):
        if phi_impl in ("auto", "torch"):
            return _plain_phi_fn(kernel)
        raise ValueError(
            f"phi_impl={phi_impl!r} requires an RBF kernel, got {kernel!r}: the hand "
            "kernels compute the RBF's φ; use phi_impl='auto' or 'torch'")
    bw = kernel.bandwidth
    if phi_impl == "torch":
        return _plain_phi_fn(kernel)
    if phi_impl == "auto":
        plain_fn = _plain_phi_fn(kernel)

        def auto_fn(y, x, s):
            d = y.shape[-1]
            gate = CUDA_MIN_PAIRS if d <= SMALL_D else CUDA_MIN_PAIRS_BIG_D
            if d <= WIDE_D_MAX and _pairs(y, x) >= gate:
                return phi_cuda(y, x, s, bw)
            return plain_fn(y, x, s)

        return auto_fn
    if phi_impl == "cuda_bf16":
        return lambda y, x, s: phi_cuda(y, x, s, bw, tier="bf16")
    if phi_impl == "torch_bf16":
        return lambda y, x, s: phi_cuda(y, x, s, bw, tier="bf16", plain=True)

    def cuda_fn(y, x, s):
        if y.device.type != "cuda":
            raise ValueError(
                f"phi_impl='cuda' launches the hand kernel and needs CUDA "
                f"tensors, got {y.device}; use 'auto' or 'torch' on the CPU"
            )
        return phi_cuda(y, x, s, bw)

    return cuda_fn
