"""The fused SVGD φ on the card: hand-written CUDA kernels, their plain
PyTorch versions, and the φ-backend policy.

Counterpart of ``dist_svgd_tpu/ops/pallas_svgd.py``.  The math is the TPU
kernels' (reference Algorithm 1 with the closed-form repulsive term):

    K_ij   = exp(−‖y_i − x_j‖² / h)
    φ(y_i) = (1/m) [ Σ_j K_ij·(s_j − (2/h)·x_j)  +  (2/h)·y_i·Σ_j K_ij ]

Two kernels, chosen on the feature dim d:

- ``csrc/phi_small_d.cu`` (d ≤ :data:`SMALL_D`), replacing
  ``_phi_kernel_small_d``: distances as direct per-dim differences;
- ``csrc/phi_big_d.cu`` (:data:`SMALL_D` < d ≤ :data:`BIG_D_MAX`),
  replacing ``_phi_kernel`` in its exact f32 tier: distances as
  ``y² + x² − 2·y·xᵀ`` clamped at 0.

Each has a plain PyTorch version here with the same distance form and the
same ``xs = s − (2/h)·x`` drive operand, so that holding a kernel against
its plain version on the card measures the kernel, not the form.

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
from typing import Callable, Dict, Tuple

import torch

from dist_svgd_torch.ops import _build
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.ops.svgd import phi

#: Feature dims up to this use the direct-difference kernel.
SMALL_D = 8

#: Largest feature dim the big-d kernel takes (its register tiles hold
#: ⌈d/4⌉ ≤ 32 drive accumulators a thread); larger d raises ``ValueError``.
BIG_D_MAX = 128

#: Launches of each kernel since the last :func:`reset_launch_counts` — one
#: per wrapper call that launched it (a call is a partial-sum kernel plus
#: the finalize kernel of the same source), so a run can show that its φ
#: went through the hand kernels.
launch_counts: Dict[str, int] = {"phi_small_d": 0, "phi_big_d": 0}


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


def phi_small_d_plain(y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                      bandwidth: float = 1.0) -> torch.Tensor:
    """Plain version of the small-d kernel: distances as direct per-dim
    differences ``Σ_c (y_c − x_c)²`` (exact, no clamp), in the dtype given."""
    _check_shapes(y, x, s)
    inv_h = 1.0 / float(bandwidth)
    xs = _drive_operand(x, s, inv_h)
    d2 = None
    for c in range(y.shape[-1]):
        diff = y[..., :, c, None] - x[..., None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    K = torch.exp(-d2 * inv_h)  # (S, k, m)
    return _epilogue(y, torch.matmul(K, xs), K.sum(-1, keepdim=True), inv_h,
                     x.shape[-2])


def phi_big_d_plain(y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                    bandwidth: float = 1.0) -> torch.Tensor:
    """Plain version of the big-d kernel: distances as ``y² + x² − 2·y·xᵀ``
    clamped at 0, in the dtype given (TF32 must be off on the card:
    :func:`dist_svgd_torch.utils.platform.resolve_device` pins it)."""
    _check_shapes(y, x, s)
    inv_h = 1.0 / float(bandwidth)
    xs = _drive_operand(x, s, inv_h)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)  # (S, k, 1)
    x2 = torch.sum(x * x, dim=-1)[..., None, :]  # (1, m) or (S, 1, m)
    yx = torch.matmul(y, x.transpose(-1, -2))  # (S, k, m)
    K = torch.exp(-torch.clamp(y2 + x2 - 2.0 * yx, min=0.0) * inv_h)
    return _epilogue(y, torch.matmul(K, xs), K.sum(-1, keepdim=True), inv_h,
                     x.shape[-2])


_SM_COUNTS: Dict[int, int] = {}


def _split_m(m: int, tile: int, row_blocks: int, device: torch.device) -> Tuple[int, int]:
    """``(nsplit, chunk)``: split the m axis into ``nsplit`` chunks of
    ``chunk`` columns (a multiple of ``tile``) so that the grid holds about
    eight blocks per SM — the output alone (``row_blocks`` blocks) is too
    few rows to fill the card at the north-star shapes."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNTS[index] = sms
    tiles = -(-m // tile)
    want = max(1, min(tiles, -(-8 * sms // max(row_blocks, 1))))
    per = -(-tiles // want)
    return -(-tiles // per), per * tile


# name → (C symbol, output rows per block, interaction columns per tile)
_KERNELS = {
    "phi_small_d": ("phi_small_d_launch", 128, 256),
    "phi_big_d": ("phi_big_d_launch", 64, 64),
}
_FUNCS: Dict[str, Callable] = {}


def _kernel_fn(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        symbol = _KERNELS[name][0]
        fn = getattr(_build.library(name), symbol)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def _launch(name: str, y: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
            bandwidth: float) -> torch.Tensor:
    """Launch one φ kernel on the current stream (no synchronise)."""
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
    xs = _drive_operand(x, s, inv_h)
    _, rows, tile = _KERNELS[name]
    nsplit, chunk = _split_m(m, tile, S * -(-k // rows), y.device)
    part = torch.empty((nsplit, S, k, d + 1), dtype=torch.float32, device=y.device)
    out = torch.empty((S, k, d), dtype=torch.float32, device=y.device)
    err = _kernel_fn(name)(
        y.data_ptr(), x.data_ptr(), xs.data_ptr(), part.data_ptr(), out.data_ptr(),
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
    if not SMALL_D < y.shape[-1] <= BIG_D_MAX:
        raise ValueError(
            f"phi_big_d takes {SMALL_D} < d <= {BIG_D_MAX}, got {y.shape[-1]}")
    return _launch("phi_big_d", y, x, s, bandwidth)


def phi_cuda(updated: torch.Tensor, interacting: torch.Tensor,
             scores: torch.Tensor, bandwidth: float = 1.0) -> torch.Tensor:
    """Fused-kernel φ̂* — drop-in for ``ops.svgd.phi(..., RBF(bandwidth))``
    on batched lanes (module docstring).  CUDA tensors launch the hand
    kernel for their d; CPU tensors take that kernel's plain version.
    Raises ``ValueError`` for d > :data:`BIG_D_MAX` (ROADMAP: φ beyond
    d = 128)."""
    _check_shapes(updated, interacting, scores)
    d = updated.shape[-1]
    if d > BIG_D_MAX:
        raise ValueError(
            f"phi_cuda: d={d} is above the big-d kernel's cap of {BIG_D_MAX}; "
            "use phi_impl='torch' for this shape"
        )
    small = d <= SMALL_D
    in_dtype = updated.dtype
    y, x, s = (t.to(torch.float32).contiguous() for t in (updated, interacting, scores))
    if y.device.type == "cpu":
        plain = phi_small_d_plain if small else phi_big_d_plain
        out = plain(y, x, s, bandwidth)
    else:
        kern = phi_small_d_cuda if small else phi_big_d_cuda
        out = kern(y, x, s, bandwidth)
    return out.to(in_dtype)


PHI_IMPLS = ("auto", "torch", "cuda")


def resolve_phi_fn(kernel, phi_impl: str) -> Callable:
    """The φ-backend policy: returns ``phi_fn(updated, interacting,
    scores)`` on batched lanes.

    - ``'auto'``  — :func:`phi_cuda`: the hand kernel for the tensors' d on
      CUDA tensors, that kernel's plain version on CPU tensors.  The TPU's
      pair-count thresholds (``PALLAS_MIN_PAIRS*``) do not carry over;
      re-deriving them for the H100 is ROADMAP work.
    - ``'torch'`` — the plain ``ops.svgd.phi`` (the JAX ``'xla'`` program's
      arithmetic) on any device.
    - ``'cuda'``  — force the hand kernel; raises on CPU tensors.
    """
    if phi_impl == "pallas_bf16":
        raise NotImplementedError(
            "phi_impl='pallas_bf16' (the bf16 tiers of both φ kernels) is not "
            "ported yet: ROADMAP B1/B2 bf16 tiers"
        )
    if phi_impl not in PHI_IMPLS:
        raise ValueError(f"unknown phi_impl {phi_impl!r}; the port has {PHI_IMPLS}")
    if not isinstance(kernel, RBF):
        raise NotImplementedError(
            f"kernel {kernel!r} is not ported: the port's φ takes an RBF "
            "(kernel='median_step' / AdaptiveRBF is ROADMAP A2)"
        )
    bw = kernel.bandwidth
    if phi_impl == "torch":
        return lambda y, x, s: phi(y, x, s, kernel)
    if phi_impl == "auto":
        return lambda y, x, s: phi_cuda(y, x, s, bw)

    def cuda_fn(y, x, s):
        if y.device.type != "cuda":
            raise ValueError(
                f"phi_impl='cuda' launches the hand kernel and needs CUDA "
                f"tensors, got {y.device}; use 'auto' or 'torch' on the CPU"
            )
        return phi_cuda(y, x, s, bw)

    return cuda_fn
