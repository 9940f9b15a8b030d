"""The Sinkhorn W2 solve on the card: four hand-written CUDA kernels, their
plain PyTorch versions, and the fused and streaming solves built on them.

Counterpart of ``dist_svgd_tpu/ops/pallas_ot.py``.  At d ≤ SMALL_D a cost
entry ``C_ij = ‖y_i − x_j‖²`` is a handful of operations from O(n·d) data,
so the passes of the solve rebuild cost tiles on chip instead of reading a
``(k, m)`` matrix:

- :func:`ctransform_reduce` (``csrc/ot_ctransform.cu``) — row-wise hard
  ``min_j (C_ij − p_j)`` or soft ``logsumexp_j ((p_j − C_ij)·inv_reg)``;
- :func:`kexp` (``csrc/ot_kexp.cu``) — the absorbed kernel
  ``exp((f_i + g_j − C_ij)·inv_reg)`` written out as a ``(k, m)`` matrix;
- :func:`kmat_vec` (``csrc/ot_kmat_vec.cu``) — ``P @ R`` with P rebuilt per
  tile, R ``(m,)`` or ``(m, r ≤ 8)``; ``Pᵀu`` is the same call with the
  roles and potentials swapped;
- :func:`plan_grad` (``csrc/ot_plan_grad.cu``) — ``grad_i = y_i·Σ_j P_ij −
  Σ_j P_ij·x_j`` with P rebuilt per tile.

Every kernel works on lanes: rows ``(S, k, d)``, columns ``(S, m, d)`` and
per-lane potentials, the S emulated shards in one launch.  Distances are
per-dim differences.  Two kernels still match their plain version bitwise:
``ot_kexp`` and the hard c-transform sum the differences without FMA
contraction and clamp at :data:`_D2_CAP`, as their plain versions do.
``ot_kmat_vec``, ``ot_plan_grad`` and the soft c-transform, the 1e10-pair
passes of the 100k streaming route, build the exponent in base 2 with FMAs
and take one ``ex2.approx`` a pair (``csrc/ot_common.cuh``), each thread
keeping several rows; the soft c-transform's running logsumexp keeps a
lazily moved reference per row (``csrc/ot_ctransform.cu``).
``chip_smoke.py`` holds these three against float64 at that route's
shapes.  Compute is float32 (inputs are cast, as the Pallas wrappers
cast).

Device rule: a wrapper uses its kernel's plain version only because the
tensors it was given lie on the CPU; on CUDA tensors it launches the kernel
or raises.  Nothing catches a failed build or launch.  The plain versions
work through the rows in chunks so that a 12,500 × 100,000 lane fits.

:func:`sinkhorn_grad_fused` and :func:`sinkhorn_grad_streaming` are the
card's two Sinkhorn routes (``ops/ot.py:_resolve_sinkhorn_route``), both over
the ONE scaling loop of ``ops/ot.py``, in reg-rescaled units (every kernel
runs at ``inv_reg = 1``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from dist_svgd_torch.ops import _build
from dist_svgd_torch.ops.cuda_svgd import SMALL_D, _split_m
from dist_svgd_torch.ops.ot import _lanes, _log_const, _sinkhorn_scaling_loop

#: Cap on a squared distance (``dist_svgd_tpu/ops/pallas_svgd.py:_D2_CAP``).
_D2_CAP = 1e30

#: Pair entries a plain version materialises at once (256 MB in float32).
_PLAIN_CHUNK = 1 << 26

#: Launches of each kernel since the last :func:`reset_launch_counts` — one
#: per wrapper call that launched it (a call may be a partial-sum kernel
#: plus the finalize kernel of the same source).
launch_counts: Dict[str, int] = {
    "ot_ctransform": 0, "ot_kexp": 0, "ot_kmat_vec": 0, "ot_plan_grad": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# --------------------------------------------------------------------------
# Shapes and the plain versions


def _check(name: str, rows: torch.Tensor, cols: torch.Tensor, row_vecs=(),
           col_vecs=()) -> None:
    """rows ``(S, k, d ≤ SMALL_D)``, cols ``(S, m, d)``, per-lane row vectors
    ``(S, k)`` and column vectors ``(S, m, ...)``, all on one device."""
    if rows.dim() != 3 or cols.dim() != 3:
        raise ValueError(f"{name}: rows and cols must be (S, ·, d), got "
                         f"{tuple(rows.shape)} and {tuple(cols.shape)}")
    S, k, d = rows.shape
    if cols.shape[0] != S or cols.shape[2] != d:
        raise ValueError(f"{name}: cols must be ({S}, m, {d}), got {tuple(cols.shape)}")
    if d > SMALL_D:
        raise ValueError(f"{name} takes d <= {SMALL_D}, got {d}")
    m = cols.shape[1]
    for t in row_vecs:
        if tuple(t.shape) != (S, k):
            raise ValueError(f"{name}: row potential must be ({S}, {k}), got {tuple(t.shape)}")
    for t in col_vecs:
        if tuple(t.shape[:2]) != (S, m):
            raise ValueError(f"{name}: column operand must be ({S}, {m}, ...), got "
                             f"{tuple(t.shape)}")
    if any(t.device != rows.device for t in (cols, *row_vecs, *col_vecs)):
        raise ValueError(f"{name}: all operands must share one device")


def _d2(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``(S, k, m)`` squared distances as per-dim differences
    ``Σ_c (y_c − x_c)²`` summed in order, clamped at :data:`_D2_CAP`."""
    d2 = None
    for c in range(rows.shape[-1]):
        diff = rows[..., :, None, c] - cols[..., None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return torch.clamp(d2, max=_D2_CAP)


def _row_step(rows: torch.Tensor, cols: torch.Tensor) -> int:
    return max(1, _PLAIN_CHUNK // max(1, rows.shape[0] * cols.shape[1]))


def _absorbed(rows, cols, f, g, inv_reg: float) -> torch.Tensor:
    """``exp((f_i + g_j − C_ij)·inv_reg)``."""
    return torch.exp((f[..., :, None] + g[..., None, :] - _d2(rows, cols)) * inv_reg)


def ctransform_reduce_plain(rows, cols, col_pot, soft: bool, inv_reg: float = 1.0):
    """Plain version of ``ot_ctransform``: ``(S, k)`` of ``logsumexp_j ((p_j −
    C_ij)·inv_reg)`` (soft) or ``min_j (C_ij − p_j)`` (hard)."""
    _check("ctransform_reduce", rows, cols, col_vecs=(col_pot,))
    step = _row_step(rows, cols)
    out = []
    for i0 in range(0, rows.shape[1], step):
        d2 = _d2(rows[:, i0:i0 + step], cols)
        if soft:
            e = (col_pot[:, None, :] - d2) * inv_reg
            mx = e.amax(dim=-1, keepdim=True)
            out.append((mx + torch.log(torch.exp(e - mx).sum(dim=-1, keepdim=True)))[..., 0])
        else:
            out.append((d2 - col_pot[:, None, :]).amin(dim=-1))
    return torch.cat(out, dim=1)


def kexp_plain(rows, cols, f, g, inv_reg: float = 1.0):
    """Plain version of ``ot_kexp``: the ``(S, k, m)`` absorbed kernel."""
    _check("kexp", rows, cols, row_vecs=(f,), col_vecs=(g,))
    return _absorbed(rows, cols, f, g, inv_reg)


def kmat_vec_plain(rows, cols, f, g, rhs, inv_reg: float = 1.0):
    """Plain version of ``ot_kmat_vec``: ``P @ rhs`` per lane, rhs ``(S, m)``
    → ``(S, k)`` or ``(S, m, r)`` → ``(S, k, r)``."""
    _check("kmat_vec", rows, cols, row_vecs=(f,), col_vecs=(g, rhs))
    vec = rhs.dim() == 2
    R = rhs[..., None] if vec else rhs
    step = _row_step(rows, cols)
    out = torch.cat([
        torch.matmul(_absorbed(rows[:, i0:i0 + step], cols, f[:, i0:i0 + step], g, inv_reg), R)
        for i0 in range(0, rows.shape[1], step)], dim=1)
    return out[..., 0] if vec else out


def plan_grad_plain(rows, cols, f, g, inv_reg: float = 1.0):
    """Plain version of ``ot_plan_grad``: ``rows·Σ_j P_ij − P @ cols``,
    ``(S, k, d)``."""
    _check("plan_grad", rows, cols, row_vecs=(f,), col_vecs=(g,))
    step = _row_step(rows, cols)
    out = []
    for i0 in range(0, rows.shape[1], step):
        y = rows[:, i0:i0 + step]
        P = _absorbed(y, cols, f[:, i0:i0 + step], g, inv_reg)
        out.append(y * P.sum(dim=-1, keepdim=True) - torch.matmul(P, cols))
    return torch.cat(out, dim=1)


# --------------------------------------------------------------------------
# The kernels

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library → argument types of its ``<name>_launch`` (pointers, ints, inv_reg,
# device, stream)
_ARGTYPES = {
    "ot_ctransform": [_P] * 5 + [_I] * 7 + [_F, _I, _P],
    "ot_kexp": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    "ot_kmat_vec": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    "ot_plan_grad": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
}
_FUNCS: Dict[str, Callable] = {}

#: Threads per block and columns per shared-memory tile of the three
#: row-reduction kernels (``OT_THREADS`` / ``OT_TILE`` in ot_common.cuh);
#: a thread of each keeps several output rows (``OT_KMV_ROWS_PER_THREAD``,
#: ``OT_PG_ROWS_PER_THREAD``, ``OT_CT_ROWS_PER_THREAD``).
_ROWS, _TILE = 128, 256
_KMV_ROWS_PER_THREAD, _PG_ROWS_PER_THREAD, _CT_ROWS_PER_THREAD = 8, 4, 4
#: The m-split's blocks an SM (:func:`_split_m`) for ``ot_kmat_vec`` and
#: ``ot_plan_grad`` (``OT_STREAMING_BLOCKS_PER_SM``) and for
#: ``ot_ctransform`` (``OT_CT_BLOCKS_PER_SM``): at 32, against the φ's 8,
#: the last wave of blocks is a smaller share of a 1e10-pair call.
_STREAMING_BLOCKS_PER_SM = 32
_CT_BLOCKS_PER_SM = 32


def _kernel_fn(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(_build.library(name), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def _require(name: str, *tensors) -> None:
    """A kernel takes contiguous float32 CUDA tensors; anything else raises."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: operands must be CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: operands must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _launch(name: str, tensors, *args) -> None:
    """Launch ``name`` on the current stream (no synchronise), raise on a
    launch error, count the launch."""
    dev = tensors[0].device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = _kernel_fn(name)(*[t.data_ptr() for t in tensors], *args, index,
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launch_counts[name] += 1


def _split(S: int, k: int, m: int, device: torch.device, rows_per_block: int,
           blocks_per_sm):
    """``(nsplit, chunk)`` of the m axis for lanes of ``k`` rows in blocks of
    ``rows_per_block`` at ``blocks_per_sm`` blocks an SM (:func:`_split_m`;
    ``None``: the φ's default)."""
    return _split_m(m, _TILE, S * -(-k // rows_per_block), device, blocks_per_sm)


def ctransform_reduce_cuda(rows, cols, col_pot, soft: bool, inv_reg: float = 1.0):
    """``csrc/ot_ctransform.cu`` on CUDA float32 tensors."""
    _check("ctransform_reduce", rows, cols, col_vecs=(col_pot,))
    _require("ot_ctransform", rows, cols, col_pot)
    S, k, d = rows.shape
    nsplit, chunk = _split(S, k, cols.shape[1], rows.device, _ROWS * _CT_ROWS_PER_THREAD,
                           _CT_BLOCKS_PER_SM)
    part = torch.empty((nsplit, S, k, 2), dtype=torch.float32, device=rows.device)
    out = torch.empty((S, k), dtype=torch.float32, device=rows.device)
    _launch("ot_ctransform", (rows, cols, col_pot, part, out),
            S, k, cols.shape[1], d, chunk, nsplit, int(bool(soft)), float(inv_reg))
    return out


def kexp_cuda(rows, cols, f, g, inv_reg: float = 1.0):
    """``csrc/ot_kexp.cu`` on CUDA float32 tensors."""
    _check("kexp", rows, cols, row_vecs=(f,), col_vecs=(g,))
    _require("ot_kexp", rows, cols, f, g)
    S, k, d = rows.shape
    m = cols.shape[1]
    if k >= 65535 * 16:
        raise ValueError(f"kexp: k={k} rows exceed the kernel's grid")
    out = torch.empty((S, k, m), dtype=torch.float32, device=rows.device)
    _launch("ot_kexp", (rows, cols, f, g, out), S, k, m, d, float(inv_reg))
    return out


def kmat_vec_cuda(rows, cols, f, g, rhs, inv_reg: float = 1.0):
    """``csrc/ot_kmat_vec.cu`` on CUDA float32 tensors."""
    _check("kmat_vec", rows, cols, row_vecs=(f,), col_vecs=(g, rhs))
    _require("ot_kmat_vec", rows, cols, f, g, rhs)
    S, k, d = rows.shape
    vec = rhs.dim() == 2
    r = 1 if vec else rhs.shape[-1]
    if not 1 <= r <= SMALL_D:
        raise ValueError(f"kmat_vec takes 1 <= r <= {SMALL_D} right-hand sides, got {r}")
    nsplit, chunk = _split(S, k, cols.shape[1], rows.device, _ROWS * _KMV_ROWS_PER_THREAD,
                           _STREAMING_BLOCKS_PER_SM)
    part = torch.empty((nsplit, S, k, r), dtype=torch.float32, device=rows.device)
    out = torch.empty((S, k, r), dtype=torch.float32, device=rows.device)
    _launch("ot_kmat_vec", (rows, cols, f, g, rhs, part, out),
            S, k, cols.shape[1], d, r, chunk, nsplit, float(inv_reg))
    return out[..., 0] if vec else out


def plan_grad_cuda(rows, cols, f, g, inv_reg: float = 1.0):
    """``csrc/ot_plan_grad.cu`` on CUDA float32 tensors."""
    _check("plan_grad", rows, cols, row_vecs=(f,), col_vecs=(g,))
    _require("ot_plan_grad", rows, cols, f, g)
    S, k, d = rows.shape
    nsplit, chunk = _split(S, k, cols.shape[1], rows.device, _ROWS * _PG_ROWS_PER_THREAD,
                           _STREAMING_BLOCKS_PER_SM)
    part = torch.empty((nsplit, S, k, d), dtype=torch.float32, device=rows.device)
    out = torch.empty((S, k, d), dtype=torch.float32, device=rows.device)
    _launch("ot_plan_grad", (rows, cols, f, g, part, out),
            S, k, cols.shape[1], d, chunk, nsplit, float(inv_reg))
    return out


def _f32(*ts):
    return [t.to(torch.float32).contiguous() for t in ts]


def _pick(plain, kern, rows):
    return plain if rows.device.type == "cpu" else kern


def ctransform_reduce(rows, cols, col_pot, soft: bool, inv_reg: float = 1.0):
    """Row-wise c-transform without materialising C (module docstring):
    ``(S, k)`` float32.  CPU tensors take the plain version."""
    rows, cols, col_pot = _f32(rows, cols, col_pot)
    fn = _pick(ctransform_reduce_plain, ctransform_reduce_cuda, rows)
    return fn(rows, cols, col_pot, soft, inv_reg)


def kexp(rows, cols, f, g, inv_reg: float = 1.0):
    """The ``(S, k, m)`` absorbed kernel, C recomputed per tile."""
    rows, cols, f, g = _f32(rows, cols, f, g)
    return _pick(kexp_plain, kexp_cuda, rows)(rows, cols, f, g, inv_reg)


def kmat_vec(rows, cols, f, g, rhs, inv_reg: float = 1.0):
    """``P @ rhs`` with P rebuilt per tile, O(n·d) memory; ``Pᵀu`` is
    ``kmat_vec(cols, rows, g, f, u)``."""
    rows, cols, f, g, rhs = _f32(rows, cols, f, g, rhs)
    return _pick(kmat_vec_plain, kmat_vec_cuda, rows)(rows, cols, f, g, rhs, inv_reg)


def plan_grad(rows, cols, f, g, inv_reg: float = 1.0):
    """The fused W2 gradient ``rows·Σ_j P_ij − P @ cols``, P never stored."""
    rows, cols, f, g = _f32(rows, cols, f, g)
    return _pick(plan_grad_plain, plan_grad_cuda, rows)(rows, cols, f, g, inv_reg)


# --------------------------------------------------------------------------
# The two kernel routes of the Sinkhorn solve


def _solve_setup(particles, previous, eps: float, g_init):
    """Shared preamble of the fused and streaming solves, per lane: float32,
    ``mean(C)`` in closed form (``E‖x‖² + E‖y‖² − 2·Ex·Ey``, no C pass), the
    rescaling ``x' = x/√reg`` that makes every kernel run at ``inv_reg = 1``
    (``exp((f+g−C)/reg) = exp(f'+g'−C')`` with potentials in units of reg),
    and the cold or warm dual start (``ops/ot.py:_sinkhorn_start`` in
    rescaled units).  ``delta0`` (warm starts only) is ``max|g⁰ − g_init|``,
    the start pair's own exit statistic.

    Returns ``(xs, ys, f0, g0, delta0, reg, sr)``; ``reg`` and ``sr = √reg``
    are ``(S,)``."""
    x, y = _f32(particles, previous)
    S, m, _ = x.shape
    n = y.shape[1]
    tiny = torch.finfo(torch.float32).tiny
    mean_c = ((x * x).sum(dim=-1).mean(dim=-1) + (y * y).sum(dim=-1).mean(dim=-1)
              - 2.0 * (x.mean(dim=-2) * y.mean(dim=-2)).sum(dim=-1))
    reg = eps * torch.clamp(mean_c, min=tiny)
    sr = torch.sqrt(reg)
    xs, ys = x / sr[:, None, None], y / sr[:, None, None]
    if g_init is None:
        zeros = torch.zeros((S, n), dtype=torch.float32, device=x.device)
        f0 = ctransform_reduce(xs, ys, zeros, soft=False)
        g0 = ctransform_reduce(ys, xs, f0, soft=False)
        return xs, ys, f0, g0, None, reg, sr
    gi = g_init.to(torch.float32) / reg[:, None]
    f0 = _log_const(1.0 / m, x) - ctransform_reduce(xs, ys, gi, soft=True)
    g0 = _log_const(1.0 / n, x) - ctransform_reduce(ys, xs, f0, soft=True)
    return xs, ys, f0, g0, torch.abs(g0 - gi).amax(dim=-1), reg, sr


def _duals(g, reg, dtype, single):
    """The dual ``g`` back in cost units and the input dtype."""
    g = (g * reg[:, None]).to(dtype)
    return g[0] if single else g


def _finish(grad, g, reg, sr, dtype, single, return_g):
    grad = (grad * sr[:, None, None]).to(dtype)
    g = (g * reg[:, None]).to(dtype)
    if single:
        grad, g = grad[0], g[0]
    return (grad, g) if return_g else grad


def sinkhorn_grad_fused(particles, previous, eps: float = 0.05, iters: int = 200,
                        tol=None, absorb_every: int = 10, g_init=None,
                        return_g: bool = False, duals_only: bool = False):
    """W2 gradient by the fused route, for one pair or lanes — the algorithm
    and exit of ``ops/ot.py`` (same scaling loop), with the fixed passes on
    the kernels: the start from two :func:`ctransform_reduce` passes, the
    block kernel from :func:`kexp`, the scaling matvecs and the finish as
    ``torch.matmul`` against it (full float32; ``resolve_device`` keeps TF32
    off).  In rescaled coordinates the gradient is ``grad/√reg``, so it is
    scaled back by √reg; the dual returns in cost units as ``g·reg``.
    Returns ``grad`` or ``(grad, g)``, in the input dtype; ``duals_only=True``
    skips the finish and returns ``g`` alone (cost units) — the resumable
    chunk behind ``ops/ot.py:sinkhorn_dual_advance``."""
    if absorb_every <= 0:
        raise ValueError(f"absorb_every must be positive, got {absorb_every}")
    (particles, previous, g_init), single = _lanes(particles, previous, g_init)
    xs, ys, f0, g0, _, reg, sr = _solve_setup(particles, previous, eps, g_init)

    def make_ops(f, g):
        kmat = kexp(xs, ys, f, g)
        return ((lambda v: torch.matmul(kmat, v[..., None])[..., 0]),
                (lambda u: torch.matmul(kmat.transpose(-1, -2), u[..., None])[..., 0]),
                kmat)

    _, g, kmat, u, v = _sinkhorn_scaling_loop(
        f0, g0, make_ops, 1.0, xs.shape[1], ys.shape[1], iters, tol, absorb_every)
    if duals_only:
        return _duals(g, reg, particles.dtype, single)
    row = u * torch.matmul(kmat, v[..., None])[..., 0]
    py = u[..., None] * torch.matmul(kmat, v[..., None] * ys)
    return _finish(xs * row[..., None] - py, g, reg, sr, particles.dtype, single, return_g)


def sinkhorn_grad_streaming(particles, previous, eps: float = 0.05, iters: int = 200,
                            tol=None, absorb_every: int = 10, g_init=None,
                            return_g: bool = False, duals_only: bool = False):
    """W2 gradient with O(n·d) memory: every scaling matvec rebuilds the
    kernel from coordinates (:func:`kmat_vec`), the finish is
    :func:`plan_grad`; no ``(k, m)`` buffer ever exists.  Blocks are pure
    exit granularity here, so with a ``tol`` the loop runs at
    ``absorb_every = 1``; and a warm lane whose start pair already meets the
    exit (``delta0 ≤ tol``) skips the loop (JAX's ``lax.cond``, a per-lane
    select under ``vmap``).  Returns like :func:`sinkhorn_grad_fused`; with
    ``duals_only`` no :func:`plan_grad` pass runs, and ``iters=0`` returns
    the start pair's ``g`` (the two c-transform passes, no scaling)."""
    (particles, previous, g_init), single = _lanes(particles, previous, g_init)
    xs, ys, f0, g0, delta0, reg, sr = _solve_setup(particles, previous, eps, g_init)
    if duals_only and iters == 0:
        return _duals(g0, reg, particles.dtype, single)

    def make_ops(f, g):
        return ((lambda v: kmat_vec(xs, ys, f, g, v)),
                (lambda u: kmat_vec(ys, xs, g, f, u)),
                None)

    f, g = _sinkhorn_scaling_loop(
        f0, g0, make_ops, 1.0, xs.shape[1], ys.shape[1], iters, tol,
        1 if tol is not None else absorb_every, carry_kmat=False,
        start_delta=delta0 if tol is not None else None)
    if duals_only:
        return _duals(g, reg, particles.dtype, single)
    return _finish(plan_grad(xs, ys, f, g), g, reg, sr, particles.dtype, single, return_g)
