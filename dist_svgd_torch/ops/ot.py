"""Wasserstein-2 / JKO proximal term, on batched tensors.

Counterpart of ``dist_svgd_tpu/ops/ot.py``.  The reference adds an optional
W2 gradient to each SVGD step (dsvgd/distsampler.py:103-129): solve the
discrete OT problem between the current particles ``x`` (weights 1/m) and
the previous step's particles ``y`` (weights 1/n) with cost ``‖x_i − y_j‖²``,
then

    w_grad_i = Σ_j plan_ij · (x_i − y_j).

Two solvers:

- :func:`wasserstein_grad_lp` — the reference's dense LP on the host
  (``scipy.optimize.linprog``), float64, one pair of point sets at a time;
- :func:`wasserstein_grad_sinkhorn` — entropic OT by absorption-stabilised
  Sinkhorn scaling (:func:`sinkhorn_plan` says how), with its resumable
  half :func:`sinkhorn_dual_advance` (the duals only, for a solve split
  across dispatches), on three routes
  chosen by :func:`_resolve_sinkhorn_route`: ``'torch'`` (the dense solve
  here, in cost units), and on the card the hand-kernel routes ``'fused'``
  and ``'streaming'`` of :mod:`dist_svgd_torch.ops.cuda_ot` (reg-rescaled
  units).  All three run the ONE scaling loop below.

Lanes: every Sinkhorn function takes ``(k, d)`` / ``(m, d)`` point sets or
batches ``(S, k, d)`` / ``(S, m, d)`` of them — the S emulated shards, each
solved on its own (its own ``reg``, its own exit).  JAX runs the per-lane
solve under ``vmap``, where a ``while_loop`` keeps running while any lane's
condition holds but only moves the lanes whose own condition is true; the
batched loop here does the same by freezing a lane (``torch.where``) once
its exit statistic is within ``tol``.  The ``tol`` test reads the count of
running lanes back to the host before every block but a cold first one.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from dist_svgd_torch.ops.kernels import squared_distances

#: ``impl='auto'`` takes the O(n·d)-memory streaming route at or above this
#: many pairs PER LANE: 2²⁸ pairs is a 1 GB float32 kernel matrix for one
#: lane, 8 GB for the north star's 8.  A memory rule, not a timing; below it
#: the materialised fused route is used.
FUSED_SINKHORN_STREAM_MIN_PAIRS = 1 << 28

SINKHORN_IMPLS = ("auto", "torch", "cuda")


def wasserstein_grad_lp(particles, previous) -> np.ndarray:
    """Exact discrete-OT W2 gradient via the host LP (reference parity).

    Builds the reference's flattened system (dsvgd/distsampler.py:111-127):
    ``c`` is the row-major squared-distance matrix, the first ``m`` rows of
    ``A_eq`` fix the row sums to ``1/m`` and the next ``n`` rows the column
    sums to ``1/n``; scipy's HiGHS returns a vertex solution.  Takes one
    ``(m, d)`` / ``(n, d)`` pair (tensors or arrays) and returns a float64
    ``(m, d)`` numpy array."""
    import scipy.optimize

    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, dtype=np.float64)

    x, y = host(particles), host(previous)
    m, n = x.shape[0], y.shape[0]
    diffs = x[:, None, :] - y[None, :, :]  # (m, n, d)
    c = np.sum(diffs ** 2, axis=2).reshape(-1)
    a_eq = np.vstack([np.kron(np.eye(m), np.ones((1, n))),
                      np.kron(np.ones((1, m)), np.eye(n))])
    b_eq = np.concatenate([np.full(m, 1.0 / m), np.full(n, 1.0 / n)])
    res = scipy.optimize.linprog(c, A_eq=a_eq, b_eq=b_eq)
    if res.x is None:  # pragma: no cover - defensive
        raise RuntimeError(f"OT linear program failed: {res.message}")
    plan = res.x.reshape(m, n)
    return np.sum(plan[:, :, None] * diffs, axis=1)


def _lanes(*ts):
    """Add a lane axis to unbatched ``(rows, ·)`` inputs; returns the
    batched tensors and whether the caller passed unbatched ones."""
    single = ts[0].dim() == 2
    if single:
        ts = tuple(None if t is None else t[None] for t in ts)
    return ts, single


def _reg(cost: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-lane entropic regulariser ``eps · mean(C)`` (``eps`` is relative),
    shape ``(S,)``."""
    tiny = torch.finfo(cost.dtype).tiny
    return eps * torch.clamp(cost.mean(dim=(-2, -1)), min=tiny)


def _log_const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``log(value)`` with ``value`` first rounded to ``like``'s dtype."""
    return torch.log(torch.tensor(value, dtype=like.dtype, device=like.device))


def _sinkhorn_start(cost: torch.Tensor, eps: float, g_init):
    """Initial dual pair, per lane.  Cold (``g_init=None``): the hard
    c-transform pair ``f⁰_i = min_j C_ij``, ``g⁰_j = min_i (C_ij − f⁰_i)``,
    which puts a zero at the top of every row and column of the log-kernel.
    Warm: the soft (entropic) c-transform pair of the carried ``g`` — one
    exact log-domain Sinkhorn iteration; after the ``f⁰`` update every row
    of ``exp((f⁰ + g − C)/reg)`` sums to its marginal, so no row starts
    underflowed for any ``g_init``, and the soft transform of an optimal
    ``g`` is the fixpoint (``dist_svgd_tpu/ops/ot.py:_sinkhorn_start``)."""
    m, n = cost.shape[-2:]
    if g_init is None:
        f0 = cost.amin(dim=-1)
        g0 = (cost - f0[..., :, None]).amin(dim=-2)
        return f0, g0
    reg = _reg(cost, eps)[..., None]
    gi = g_init.to(cost.dtype)
    f0 = reg * _log_const(1.0 / m, cost) - reg * torch.logsumexp(
        (gi[..., None, :] - cost) / reg[..., None], dim=-1)
    g0 = reg * _log_const(1.0 / n, cost) - reg * torch.logsumexp(
        (f0[..., :, None] - cost) / reg[..., None], dim=-2)
    return f0, g0


def _sinkhorn_scaling_loop(f0, g0, make_kernel_ops: Callable, fold_scale, m: int,
                           n: int, iters: int, tol: Optional[float],
                           absorb_every: int, carry_kmat: bool = True,
                           start_delta: Optional[torch.Tensor] = None):
    """The absorbed-scaling loop shared by the torch route (below) and the
    card's fused and streaming routes (``ops/cuda_ot.py``) — one copy of the
    block structure, the ``tol`` exit statistic and the u/v clamps.

    ``make_kernel_ops(f, g) -> (mv, rmv, kmat)`` with ``mv(v) ≈ K @ v`` and
    ``rmv(u) ≈ Kᵀ @ u`` per lane, ``K = exp((f + g − C)·inv_reg)``; ``kmat``
    is the materialised kernel where one exists (carried so that the last
    block's kernel serves the gradient finish), ``None`` for the streaming
    route, which passes ``carry_kmat=False``.  ``fold_scale`` sets the
    potential units: ``reg`` as ``(S, 1)`` in cost units, ``1.0`` in
    reg-rescaled units.  ``f0`` is ``(S, m)``, ``g0`` ``(S, n)``.

    ``tol=None`` runs ``iters`` iterations in blocks of ``absorb_every``
    plus a remainder block.  A float ``tol`` runs uniform blocks until a
    lane's last-iteration sup-change of ``log v`` is within ``tol`` or
    ``ceil(iters / absorb_every)`` blocks ran; a lane that has exited is
    frozen while the others go on.  ``start_delta`` (``(S,)``, streaming
    warm starts) freezes from the start every lane whose value is already
    within ``tol``.

    Returns ``(f, g, kmat, u, v)`` with ``plan = u·kmat·v`` entrywise when
    ``carry_kmat``, else ``(f, g)``.  Requires ``iters >= 1``.
    """
    if absorb_every <= 0:
        raise ValueError(f"absorb_every must be positive, got {absorb_every}")
    if iters < 1:
        raise ValueError(f"the scaling loop needs iters >= 1, got {iters}")
    dt = f0.dtype
    tiny = torch.finfo(dt).tiny
    a = torch.tensor(1.0 / m, dtype=dt, device=f0.device)
    b = torch.tensor(1.0 / n, dtype=dt, device=f0.device)
    lanes = f0.shape[0]

    def run_block(f, g, k_iters: int):
        mv, rmv, kmat = make_kernel_ops(f, g)

        def one(v):
            u = a / torch.clamp(mv(v), min=tiny)
            return u, b / torch.clamp(rmv(u), min=tiny)

        v = torch.ones((lanes, n), dtype=dt, device=f0.device)
        for _ in range(k_iters - 1):
            v = one(v)[1]
        u, new_v = one(v)
        delta = torch.abs(torch.log(new_v) - torch.log(v)).amax(dim=-1)
        payload = (kmat, u, new_v) if carry_kmat else None
        return (f + fold_scale * torch.log(u), g + fold_scale * torch.log(new_v),
                payload, delta)

    absorb_every = min(absorb_every, iters)  # short runs stay exact
    blocks, rem = divmod(iters, absorb_every)
    f, g, payload = f0, g0, None
    if tol is None:
        for _ in range(blocks):
            f, g, payload, _ = run_block(f, g, absorb_every)
        if rem:
            f, g, payload, _ = run_block(f, g, rem)
    else:
        thresh = torch.tensor(tol, dtype=dt, device=f0.device)
        delta = torch.full((lanes,), math.inf, dtype=dt, device=f0.device)
        if start_delta is not None:
            delta = torch.where(start_delta <= thresh, start_delta, delta)
        for block in range(blocks + (1 if rem else 0)):
            active = delta > thresh
            # the per-block host sync; a cold first block runs every lane
            n_active = (lanes if block == 0 and start_delta is None
                        else int(active.sum()))
            if n_active == 0:
                break
            # uniform block length; the cap may overshoot iters by
            # < absorb_every on the last block, as in JAX
            nf, ng, npay, nd = run_block(f, g, absorb_every)
            if n_active == lanes:
                f, g, payload, delta = nf, ng, npay, nd
                continue
            keep = active[:, None]
            f, g = torch.where(keep, nf, f), torch.where(keep, ng, g)
            delta = torch.where(active, nd, delta)
            if carry_kmat:  # block 1 ran every lane, so payload is set
                kmat, u, v = npay
                payload = (torch.where(active[:, None, None], kmat, payload[0]),
                           torch.where(keep, u, payload[1]),
                           torch.where(keep, v, payload[2]))
    if carry_kmat:
        kmat, u, v = payload
        return f, g, kmat, u, v
    return f, g


def _sinkhorn_solve(cost, eps, iters, tol, absorb_every, g_init):
    """Torch-route solve over a materialised ``(S, m, n)`` cost: the shared
    scaling loop with a dense-exp kernel, in cost units.  Returns
    ``(f, g, kmat, u, v, reg)``."""
    m, n = cost.shape[-2:]
    reg = _reg(cost, eps)
    f0, g0 = _sinkhorn_start(cost, eps, g_init)

    def make_ops(f, g):
        kmat = torch.exp((f[..., :, None] + g[..., None, :] - cost) / reg[:, None, None])
        return ((lambda v: torch.matmul(kmat, v[..., None])[..., 0]),
                (lambda u: torch.matmul(kmat.transpose(-1, -2), u[..., None])[..., 0]),
                kmat)

    f, g, kmat, u, v = _sinkhorn_scaling_loop(
        f0, g0, make_ops, reg[:, None], m, n, iters, tol, absorb_every)
    return f, g, kmat, u, v, reg


def sinkhorn_plan(x, y, eps: float = 0.05, iters: int = 200,
                  tol: Optional[float] = None, absorb_every: int = 10,
                  g_init=None, return_potentials: bool = False):
    """Entropic-OT plan between uniform measures on ``x`` and ``y`` (torch
    route, any dtype and device): ``(m, n)`` for one pair, ``(S, m, n)`` for
    lanes.

    ``eps`` is relative: the regulariser is ``eps · mean(C)``.  Blocks of
    ``absorb_every`` plain scaling iterations (``u ← a/(K v)``, ``v ←
    b/(Kᵀ u)``) alternate with log-domain absorptions that fold ``reg·log u``
    and ``reg·log v`` into the potentials and rebuild the kernel.  The start
    is the hard c-transform pair (cold) or the soft one of ``g_init`` (warm)
    — :func:`_sinkhorn_start`.  ``tol`` and the lane semantics:
    :func:`_sinkhorn_scaling_loop`.  ``iters=0`` returns the start pair's
    plan.  ``return_potentials=True`` returns ``(plan, (f, g))``; feed ``g``
    back as the next solve's ``g_init``."""
    if absorb_every <= 0:
        raise ValueError(f"absorb_every must be positive, got {absorb_every}")
    (x, y, g_init), single = _lanes(x, y, g_init)
    cost = squared_distances(x, y)
    if iters == 0:  # the bare start, no scaling pass
        f, g = _sinkhorn_start(cost, eps, g_init)
        reg = _reg(cost, eps)[:, None, None]
        plan = torch.exp((f[..., :, None] + g[..., None, :] - cost) / reg)
    else:
        f, g, kmat, u, v, _ = _sinkhorn_solve(cost, eps, iters, tol, absorb_every, g_init)
        # the last block's kernel and scalings are the plan
        plan = u[..., :, None] * kmat * v[..., None, :]
    if single:
        plan, f, g = plan[0], f[0], g[0]
    return (plan, (f, g)) if return_potentials else plan


def _resolve_sinkhorn_route(x: torch.Tensor, y: torch.Tensor, impl: str) -> str:
    """``'torch'``, ``'fused'`` or ``'streaming'`` for lanes ``x`` ``(S, k,
    d)`` and ``y`` ``(S, m, d)``.  The pair count is one lane's, ``k·m``, as
    JAX's gate sees one lane under ``vmap``.

    - ``'torch'`` — always the torch route.
    - ``'auto'`` — on CUDA tensors, float32 and d ≤ SMALL_D take the hand
      kernels at any size (the TPU's ``FUSED_SINKHORN_MIN_PAIRS`` does not
      carry over, ROADMAP B9), streaming from
      :data:`FUSED_SINKHORN_STREAM_MIN_PAIRS` pairs per lane; anything else
      takes the torch route, with a warning past that memory line.  On the
      CPU, the torch route.
    - ``'cuda'`` — force the kernels: CUDA tensors and d ≤ SMALL_D only
      (raises otherwise); wider-than-f32 inputs warn (the kernel routes
      compute in float32).
    """
    from dist_svgd_torch.ops.cuda_svgd import SMALL_D

    if impl not in SINKHORN_IMPLS:
        raise ValueError(f"unknown sinkhorn impl {impl!r}; the port has {SINKHORN_IMPLS}")
    if impl == "torch":
        return "torch"
    d = x.shape[-1]
    pairs = x.shape[-2] * y.shape[-2]
    on_card = x.device.type == "cuda" and y.device.type == "cuda"
    small_d = d <= SMALL_D
    f32 = x.dtype == torch.float32 and y.dtype == torch.float32
    if impl == "cuda":
        if not on_card:
            raise ValueError(
                f"sinkhorn impl='cuda' launches the hand kernels and needs CUDA "
                f"tensors, got {x.device}; use 'auto' or 'torch' on the CPU")
        if not small_d:
            raise ValueError(f"sinkhorn impl='cuda' requires d <= {SMALL_D}, got {d}")
        if x.dtype.itemsize > 4 or y.dtype.itemsize > 4:
            warnings.warn(
                f"sinkhorn impl='cuda' computes in float32 but got {x.dtype}/"
                f"{y.dtype} inputs; the result is cast back with float32 "
                "precision — use impl='auto' or 'torch' for full precision",
                stacklevel=3)
    elif not (on_card and small_d and f32):
        if on_card and pairs >= FUSED_SINKHORN_STREAM_MIN_PAIRS:
            warnings.warn(
                f"sinkhorn solve with {pairs:.2e} cost entries per lane (dtype "
                f"{x.dtype}, d={d}) is past the streaming line but outside the "
                f"streaming route's domain (float32, d <= {SMALL_D}); the "
                "materialised torch solve will likely exhaust device memory",
                stacklevel=3)
        return "torch"
    return "streaming" if pairs >= FUSED_SINKHORN_STREAM_MIN_PAIRS else "fused"


def _grad_torch(x, y, eps, iters, tol, absorb_every, g_init):
    """Torch-route gradient on lanes: ``grad_i = x_i·rowsum_i − P @ y`` from
    the last block's ``(kmat, u, v)`` — two matvecs, no further exp pass."""
    cost = squared_distances(x, y)
    _, g, kmat, u, v, _ = _sinkhorn_solve(cost, eps, iters, tol, absorb_every, g_init)
    row = u * torch.matmul(kmat, v[..., None])[..., 0]
    py = u[..., None] * torch.matmul(kmat, v[..., None] * y)
    return x * row[..., None] - py, g


def wasserstein_grad_sinkhorn(particles, previous, eps: float = 0.05,
                              iters: int = 200, tol: Optional[float] = None,
                              absorb_every: int = 10, g_init=None,
                              return_g: bool = False, impl: str = "auto"):
    """W2 gradient from the Sinkhorn plan, ``grad_i = Σ_j P_ij (x_i − y_j)``,
    for one pair ``(k, d)`` / ``(m, d)`` or lanes ``(S, k, d)`` /
    ``(S, m, d)``, without materialising the ``(k, m, d)`` differences.

    ``g_init`` (``(m,)`` or ``(S, m)``, cost units) warm-starts the solve
    from a carried dual; ``return_g=True`` returns ``(grad, g)``.  ``impl``
    picks the route (:func:`_resolve_sinkhorn_route`); the kernel routes
    compute in float32 and cast back.  ``iters=0`` is the bare-start edge:
    the gradient of the start pair's plan, on the torch route."""
    if impl not in SINKHORN_IMPLS:
        raise ValueError(f"unknown sinkhorn impl {impl!r}; the port has {SINKHORN_IMPLS}")
    (x, y, g_init), single = _lanes(particles, previous, g_init)
    if iters == 0:
        plan, (_, g) = sinkhorn_plan(x, y, eps=eps, iters=0, absorb_every=absorb_every,
                                     g_init=g_init, return_potentials=True)
        grad = x * plan.sum(dim=-1)[..., None] - torch.matmul(plan, y)
    else:
        route = _resolve_sinkhorn_route(x, y, impl)
        if route == "torch":
            grad, g = _grad_torch(x, y, eps, iters, tol, absorb_every, g_init)
        else:
            from dist_svgd_torch.ops import cuda_ot

            fn = (cuda_ot.sinkhorn_grad_streaming if route == "streaming"
                  else cuda_ot.sinkhorn_grad_fused)
            grad, g = fn(x, y, eps=eps, iters=iters, tol=tol, absorb_every=absorb_every,
                         g_init=g_init, return_g=True)
    if single:
        grad, g = grad[0], g[0]
    return (grad, g) if return_g else grad


def sinkhorn_dual_advance(particles, previous, eps: float = 0.05, iters: int = 200,
                          tol: Optional[float] = None, absorb_every: int = 10, g_init=None,
                          impl: str = "auto"):
    """Advance the Sinkhorn dual ``g`` by up to ``iters`` scaling iterations
    without the gradient finish — the resumable half of
    :func:`wasserstein_grad_sinkhorn` (JAX ``ops/ot.py:sinkhorn_dual_advance``).
    A host loop splits one solve into chunks, ``g = sinkhorn_dual_advance(x,
    y, iters=k, g_init=g)`` repeated, and only the last chunk pays the
    finish (``wasserstein_grad_sinkhorn(..., g_init=g, return_g=True)``).

    Each resume pays the two soft c-transform start passes; the start pair
    is one exact log-domain iteration from ``g_init``, so a split solve sits
    a few iterations ahead of the unsplit one and meets it at convergence.
    ``iters=0`` returns the bare start pair's ``g`` — on the streaming route
    without ever building C.  Same routes as
    :func:`wasserstein_grad_sinkhorn`; returns ``g`` in cost units, ``(m,)``
    or ``(S, m)``."""
    if impl not in SINKHORN_IMPLS:
        raise ValueError(f"unknown sinkhorn impl {impl!r}; the port has {SINKHORN_IMPLS}")
    (x, y, g_init), single = _lanes(particles, previous, g_init)
    route = _resolve_sinkhorn_route(x, y, impl)
    if iters == 0 and route != "streaming":
        _, (_, g) = sinkhorn_plan(x, y, eps=eps, iters=0, absorb_every=absorb_every,
                                  g_init=g_init, return_potentials=True)
    elif route == "torch":
        if absorb_every <= 0:
            raise ValueError(f"absorb_every must be positive, got {absorb_every}")
        _, g, _, _, _, _ = _sinkhorn_solve(squared_distances(x, y), eps, iters, tol,
                                           absorb_every, g_init)
    else:
        from dist_svgd_torch.ops import cuda_ot

        fn = (cuda_ot.sinkhorn_grad_streaming if route == "streaming"
              else cuda_ot.sinkhorn_grad_fused)
        g = fn(x, y, eps=eps, iters=iters, tol=tol, absorb_every=absorb_every,
               g_init=g_init, duals_only=True)
    return g[0] if single else g
