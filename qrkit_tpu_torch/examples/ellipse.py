"""Ellipse fitting with latent correspondences, on torch tensors.

Counterpart of ``qrkit_tpu/examples/ellipse.py``, the reference's flagship
demo (``examples/ellipse_fitting.cpp``): fit (a, b, x0, y0, r) plus one
latent parameter t_i per point by Levenberg–Marquardt.  The Jacobian is
block-angular: a block-diagonal left part (∂residual_i/∂t_i, one 2×1 block
per point) and 5 dense right columns (∂/∂ the model parameters).  The model
(residuals, Jacobian, the gradient ``Jᵀr``) is kernel K4
(:mod:`~qrkit_tpu_torch.ops.ellipse_eval`, one pass over the points each;
its plain versions on the CPU).

The damped system keeps that structure: each t_i's damping row goes under
its block (2×1 blocks become 3×1) and the 5 parameter damping rows go
below.  Residuals and Jacobian entries are computed vectorized over all
points, in the AoS form (point-major, for the class-based and fused
block-angular steps) and the lane-major form (point axis last and
contiguous, for the device loop's step
:func:`~qrkit_tpu_torch.functional.lm_damped_step_blockdiag1`).

Input points are host NumPy ``[2, N]``; :class:`EllipseFitting`,
:func:`fit_ellipse` and :func:`fit_ellipse_batch` take the ``device`` and
``dtype`` to fit on.  Under a ``torch.profiler`` the fits name their host
parts: ``qrk.fit.initial_guess``, ``qrk.fit.upload`` (points and x0 to the
device) and ``qrk.fit.canonical`` (:func:`fit_ellipse`'s canonical form).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _device
from .._program import Programs
from ..containers import BlockDiagonal, BlockMatrix1x2
from ..functional import _as_lam, block_angular_lstsq, lm_damped_step_blockdiag1
from ..ops.ellipse_eval import ellipse_jacobian_residuals, ellipse_residuals
from ..lm import (
    LMConfig,
    LMResult,
    levenberg_marquardt,
    levenberg_marquardt_device,
    levenberg_marquardt_device_batch,
)
from ..profiling import span
from ..solvers import BandedBlockedQR, BlockAngularQR, BlockDiagonalQR, DenseColPivQR, QFormat
from ..sparse import SparseCSR

__all__ = [
    "Ellipse",
    "ellipse_points",
    "EllipseFitting",
    "canonicalize_ellipse",
    "fit_ellipse",
    "fit_ellipse_batch",
    "initial_params_np",
]


@dataclasses.dataclass
class Ellipse:
    a: float = 7.5
    b: float = 2.0
    x0: float = 17.0
    y0: float = 23.0
    r: float = 0.23


def ellipse_points(el: Ellipse, npoints: int, arc: float = 1.3 * np.pi) -> np.ndarray:
    """Sample points along the ellipse (bench_sparse_qr_extra.cpp:281-292);
    host NumPy ``[2, N]``."""
    t = np.arange(npoints) * (arc / npoints)
    x = el.x0 + el.a * np.cos(t) * np.cos(el.r) - el.b * np.sin(t) * np.sin(el.r)
    y = el.y0 + el.a * np.cos(t) * np.sin(el.r) + el.b * np.sin(t) * np.cos(el.r)
    return np.stack([x, y])


def _residuals_soa(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Residuals in lane-major ``[2, N]`` form:
    ``[X_i − x(t_i), Y_i − y(t_i)]`` (ellipse_fitting.cpp:62-79); kernel
    K4r's interleaved residuals viewed point-major."""
    return ellipse_residuals(params, pts).view(-1, 2).T


def _residuals(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """fvec[2i] = X_i − x(t_i), fvec[2i+1] = Y_i − y(t_i): ``[2N]`` (kernel
    K4r; its gradient kernel K4g)."""
    return ellipse_residuals(params, pts)


def _jacobian_soa(params: torch.Tensor, pts: torch.Tensor):
    """Structured Jacobian in lane-major form: left ``[2, N]`` (the 2×1
    block of point i is column i), right ``[2, 5, N]``
    (ellipse_fitting.cpp:85-113; kernel K4j)."""
    left, right, _ = ellipse_jacobian_residuals(params, pts)
    return left, right


def _jacobian_blocks(params: torch.Tensor, pts: torch.Tensor):
    """Structured Jacobian, AoS: left 2×1 diagonal blocks ``[N, 2, 1]`` and
    the dense right ``[2N, 5]`` (rows interleaved 2i, 2i+1)."""
    n = pts.shape[1]
    left, right = _jacobian_soa(params, pts)
    return left.T[:, :, None], right.permute(2, 0, 1).reshape(2 * n, 5)


def _damped_system(left, right, res, lam):
    """``[J; √λ I]`` with the damping rows interleaved into the block
    structure: left ``[N, 2, 1]``, right ``[2N, 5]``, res ``[2N]`` →
    left_d ``[N, 3, 1]`` (a damping row under each block), right_d
    ``[3N+5, 5]`` (zeros at the damping rows, √λ I₅ at the bottom) and rhs
    ``[3N+5]`` (−res interleaved with zeros)."""
    n = left.shape[0]
    sl = torch.sqrt(torch.as_tensor(lam, dtype=left.dtype, device=left.device))
    left_d = torch.cat([left, sl.expand(n, 1, 1)], dim=1)
    right3 = torch.cat([right.reshape(n, 2, 5), right.new_zeros((n, 1, 5))], dim=1)
    right_d = torch.cat(
        [right3.reshape(3 * n, 5), sl * torch.eye(5, dtype=left.dtype, device=left.device)]
    )
    rhs3 = torch.cat([-res.reshape(n, 2), res.new_zeros((n, 1))], dim=1).reshape(3 * n)
    return left_d, right_d, torch.cat([rhs3, res.new_zeros(5)])


def _residuals_aux(params, pts):
    return _residuals(params, pts)


# the sharded damped step's captured programs, by axis and operand shapes
_MESH_STEP_PROGRAMS = Programs(limit=4)


def _damped_step_aux(params, res, lam, pts, *, mesh=None, axis: str = "dp"):
    """The device loop's damped step: the lane-major pipeline.  Residuals
    and Jacobian are recomputed in ``[·, N]`` form (``res`` is not used: a
    few elementwise ops cost less than a relayout).

    ``mesh=`` shards the points (lanes) over the mesh axis, where the
    reference places ``pts`` sharded along its point axis: every rank passes
    the global ``params`` and ``pts``, works on its own lanes, and returns
    the global step (the bottom panel reduces across ranks by TSQR, the
    point part is gathered).  On the card that call is one captured program
    holding its collectives, as the reference jits it with
    ``in_shardings``."""
    if mesh is None:
        return _lane_major_step(params, lam, pts)
    return _MESH_STEP_PROGRAMS.solve(
        None, "ellipse._damped_step_aux", axis,
        lambda _, p, s, x: _lane_major_step(p, s, x, mesh, axis), params, _as_lam(lam, params),
        pts, mesh=mesh, axis=axis,
    )


def _lane_major_step(params, lam, pts, mesh=None, axis: str = "dp"):
    """:func:`_damped_step_aux`'s work: the Jacobian and residuals in one
    pass (kernel K4j), then the step; over a mesh on this rank's lanes (a
    view of ``pts``: K4j reads it through its row stride)."""
    if mesh is not None:
        from ..parallel.mesh import shard_bounds

        n = pts.shape[1]
        lo, hi = shard_bounds(n, mesh, axis)
        pts, params = pts[:, lo:hi], torch.cat([params[lo:hi], params[n:]])
    left, right, res = ellipse_jacobian_residuals(params, pts)
    return lm_damped_step_blockdiag1(left, right, res, lam, mesh=mesh, axis=axis)


def _damped_step_aux_aos(params, res, lam, pts):
    """The fused block-angular step on the AoS damped system (a cross-check
    of the lane-major step)."""
    left, right = _jacobian_blocks(params, pts)
    left_d, right_d, rhs = _damped_system(left, right, res, lam)
    return block_angular_lstsq(left_d, right_d, rhs, n_shards=1, tail=5)


class EllipseFitting:
    """LM functor bundle: residuals and the damped structured step by
    block-angular QR.

    ``fused=True`` (default) runs the damped step through
    :func:`~qrkit_tpu_torch.functional.block_angular_lstsq`; ``fused=False``
    through the class-based composition ``BlockAngularQR(BlockDiagonalQR,
    DenseColPivQR)`` (same math, a cross-check).  ``pts`` is host NumPy
    ``[2, N]``, put on ``device`` (default CUDA) in ``dtype``."""

    def __init__(self, pts: np.ndarray, dtype=torch.float64, fused: bool = True, device=None):
        self._pts_np = np.asarray(pts)  # host copy for initial_params
        self.pts = _device.as_tensor(self._pts_np, device, dtype)
        self.n = int(self._pts_np.shape[1])
        self.dtype = dtype
        self.device = self.pts.device
        self.fused = fused

    def residuals(self, params: torch.Tensor) -> torch.Tensor:
        return _residuals(params, self.pts)

    def _damped(self, params, res, lam):
        left, right = _jacobian_blocks(params, self.pts)
        return _damped_system(left, right, res, torch.as_tensor(lam, dtype=self.dtype, device=self.device))

    def damped_step(self, params: torch.Tensor, res: torch.Tensor, lam) -> torch.Tensor:
        left_d, right_d, rhs = self._damped(params, res, lam)
        if self.fused:
            return block_angular_lstsq(left_d, right_d, rhs, n_shards=1, tail=5)
        blk = BlockDiagonal(left_d, 3 * self.n + 5, self.n)
        solver = BlockAngularQR(BlockDiagonalQR(QFormat.FULL_Q, pivot=False), DenseColPivQR())
        solver.compute(BlockMatrix1x2(blk, right_d))
        return solver.solve(rhs)

    def damped_step_banded(self, params: torch.Tensor, res: torch.Tensor, lam) -> torch.Tensor:
        """The reference's second solver stack: a banded-blocked left solver
        (3×1 blocks, no overlap; its chain kernel B5 on a CUDA device)
        composed with a dense ColPiv right
        (SparseBlockBandedQR_EllipseFitting, ellipse_fitting.cpp:149-180).
        The sparse left is built on the host per call: a parity path, not
        the production loop."""
        left_d, right_d, rhs = self._damped(params, res, lam)
        n = self.n
        left_sp = SparseCSR.from_triplets(
            np.arange(3 * n), np.repeat(np.arange(n), 3),
            left_d.detach().cpu().numpy().reshape(-1), (3 * n + 5, n),
        )
        solver = BlockAngularQR(
            BandedBlockedQR(
                block_rows=3, block_cols=1, block_overlap=0, suggested_block_cols=1,
                device=self.device, dtype=self.dtype,
            ),
            DenseColPivQR(),
        )
        solver.compute(BlockMatrix1x2(left_sp, right_d))
        return solver.solve(rhs)

    def initial_params(self) -> torch.Tensor:
        """ellipse_fitting.cpp:208-232: bounding-box init + uniform t spread."""
        return torch.as_tensor(initial_params_np(self._pts_np), dtype=self.dtype, device=self.device)


def initial_params_np(pts: np.ndarray) -> np.ndarray:
    """Host-only initial guess (ellipse_fitting.cpp:208-232): bounding-box
    init + uniform t spread."""
    pts = np.asarray(pts)
    n = pts.shape[1]
    params = np.zeros(n + 5)
    params[:n] = np.arange(n) * (1.3 * np.pi / n)
    params[n] = 0.5 * (pts[0].max() - pts[0].min())
    params[n + 1] = 0.5 * (pts[1].max() - pts[1].min())
    params[n + 2] = 0.5 * (pts[0].max() + pts[0].min())
    params[n + 3] = 0.5 * (pts[1].max() + pts[1].min())
    return params


def canonicalize_ellipse(params: np.ndarray, n: int) -> np.ndarray:
    """Resolve the parameter ambiguities (ellipse_fitting.cpp:234-253)."""
    p = np.array(params, dtype=np.float64)
    if abs(p[n + 1]) > abs(p[n]):
        p[n], p[n + 1] = p[n + 1], p[n]
        p[n + 4] -= 0.5 * np.pi
    if p[n] < 0:
        p[n] *= -1.0
        p[n + 1] *= -1.0
        p[n + 4] += np.pi
    while p[n + 4] < 0:
        p[n + 4] += 2.0 * np.pi
    while p[n + 4] > np.pi:
        p[n + 4] -= np.pi
    return p


def fit_ellipse(
    pts: np.ndarray,
    config: Optional[LMConfig] = None,
    dtype=torch.float64,
    fused: bool = True,
    loop: str = "device",
    device=None,
) -> Tuple[LMResult, np.ndarray]:
    """End-to-end LM ellipse fit; returns (LMResult, canonicalized params).

    ``loop="device"`` (default) keeps the LM state on ``device`` with the
    lane-major damped step: on the card the fit is one captured loop
    (:func:`~qrkit_tpu_torch.lm.levenberg_marquardt_device`), one graph
    launch and one fetch of the result when warm (``lm.clear_programs()``
    drops it; on the CPU, one host read an iteration); ``loop="host"`` runs
    the host loop with :meth:`EllipseFitting.damped_step`."""
    if loop not in ("device", "host"):
        raise ValueError(f"loop must be 'device' or 'host', got {loop!r}")
    pts = np.asarray(pts)
    with span("qrk.fit.initial_guess"):
        x0 = initial_params_np(pts)
    with span("qrk.fit.upload"):
        functor = EllipseFitting(pts, dtype=dtype, fused=fused, device=device)
        x0 = torch.as_tensor(x0, dtype=dtype, device=functor.device)
    cfg = config or LMConfig(max_iters=60)
    if loop == "device":
        result = levenberg_marquardt_device(_residuals_aux, _damped_step_aux, x0, cfg,
                                            aux=functor.pts)
    else:
        result = levenberg_marquardt(functor.residuals, functor.damped_step, x0, cfg)
    x = result.x.detach().cpu().numpy() if isinstance(result.x, torch.Tensor) else result.x
    with span("qrk.fit.canonical"):
        return result, canonicalize_ellipse(x, functor.n)


def fit_ellipse_batch(
    pts_batch: np.ndarray,
    config: Optional[LMConfig] = None,
    dtype=torch.float64,
    device=None,
) -> LMResult:
    """Fit B independent ellipses in one device loop (the solo fit's loop
    over a leading problem axis; one captured loop on the card, as the solo
    fit's).  ``pts_batch`` is host NumPy ``[B, 2,
    N]``; returns an :class:`LMResult` of NumPy arrays (``[B, N+5]``
    solutions, ``[B]`` costs, iterations and convergence flags)."""
    pts_batch = np.asarray(pts_batch)
    with span("qrk.fit.initial_guess"):
        x0 = np.stack([initial_params_np(p) for p in pts_batch])
    with span("qrk.fit.upload"):
        x0, pts = _device.as_tensor(x0, device, dtype), _device.as_tensor(pts_batch, device, dtype)
    return levenberg_marquardt_device_batch(
        _residuals_aux, _damped_step_aux, x0, config or LMConfig(max_iters=60), aux_batch=pts
    )
