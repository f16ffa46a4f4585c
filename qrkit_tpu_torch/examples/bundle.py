"""Bundle adjustment on torch tensors: the Jacobian family the library was
built for.

Counterpart of ``qrkit_tpu/examples/bundle.py`` (``make_scene``,
``residuals``, ``_jacobian_blocks``, ``_damped_left_rhs``, ``_BundleStep``,
``fit_bundle``, ``_make_damped_step``, ``fit_bundle_device``):

* Parameters: P 3D points (3 each) and C cameras (axis-angle rotation +
  translation, 6 each); observations are pinhole projections of every
  point in every camera.
* Rows grouped by point make the point columns **block-diagonal** (``[2C,
  3]`` a point; with its damping rows ``[2C+3, 3]``) and the camera columns
  a thin shared right block that is itself **sparse** (an observation row
  touches one camera's 6 columns).
* The damped step is ``BlockAngularQR(BlockDiagonalQR(pivot=False),
  DenseColPivQR())`` over ``[BlockDiagonal | SparseCSR]``: on the card the
  point blocks factor with kernel B2 (19×3 at C = 8), the sparse-A2 path
  keeps the camera block in O(nnz), and the ColPiv right solver absorbs the
  gauge freedom (a free similarity transform makes the undamped camera
  block rank-deficient).  The reference's point QR pivots; the damped
  blocks are full rank, so the step is the same least-squares minimizer.

Residuals are vectorized over all observations; Jacobians come from
``torch.func.vmap`` + ``torch.func.jacfwd``.  :func:`fit_bundle` runs the
host LM loop over the class stack; :func:`fit_bundle_device` keeps the LM
state on the device with the fused ``block_angular_lstsq`` step; with
``mesh=`` the point axis of the scene is sharded over the ranks of a
``DeviceMesh``: each rank holds its points' observations, Jacobian blocks
and block QR, the all-gather of each rank's ``[6C, 6C + 1]`` factor ``[R |
Qᵀy]`` of the camera block's bottom is the step's only collective, and the LM cost and gradient are
all-reduced, so every rank returns the same result; on the card the step
and the whole fit are captured programs with those collectives inside.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _device
from .._program import Programs
from ..containers import BlockDiagonal, BlockMatrix1x2
from ..functional import _as_lam, block_angular_lstsq
from ..lm import LMConfig, LMResult, levenberg_marquardt, levenberg_marquardt_device
from ..parallel.mesh import all_reduce_sum, mesh_rank, shard_bounds, shard_leading_axis
from ..solvers import BlockAngularQR, BlockDiagonalQR, DenseColPivQR
from ..sparse import SparseCSR

__all__ = ["make_scene", "residuals", "fit_bundle", "fit_bundle_device"]


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] → rotation matrices [..., 3, 3], smooth at w = 0
    (both branches are evaluated; the 1e-30 guards keep their tangents
    finite)."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2 + 1e-30)
    a = torch.where(th2 < 1e-16, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(th2 < 1e-16, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th2 + 1e-30))
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    K = torch.stack([
        torch.stack([z, -w2, w1], -1),
        torch.stack([w2, z, -w0], -1),
        torch.stack([-w1, w0, z], -1),
    ], -2)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * (K @ K)


def _project(cam: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Pinhole projection (f = 1) of world point X by camera (omega, t)."""
    p = _rodrigues(cam[:3]) @ X + cam[3:]
    return p[:2] / p[2]


def _project_all(cams: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[P, C, 2] projections of every point in every camera."""
    return torch.func.vmap(lambda X: torch.func.vmap(lambda c: _project(c, X))(cams))(pts)


def make_scene(
    n_cams: int = 3, n_pts: int = 32, noise: float = 0.0, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic scene: a unit point cloud at the origin, cameras ~6 units in
    front looking roughly down +z.  Returns host NumPy (cams [C, 6], pts
    [P, 3], uv [P, C, 2]); the projections are computed in float64 on the
    CPU, so a seed gives the reference's scene."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n_pts, 3))
    cams = np.concatenate(
        [
            0.1 * rng.normal(size=(n_cams, 3)),
            np.stack(
                [
                    0.4 * rng.normal(size=n_cams),
                    0.4 * rng.normal(size=n_cams),
                    6.0 + 0.3 * rng.normal(size=n_cams),
                ],
                axis=1,
            ),
        ],
        axis=1,
    )
    proj = _project_all(torch.as_tensor(cams), torch.as_tensor(pts)).numpy()
    uv = proj + noise * rng.normal(size=proj.shape)
    return cams, pts, uv


def _split(x: torch.Tensor, n_pts: int, n_cams: int):
    return x[: 3 * n_pts].reshape(n_pts, 3), x[3 * n_pts :].reshape(n_cams, 6)


def residuals(x: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Reprojection residuals, point-major then camera then (u, v) — the row
    order that makes the point columns block-diagonal."""
    n_pts, n_cams = uv.shape[0], uv.shape[1]
    pts, cams = _split(x, n_pts, n_cams)
    return (_project_all(cams, pts) - uv).reshape(-1)


def _jacobian_blocks(x: torch.Tensor, uv: torch.Tensor):
    """Structured Jacobian by forward-mode AD over the observations:
    J_pt [P, 2C, 3] (the block-diagonal batch) and J_cam [P, C, 2, 6]."""
    n_pts, n_cams = uv.shape[0], uv.shape[1]
    pts, cams = _split(x, n_pts, n_cams)
    vmap, jacfwd = torch.func.vmap, torch.func.jacfwd
    jp = vmap(lambda X: vmap(lambda c: jacfwd(_project, argnums=1)(c, X))(cams))(pts)
    jc = vmap(lambda X: vmap(lambda c: jacfwd(_project, argnums=0)(c, X))(cams))(pts)
    return jp.reshape(n_pts, 2 * n_cams, 3), jc


def _damped_left_rhs(jp: torch.Tensor, res: torch.Tensor, lam, n_cams: int):
    """[J_pt; √λ I3] blocks ``[P, 2C+3, 3]`` and the rhs (−res at the
    observation rows, zeros at the interleaved point-damping rows)."""
    n_pts = jp.shape[0]
    sl = torch.sqrt(torch.as_tensor(lam, dtype=jp.dtype, device=jp.device))
    eye3 = torch.eye(3, dtype=jp.dtype, device=jp.device).expand(n_pts, 3, 3)
    left_d = torch.cat([jp, sl * eye3], dim=1)
    rhs = torch.cat([-res.reshape(n_pts, 2 * n_cams), res.new_zeros((n_pts, 3))], dim=1)
    return left_d, rhs.reshape(-1)


class _BundleStep:
    """Damped-step functor: one block-angular QR solve per call.

    The camera block's pattern (which rows touch which camera columns) is
    the same every iteration; its CSR structure and its layout token are
    built once and each call only orders the new values into it, and one
    ``BlockAngularQR`` is kept across calls, so its sparse-A2 plan is built
    once and, on the card, its sparse-A2 recompute is one captured program
    from the third call on."""

    def __init__(self, uv: np.ndarray, *, device=None, dtype=torch.float64):
        self.uv = _device.as_tensor(np.asarray(uv), device, dtype)
        n_pts, n_cams = uv.shape[0], uv.shape[1]
        self.n_pts, self.n_cams = n_pts, n_cams
        brows = 2 * n_cams + 3
        self.n1 = n_pts * brows + 6 * n_cams
        # observation rows of A2: row p*brows + 2c + k, cols 6c..6c+6; then
        # the camera damping rows √λ I at the zero tail of A1
        p, c, k, j = np.meshgrid(
            np.arange(n_pts), np.arange(n_cams), np.arange(2), np.arange(6), indexing="ij"
        )
        rows = np.concatenate([(p * brows + 2 * c + k).reshape(-1), n_pts * brows + np.arange(6 * n_cams)])
        cols = np.concatenate([(6 * c + j).reshape(-1), np.arange(6 * n_cams)])
        self._order = np.lexsort((cols, rows))  # CSR order of the (distinct) pairs
        indptr = np.zeros(self.n1 + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        self._indptr, self._indices = np.cumsum(indptr), cols[self._order]
        # the layout's token, handed to every iteration's A2 (no re-hash)
        self._fp = SparseCSR((self.n1, 6 * n_cams), self._indptr, self._indices,
                             np.zeros(self._indices.size)).pattern_fingerprint()
        self._qr = BlockAngularQR(BlockDiagonalQR(pivot=False), DenseColPivQR())
        self.last_qr: Optional[BlockAngularQR] = None

    def __call__(self, x: torch.Tensor, r: torch.Tensor, lam) -> torch.Tensor:
        jp, jc = _jacobian_blocks(x, self.uv)
        left_d, rhs = _damped_left_rhs(jp, r, lam, self.n_cams)
        blk = BlockDiagonal.from_dense_batch(left_d, nrows=self.n1, ncols=3 * self.n_pts)
        sl = float(np.sqrt(lam))
        vals = np.concatenate([jc.detach().cpu().numpy().reshape(-1), np.full(6 * self.n_cams, sl)])
        a2 = SparseCSR((self.n1, 6 * self.n_cams), self._indptr, self._indices, vals[self._order])
        a2._fp_memo = self._fp
        qr = self._qr.compute(BlockMatrix1x2(blk, a2))
        self.last_qr = qr
        b = torch.cat([rhs, rhs.new_zeros(6 * self.n_cams)])
        rperm = qr.rows_permutation()
        if not rperm.is_identity():
            b = b[torch.as_tensor(rperm.gather_indices(), device=b.device)]
        return qr.solve(b)


def _initial_x(cams0, pts0, device, dtype) -> torch.Tensor:
    x0 = np.concatenate([np.asarray(pts0).reshape(-1), np.asarray(cams0).reshape(-1)])
    return _device.as_tensor(x0, device, dtype)


def fit_bundle(
    cams0: np.ndarray,
    pts0: np.ndarray,
    uv: np.ndarray,
    config: Optional[LMConfig] = None,
    *,
    device=None,
    dtype=torch.float64,
) -> LMResult:
    """LM bundle adjustment from an initial guess (cams0, pts0): the host LM
    loop over the class-based solver composition.  Host data goes to
    ``device`` (default CUDA) in ``dtype``."""
    step = _BundleStep(np.asarray(uv), device=device, dtype=dtype)
    uvd = step.uv
    return levenberg_marquardt(
        lambda x: residuals(x, uvd), step, _initial_x(cams0, pts0, uvd.device, dtype),
        config or LMConfig(max_iters=50),
    )


def _own_points(x: torch.Tensor, n_cams: int, mesh, axis: str) -> torch.Tensor:
    """The parameters a rank's residuals read: its points' coordinates,
    then every camera (``x`` is the global ``[3P + 6C]``)."""
    n_pts = (x.shape[0] - 6 * n_cams) // 3
    lo, hi = shard_bounds(n_pts, mesh, axis)
    return torch.cat([x[3 * lo : 3 * hi], x[3 * n_pts :]])


@functools.lru_cache(maxsize=8)
def _camera_scatter(n_cams: int, device: torch.device):
    """The (row, column) of each ``jc`` entry of a point in its ``[2C, 6C]``
    camera block, as index tensors on ``device``, built once (a capture
    refuses the copy from the host)."""
    c, k, j = np.meshgrid(np.arange(n_cams), np.arange(2), np.arange(6), indexing="ij")
    return (torch.as_tensor((2 * c + k).ravel(), device=device),
            torch.as_tensor((6 * c + j).ravel(), device=device))


def _damped_step(x, r, lam, uv, n_shards: int, mesh=None, axis: str = "dp"):
    """The work of :func:`_make_damped_step`'s step."""
    n_pts, n_cams = uv.shape[0], uv.shape[1]
    if mesh is not None:
        x = _own_points(x, n_cams, mesh, axis)
    brows = 2 * n_cams + 3
    c6 = 6 * n_cams
    jp, jc = _jacobian_blocks(x, uv)
    left_d, rhs = _damped_left_rhs(jp, r, lam, n_cams)
    dt, dev = left_d.dtype, left_d.device
    # per-point camera block [2C, 6C] scattered from jc [P, C, 2, 6]
    rows, cols = _camera_scatter(n_cams, dev)
    a2p = torch.zeros((n_pts, 2 * n_cams, c6), dtype=dt, device=dev)
    a2p[:, rows, cols] = jc.reshape(n_pts, -1)
    a2_blocks = torch.cat([a2p, a2p.new_zeros((n_pts, 3, c6))], dim=1).reshape(n_pts * brows, c6)
    sl = torch.sqrt(torch.as_tensor(lam, dtype=dt, device=dev))
    a2 = torch.cat([a2_blocks, sl * torch.eye(c6, dtype=dt, device=dev)])
    b = torch.cat([rhs, rhs.new_zeros(c6)])
    return block_angular_lstsq(left_d, a2, b, n_shards=n_shards, tail=c6, mesh=mesh, axis=axis)


@functools.lru_cache(maxsize=8)
def _make_damped_step(n_shards: int, mesh=None, axis: str = "dp"):
    """The damped bundle step with no host read: the camera block assembled
    as a dense ``[n1 + 6C, 6C]`` operand on the device (6C columns: dense is
    the right layout at this width) and solved by the fused
    :func:`~qrkit_tpu_torch.functional.block_angular_lstsq`, ``n_shards``
    passed on (with ``mesh=`` the ranks' count, ``uv`` and ``r`` being the
    rank's points and the step global).  With
    ``mesh=`` the step is one captured program on the card holding the
    step's all-gathers (the reference jits the sharded step whole)."""
    if mesh is None:
        def step(x, r, lam, uv):
            return _damped_step(x, r, lam, uv, n_shards)

        return step
    programs = Programs(limit=4)

    def sharded_step(x, r, lam, uv):
        return programs.solve(
            None, "bundle._damped_step", (n_shards, axis),
            lambda _, *a: _damped_step(*a, n_shards, mesh, axis),
            x, r, _as_lam(lam, x), uv, mesh=mesh, axis=axis,
        )

    return sharded_step


_damped_step_device = _make_damped_step(1)


def _residuals_aux(x, uv):
    return residuals(x, uv)


def _residuals_own(x, uv, *, mesh, axis: str):
    """A rank's residuals: its points' observations ``uv``."""
    return residuals(_own_points(x, uv.shape[1], mesh, axis), uv)


def fit_bundle_device(
    cams0: np.ndarray,
    pts0: np.ndarray,
    uv: np.ndarray,
    config: Optional[LMConfig] = None,
    mesh=None,
    axis: str = "dp",
    *,
    device=None,
    dtype=torch.float64,
) -> LMResult:
    """Bundle adjustment with the LM state on the device: damped step,
    acceptance, λ adaptation and convergence checks run with no host read
    inside an iteration.  On the card a fit is one captured loop
    (:func:`~qrkit_tpu_torch.lm.levenberg_marquardt_device`): when warm, one
    graph launch and one fetch of the result (``lm.clear_programs()`` drops
    it).  Host data goes to ``device`` (default CUDA) in ``dtype``.

    ``mesh``/``axis`` shard the point axis over the ranks of a
    ``DeviceMesh`` (every rank passes the whole scene; the point count must
    divide over the ranks): each rank keeps its points' observations and
    block QR, the all-gather of the camera block's ``[R | Qᵀy]`` factors is
    the step's only collective, and the cost and gradient are all-reduced, so every rank
    returns the same :class:`LMResult`.  On the card such a fit is a
    captured loop as well, its collectives inside its graphs: when warm, one
    launch and one fetch a chunk of 8 iterations on every rank."""
    uvd = _device.as_tensor(np.asarray(uv), device, dtype)
    x0 = _initial_x(cams0, pts0, uvd.device, dtype)
    cfg = config or LMConfig(max_iters=50)
    if mesh is None:
        return levenberg_marquardt_device(_residuals_aux, _damped_step_device, x0, cfg, aux=uvd)
    residual_fn, step_fn, reduce = _mesh_fit_fns(mesh, axis)
    return levenberg_marquardt_device(residual_fn, step_fn, x0, cfg,
                                      aux=shard_leading_axis(uvd, mesh, axis), reduce=reduce)


@functools.lru_cache(maxsize=8)
def _mesh_fit_fns(mesh, axis: str):
    """(residuals, damped step, reduce) of a point-sharded fit on ``mesh``:
    the same objects from fit to fit, since they key the captured loop."""
    return (functools.partial(_residuals_own, mesh=mesh, axis=axis),
            _make_damped_step(mesh_rank(mesh, axis)[1], mesh, axis),
            functools.partial(all_reduce_sum, mesh=mesh, axis=axis))
