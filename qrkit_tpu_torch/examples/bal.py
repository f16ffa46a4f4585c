"""Bundle adjustment in the large: BAL's camera model over an observation
list, solved by the ragged block-angular step in the device LM loop.

The problems of *Bundle Adjustment in the Large* (Agarwal, Snavely, Seitz,
Szeliski, ECCV 2010; the BAL data sets) observe each point in a few of the
cameras, a different number for each point.  Their camera has 9
parameters: a Rodrigues rotation ω, a translation t, a focal length f and
radial distortion k1, k2.  Observation i of point X in camera c predicts

    P = R(ω)·X + t,   p = −P_xy / P_z,   f·(1 + k1‖p‖² + k2‖p‖⁴)·p

and its residual is that minus the measured ``(u, v)``.  The parameters
are ``x = [points (3P); cameras (9C)]``; the residual rows run point by
point (each point's observations together), two a observation.

The damped step ``min ‖[J; √λ·I] δ + [r; 0]‖`` is block-angular: a
point's rows touch its 3 columns and the 9 of each camera that sees it.
:func:`fit_bal_device` groups the points by track length into buckets
(:func:`bucket_plan`: host work once a visibility pattern, timed as
``setup_seconds()``'s ``analysis``) and solves each step with
:func:`~qrkit_tpu_torch.functional.block_angular_lstsq_ragged`: a batched
QR of each bucket's ``[2k + 3, 3]`` point blocks, their Q1ᵀ on the
compact camera slabs ``[2k + 3, 9k]``, the complement rows scattered into
the dense bottom ``[2·N_obs + 9C, 9C]`` under which the camera damping
lies, and its R-only QR (kernel K5 on the card, ``ops/tall_qr.py``).  The Jacobian blocks (``[2, 3]`` a point, ``[2, 9]``
a camera, per observation) come from ``torch.func.jacfwd``.  The fit runs
:func:`~qrkit_tpu_torch.lm.levenberg_marquardt_device`: on the card one
captured loop a fit, one launch and one fetch when warm; each step marks
its entry, its bottom assembled and its R2 and y2 done inside the loop's body
(kernel L2, ``profiling.loop_records()``'s ``marks``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _device
from ..functional import block_angular_lstsq_ragged
from ..lm import LMConfig, LMResult, levenberg_marquardt_device
from ..ops.graph_loop import mark
from ..profiling import span
from .bundle import _rodrigues

__all__ = ["CAMERA", "BucketPlan", "bucket_plan", "fit_bal_device", "jacobian_blocks",
           "make_scene", "project", "residuals", "split"]

CAMERA = 9  # ω (3), t (3), f, k1, k2


def project(cam: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """BAL's predicted image point ``[..., 2]`` of points ``X [..., 3]`` in
    cameras ``cam [..., 9]``."""
    P = (_rodrigues(cam[..., :3]) @ X[..., None])[..., 0] + cam[..., 3:6]
    p = -P[..., :2] / P[..., 2:3]
    r2 = (p * p).sum(-1, keepdim=True)
    f, k1, k2 = cam[..., 6:7], cam[..., 7:8], cam[..., 8:9]
    return f * (1.0 + k1 * r2 + k2 * r2 * r2) * p


def split(x: torch.Tensor, n_pts: int, n_cams: int):
    """``x [3P + 9C]`` → (points ``[P, 3]``, cameras ``[C, 9]``), views."""
    return x[: 3 * n_pts].reshape(n_pts, 3), x[3 * n_pts :].reshape(n_cams, CAMERA)


def residuals(x: torch.Tensor, obs_cam: torch.Tensor, obs_pt: torch.Tensor,
              uv: torch.Tensor, n_cams: int) -> torch.Tensor:
    """``[2·N]``: each observation's predicted image point minus ``uv [N,
    2]``, in the observations' order."""
    pts, cams = split(x, (x.shape[0] - CAMERA * n_cams) // 3, n_cams)
    return (project(cams[obs_cam], pts[obs_pt]) - uv).reshape(-1)


def jacobian_blocks(x: torch.Tensor, obs_cam: torch.Tensor, obs_pt: torch.Tensor,
                    n_cams: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each observation's Jacobian blocks by forward-mode AD: ``[N, 2, 3]``
    in its point's coordinates and ``[N, 2, 9]`` in its camera's."""
    pts, cams = split(x, (x.shape[0] - CAMERA * n_cams) // 3, n_cams)
    jc, jp = torch.func.vmap(torch.func.jacfwd(project, argnums=(0, 1)))(cams[obs_cam],
                                                                          pts[obs_pt])
    return jp, jc


# --- the bucket plan --------------------------------------------------------------


def bucket_widths(longest: int):
    """The track lengths the buckets are padded to, up to ``longest``: each
    length to 8, then steps of at most a quarter (a point's block grows by
    less than a quarter)."""
    widths = list(range(1, min(longest, 8) + 1))
    while widths[-1] < longest:
        widths.append(min(longest, widths[-1] + max(1, widths[-1] // 4)))
    return widths


class BucketPlan(NamedTuple):
    """The points grouped by track length (host NumPy, int64).

    ``order [N]``: the observations sorted by point (a stable sort), the
    residuals' row order.  A bucket ``(points [nb], obs [nb, k], slots [nb,
    k], dest [nb, 2k])`` holds points of track length at most ``k``:
    ``obs`` the positions of their observations in ``order`` (``N`` for a
    padded slot: a zero row), ``slots`` their cameras (a padded slot takes
    a camera that the point's track lacks, distinct), ``dest`` the bottom
    row of each complement row (``2N + 9C`` for a padding row).  ``inverse
    [P]``: each point's row in the buckets' points, concatenated."""

    order: np.ndarray
    buckets: tuple
    inverse: np.ndarray
    rows: int


def bucket_plan(obs_cam: np.ndarray, obs_pt: np.ndarray, n_pts: int, n_cams: int) -> BucketPlan:
    """The plan of one visibility pattern: ``obs_cam``, ``obs_pt [N]`` the
    camera and point of each observation.  Every point needs one
    observation at least, and a point's cameras are distinct."""
    obs_cam, obs_pt = np.asarray(obs_cam, np.int64), np.asarray(obs_pt, np.int64)
    n_obs = obs_cam.size
    if obs_pt.size != n_obs or n_obs == 0:
        raise ValueError(f"obs_cam and obs_pt must be of one length > 0, got {obs_cam.size}, "
                         f"{obs_pt.size}")
    if obs_cam.min() < 0 or obs_cam.max() >= n_cams or obs_pt.min() < 0 or obs_pt.max() >= n_pts:
        raise ValueError("an observation's camera or point lies outside the scene")
    order = np.argsort(obs_pt, kind="stable")
    track = np.bincount(obs_pt, minlength=n_pts)
    if track.min() < 1:
        raise ValueError(f"{int((track < 1).sum())} points have no observation")
    start = np.concatenate([[0], np.cumsum(track)[:-1]])
    cams_sorted = obs_cam[order]
    pairs = obs_pt[order] * n_cams + cams_sorted
    if np.unique(pairs).size != n_obs:
        raise ValueError("a point is observed twice by one camera")
    widths = np.asarray(bucket_widths(int(track.max())))
    width = widths[np.searchsorted(widths, track)]
    trash, base, buckets = 2 * n_obs + n_cams * CAMERA, 0, []
    for k in np.unique(width):
        pts = np.flatnonzero(width == k)
        nb, kp = pts.size, track[pts]
        j = np.arange(k)
        real = j[None, :] < kp[:, None]
        obs = np.where(real, start[pts, None] + j, n_obs)
        used = np.zeros((nb, n_cams), dtype=bool)
        rows_, cols_ = np.nonzero(real)
        used[rows_, cams_sorted[obs[rows_, cols_]]] = True
        spare = np.argsort(used, axis=1, kind="stable")  # each point's unused cameras first
        pad_rank = np.cumsum(~real, axis=1) - 1
        slots = np.where(real, cams_sorted[np.minimum(obs, n_obs - 1)],
                         np.take_along_axis(spare, np.maximum(pad_rank, 0), axis=1))
        i = np.arange(2 * k)
        first = base + np.concatenate([[0], np.cumsum(2 * kp)[:-1]])
        dest = np.where(i[None, :] < 2 * kp[:, None], first[:, None] + i, trash)
        base += int(2 * kp.sum())
        buckets.append((pts, obs, slots, dest))
    inverse = np.empty(n_pts, dtype=np.int64)
    inverse[np.concatenate([bk[0] for bk in buckets])] = np.arange(n_pts)
    return BucketPlan(order, tuple(buckets), inverse, 2 * n_obs)


# the device plans of the patterns last fitted, newest last: (point and
# camera counts, device, obs_cam, obs_pt, plan)
_PLANS: list = []
_PLANS_KEPT = 4


def _device_plan(obs_cam: np.ndarray, obs_pt: np.ndarray, n_pts: int, n_cams: int, device):
    """(the observations' cameras and points in the residuals' order,
    buckets, inverse, rows) on ``device``, built once a pattern (the newest
    :data:`_PLANS_KEPT` kept): a new pattern's plan is set-up work
    (``analysis``)."""
    key = (n_pts, n_cams, str(device))
    for *k, cam, pt, plan in _PLANS:
        if tuple(k) == key and np.array_equal(cam, obs_cam) and np.array_equal(pt, obs_pt):
            return plan
    with span("qrk.setup.analysis", setup=True):
        host = bucket_plan(obs_cam, obs_pt, n_pts, n_cams)
        t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
        plan = (t(np.asarray(obs_cam)[host.order]), t(np.asarray(obs_pt)[host.order]),
                t(host.order), tuple(tuple(t(a) for a in bk[1:]) for bk in host.buckets),
                t(host.inverse), host.rows)
    _PLANS.append((*key, np.array(obs_cam, copy=True), np.array(obs_pt, copy=True), plan))
    del _PLANS[:-_PLANS_KEPT]
    return plan


# --- the fit ----------------------------------------------------------------------


def _residuals_aux(x, aux):
    obs_cam, obs_pt, uv, _, _, n_cams, _ = aux
    return residuals(x, obs_cam, obs_pt, uv, n_cams)


def _damped_step_aux(x, r, lam, aux):
    """The damped step: each bucket's point blocks ``[√λ·I3; J_pt]``, its
    compact camera slabs and rhs, then the ragged block-angular solve with
    the camera damping ``√λ·I`` under the bottom."""
    obs_cam, obs_pt, _, buckets, inverse, n_cams, rows = aux
    mark("step")
    jp, jc = jacobian_blocks(x, obs_cam, obs_pt, n_cams)
    dt, dev = x.dtype, x.device
    n_obs = obs_cam.shape[0]
    sl = torch.sqrt(lam)
    zero = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
    jp = torch.cat([jp, zero(1, 2, 3)])  # row N: a padded slot's
    jc = torch.cat([jc, zero(1, 2, CAMERA)])
    res = torch.cat([r.reshape(n_obs, 2), zero(1, 2)])
    eye3 = torch.eye(3, dtype=dt, device=dev)
    left, right, b = [], [], []
    for obs, _, _ in buckets:
        nb, k = obs.shape
        left.append(torch.cat([(sl * eye3).expand(nb, 3, 3), jp[obs].reshape(nb, 2 * k, 3)], 1))
        diag = torch.eye(k, dtype=dt, device=dev)[None, :, None, :, None]
        slab = (jc[obs][:, :, :, None, :] * diag).reshape(nb, 2 * k, CAMERA * k)
        right.append(torch.cat([zero(nb, 3, CAMERA * k), slab], 1))
        b.append(torch.cat([zero(nb, 3), -res[obs].reshape(nb, 2 * k)], 1))
    m2 = CAMERA * n_cams
    x1, x2 = block_angular_lstsq_ragged(
        left, right, [bk[1] for bk in buckets], b, [bk[2] for bk in buckets],
        sl * torch.eye(m2, dtype=dt, device=dev), zero(m2), rows, marks=("bottom", "tsqr"))
    return torch.cat([torch.cat(x1)[inverse].reshape(-1), x2])


def fit_bal_device(
    cams0: np.ndarray,
    pts0: np.ndarray,
    obs_cam: np.ndarray,
    obs_pt: np.ndarray,
    uv: np.ndarray,
    config: Optional[LMConfig] = None,
    *,
    device=None,
    dtype=torch.float32,
) -> LMResult:
    """LM bundle adjustment of a BAL problem with the state on the device:
    ``cams0 [C, 9]`` and ``pts0 [P, 3]`` the start, observation ``i`` of
    point ``obs_pt[i]`` in camera ``obs_cam[i]`` at ``uv[i]`` (host NumPy).
    On the card a fit is one captured loop
    (:func:`~qrkit_tpu_torch.lm.levenberg_marquardt_device`): when warm,
    one launch and one fetch; a pattern's first fit builds its bucket plan.
    Returns an :class:`LMResult` whose
    ``x`` is ``[3P + 9C]`` (:func:`split`)."""
    cams0, pts0 = np.asarray(cams0), np.asarray(pts0)
    n_cams, n_pts = cams0.shape[0], pts0.shape[0]
    if cams0.shape != (n_cams, CAMERA) or pts0.shape != (n_pts, 3):
        raise ValueError(f"cams0 must be [C, 9] and pts0 [P, 3], got {cams0.shape}, {pts0.shape}")
    obs_cam, obs_pt = np.asarray(obs_cam), np.asarray(obs_pt)
    dev = _device.resolve(device)
    with span("qrk.fit.plan"):
        cam_d, pt_d, order, buckets, inverse, rows = _device_plan(obs_cam, obs_pt, n_pts, n_cams,
                                                                  dev)
    with span("qrk.fit.upload"):
        x0 = _device.as_tensor(np.concatenate([pts0.reshape(-1), cams0.reshape(-1)]), dev, dtype)
        uvd = _device.as_tensor(np.asarray(uv).reshape(-1, 2), dev, dtype)[order]
    aux = (cam_d, pt_d, uvd, buckets, inverse, n_cams, rows)
    return levenberg_marquardt_device(_residuals_aux, _damped_step_aux, x0,
                                      config or LMConfig(max_iters=50), aux=aux)


def make_scene(n_cams: int = 6, n_pts: int = 300, tracks=(2, 6), noise: float = 1.0,
               seed: int = 0):
    """A small BAL scene for tests and demos (host NumPy, float64):
    cameras on a ring of radius 20 around a point cloud of radius 4,
    looking at its centre (every observation has P_z < 0), f in [800,
    1200], small distortion; each point seen by a uniform number of
    distinct cameras in ``tracks`` (inclusive).  Returns (cams [C, 9],
    pts [P, 3], obs_cam [N], obs_pt [N], uv [N, 2]): the truth and its
    observations with ``noise`` pixels of Gaussian noise."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4.0, 4.0, (n_pts, 3))
    cams = np.zeros((n_cams, CAMERA))
    for c in range(n_cams):
        a = 2.0 * np.pi * c / n_cams
        centre = np.array([20.0 * np.cos(a), 20.0 * np.sin(a), 2.0])
        z = centre / np.linalg.norm(centre)  # the camera's +z points away from the scene
        xax = np.cross([0.0, 0.0, 1.0], z)
        xax /= np.linalg.norm(xax)
        R = np.stack([xax, np.cross(z, xax), z])  # world → camera rows
        cams[c, :3] = _axis_angle(R)
        cams[c, 3:6] = -R @ centre
        cams[c, 6] = rng.uniform(800.0, 1200.0)
        cams[c, 7:9] = rng.normal(0.0, [0.05, 0.01])
    k = rng.integers(tracks[0], tracks[1] + 1, size=n_pts)
    obs_pt = np.repeat(np.arange(n_pts), k)
    obs_cam = np.concatenate([rng.permutation(n_cams)[:kk] for kk in k])
    with torch.no_grad():
        uv = project(torch.as_tensor(cams[obs_cam]), torch.as_tensor(pts[obs_pt])).numpy()
    return cams, pts, obs_cam, obs_pt, uv + noise * rng.normal(size=uv.shape)


def _axis_angle(R: np.ndarray) -> np.ndarray:
    """The Rodrigues vector of a rotation matrix, through its unit
    quaternion (Shepperd's choice of the largest component)."""
    t = np.trace(R)
    d = np.diag(R)
    i = int(np.argmax(np.concatenate([[t], d])))
    if i == 0:
        w = 0.5 * np.sqrt(1.0 + t)
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (4.0 * w)
    else:
        a = i - 1
        b, c = (a + 1) % 3, (a + 2) % 3
        v = np.zeros(3)
        v[a] = 0.5 * np.sqrt(1.0 + 2.0 * R[a, a] - t)
        w = (R[c, b] - R[b, c]) / (4.0 * v[a])
        v[b] = (R[a, b] + R[b, a]) / (4.0 * v[a])
        v[c] = (R[a, c] + R[c, a]) / (4.0 * v[a])
    if w < 0:
        w, v = -w, -v
    s = np.linalg.norm(v)
    return v * (2.0 * np.arctan2(s, w) / s) if s > 1e-15 else 2.0 * v
