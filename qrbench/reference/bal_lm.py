"""Plain Levenberg–Marquardt bundle adjustment of a BAL problem.

The model of *Bundle Adjustment in the Large* (Agarwal et al., ECCV 2010):
a camera ``(ω, t, f, k1, k2)`` sees point X at

    P = R(ω)·X + t,   p = −P_xy / P_z,   f·(1 + k1‖p‖² + k2‖p‖⁴)·p

(R(ω) by Rodrigues' formula, as Ceres's ``AngleAxisRotatePoint``), and an
observation's residual is that minus its ``(u, v)``.  Parameters ``x =
[points (3P); cameras (9C)]``.  The Jacobian comes from ``torch.func``.

The damped step ``min ‖J δ + r‖² + λ‖δ‖²`` is solved by the normal
equations with the points eliminated (the Schur complement): per point its
3×3 block ``V_p = Σ J_pᵀJ_p + λI``, then the reduced camera system ``S =
U + λI − Σ_p W_pᵀ V_p⁻¹ W_p`` (9C × 9C) by Cholesky, then each point's
step.  No QR: an independent route to the same step.  λ follows the
Madsen–Nielsen gain ratio with identity damping, and the loop stops on a
small step (xtol) or a small cost reduction (ftol), as the LM driver under
test states it.

``precision="float64"`` is the reference; ``"bfloat16"`` is the control:
the model, the Jacobian and every sum in bfloat16, only the solves (the
3×3 blocks and the camera system) lifted to float32 (PyTorch has no
bfloat16 solve).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

CAMERA = 9
PAIR_CHUNK = 1 << 24  # entries of the point-pair camera blocks summed at a time


@dataclasses.dataclass(frozen=True)
class LMSettings:
    max_iters: int = 50
    ftol: float = 1e-6
    xtol: float = 1e-8
    lambda_init: float = 1e-3
    lambda_min: float = 1e-12
    lambda_max: float = 1e10


def rotate(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """R(w)·X for axis-angle ``w [..., 3]``: Rodrigues' formula, and its
    first order ``X + w × X`` near w = 0."""
    th2 = (w * w).sum(-1, keepdim=True)
    small = th2 < 1e-16
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    k = w / th
    c, s = torch.cos(th), torch.sin(th)
    kx = torch.linalg.cross(k, X)
    full = X * c + kx * s + k * ((k * X).sum(-1, keepdim=True) * (1.0 - c))
    return torch.where(small, X + torch.linalg.cross(w, X), full)


def project(cam: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    P = rotate(cam[..., :3], X) + cam[..., 3:6]
    p = -P[..., :2] / P[..., 2:3]
    r2 = (p * p).sum(-1, keepdim=True)
    return cam[..., 6:7] * (1.0 + cam[..., 7:8] * r2 + cam[..., 8:9] * r2 * r2) * p


def _split(x, n_cams):
    n_pts = (x.shape[0] - CAMERA * n_cams) // 3
    return x[: 3 * n_pts].reshape(n_pts, 3), x[3 * n_pts :].reshape(n_cams, CAMERA)


def predicted(x: torch.Tensor, obs_cam, obs_pt, n_cams: int) -> torch.Tensor:
    """``[N, 2]``: each observation's predicted image point."""
    pts, cams = _split(x, n_cams)
    return project(cams[obs_cam], pts[obs_pt])


def residuals(x, obs_cam, obs_pt, uv, n_cams):
    return predicted(x, obs_cam, obs_pt, n_cams) - uv


def jacobian(x, obs_cam, obs_pt, n_cams):
    """``(jp [N, 2, 3], jc [N, 2, 9])``: each residual's Jacobian in its
    point and its camera."""
    pts, cams = _split(x, n_cams)
    jc, jp = torch.func.vmap(torch.func.jacfwd(project, argnums=(0, 1)))(cams[obs_cam],
                                                                          pts[obs_pt])
    return jp, jc


class Tracks:
    """The observations grouped by point, by track length: for each length
    k, the points ``[nb]`` and their observations ``[nb, k]``."""

    def __init__(self, obs_pt: np.ndarray, n_pts: int, device):
        order = np.argsort(obs_pt, kind="stable")
        count = np.bincount(obs_pt, minlength=n_pts)
        start = np.concatenate([[0], np.cumsum(count)[:-1]])
        self.groups = []
        for k in np.unique(count[count > 0]):
            pts = np.flatnonzero(count == k)
            obs = order[start[pts, None] + np.arange(k)]
            self.groups.append((torch.as_tensor(pts, device=device),
                                torch.as_tensor(obs, device=device)))


def damped_step(x, r, lam, obs_cam, obs_pt, tracks: Tracks, n_cams: int):
    """(δ, g): the minimiser of ‖J δ + r‖² + λ‖δ‖² by the Schur complement
    on the cameras, and the gradient g = Jᵀr."""
    dt, dev = x.dtype, x.device
    solve_dt = torch.float32 if dt == torch.bfloat16 else dt
    jp, jc = jacobian(x, obs_cam, obs_pt, n_cams)
    n_pts = (x.shape[0] - CAMERA * n_cams) // 3
    m2 = CAMERA * n_cams
    V = torch.zeros((n_pts, 3, 3), dtype=dt, device=dev).index_add_(0, obs_pt, jp.mT @ jp)
    V = V + lam * torch.eye(3, dtype=dt, device=dev)
    U = torch.zeros((n_cams, CAMERA, CAMERA), dtype=dt, device=dev).index_add_(
        0, obs_cam, jc.mT @ jc)
    W = jp.mT @ jc                                                   # [N, 3, 9]
    gp = torch.zeros((n_pts, 3), dtype=dt, device=dev).index_add_(
        0, obs_pt, (jp.mT @ r[..., None])[..., 0])
    gc = torch.zeros((n_cams, CAMERA), dtype=dt, device=dev).index_add_(
        0, obs_cam, (jc.mT @ r[..., None])[..., 0])
    Vinv = torch.linalg.inv(V.to(solve_dt)).to(dt)
    S = torch.zeros((n_cams, n_cams, CAMERA, CAMERA), dtype=dt, device=dev)
    S[torch.arange(n_cams), torch.arange(n_cams)] = U
    S = S.reshape(n_cams * n_cams, CAMERA, CAMERA)
    for pts, obs in tracks.groups:
        k = obs.shape[1]
        step = max(1, PAIR_CHUNK // (k * k * CAMERA * CAMERA))
        for lo in range(0, pts.shape[0], step):
            p, o = pts[lo : lo + step], obs[lo : lo + step]
            Wk = W[o]                                                # [nb, k, 3, 9]
            VW = Vinv[p][:, None] @ Wk                               # [nb, k, 3, 9]
            blocks = Wk.mT[:, :, None] @ VW[:, None]                 # [nb, k, k, 9, 9]
            c = obs_cam[o]
            pair = (c[:, :, None] * n_cams + c[:, None, :]).reshape(-1)
            S.index_add_(0, pair, -blocks.reshape(-1, CAMERA, CAMERA))
    S = S.reshape(n_cams, n_cams, CAMERA, CAMERA).transpose(1, 2).reshape(m2, m2)
    S = S + lam * torch.eye(m2, dtype=dt, device=dev)
    vg = (Vinv @ gp[..., None])[..., 0]                              # V⁻¹ g_p
    rhs = -gc.reshape(-1) + torch.zeros((n_cams, CAMERA), dtype=dt, device=dev).index_add_(
        0, obs_cam, (W.mT @ vg[obs_pt][..., None])[..., 0]).reshape(-1)
    S32, rhs32 = S.to(solve_dt), rhs.to(solve_dt)
    L, info = torch.linalg.cholesky_ex(S32)
    if int(info) == 0:
        dc = torch.cholesky_solve(rhs32[:, None], L)[:, 0]
    else:  # not positive definite in this precision
        dc = torch.linalg.lstsq(S32, rhs32[:, None]).solution[:, 0]
    dc = dc.to(dt)
    wd = torch.zeros((n_pts, 3), dtype=dt, device=dev).index_add_(
        0, obs_pt, (W @ dc.reshape(n_cams, CAMERA)[obs_cam][..., None])[..., 0])
    dp = -(Vinv @ (gp + wd)[..., None])[..., 0]
    return torch.cat([dp.reshape(-1), dc]), torch.cat([gp.reshape(-1), gc.reshape(-1)])


def fit(cams0: np.ndarray, pts0: np.ndarray, obs_cam: np.ndarray, obs_pt: np.ndarray,
        uv: np.ndarray, settings: LMSettings = LMSettings(), precision: str = "float64",
        device="cpu"):
    """LM from ``(cams0 [C, 9], pts0 [P, 3])``; returns (x ``[3P + 9C]`` as
    float64 NumPy, iterations, converged, final cost).  TF32 is turned off
    for the process (the control's float32 solves stay float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}[precision]
    n_cams, n_pts = len(cams0), len(pts0)
    oc = torch.as_tensor(np.asarray(obs_cam), dtype=torch.int64, device=device)
    op = torch.as_tensor(np.asarray(obs_pt), dtype=torch.int64, device=device)
    tracks = Tracks(np.asarray(obs_pt), n_pts, device)
    u = torch.as_tensor(np.asarray(uv), dtype=dtype, device=device)
    x = torch.as_tensor(np.concatenate([np.ravel(pts0), np.ravel(cams0)]), dtype=dtype,
                        device=device)
    r = residuals(x, oc, op, u, n_cams)
    cost = 0.5 * (r * r).sum()
    lam, nu = settings.lambda_init, 2.0
    done, it = False, 0
    while it < settings.max_iters and not done:
        delta, g = damped_step(x, r, torch.as_tensor(lam, dtype=dtype, device=device), oc, op,
                               tracks, n_cams)
        x_new = x + delta
        r_new = residuals(x_new, oc, op, u, n_cams)
        cost_new = 0.5 * (r_new * r_new).sum()
        c, c_new = float(cost), float(cost_new)
        dd = float((delta.double() ** 2).sum())
        predicted_red = max(0.5 * (lam * dd - float((delta.double() * g.double()).sum())), 1e-30)
        rho = (c - c_new) / predicted_red
        it += 1
        if c_new < c:
            done = (math.sqrt(dd) <= settings.xtol * (float(torch.linalg.norm(x.double()))
                                                      + settings.xtol)
                    or (c - c_new) <= settings.ftol * max(c, 1e-30))
            lam = max(lam * max(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0), settings.lambda_min)
            nu = 2.0
            x, r, cost = x_new, r_new, cost_new
        else:
            lam = min(lam * nu, settings.lambda_max)
            nu = min(nu * 2.0, 64.0)
            done = lam >= settings.lambda_max
    return x.double().cpu().numpy(), it, done, float(cost)


def cost64(x: np.ndarray, obs_cam: np.ndarray, obs_pt: np.ndarray, uv: np.ndarray, n_cams: int,
           device="cpu") -> float:
    """0.5‖r(x)‖² in float64: the cost of any fit's parameters, however they
    were computed."""
    t = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa: E731
                                                    device=device)
    r = residuals(t(x), t(obs_cam, torch.int64), t(obs_pt, torch.int64), t(uv), n_cams)
    return float(0.5 * (r * r).sum())


def image_points(x: np.ndarray, obs_cam: np.ndarray, obs_pt: np.ndarray, n_cams: int,
                 device="cpu") -> np.ndarray:
    """``[N, 2]`` float64: the predicted image points of a fit's parameters
    (gauge-free, where the parameters are not)."""
    t = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa: E731
                                                    device=device)
    return predicted(t(x), t(obs_cam, torch.int64), t(obs_pt, torch.int64), n_cams).cpu().numpy()
