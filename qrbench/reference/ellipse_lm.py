"""Plain Levenberg–Marquardt ellipse fit with latent correspondences.

The model of QRkit's ellipse benchmark (arXiv 1802.03773): points
``(X_i, Y_i)`` on an ellipse ``(a, b, x0, y0, r)``, one latent angle ``t_i``
per point, residual ``[X_i - x(t_i), Y_i - y(t_i)]``.  The damped step
``min ‖J δ + r‖² + λ‖δ‖²`` is solved by the normal equations with the
latent block eliminated (a Schur complement on the 5 model parameters), not
by a QR: an independent route to the same step.  λ follows the
Madsen–Nielsen gain-ratio rule and the loop stops on a small step or a
small cost reduction, as the LM driver under test states it.

``precision="float64"`` is the reference; ``"bfloat16"`` is the control:
every per-point quantity and every sum in bfloat16, only the 5×5 solve
lifted to float32 (PyTorch has no bfloat16 solve).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

ARC = 1.3 * math.pi


@dataclasses.dataclass(frozen=True)
class LMSettings:
    max_iters: int = 40
    ftol: float = 1e-8
    xtol: float = 1e-8
    lambda_init: float = 1e-3
    lambda_min: float = 1e-12
    lambda_max: float = 1e10


def initial_guess(pts: np.ndarray) -> np.ndarray:
    """Bounding-box start: half extents as axes, the box centre, r = 0, and
    the latent angles spread uniformly over the sampled arc."""
    n = pts.shape[1]
    x = np.zeros(n + 5)
    x[:n] = np.arange(n) * (ARC / n)
    x[n] = 0.5 * (pts[0].max() - pts[0].min())
    x[n + 1] = 0.5 * (pts[1].max() - pts[1].min())
    x[n + 2] = 0.5 * (pts[0].max() + pts[0].min())
    x[n + 3] = 0.5 * (pts[1].max() + pts[1].min())
    return x


def canonical(x: np.ndarray, n: int) -> np.ndarray:
    """The same ellipse with a ≥ |b|, a > 0 and r in [0, π]."""
    p = np.array(x, dtype=np.float64)
    if abs(p[n + 1]) > abs(p[n]):
        p[n], p[n + 1] = p[n + 1], p[n]
        p[n + 4] -= 0.5 * math.pi
    if p[n] < 0:
        p[n] *= -1.0
        p[n + 1] *= -1.0
        p[n + 4] += math.pi
    p[n + 4] = math.fmod(p[n + 4], math.pi)
    if p[n + 4] < 0:
        p[n + 4] += math.pi
    return p


def _parts(x, n):
    t = x[:n]
    a, b, x0, y0, r = (x[n + k] for k in range(5))
    return torch.cos(t), torch.sin(t), torch.cos(r), torch.sin(r), a, b, x0, y0


def residuals(x: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``[2, n]``: the data minus the model point at each latent angle."""
    ct, st, cr, sr, a, b, x0, y0 = _parts(x, pts.shape[1])
    return torch.stack([pts[0] - (a * ct * cr - b * st * sr + x0),
                        pts[1] - (a * ct * sr + b * st * cr + y0)])


def jacobian(x: torch.Tensor, pts: torch.Tensor):
    """``d [2, n]``: ∂r_i/∂t_i; ``e [2, 5, n]``: ∂r_i/∂(a, b, x0, y0, r)."""
    ct, st, cr, sr, a, b, _, _ = _parts(x, pts.shape[1])
    d = torch.stack([a * st * cr + b * ct * sr, a * st * sr - b * ct * cr])
    one, zero = torch.ones_like(ct), torch.zeros_like(ct)
    e = torch.stack([
        torch.stack([-ct * cr, st * sr, -one, zero, a * ct * sr + b * st * cr]),
        torch.stack([-ct * sr, -st * cr, zero, -one, -a * ct * cr + b * st * sr]),
    ])
    return d, e


def damped_step(x, pts, r, lam):
    """(δ, g): the minimiser of ‖J δ + r‖² + λ‖δ‖² and the gradient Jᵀr."""
    n = pts.shape[1]
    d, e = jacobian(x, pts)
    a = (d * d).sum(0) + lam                       # [n]
    u = (e * d[:, None, :]).sum(0)                 # [5, n] = E_iᵀ d_i
    gt = (d * r).sum(0)                            # [n]
    gp = (e * r[:, None, :]).sum((0, 2))           # [5]
    ete = torch.einsum("kin,kjn->ij", e, e)        # [5, 5]
    s = ete + lam * torch.eye(5, dtype=x.dtype, device=x.device) - (u / a) @ u.T
    rhs = -gp + (u * (gt / a)).sum(1)
    solve_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    dp = torch.linalg.solve(s.to(solve_dtype), rhs.to(solve_dtype)).to(x.dtype)
    dt = (-gt - (u * dp[:, None]).sum(0)) / a
    return torch.cat([dt, dp]), torch.cat([gt, gp])


def fit(pts: np.ndarray, settings: LMSettings = LMSettings(), precision: str = "float64",
        device="cpu"):
    """LM from :func:`initial_guess`; returns (x canonical as float64 NumPy,
    iterations, converged)."""
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}[precision]
    n = pts.shape[1]
    p = torch.as_tensor(np.asarray(pts), dtype=dtype, device=device)
    x = torch.as_tensor(initial_guess(np.asarray(pts)), dtype=dtype, device=device)
    r = residuals(x, p)
    cost = 0.5 * (r * r).sum()
    lam, nu = settings.lambda_init, 2.0
    done, it = False, 0
    while it < settings.max_iters and not done:
        delta, g = damped_step(x, p, r, torch.as_tensor(lam, dtype=dtype, device=device))
        x_new = x + delta
        r_new = residuals(x_new, p)
        cost_new = 0.5 * (r_new * r_new).sum()
        c, c_new = float(cost), float(cost_new)
        dd = float((delta * delta).sum())
        predicted = max(0.5 * (lam * dd - float((delta * g).sum())), 1e-30)
        rho = (c - c_new) / predicted
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
    return canonical(x.double().cpu().numpy(), n), it, done
