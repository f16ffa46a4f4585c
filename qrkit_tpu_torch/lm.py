"""Levenberg–Marquardt drivers over structured QR solvers, on torch tensors.

Counterpart of ``qrkit_tpu/lm.py`` (``predicted_reduction``, ``LMConfig``,
``LMResult``, ``levenberg_marquardt``, ``levenberg_marquardt_device``,
``levenberg_marquardt_device_batch``).  The step minimizes ``‖[J; √λ·D] δ +
[r; 0]‖`` with the damping rows placed in the Jacobian's block structure, so
one structure plan serves every iteration; λ adapts by the Madsen–Nielsen
gain ratio with ``g = Jᵀr`` from one ``torch.func.vjp`` of the residual
function.

* :func:`levenberg_marquardt` is the host loop: every acceptance decision
  is read on the host.
* :func:`levenberg_marquardt_device` keeps the whole state (x, r, cost, λ,
  ν, iteration, done) on the device; the reference's ``lax.while_loop``
  body becomes one Python loop iteration whose accept/reject choices are
  ``torch.where`` selects.  The only host read per iteration is the ``done``
  flag that ends the loop (counted in
  ``levenberg_marquardt_device.host_reads``).
* :func:`levenberg_marquardt_device_batch` runs the same loop over a
  leading problem axis (the per-problem functions under ``torch.func.vmap``):
  finished problems hold their state while the others iterate, so each
  problem follows its solo trajectory.  The solo driver is that loop with
  one problem.

Residuals sharded over the ranks of a mesh (bundle adjustment's point axis)
make the cost and ``g = Jᵀr`` per-rank partial sums: the solo driver takes
a ``reduce`` hook (an all-reduce) that sums them, so that every rank holds
the same cost, acceptance, λ and ``done`` flag and the ranks never diverge.
Collectives do not run under ``torch.func.vmap``: the batch driver has no
such hook.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import _device

__all__ = [
    "LMConfig",
    "LMResult",
    "predicted_reduction",
    "levenberg_marquardt",
    "levenberg_marquardt_device",
    "levenberg_marquardt_device_batch",
]


def predicted_reduction(delta, g, lam):
    """Madsen–Nielsen predicted cost reduction of the damped LM step,
    ``0.5 δᵀ(λδ − g)`` with gradient ``g = Jᵀr`` (over the last axis).  For
    the exact damped minimizer this equals the Gauss–Newton model reduction
    ``0.5(‖r‖² − ‖r + Jδ‖²)``, so the gain ratio is exactly 1 on a problem
    with linear residuals."""
    return 0.5 * (lam * (delta * delta).sum(-1) - (delta * g).sum(-1))


@dataclasses.dataclass
class LMConfig:
    max_iters: int = 100
    ftol: float = 1e-10
    xtol: float = 1e-10
    gtol: float = 1e-12
    lambda_init: float = 1e-3
    lambda_min: float = 1e-12
    lambda_max: float = 1e10


class LMResult(NamedTuple):
    x: object
    cost: object
    iterations: object
    converged: object
    lambda_final: object


def levenberg_marquardt(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    damped_step_fn: Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor],
    x0: torch.Tensor,
    config: Optional[LMConfig] = None,
) -> LMResult:
    """Host-loop LM.  ``damped_step_fn(x, r, lam)`` returns the least-squares
    minimizer of ``‖J(x) δ + r‖² + lam ‖δ‖²``, typically by a structured QR
    of the damped Jacobian (see :mod:`qrkit_tpu_torch.examples.ellipse`)."""
    cfg = config or LMConfig()
    x = _device.as_tensor(x0)
    r = residual_fn(x)
    cost = float(0.5 * (r * r).sum())
    lam = cfg.lambda_init
    nu = 2.0
    converged = False
    it = 0
    g = None  # Jᵀr at the current (x, r), kept across rejected steps
    vjp_ok = True  # residual_fn may be host/NumPy code (not differentiable)
    for it in range(1, cfg.max_iters + 1):
        delta = damped_step_fn(x, r, lam)
        x_new = x + delta
        r_new = residual_fn(x_new)
        cost_new = float(0.5 * (r_new * r_new).sum())
        # gain ratio: predicted = 0.5 δᵀ(λδ − g), g = Jᵀr from one VJP,
        # computed only when (x, r) changed; a residual function that cannot
        # be differentiated falls back to the damping-only model (it
        # over-estimates rho, and acceptance still needs a lower cost)
        if g is None and vjp_ok:
            try:
                g = torch.func.vjp(residual_fn, x)[1](r)[0]
            except Exception:
                vjp_ok = False
        if g is not None:
            predicted = max(float(predicted_reduction(delta, g, lam)), 1e-300)
        else:
            predicted = max(0.5 * lam * float((delta * delta).sum()), 1e-300)
        rho = (cost - cost_new) / predicted

        if cost_new < cost:  # accept
            step_small = float(torch.linalg.norm(delta)) <= cfg.xtol * (
                float(torch.linalg.norm(x)) + cfg.xtol
            )
            cost_red_small = (cost - cost_new) <= cfg.ftol * max(cost, 1e-300)
            x, r, cost = x_new, r_new, cost_new
            g = None
            lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), cfg.lambda_min)
            nu = 2.0
            if step_small or cost_red_small:
                converged = True
                break
        else:
            lam = min(lam * nu, cfg.lambda_max)
            nu = min(nu * 2.0, 64.0)
            if lam >= cfg.lambda_max:
                break
    return LMResult(x, cost, it, converged, lam)


def _minimize_batch(residual_fn, damped_step_fn, x0: torch.Tensor, aux, cfg: LMConfig,
                    reduce=None):
    """The device loop over a leading problem axis: ``residual_fn(x [B, n],
    aux) → r [B, m]`` and ``damped_step_fn(x, r, lam [B], aux) → δ [B, n]``;
    ``reduce`` sums a per-rank partial sum over the ranks (None: one device).
    Returns the final state ``(x, cost, lam, it, done)``, all on the device."""
    dt, dev = x0.dtype, x0.device
    total = reduce if reduce is not None else (lambda t: t)
    B = x0.shape[0]
    x = x0
    r = residual_fn(x, aux)
    cost = total(0.5 * (r * r).sum(-1))
    lam = torch.full((B,), cfg.lambda_init, dtype=dt, device=dev)
    nu = torch.full((B,), 2.0, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(cfg.max_iters):
        delta = damped_step_fn(x, r, lam, aux)
        x_new = x + delta
        r_new = residual_fn(x_new, aux)
        cost_new = total(0.5 * (r_new * r_new).sum(-1))
        accept = cost_new < cost

        # Madsen–Nielsen predicted reduction 0.5 δᵀ(λδ − g), g = Jᵀr by VJP
        g = total(torch.func.vjp(lambda xx: residual_fn(xx, aux), x)[1](r)[0])
        predicted = torch.clamp_min(predicted_reduction(delta, g, lam), 1e-30)
        rho = (cost - cost_new) / predicted
        shrink = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
        lam_acc = torch.clamp_min(lam * shrink, cfg.lambda_min)
        lam_rej = torch.clamp_max(lam * nu, cfg.lambda_max)
        nu_rej = torch.clamp_max(nu * 2.0, 64.0)

        step_small = torch.sqrt((delta * delta).sum(-1)) <= cfg.xtol * (
            torch.linalg.norm(x, dim=-1) + cfg.xtol
        )
        cost_small = (cost - cost_new) <= cfg.ftol * torch.clamp_min(cost, 1e-30)
        done_new = torch.where(accept, step_small | cost_small, lam_rej >= cfg.lambda_max)

        # finished problems hold their state
        live = ~done
        take = live & accept
        x = torch.where(take[:, None], x_new, x)
        r = torch.where(take[:, None], r_new, r)
        cost = torch.where(take, cost_new, cost)
        lam = torch.where(live, torch.where(accept, lam_acc, lam_rej), lam)
        nu = torch.where(live, torch.where(accept, torch.full_like(nu, 2.0), nu_rej), nu)
        it = it + live.to(torch.int32)
        done = done | (live & done_new)
        levenberg_marquardt_device.host_reads += 1
        if bool(done.all()):  # the one host read of the iteration
            break
    return x, cost, lam, it, done


def _fetch(x, cost, lam, it, done):
    """The final state on the host: x as NumPy, the scalars as NumPy arrays."""
    scal = torch.stack([cost, lam, it.to(cost.dtype), done.to(cost.dtype)]).cpu().numpy()
    return x.cpu().numpy(), scal[0], scal[1], scal[2].astype(np.int64), scal[3] > 0.5


def levenberg_marquardt_device(
    residual_fn: Callable,
    damped_step_fn: Callable,
    x0: torch.Tensor,
    config: Optional[LMConfig] = None,
    aux=None,
    *,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> LMResult:
    """LM with its state on the device: ``residual_fn(x, aux)`` and
    ``damped_step_fn(x, r, lam, aux)`` (``lam`` a 0-d device tensor) run
    with no host read inside an iteration; the loop reads one ``done`` flag
    per iteration, and the result is fetched once at the end.  Per-problem
    data (points, measurements, ...) travels through ``aux``.

    ``reduce`` is for residuals sharded over the ranks of a mesh: each rank's
    ``residual_fn`` returns its own residuals, and ``reduce`` (an all-reduce
    sum, e.g. ``functools.partial(parallel.mesh.all_reduce_sum, mesh=m)``)
    turns the cost and ``Jᵀr`` into global sums.  ``x`` and the step stay
    global, so every rank takes the same decisions and returns the same
    result.

    Returns an :class:`LMResult` of host values (x as NumPy)."""
    cfg = config or LMConfig()
    x, cost, lam, it, done = _fetch(*_minimize_batch(
        lambda x, aux: residual_fn(x[0], aux)[None],
        lambda x, r, lam, aux: damped_step_fn(x[0], r[0], lam[0], aux)[None],
        _device.as_tensor(x0)[None], aux, cfg, reduce,
    ))
    return LMResult(x[0], float(cost[0]), int(it[0]), bool(done[0]), float(lam[0]))


levenberg_marquardt_device.host_reads = 0


def levenberg_marquardt_device_batch(
    residual_fn: Callable,
    damped_step_fn: Callable,
    x0_batch: torch.Tensor,
    config: Optional[LMConfig] = None,
    aux_batch=None,
) -> LMResult:
    """B independent fits in one device loop: the per-problem functions of
    :func:`levenberg_marquardt_device` under ``torch.func.vmap`` over a
    leading problem axis.  The loop runs while any problem is unfinished;
    finished problems hold their state, so each follows its solo
    trajectory.

    ``x0_batch`` is ``[B, n]`` (``aux_batch`` ``[B, ...]``); returns an
    :class:`LMResult` of NumPy arrays: ``x [B, n]``, ``cost [B]``,
    ``iterations [B]``, ``converged [B]``, ``lambda_final [B]``."""
    cfg = config or LMConfig()
    aux_dim = None if aux_batch is None else 0
    rf = torch.func.vmap(residual_fn, in_dims=(0, aux_dim))
    sf = torch.func.vmap(damped_step_fn, in_dims=(0, 0, 0, aux_dim))
    x, cost, lam, it, done = _fetch(
        *_minimize_batch(rf, sf, _device.as_tensor(x0_batch), aux_batch, cfg)
    )
    return LMResult(x, cost, it, done, lam)
