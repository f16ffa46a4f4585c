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
  body is one iteration (:func:`_step`) whose accept/reject choices are
  ``torch.where`` selects.  On the card a fit is one program, as in the
  reference: the loop is captured once per key (the functions, the config
  and the operands' shapes, dtypes and device, the reference's
  ``lru_cache`` key) as a CUDA graph whose conditional WHILE node replays
  the iteration while kernel L1 (:mod:`~qrkit_tpu_torch.ops.graph_loop`)
  finds ``k < max_iters`` and a problem not done (:class:`~qrkit_tpu_torch._program.LoopProgram`).
  A key's first fit runs iteration 1 eagerly (a fit that it finishes
  ends there, uncaptured) and iteration 2 as the warm-up of the capture,
  then the whole fit from ``x0`` as one launch; a later fit is one launch
  and one fetch.  At most 4 keys are kept (:func:`clear_programs`).
  A ``reduce=`` fit over a mesh is captured too, its collectives inside
  plain graphs of 8 gated iterations each (NCCL's kernels cannot sit in a
  WHILE body): one launch and one fetch a chunk.
  Elsewhere (CPU operands, operands that require grad, under
  ``_program.eager()``) the loop runs eagerly with one host read of
  ``done`` an iteration.
  ``levenberg_marquardt_device.host_reads`` counts the reads that wait on
  the loop: one an eager iteration, one fetch a captured launch.
* :func:`levenberg_marquardt_device_batch` runs the same loop over a
  leading problem axis (the per-problem functions under ``torch.func.vmap``):
  finished problems hold their state while the others iterate, so each
  problem follows its solo trajectory.  The solo driver is that loop with
  one problem.

On the card the functions must be capturable, as the reference's must be
traceable: no host read inside them (``torch.linalg.solve_ex`` rather than
``torch.linalg.solve``, which checks its factorization on the host); a
capture that fails raises with the program's name, and a fit under
``_program.eager()`` runs the eager loop.  A captured loop reads what its
functions read when it was captured: the functions key it, so a function
must not change what it computes between fits (the reference's jitted
functions are hashed the same way).  The tensors the functions hold
(closure cells, defaults, a bound method's object's attributes) are read
at their addresses: the loop keeps them alive, and a fit whose functions
hold other tensors than at capture (a rebound closure variable or
attribute) captures the loop again.  A tensor reached otherwise (a module
global) is read where it lay at capture: rebinding one is undefined.

Residuals sharded over the ranks of a mesh (bundle adjustment's point axis)
make the cost and ``g = Jᵀr`` per-rank partial sums: the solo driver takes
a ``reduce`` hook (an all-reduce) that sums them, so that every rank holds
the same cost, acceptance, λ and ``done`` flag and the ranks never diverge:
every rank's captured loop (chunks of gated iterations holding the
all-reduces) runs the same iterations.
Collectives do not run under ``torch.func.vmap``: the batch driver has no
such hook.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import _device, _program, profiling
from ._program import Loops

__all__ = [
    "LMConfig",
    "LMResult",
    "predicted_reduction",
    "levenberg_marquardt",
    "levenberg_marquardt_device",
    "levenberg_marquardt_device_batch",
    "clear_programs",
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


def _cfg_key(cfg: LMConfig):
    return (
        cfg.max_iters, cfg.ftol, cfg.xtol, cfg.gtol,
        cfg.lambda_init, cfg.lambda_min, cfg.lambda_max,
    )


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


def _start(residual_fn, x0: torch.Tensor, aux, cfg: LMConfig, total):
    """The loop's state before its first iteration: ``(x, r, cost, lam, nu,
    it, done)``, all on ``x0``'s device."""
    dt, dev = x0.dtype, x0.device
    B = x0.shape[0]
    r = residual_fn(x0, aux)
    cost = total(0.5 * (r * r).sum(-1))
    lam = torch.full((B,), cfg.lambda_init, dtype=dt, device=dev)
    nu = torch.full((B,), 2.0, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    return x0, r, cost, lam, nu, it, done


def _step(residual_fn, damped_step_fn, state, aux, cfg: LMConfig, total):
    """One iteration of the loop (the reference's ``lax.while_loop`` body):
    the new state, with no host read."""
    x, r, cost, lam, nu, it, done = state
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
    return x, r, cost, lam, nu, it, done


def _identity(t):
    return t


def _minimize_batch(residual_fn, damped_step_fn, x0: torch.Tensor, aux, cfg: LMConfig,
                    reduce=None):
    """The eager device loop over a leading problem axis: ``residual_fn(x
    [B, n], aux) → r [B, m]`` and ``damped_step_fn(x, r, lam [B], aux) → δ
    [B, n]``; ``reduce`` sums a per-rank partial sum over the ranks (None:
    one device).  One host read of ``done`` an iteration.  Returns the final
    state ``(x, r, cost, lam, nu, it, done)``, all on the device."""
    total = reduce if reduce is not None else _identity
    state = _start(residual_fn, x0, aux, cfg, total)
    for _ in range(cfg.max_iters):
        state = _step(residual_fn, damped_step_fn, state, aux, cfg, total)
        if _read_done(state[6]):
            break
    return state


def _read_done(done: torch.Tensor) -> bool:
    """The host read that ends an eager iteration: are all problems done?"""
    levenberg_marquardt_device.host_reads += 1
    return bool(done.all())


def _pack(x, cost, lam, it, done, *extra):
    """The result as one flat tensor in x's dtype (one fetch brings it to the
    host): x, cost, lam, it, done, then ``extra`` (the loop counter and L1's
    count of its evaluations)."""
    dt = x.dtype
    return torch.cat([x.reshape(-1), cost, lam, it.to(dt), done.to(dt),
                      *(t.to(dt).reshape(1) for t in extra)])


def _unpack(host: np.ndarray, B: int, n: int):
    """(x [B, n], cost, lam, it, done) from a fetched :func:`_pack`."""
    x, scal = host[: B * n].reshape(B, n), host[B * n : B * n + 4 * B].reshape(4, B)
    return x, scal[0], scal[1], scal[2].astype(np.int64), scal[3] > 0.5


def _fetch(x, r, cost, lam, nu, it, done):
    """The final state on the host, in one fetch: x as NumPy, the scalars as
    NumPy arrays (host values: no gradient flows through a fetch)."""
    return _unpack(_pack(x, cost, lam, it, done).detach().cpu().numpy(), *x.shape)


# the captured loops of the device fits, by functions, config and operands
_LOOPS = Loops(limit=4)


def clear_programs() -> None:
    """Drop the device fits' captured loops (their graphs, then their
    static buffers and graph pool)."""
    _LOOPS.clear()


def _loop_operands(name: str, x0: torch.Tensor, aux):
    """``aux`` as a captured loop takes it: (its tensor leaves, the key of
    the rest: the tree's structure and its other leaves, a function that
    builds an ``aux`` from new tensor leaves).  Raises where ``aux`` cannot
    be captured: a tensor off ``x0``'s device, or a leaf that cannot key a
    loop."""
    leaves, spec = tree_flatten(aux)
    tensors = tuple(leaf for leaf in leaves if isinstance(leaf, torch.Tensor))
    rest = (spec, tuple(None if isinstance(leaf, torch.Tensor) else leaf for leaf in leaves))
    off = [tuple(t.shape) for t in tensors if t.device != x0.device]
    if off:
        raise ValueError(f"{name}: aux tensors of shapes {off} do not lie on {x0.device}, "
                         "where the loop is captured")
    try:
        hash(rest)
    except TypeError as e:
        raise TypeError(f"{name}: aux's structure and non-tensor leaves key the captured loop "
                        f"and must be hashable: {e}") from e

    def build(ts):
        it = iter(ts)
        return tree_unflatten([next(it) if isinstance(leaf, torch.Tensor) else leaf
                               for leaf in leaves], spec)

    return tensors, rest, build


def _minimize(kind: str, residual_fn, damped_step_fn, fns, x0: torch.Tensor, aux,
              cfg: LMConfig, reduce=None):
    """A device fit, fetched: :func:`_minimize_batch`'s loop, captured as one
    loop program on the card (``fns``: the caller's functions, which key it
    with ``kind``, the config and the operands).  ``aux`` is any tree of
    tensors and other values (``torch.utils._pytree``): its tensors are
    inputs of the loop, the rest keys it.

    The first fit of a key runs iteration 1 eagerly (a fit it finishes ends
    there, uncaptured), iteration 2 as the warm-up of the capture, and then
    the whole fit from ``x0`` as one launch of the captured loop; a later
    fit is one launch from new operands.  A ``reduce=`` fit is captured the
    same way (``reduce`` keys the loop too); when its iteration issues
    collectives the loop runs as chunks (``_program._ChunkedLoop``: one
    launch and one fetch a chunk of 8 iterations): ``done`` is global after
    the all-reduces, so every rank's loop runs the same iterations.  Fits under :func:`~qrkit_tpu_torch._program.eager`,
    CPU operands and operands that require grad run the eager loop."""
    name = f"lm.levenberg_marquardt_device{'_batch' if kind == 'batch' else ''}"
    total = reduce if reduce is not None else _identity
    if not _LOOPS.capturable((x0,)):
        return _fetch(*_minimize_batch(residual_fn, damped_step_fn, x0, aux, cfg, reduce))
    tensors, rest, build = _loop_operands(name, x0, aux)
    inputs = (x0, *tensors)
    if not _LOOPS.capturable(inputs):  # an aux tensor that requires grad
        return _fetch(*_minimize_batch(residual_fn, damped_step_fn, x0, aux, cfg, reduce))
    fns = fns + ((reduce,) if reduce is not None else ())
    key = (kind, *fns, _cfg_key(cfg), rest, _program._signature(inputs))
    prog = _LOOPS.get(key, reads=fns)
    if prog is None:
        with _program.eager():  # the steps' own programs stay out of the loop's capture
            with profiling.span("qrk.setup.first_call", setup=True):
                state = _start(residual_fn, x0, aux, cfg, total)
                if cfg.max_iters >= 1:
                    state = _step(residual_fn, damped_step_fn, state, aux, cfg, total)
                    if _read_done(state[6]) or cfg.max_iters == 1:
                        return _fetch(*state)
            prog = _capture(name, key, residual_fn, damped_step_fn, fns, inputs, build, state,
                            cfg, total)
    host = prog.run(inputs)
    levenberg_marquardt_device.host_reads += prog.reads  # the fetch (one a chunk)
    return _unpack(host, *x0.shape)


def _capture(name, key, residual_fn, damped_step_fn, fns, inputs, build, state, cfg: LMConfig,
             total):
    """Capture the loop of ``key`` over static copies of ``inputs`` and of
    the loop's ``state`` (iteration 2 of the caller's fit is the warm-up);
    ``total`` sums the cost and gradient over the ranks (the identity on
    one device)."""
    static_in = tuple(t.clone() for t in inputs)
    x_in, aux_in = static_in[0], build(static_in[1:])
    S = tuple(t.clone() for t in state)  # the loop's state, updated in place
    dev = x_in.device
    k = torch.zeros((), dtype=torch.int32, device=dev)  # iterations run
    count = torch.zeros((), dtype=torch.int32, device=dev)  # L1's evaluations
    out = _pack(S[0], S[2], S[3], S[5], S[6], k, count)

    def init():
        torch._foreach_copy_(list(S), list(_start(residual_fn, x_in, aux_in, cfg, total)))
        k.zero_()
        count.zero_()

    def body():
        new = _step(residual_fn, damped_step_fn, S, aux_in, cfg, total)
        torch._foreach_copy_(list(S), list(new))
        k.add_(1)

    def tail():
        out.copy_(_pack(S[0], S[2], S[3], S[5], S[6], k, count))

    return _LOOPS.capture(key, name, init, body, tail, static_in, S[6], k, count, out,
                          cfg.max_iters, reads=fns, buffers=S)


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
    with no host read inside an iteration.  On the card the fit is one
    captured loop (the module docstring): a warm fit is one graph launch and
    one fetch of the result; elsewhere the loop reads one ``done`` flag per
    iteration.  Per-problem data (points, measurements, ...) travels through
    ``aux``: a tensor, None, or a tree of them (``torch.utils._pytree``)
    whose other leaves are hashable values that key the captured loop; on
    the card its tensors lie on ``x0``'s device.

    ``reduce`` is for residuals sharded over the ranks of a mesh: each rank's
    ``residual_fn`` returns its own residuals, and ``reduce`` (an all-reduce
    sum, e.g. ``functools.partial(parallel.mesh.all_reduce_sum, mesh=m)``)
    turns the cost and ``Jᵀr`` into global sums.  ``x`` and the step stay
    global, so every rank takes the same decisions and returns the same
    result.  On the card such a fit is a captured loop too, its collectives
    inside chunks of gated iterations (one launch and one fetch a chunk);
    ``reduce`` keys the loop, so pass the same function object from fit to
    fit.

    Returns an :class:`LMResult` of host values (x as NumPy)."""
    cfg = config or LMConfig()
    x, cost, lam, it, done = _minimize(
        "solo",
        lambda x, aux: residual_fn(x[0], aux)[None],
        lambda x, r, lam, aux: damped_step_fn(x[0], r[0], lam[0], aux)[None],
        (residual_fn, damped_step_fn), _device.as_tensor(x0)[None], aux, cfg, reduce,
    )
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
    trajectory.  On the card the fit is one captured loop, as the solo
    fit's.

    ``x0_batch`` is ``[B, n]`` (``aux_batch`` ``[B, ...]``); returns an
    :class:`LMResult` of NumPy arrays: ``x [B, n]``, ``cost [B]``,
    ``iterations [B]``, ``converged [B]``, ``lambda_final [B]``."""
    cfg = config or LMConfig()
    aux_dim = None if aux_batch is None else 0
    rf = torch.func.vmap(residual_fn, in_dims=(0, aux_dim))
    sf = torch.func.vmap(damped_step_fn, in_dims=(0, 0, 0, aux_dim))
    x, cost, lam, it, done = _minimize(
        "batch", rf, sf, (residual_fn, damped_step_fn), _device.as_tensor(x0_batch), aux_batch, cfg
    )
    return LMResult(x, cost, it, done, lam)
