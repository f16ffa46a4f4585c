"""The ellipse model's residuals, Jacobian and gradient: kernel K4 and its
plain versions.

No Pallas counterpart: the reference computes the model of
``qrkit_tpu/examples/ellipse.py`` (``_residuals``, ``_residuals_soa``,
``_jacobian_soa``) and the gradient ``g = Jᵀr`` (``jax.vjp`` in
``qrkit_tpu/lm.py``) as jnp expressions under ``jax.jit``, which XLA fuses.
Op by op in PyTorch the ellipse LM iteration's model is some 155 small
kernels; K4 (``csrc/ellipse_eval.cu``) evaluates it in one pass over the
points, one thread a point:

* K4r, :func:`ellipse_residuals`: ``params [..., N + 5]``, ``pts [..., 2,
  N]`` → the interleaved residuals ``[..., 2N]`` (``r[2i] = X_i − x(t_i)``,
  ``r[2i + 1] = Y_i − y(t_i)``);
* K4g, :func:`ellipse_residuals_vjp`: ``(params, r̄ [..., 2N])`` → ``g = Jᵀr̄
  [..., N + 5]``; the five model entries are sums over the points, reduced
  in a fixed order (warp shuffles, the CTA, then the problem's last CTA over
  the CTAs' partials in index order: one launch and one memset of its
  ticket), so two calls give the same bits;
* K4j, :func:`ellipse_jacobian_residuals`: ``(params, pts)`` → the
  lane-major operands of the damped step, ``left [..., 2, N]``, ``right
  [..., 2, 5, N]`` and ``res [..., 2, N]``, in one pass.

Each is a ``torch.library.custom_op`` over a leading problem axis with a
``vmap`` rule (the vmapped axis joins the problem axis: one launch for the
batch fit's problems).  The wrappers differentiate through an
``autograd.Function`` (custom ops' own autograd rules do not compose with
``torch.func``): K4r's backward runs K4g, so ``torch.func.vjp`` of the
residuals is two launches, under ``vmap`` too; K4j's backward is the
vector-Jacobian product of its plain version (no caller differentiates the
step's operands by the parameters).  ``pts`` is read in place through its
strides (a rank's slice of a wider point array needs no copy); its point
axis is contiguous.

The plain versions are the torch formulas K4 replaces, kept here: a CPU
tensor runs them; a CUDA tensor launches the kernel or raises.  The kernel
evaluates each elementwise output in the plain version's order, each
product and sum rounded on its own (``--fmad=false``), with the precise
sin and cos, so K4r, K4j and K4g's point entries equal the plain versions
on the card bit for bit; K4g's five sums differ from ``torch.sum``'s
order.  Each wrapper's ``launches`` counter counts its kernel's launches.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build

__all__ = ["ellipse_jacobian_residuals", "ellipse_residuals", "ellipse_residuals_vjp"]

# points a CTA (kThreads in the source)
THREADS = 256
_MODEL = 5  # a, b, x0, y0, r


# --- the plain versions ----------------------------------------------------------------

def _model(params: torch.Tensor, n: int):
    """cos t, sin t ``[..., N]``, cos r, sin r, a, b, x0, y0 ``[..., 1]``."""
    t = params[..., :n]
    a, b, x0, y0, r = (params[..., n + i, None] for i in range(_MODEL))
    return torch.cos(t), torch.sin(t), torch.cos(r), torch.sin(r), a, b, x0, y0


def _residuals_soa_plain(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``[X_i − x(t_i), Y_i − y(t_i)]`` as ``[..., 2, N]``
    (ellipse_fitting.cpp:62-79)."""
    ct, st, cr, sr, a, b, x0, y0 = _model(params, pts.shape[-1])
    x = a * ct * cr - b * st * sr + x0
    y = a * ct * sr + b * st * cr + y0
    return torch.stack([pts[..., 0, :] - x, pts[..., 1, :] - y], dim=-2)


def _residuals_plain(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """K4r's plain version: the residuals interleaved, ``[..., 2N]``."""
    res = _residuals_soa_plain(params, pts)
    return res.transpose(-1, -2).reshape(*res.shape[:-2], -1)


def _jacobian_plain(params: torch.Tensor, n: int):
    """left ``[..., 2, N]`` (∂r/∂t_i, point i's 2×1 block as column i) and
    right ``[..., 2, 5, N]`` (∂r/∂(a, b, x0, y0, r)) (ellipse_fitting.cpp:85-113)."""
    ct, st, cr, sr, a, b, _, _ = _model(params, n)
    left = torch.stack([a * cr * st + b * sr * ct, a * sr * st - b * cr * ct], dim=-2)
    one, zero = torch.ones_like(ct), torch.zeros_like(ct)
    row0 = torch.stack([-ct * cr, st * sr, -one, zero, a * ct * sr + b * st * cr], dim=-2)
    row1 = torch.stack([-ct * sr, -st * cr, zero, -one, -a * ct * cr + b * st * sr], dim=-2)
    return left, torch.stack([row0, row1], dim=-3)


def _jacobian_residuals_plain(params: torch.Tensor, pts: torch.Tensor):
    """K4j's plain version: (left, right, res)."""
    return (*_jacobian_plain(params, pts.shape[-1]), _residuals_soa_plain(params, pts))


def _residuals_vjp_plain(params: torch.Tensor, rbar: torch.Tensor) -> torch.Tensor:
    """K4g's plain version: ``g = Jᵀr̄``, ``[..., N + 5]``: point i's entry
    ``left[0, i] r̄_2i + left[1, i] r̄_2i+1``, then the model's five entries,
    ``right[0, m, i] r̄_2i + right[1, m, i] r̄_2i+1`` summed over the points."""
    n = params.shape[-1] - _MODEL
    left, right = _jacobian_plain(params, n)
    rb = rbar.reshape(*rbar.shape[:-1], n, 2)
    r0, r1 = rb[..., 0], rb[..., 1]
    g_t = left[..., 0, :] * r0 + left[..., 1, :] * r1
    g_m = (right[..., 0, :, :] * r0[..., None, :] + right[..., 1, :, :] * r1[..., None, :]).sum(-1)
    return torch.cat([g_t, g_m], dim=-1)


# --- the kernels -----------------------------------------------------------------------

def _tiles(n: int) -> int:
    """CTAs a problem (``tiles_of`` in the source)."""
    return max(1, -(-n // THREADS))


def _point_major(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last axis contiguous (the kernels' lanes)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _paired(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, its start aligned to two values (the kernels read and
    write a point's pair of residuals as one vector)."""
    t = t.contiguous()
    return t if t.data_ptr() % (2 * t.element_size()) == 0 else t.clone()


def _residuals_kernel(params, pts) -> torch.Tensor:
    P, m = params.shape
    n = m - _MODEL
    params, pts = _point_major(params), _point_major(pts)
    r = params.new_empty((P, 2 * n))
    _build.ellipse_launcher("residuals", params.dtype)(
        params.device.index, params.data_ptr(), params.stride(0), pts.data_ptr(), pts.stride(0),
        pts.stride(1), r.data_ptr(), n, P)
    ellipse_residuals.launches += 1
    return r


def _jacobian_kernel(params, pts):
    P, m = params.shape
    n = m - _MODEL
    params, pts = _point_major(params), _point_major(pts)
    left = params.new_empty((P, 2, n))
    right = params.new_empty((P, 2, _MODEL, n))
    res = params.new_empty((P, 2, n))
    _build.ellipse_launcher("jacobian", params.dtype)(
        params.device.index, params.data_ptr(), params.stride(0), pts.data_ptr(), pts.stride(0),
        pts.stride(1), left.data_ptr(), right.data_ptr(), res.data_ptr(), n, P)
    ellipse_jacobian_residuals.launches += 1
    return left, right, res


def _vjp_kernel(params, rbar) -> torch.Tensor:
    P, m = params.shape
    n = m - _MODEL
    params, rbar = _point_major(params), _paired(rbar)
    g = params.new_empty((P, m))
    partials = params.new_empty((P, _tiles(n), _MODEL))
    ticket = params.new_empty((P,), dtype=torch.int32)
    _build.ellipse_launcher("vjp", params.dtype)(
        params.device.index, params.data_ptr(), params.stride(0), rbar.data_ptr(), g.data_ptr(),
        partials.data_ptr(), ticket.data_ptr(), n, P)
    ellipse_residuals_vjp.launches += 1
    return g


def _route(params, plain, kernel, *args):
    """The plain version on a CPU tensor, the kernel on a CUDA tensor."""
    if params.device.type == "cpu":
        return plain(*args)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    return kernel(*args)


# --- the ops: [P, ...] operands --------------------------------------------------------

@torch.library.custom_op("qrkit_tpu_torch::ellipse_residuals", mutates_args=())
def _residuals_op(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """K4r over a leading problem axis: params ``[P, N + 5]``, pts ``[P, 2, N]``."""
    return _route(params, _residuals_plain, _residuals_kernel, params, pts)


@_residuals_op.register_fake
def _(params, pts):
    return params.new_empty((params.shape[0], 2 * pts.shape[-1]))


@torch.library.custom_op("qrkit_tpu_torch::ellipse_residuals_vjp", mutates_args=())
def _vjp_op(params: torch.Tensor, rbar: torch.Tensor) -> torch.Tensor:
    """K4g over a leading problem axis: params ``[P, N + 5]``, r̄ ``[P, 2N]``."""
    return _route(params, _residuals_vjp_plain, _vjp_kernel, params, rbar)


@_vjp_op.register_fake
def _(params, rbar):
    return torch.empty_like(params)


@torch.library.custom_op("qrkit_tpu_torch::ellipse_jacobian", mutates_args=())
def _jacobian_op(params: torch.Tensor,
                 pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4j over a leading problem axis: params ``[P, N + 5]``, pts ``[P, 2, N]``."""
    return _route(params, _jacobian_residuals_plain, _jacobian_kernel, params, pts)


@_jacobian_op.register_fake
def _(params, pts):
    P, n = params.shape[0], pts.shape[-1]
    return params.new_empty((P, 2, n)), params.new_empty((P, 2, _MODEL, n)), params.new_empty((P, 2, n))


class _Residuals(torch.autograd.Function):
    """K4r with K4g as its backward.  A Function (not the op's own autograd
    rule) so that ``torch.func.vjp`` takes it; under ``vmap`` its forward
    and backward run the ops' vmap rules (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(params, pts):
        return _residuals_op(params, pts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        """K4g for the parameters; the points' cotangent is r̄ itself, laid
        out as ``[P, 2, N]`` (∂r/∂pts is the identity)."""
        (params,) = ctx.saved_tensors
        g_params = _vjp_op(params, grad) if ctx.needs_input_grad[0] else None
        g_pts = grad.reshape(grad.shape[0], -1, 2).transpose(1, 2) if ctx.needs_input_grad[1] else None
        return g_params, g_pts


class _Jacobian(torch.autograd.Function):
    """K4j; its backward is the vector-Jacobian product of the plain
    version, recomputed (no caller differentiates the step's operands by
    the parameters: the fits differentiate the residuals)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(params, pts):
        return _jacobian_op(params, pts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        _, vjp = torch.func.vjp(_jacobian_residuals_plain, *ctx.saved_tensors)
        return vjp(grads)


def _merge(size: int, t: torch.Tensor, d):
    """``t`` with the vmapped axis ``d`` (None: not mapped, expanded) joined
    to its problem axis."""
    t = t.movedim(d, 0) if d is not None else t.expand(size, *t.shape)
    return t.reshape(size * t.shape[1], *t.shape[2:])


def _split(size: int, t: torch.Tensor) -> torch.Tensor:
    return t.reshape(size, -1, *t.shape[1:])


def _vmap_rule(op):
    """vmap rule of a K4 op: the vmapped axis joins the problem axis (one
    launch for the whole batch)."""

    def rule(info, in_dims, *args):
        out = op(*(_merge(info.batch_size, t, d) for t, d in zip(args, in_dims)))
        if isinstance(out, tuple):
            return tuple(_split(info.batch_size, t) for t in out), (0,) * len(out)
        return _split(info.batch_size, out), 0

    return rule


for _op in (_residuals_op, _vjp_op, _jacobian_op):
    torch.library.register_vmap(_op, _vmap_rule(_op))


# --- the wrappers: any leading axes ----------------------------------------------------

def _check(params: torch.Tensor, other: torch.Tensor, name: str, tail) -> Tuple[tuple, int]:
    """The leading axes and N of ``params [..., N + 5]`` and ``other`` (pts
    ``[..., 2, N]`` or r̄ ``[..., 2N]``: ``tail(n)`` its trailing shape)."""
    for label, t in (("params", params), (name, other)):
        if t.dtype not in _build._SUFFIX or t.dtype != params.dtype or t.device != params.device:
            raise TypeError(f"{label}: {t.dtype} on {t.device}; the ellipse model takes float32 or "
                            f"float64 operands of one dtype on one device")
    if params.dim() < 1 or params.shape[-1] < _MODEL:
        raise ValueError(f"params must be [..., N + 5], got {tuple(params.shape)}")
    *lead, m = params.shape
    n = m - _MODEL
    if tuple(other.shape) != (*lead, *tail(n)):
        raise ValueError(f"{name} {tuple(other.shape)} does not match params {tuple(params.shape)}: "
                         f"want {(*lead, *tail(n))}")
    return tuple(lead), n


def ellipse_residuals(params: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The ellipse residuals (kernel K4r), interleaved: ``params [..., N +
    5]`` (t_0..t_{N−1}, then a, b, x0, y0, r) and ``pts [..., 2, N]`` →
    ``[..., 2N]`` with ``r[2i] = X_i − x(t_i)``, ``r[2i + 1] = Y_i −
    y(t_i)``.  Differentiable (the backward is :func:`ellipse_residuals_vjp`)."""
    lead, n = _check(params, pts, "pts", lambda n: (2, n))
    P = math.prod(lead)
    out = _Residuals.apply(params.reshape(P, n + _MODEL), pts.reshape(P, 2, n))
    return out.reshape(*lead, 2 * n)


def ellipse_residuals_vjp(params: torch.Tensor, rbar: torch.Tensor) -> torch.Tensor:
    """``g = Jᵀr̄`` of the ellipse residuals (kernel K4g): ``params [..., N +
    5]``, ``rbar [..., 2N]`` (interleaved as :func:`ellipse_residuals`) →
    ``[..., N + 5]``."""
    lead, n = _check(params, rbar, "rbar", lambda n: (2 * n,))
    P = math.prod(lead)
    return _vjp_op(params.reshape(P, n + _MODEL), rbar.reshape(P, 2 * n)).reshape(*lead, n + _MODEL)


def ellipse_jacobian_residuals(params: torch.Tensor, pts: torch.Tensor):
    """The structured Jacobian and the residuals in lane-major form (kernel
    K4j): ``params [..., N + 5]``, ``pts [..., 2, N]`` → left ``[..., 2,
    N]`` (point i's 2×1 block of ∂r/∂t is column i), right ``[..., 2, 5,
    N]`` (∂r/∂(a, b, x0, y0, r)) and res ``[..., 2, N]``."""
    lead, n = _check(params, pts, "pts", lambda n: (2, n))
    P = math.prod(lead)
    left, right, res = _Jacobian.apply(params.reshape(P, n + _MODEL), pts.reshape(P, 2, n))
    return left.reshape(*lead, 2, n), right.reshape(*lead, 2, _MODEL, n), res.reshape(*lead, 2, n)


ellipse_residuals.launches = 0
ellipse_residuals_vjp.launches = 0
ellipse_jacobian_residuals.launches = 0
