"""Batched tiny-block QR + least-squares solve: CUDA kernels and their plain
PyTorch versions.

Counterpart of ``qrkit_tpu/ops/pallas_blockdiag.py``:

* :func:`block_diagonal_lstsq_soa` ← ``pallas_block_diagonal_lstsq_soa``
  (kernel ``_lstsq_kernel``): fused QR, Qᵀb and back-substitution per block,
  with the ``b_scale`` (a device scalar multiplying x) and ``stepnorm``
  (Σx² over every block) options.
* :func:`block_diagonal_qr_r_soa` ← ``pallas_block_diagonal_qr_r_soa``
  (kernel ``_qr_r_kernel``): packed upper-triangular R per block.
* :func:`block_diagonal_lstsq` / :func:`block_diagonal_qr_r` ← the AoS
  wrappers ``pallas_block_diagonal_lstsq`` / ``pallas_block_diagonal_qr_r``.

The SoA layout is ``[br*bc, n]``: entry (r, c) of block k at
``[r*bc + c, k]``, the block index contiguous, so one GPU thread per block
reads coalesced rows.  Unlike the TPU version nothing is padded: the kernels
mask the ragged edge themselves.

Each SoA wrapper runs its hand-written CUDA kernel (``csrc/blockdiag_qr.cu``)
on a CUDA tensor, or raises; it runs the plain version beside it only for a
CPU tensor.  The plain versions (:func:`_lstsq_soa_plain`,
:func:`_qr_r_soa_plain`) are the same unrolled recurrence on per-entry
tensors of shape ``[n]``, batched over blocks.  Each wrapper carries a
``launches`` counter, incremented once per kernel launch and nowhere else.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = [
    "block_diagonal_lstsq",
    "block_diagonal_lstsq_soa",
    "block_diagonal_qr_r",
    "block_diagonal_qr_r_soa",
]

_MAX_ENTRIES = 64  # br*bc cap: the recurrence lives in one thread's registers
# the smallest CTA the kernels launch (kMinThreads in the source, which
# static_asserts this value): one stepnorm partial per CTA, at most n/32
_MIN_THREADS = 32
_SUFFIX = _build._SUFFIX  # the dtypes the kernels take


def _householder_inplace(a, rhs_list, br: int, bc: int) -> None:
    """Unrolled Householder QR on per-entry tensors ``a[r][c]`` (each
    ``[n]``, one value per block); every rhs in ``rhs_list`` (a list of
    per-row tensors) is updated by Hᵀ too.  Unnormalized reflector
    ``H = I − u uᵀ / (β(β−x₀))`` with ``u = (x₀−β, a[j+1..])``; column j is
    never updated, its diagonal is written directly (β, or x₀ when the
    column is already zero below the diagonal).  Every multiply and add
    rounds on its own, as in the CUDA kernel built with ``--fmad=false``."""
    for j in range(bc):
        x0 = a[j][j]
        one = torch.ones_like(x0)
        sigma = torch.zeros_like(x0)
        for r in range(j + 1, br):
            sigma = sigma + a[r][j] * a[r][j]
        norm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -norm, norm)
        degen = sigma <= 0
        t = beta * (beta - x0)
        c_scale = torch.where(degen, torch.zeros_like(x0), one / torch.where(degen, one, t))
        u = [None] * br
        u[j] = x0 - beta
        for r in range(j + 1, br):
            u[r] = a[r][j]
        a[j][j] = torch.where(degen, x0, beta)
        for c in range(j + 1, bc):
            w = u[j] * a[j][c]
            for r in range(j + 1, br):
                w = w + u[r] * a[r][c]
            w = c_scale * w
            for r in range(j, br):
                a[r][c] = a[r][c] - u[r] * w
        for rhs in rhs_list:
            w = u[j] * rhs[j]
            for r in range(j + 1, br):
                w = w + u[r] * rhs[r]
            w = c_scale * w
            for r in range(j, br):
                rhs[r] = rhs[r] - u[r] * w


def _lstsq_soa_plain(
    a_soa: torch.Tensor,
    b_soa: torch.Tensor,
    b_scale: Optional[torch.Tensor] = None,
    stepnorm: bool = False,
):
    """Plain PyTorch version of the fused QR + LS-solve kernel:
    ``a_soa [br*bc, n]``, ``b_soa [br, n]`` → ``x_soa [bc, n]``, multiplied
    by ``b_scale`` after the back-substitution when given; with ``stepnorm``
    returns ``(x_soa, Σ x²)``."""
    br = b_soa.shape[0]
    bc = a_soa.shape[0] // br
    a = [[a_soa[r * bc + c] for c in range(bc)] for r in range(br)]
    rhs = [b_soa[r] for r in range(br)]
    _householder_inplace(a, [rhs], br, bc)
    x = [None] * bc
    for j in range(bc - 1, -1, -1):
        acc = rhs[j]
        for c in range(j + 1, bc):
            acc = acc - a[j][c] * x[c]
        x[j] = acc / a[j][j]
    if b_scale is not None:
        x = [xj * b_scale.reshape(()) for xj in x]
    x = torch.stack(x)
    if stepnorm:
        return x, (x * x).sum()
    return x


def _qr_r_soa_plain(a_soa: torch.Tensor, br: int) -> torch.Tensor:
    """Plain PyTorch version of the packed-R kernel: ``a_soa [br*bc, n]`` →
    ``[bc(bc+1)/2, n]`` in row-major (j, c >= j) order."""
    bc = a_soa.shape[0] // br
    a = [[a_soa[r * bc + c] for c in range(bc)] for r in range(br)]
    _householder_inplace(a, [], br, bc)
    return torch.stack([a[j][c] for j in range(bc) for c in range(j, bc)])


def _check_operand(a_soa: torch.Tensor, br: int) -> int:
    """Validate an SoA operand; returns bc."""
    if a_soa.dtype not in _SUFFIX:
        raise TypeError(f"expected float32 or float64, got {a_soa.dtype}")
    if a_soa.dim() != 2 or br < 1 or a_soa.shape[0] % br:
        raise ValueError(
            f"a_soa must be [br*bc, n] with br={br} dividing its rows, got {tuple(a_soa.shape)}"
        )
    bc = a_soa.shape[0] // br
    if not 1 <= bc <= br or br * bc > _MAX_ENTRIES:
        raise ValueError(
            f"unsupported block shape {br}x{bc}: needs br >= bc >= 1 and br*bc <= {_MAX_ENTRIES}"
        )
    if a_soa.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a_soa.device}")
    return bc


def block_diagonal_lstsq_soa(
    a_soa: torch.Tensor,
    b_soa: torch.Tensor,
    b_scale: Optional[torch.Tensor] = None,
    stepnorm: bool = False,
):
    """Fused per-block QR + least-squares solve on SoA operands.

    ``a_soa`` is ``[br*bc, n]``, ``b_soa`` is ``[br, n]``; returns ``x_soa
    [bc, n]`` with x_k = argmin ‖A_k x − b_k‖ for every block k.  Blocks
    are portrait (br >= bc) with br*bc <= 64, float32 or float64, and both
    operands contiguous on one device.  A CUDA tensor runs the CUDA kernel
    (built at first use) on its own card, ``cuda:N``, or raises; a CPU
    tensor runs the plain version.

    ``b_scale`` (a one-element tensor on the operands' device, never a host
    float, so nothing waits for the device) solves for ``b_scale · b`` by
    scaling x.  ``stepnorm=True`` returns ``(x_soa, Σ x²)`` with the sum over
    every block reduced on the device (a 0-d tensor)."""
    if b_soa.dim() != 2:
        raise ValueError(f"b_soa must be [br, n], got {tuple(b_soa.shape)}")
    br, n = b_soa.shape
    bc = _check_operand(a_soa, br)
    if a_soa.shape[1] != n or b_soa.dtype != a_soa.dtype or b_soa.device != a_soa.device:
        raise ValueError(
            f"a_soa {tuple(a_soa.shape)} {a_soa.dtype} {a_soa.device} and b_soa "
            f"{tuple(b_soa.shape)} {b_soa.dtype} {b_soa.device} do not match"
        )
    if b_scale is not None and (
        b_scale.numel() != 1 or b_scale.dtype != a_soa.dtype or b_scale.device != a_soa.device
    ):
        raise ValueError(
            f"b_scale must be one {a_soa.dtype} value on {a_soa.device}, got "
            f"{tuple(b_scale.shape)} {b_scale.dtype} {b_scale.device}"
        )
    if a_soa.device.type == "cpu":
        return _lstsq_soa_plain(a_soa, b_soa, b_scale, stepnorm)
    if not (a_soa.is_contiguous() and b_soa.is_contiguous()):
        raise ValueError("a_soa and b_soa must be contiguous")
    x = a_soa.new_empty((bc, n))
    if n == 0:
        return (x, x.new_zeros(())) if stepnorm else x
    dev = a_soa.device.index
    partials = sn = None
    if b_scale is None and not stepnorm:
        _build.blockdiag_launcher("lstsq", br, bc, a_soa.dtype)(
            dev, a_soa.data_ptr(), b_soa.data_ptr(), x.data_ptr(), n)
    else:
        # one partial per CTA, at most n/32 of them; the finish kernel writes sn
        if stepnorm:
            partials = a_soa.new_empty(-(-n // _MIN_THREADS))
            sn = a_soa.new_empty(())
        scale = b_scale.reshape(1).contiguous() if b_scale is not None else None
        _build.blockdiag_launcher("lstsq_opt", br, bc, a_soa.dtype)(
            dev, a_soa.data_ptr(), b_soa.data_ptr(), x.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (scale, partials, sn)), n)
    block_diagonal_lstsq_soa.launches += 1
    return (x, sn) if stepnorm else x


block_diagonal_lstsq_soa.launches = 0


def block_diagonal_qr_r_soa(a_soa: torch.Tensor, br: int) -> torch.Tensor:
    """Per-block R factors on an SoA operand: ``a_soa [br*bc, n]`` → packed
    upper-triangular entries ``[bc(bc+1)/2, n]`` in row-major (j, c >= j)
    order, so the diagonal entry of column j sits at row
    ``j*bc - j*(j-1)//2``.  Same geometry, dtype and device rules as
    :func:`block_diagonal_lstsq_soa`."""
    bc = _check_operand(a_soa, br)
    n = a_soa.shape[1]
    if a_soa.device.type == "cpu":
        return _qr_r_soa_plain(a_soa, br)
    if not a_soa.is_contiguous():
        raise ValueError("a_soa must be contiguous")
    r_soa = a_soa.new_empty((bc * (bc + 1) // 2, n))
    if n == 0:
        return r_soa
    _build.blockdiag_launcher("qr_r", br, bc, a_soa.dtype)(
        a_soa.device.index, a_soa.data_ptr(), r_soa.data_ptr(), n)
    block_diagonal_qr_r_soa.launches += 1
    return r_soa


block_diagonal_qr_r_soa.launches = 0


def to_soa(blocks: torch.Tensor) -> torch.Tensor:
    """AoS ``[nb, br, bc]`` → contiguous SoA ``[br*bc, nb]``."""
    nb, br, bc = blocks.shape
    return blocks.permute(1, 2, 0).reshape(br * bc, nb).contiguous()


def to_aos(a_soa: torch.Tensor, br: int, bc: int) -> torch.Tensor:
    """SoA ``[br*bc, nb]`` → an AoS ``[nb, br, bc]`` view."""
    return a_soa.reshape(br, bc, -1).permute(2, 0, 1)


def block_diagonal_lstsq(blocks: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused QR + LS solve of a ``[nb, br, bc]`` block-diagonal system: x
    ``[nb*bc]`` minimizing ‖A x − b‖ blockwise (``b`` is ``[nb*br]``, extra
    tail rows ignored).  AoS wrapper: relayouts once at the boundary and
    calls :func:`block_diagonal_lstsq_soa`."""
    nb, br, bc = blocks.shape
    b_soa = b[: nb * br].reshape(nb, br).T.contiguous()
    return block_diagonal_lstsq_soa(to_soa(blocks), b_soa).T.reshape(nb * bc)


def block_diagonal_qr_r(blocks: torch.Tensor) -> torch.Tensor:
    """Per-block R factors of a ``[nb, br, bc]`` batch → packed
    ``[nb, bc(bc+1)/2]`` upper-triangular entries in row-major (j, c >= j)
    order.  AoS wrapper around :func:`block_diagonal_qr_r_soa`."""
    br = blocks.shape[1]
    return block_diagonal_qr_r_soa(to_soa(blocks), br).T
