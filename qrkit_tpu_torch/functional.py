"""Functional block-diagonal pipelines: batched factorize and a
differentiable factorize + least-squares solve.

Counterpart of the block-diagonal part of ``qrkit_tpu/functional.py``
(``block_diagonal_factorize``, ``block_diagonal_lstsq`` and its custom VJP).
As in the reference this path runs no device kernel of its own: it is
batched plain torch (compact-WY QR, Qᵀb through the implicit Y/T factors,
batched triangular solve) on either device.
"""
from __future__ import annotations

import torch

from .ops.householder import (
    build_t_factor,
    colpiv_householder_qr,
    form_q,
    highest_precision,
    panel_qr_yt,
)

__all__ = ["block_diagonal_factorize", "block_diagonal_lstsq"]


def _qr_wy(blocks: torch.Tensor, pivot: bool):
    """Per-block compact-WY QR of [nb, br, bc]: (Y, T, reduced A, perm)."""
    nb, _, bc = blocks.shape
    if pivot:
        Y, taus, Ared, perm = colpiv_householder_qr(blocks)
        return Y, build_t_factor(Y, taus), Ared, perm
    Y, T, Ared = panel_qr_yt(blocks)
    return Y, T, Ared, torch.arange(bc, device=blocks.device).expand(nb, bc)


@highest_precision()
def block_diagonal_factorize(blocks: torch.Tensor, pivot: bool = False):
    """Batched QR of a [nb, br, bc] block-diagonal batch → (Q [nb,br,br],
    R [nb,k,bc], perm [nb,bc]) with k = min(br, bc): square R for portrait
    blocks, the wide upper trapezoid for landscape ones."""
    Y, T, Ared, perm = _qr_wy(blocks, pivot)
    return form_q(Y, T), torch.triu(Ared[:, : blocks.shape[2]]), perm


def _scatter_cols(v: torch.Tensor, lperm: torch.Tensor) -> torch.Tensor:
    """out[:, lperm[:, j]] = v[:, j] per block."""
    return torch.zeros_like(v).scatter(1, lperm, v)


@highest_precision()
def _block_diagonal_lstsq_primal(blocks: torch.Tensor, b: torch.Tensor, pivot: bool):
    """Shared primal: returns (x [nb*bc], R [nb,bc,bc], lperm [nb,bc])."""
    nb, br, bc = blocks.shape
    bb = b[: nb * br].reshape(nb, br, 1)
    Y, T, Ared, lperm = _qr_wy(blocks, pivot)
    qtb = bb + Y @ (T.mT @ (Y.mT @ bb))
    R = torch.triu(Ared[:, :bc])
    x = torch.linalg.solve_triangular(R, qtb[:, :bc], upper=True)[..., 0]
    if pivot:
        x = _scatter_cols(x, lperm)
    return x.reshape(nb * bc), R, lperm


class _BlockDiagonalLstsq(torch.autograd.Function):
    """x* = argmin ‖A x − b‖ with the implicit-function-theorem backward
    (the reference's ``jax.custom_vjp``)."""

    @staticmethod
    def forward(ctx, blocks, b, pivot):
        x, R, lperm = _block_diagonal_lstsq_primal(blocks, b, pivot)
        ctx.pivot = pivot
        ctx.save_for_backward(blocks, b, x, R, lperm)
        return x

    @staticmethod
    @highest_precision()
    def backward(ctx, g):
        """With u = (AᵀA)⁻¹ḡ (two triangular solves against the saved R),
        ∂b = A u and ∂A = r uᵀ − (A u) x*ᵀ with r = b − A x* — per block,
        never differentiating through the factorization (full-rank A)."""
        blocks, b, x, R, lperm = ctx.saved_tensors
        nb, br, bc = blocks.shape
        gB = g.reshape(nb, bc)
        xB = x.reshape(nb, bc)
        # to permuted column order (A[:, perm] = Q R => AᵀA = S RᵀR Sᵀ)
        g_p = torch.gather(gB, 1, lperm) if ctx.pivot else gB
        w = torch.linalg.solve_triangular(R.mT, g_p[..., None], upper=False)
        u_p = torch.linalg.solve_triangular(R, w, upper=True)[..., 0]
        u = _scatter_cols(u_p, lperm) if ctx.pivot else u_p
        Au = torch.einsum("bij,bj->bi", blocks, u)
        r = b[: nb * br].reshape(nb, br) - torch.einsum("bij,bj->bi", blocks, xB)
        g_blocks = torch.einsum("bi,bj->bij", r, u) - torch.einsum("bi,bj->bij", Au, xB)
        g_b = torch.zeros_like(b)
        g_b[: nb * br] = Au.reshape(nb * br)
        return g_blocks, g_b, None


def block_diagonal_lstsq(blocks: torch.Tensor, b: torch.Tensor, pivot: bool = False):
    """Fused factorize + least-squares solve for a block-diagonal system.

    ``blocks`` is [nb, br, bc] (portrait), ``b`` is [nb*br] (+ ignored tail
    rows); returns x [nb*bc].  Batched compact-WY QR, Qᵀb through the
    implicit Y/T factors, batched triangular solve and the pivot
    back-permutation.  Differentiable w.r.t. ``blocks`` and ``b`` through an
    implicit-function-theorem backward (full-rank blocks assumed)."""
    return _BlockDiagonalLstsq.apply(blocks, b, pivot)
