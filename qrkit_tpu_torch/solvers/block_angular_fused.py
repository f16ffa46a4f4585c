"""Fused programs for the dense-A2 block-angular stack, on torch tensors.

Counterpart of ``qrkit_tpu/solvers/block_angular_fused.py``
(``fused_dense_compute/solve/compute_solve``, ``fused_soa_compute``,
``fused_soa_solve/compute_solve``; ``_soa_solve_body`` is
:func:`fused_soa_solve`).  Each function runs
the whole reference pipeline (compute steps 1-5 of
``BlockAngularSparseQR.h:458-514`` and the ``_solve_impl`` shape of
:305-330) straight through for the flagship stack; the caller
(``BlockAngularQR.compute`` / ``.solve``) fills the sub-solver objects from
the outputs, so every other protocol method behaves as on the generic path.
No kernel: plain torch on either device, no host synchronization.

Applicability (checked by the caller): the left solver is
``BlockDiagonalQR`` with ``FULL_Q``, ``pivot=False``, portrait blocks and
no zero-column tail; the right one is ``DenseColPivQR`` or
``DenseHouseholderQR``; A2 is dense with at least ``m2`` rows below the
economy band.  Tail rows (beyond ``nb*br``) pass through Q1 as the identity.

The lane-major programs (``fused_soa_*``) keep the point axis last and
contiguous in every boundary array and stored factor: blocks ``[br*bc, N]``
(``BlockDiagonal.from_soa``), A2 transposed ``[m2, n1]``
(``BlockMatrix1x2(right_t=True)``).  On the GPU that makes every per-point
scalar one coalesced row; the per-block A2 rows are strided views
``a2t[:, r::br]``.
"""
from __future__ import annotations

import torch

from ..functional import _solve_upper
from ..ops.householder import (
    apply_wy,
    build_t_factor,
    colpiv_householder_qr,
    form_q,
    highest_precision,
    panel_qr_yt,
    rank_from_diag,
    rank_masked_triangular_solve,
)
from ..ops.lm_step import _reflector
from .base import _diag_health

__all__ = [
    "fused_dense_compute",
    "fused_dense_compute_solve",
    "fused_dense_solve",
    "fused_soa_compute",
    "fused_soa_compute_solve",
    "fused_soa_solve",
]


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    """inverse(perm) on the device: out[perm[i]] = i."""
    return torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    )


@highest_precision()
def fused_dense_compute(blocks: torch.Tensor, a2: torch.Tensor, *, bc: int, colpiv: bool):
    """blocks [nb, br, bc], a2 [n1, m2] → the whole composite factorization.

    Returns ``(Q, R, j2_top, Y2, T2, R2, perm2, r12, h1, h2)``: per-block
    full Q/R (step 1), Q1ᵀA2 split at the economy band (steps 2-3), the right
    QR of the bottom rows, and R12 = the top rows in the right solver's
    column order (step 4).  ``h1``/``h2`` are each child's health flag with
    its own zero-pivot semantics."""
    nb, br, _ = blocks.shape
    m2 = a2.shape[1]

    # step 1: batched per-block QR (non-pivoting), full Q
    Y, T, Ared = panel_qr_yt(blocks)
    Q, R = form_q(Y, T), torch.triu(Ared[:, :bc])

    # steps 2-3: J2 = Q1ᵀ A2 in FULL_Q row coordinates: economy rows
    # (0..nb*bc), then complement rows, then the identity pass-through tail
    outb = Q.mT @ a2[: nb * br].reshape(nb, br, m2)
    j2_top = outb[:, :bc].reshape(nb * bc, m2)
    j2_bot = torch.cat([outb[:, bc:].reshape(nb * (br - bc), m2), a2[nb * br :]], dim=0)

    if colpiv:
        Y2, taus2, R2raw, perm2 = colpiv_householder_qr(j2_bot)
        T2 = build_t_factor(Y2, taus2)
        R2 = torch.triu(R2raw)
        h2 = _diag_health(torch.diagonal(R2), check_zero=False)
        r12 = j2_top[:, perm2]
    else:
        Y2, T2, R2raw = panel_qr_yt(j2_bot)
        R2 = torch.triu(R2raw)
        perm2 = torch.arange(m2, device=a2.device)
        h2 = _diag_health(torch.diagonal(R2), check_zero=True)
        r12 = j2_top

    h1 = _diag_health(torch.diagonal(R, dim1=1, dim2=2).reshape(-1), check_zero=True)
    return Q, R, j2_top, Y2, T2, R2, perm2, r12, h1, h2


@highest_precision()
def fused_dense_solve(Q, R, Y2, T2, R2, perm2, r12, b, *, bc: int, colpiv: bool):
    """Least-squares solve against the fused factorization: per-block Q1ᵀb,
    the right Q2ᵀ on the bottom rows, R2 back-substitution (rank-masked for
    the ColPiv right), R12 elimination, per-block R1 back-substitution, and
    the right block's column back-permutation on the device."""
    nb, br, _ = Q.shape
    m2 = R2.shape[1]
    m1 = nb * bc
    outb = (Q.mT @ b[: nb * br].reshape(nb, br, 1))[..., 0]
    y_top = outb[:, :bc].reshape(m1)
    y_bot = torch.cat([outb[:, bc:].reshape(-1), b[nb * br :]])

    y2 = apply_wy(Y2, T2, y_bot[:, None], transpose=True)[:, 0]
    R2sq = R2[:m2, :m2]
    if colpiv:
        k = rank_from_diag(torch.diagonal(R2sq), Y2.shape[0], m2)
        x2 = rank_masked_triangular_solve(R2sq, y2[:m2], k)
    else:
        x2 = _solve_upper(R2sq, y2[:m2])
    x1 = _solve_upper(R, (y_top - r12 @ x2).reshape(nb, bc)).reshape(m1)
    # the left permutation is the identity (no pivot, no tail), so only the
    # right block permutes: x[m1 + perm2[i]] = x2[i]
    return torch.cat([x1, x2[_inverse_perm(perm2)]])


def fused_dense_compute_solve(blocks, a2, b, *, bc: int, colpiv: bool):
    """Factorize + least-squares solve in one call; returns ``(compute
    outputs..., x)``."""
    out = fused_dense_compute(blocks, a2, bc=bc, colpiv=colpiv)
    Q, R, _, Y2, T2, R2, perm2, r12, _, _ = out
    return out + (fused_dense_solve(Q, R, Y2, T2, R2, perm2, r12, b, bc=bc, colpiv=colpiv),)


@highest_precision()
def fused_soa_compute(a_in, a2_in, *, br: int, bc: int, colpiv: bool, aos: bool, a2_aos: bool):
    """Lane-major twin of :func:`fused_dense_compute`: the whole five-step
    composition with the point axis last.

    ``a_in`` is SoA ``[br*bc, N]`` (or AoS ``[N, br, bc]`` with ``aos``),
    ``a2_in`` is ``[m2, n1]`` (or ``[n1, m2]`` with ``a2_aos``).  Per-block
    Householder QR with unnormalized reflectors, the trailing update on the
    per-block A2 rows, then a lane-major tall QR of the bottom panel whose
    column pivoting (Eigen ColPivHouseholderQR order, downdated norms, as in
    :func:`~qrkit_tpu_torch.ops.householder.colpiv_householder_qr`) runs as
    row swaps of the transposed panel, the pivot found by ``argmax`` on the
    device.  Returns ``(U1 [bc, br, N], c1 [bc, N], R1 [bc, bc, N], j2t
    [bc, m2, N], U2 [m2, Lb], c2 [m2], R2 [m2, m2], perm2 [m2], r12t
    [bc, m2, N], health)``."""
    if aos:
        nb = a_in.shape[0]
        a = [[a_in[:, r, c] for c in range(bc)] for r in range(br)]  # [br][bc] of [N]
    else:
        nb = a_in.shape[1]
        a = [[a_in[r * bc + c] for c in range(bc)] for r in range(br)]
    a2t = a2_in.T if a2_aos else a2_in  # [m2, n1]
    m2 = a2t.shape[0]
    dev = a2t.device

    # per-block A2 rows as br strided views [m2, N]
    Br = [a2t[:, r : nb * br : br] for r in range(br)]

    u1s, c1s, r1_rows = [], [], []
    for j in range(bc):
        x0 = a[j][j]
        sigma = torch.zeros_like(x0)
        for r in range(j + 1, br):
            sigma = sigma + a[r][j] * a[r][j]
        beta, c_scale, degen = _reflector(x0, sigma)
        u = [torch.zeros_like(x0)] * j + [x0 - beta] + [a[r][j] for r in range(j + 1, br)]
        for col in range(j + 1, bc):
            wA = u[j] * a[j][col]
            for r in range(j + 1, br):
                wA = wA + u[r] * a[r][col]
            wA = c_scale * wA
            for r in range(j, br):
                a[r][col] = a[r][col] - u[r] * wA
        wB = u[j][None, :] * Br[j]
        for r in range(j + 1, br):
            wB = wB + u[r][None, :] * Br[r]
        wB = c_scale[None, :] * wB  # [m2, N]
        for r in range(j, br):
            Br[r] = Br[r] - u[r][None, :] * wB
        diag_j = torch.where(degen, x0, beta)
        r1_rows.append(torch.stack([torch.zeros_like(x0)] * j + [diag_j] + [
            a[j][jj] for jj in range(j + 1, bc)
        ]))
        u1s.append(torch.stack(u))
        c1s.append(c_scale)
    U1 = torch.stack(u1s)  # [bc, br, N]
    c1 = torch.stack(c1s)  # [bc, N]
    R1 = torch.stack(r1_rows)  # [bc, bc, N]

    j2t = torch.stack(Br[:bc])  # [bc, m2, N]: the economy-band rows
    # bottom panel lane-major: complement rows (r-major, matching the solve's
    # y_bot order), then the pass-through tail
    X = torch.cat(Br[bc:] + [a2t[:, nb * br :]], dim=1)  # [m2, Lb]
    Lb = X.shape[1]

    lane = torch.arange(Lb, device=dev)
    rows_i = torch.arange(m2, device=dev)
    perm2 = torch.arange(m2, device=dev)
    norms2 = (X * X).sum(1)
    zero = X.new_zeros(())
    neg_inf = X.new_full((), float("-inf"))
    u2s, c2s = [], []
    for j in range(m2):
        if colpiv:
            p = torch.argmax(torch.where(rows_i >= j, norms2, neg_inf))  # first max
            swap = torch.where(rows_i == j, p, torch.where(rows_i == p, j, rows_i))
            X, perm2, norms2 = X[swap], perm2[swap], norms2[swap]
        col = X[j]
        x0 = col[j]
        tail = torch.where(lane > j, col, zero)
        beta, c_scale, degen = _reflector(x0, (tail * tail).sum())
        u = torch.where(lane == j, x0 - beta, tail)
        w = (X @ u) * c_scale  # [m2]
        X = X - torch.outer(w, u)
        X[j, j] = torch.where(degen, x0, beta)
        if colpiv:
            rj = torch.where(rows_i > j, X[:, j], zero)
            norms2 = torch.clamp_min(norms2 - rj * rj, 0)
        u2s.append(u)
        c2s.append(c_scale)
    U2 = torch.stack(u2s)  # [m2, Lb]
    c2 = torch.stack(c2s)  # [m2]
    R2 = torch.triu(X[:, :m2].T)  # [m2, m2]

    r12t = j2t[:, perm2] if colpiv else j2t
    h1 = _diag_health(torch.diagonal(R1, dim1=0, dim2=1).reshape(-1), check_zero=True)
    h2 = _diag_health(torch.diagonal(R2), check_zero=not colpiv)
    return U1, c1, R1, j2t, U2, c2, R2, perm2, r12t, h1 & h2


@highest_precision()
def fused_soa_solve(U1, c1, R1, U2, c2, R2, perm2, r12t, b, *, colpiv: bool):
    """Least-squares solve against the lane-major factorization: per-block
    Q1ᵀb through the stored unnormalized reflectors, the tall-panel Q2ᵀ,
    rank-masked R2 back-substitution (ColPiv right), R12 elimination,
    per-point R1 back-substitution and the right block's column
    back-permutation; the math of :func:`fused_dense_solve` (the
    reference's ``_soa_solve_body``)."""
    bc, br, nb = U1.shape
    m2, Lb = U2.shape
    # b rows per block row as strided views (no [nb, br] → [br, nb] copy)
    body = [b[r : nb * br : br] for r in range(br)]
    for j in range(bc):
        w = U1[j, 0] * body[0]
        for r in range(1, br):
            w = w + U1[j, r] * body[r]
        w = c1[j] * w
        for r in range(br):
            body[r] = body[r] - U1[j, r] * w
    y_top = torch.stack(body[:bc])  # [bc, N]
    y = torch.cat(body[bc:] + [b[nb * br :]])  # [Lb]
    for j in range(m2):
        y = y - (c2[j] * (U2[j] @ y)) * U2[j]
    y2 = y[:m2]
    if colpiv:
        x2 = rank_masked_triangular_solve(R2, y2, rank_from_diag(torch.diagonal(R2), Lb, m2))
    else:
        x2 = _solve_upper(R2, y2)
    rhs1 = y_top - (r12t * x2[None, :, None]).sum(1)  # [bc, N]
    x1_rows = [None] * bc
    for j in range(bc - 1, -1, -1):
        acc = rhs1[j]
        for jj in range(j + 1, bc):
            acc = acc - R1[j, jj] * x1_rows[jj]
        x1_rows[j] = acc / R1[j, j]
    x1 = torch.stack(x1_rows, dim=1).reshape(-1)  # [N*bc], point-major
    return torch.cat([x1, x2[_inverse_perm(perm2)]])


def fused_soa_compute_solve(a_in, a2_in, b, *, br: int, bc: int, colpiv: bool, aos: bool,
                            a2_aos: bool):
    """Lane-major factorize + solve in one call (see :func:`fused_soa_compute`);
    returns ``(compute outputs..., x)``."""
    out = fused_soa_compute(a_in, a2_in, br=br, bc=bc, colpiv=colpiv, aos=aos, a2_aos=a2_aos)
    U1, c1, R1, _, U2, c2, R2, perm2, r12t, _ = out
    return out + (fused_soa_solve(U1, c1, R1, U2, c2, R2, perm2, r12t, b, colpiv=colpiv),)
