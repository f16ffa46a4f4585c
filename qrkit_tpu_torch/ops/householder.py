"""Dense panel Householder QR in compact-WY form, batched plain torch.

Counterpart of ``qrkit_tpu/ops/householder.py`` (``panel_qr_yt``,
``panel_qr_yt_lapack``, ``householder_qr_unblocked``, ``build_t_factor``,
``_combine_t``, ``form_q``, ``apply_wy``, ``colpiv_householder_qr`` (its
unrolled and scanned forms are one loop here), ``rank_from_diag``,
``rank_masked_triangular_solve``, ``panel_qr_yt_soa``).  Where JAX wrote one
block and ``vmap``-ed it, every function here takes any number of leading
batch dimensions (``[..., m, n]``); the per-column loop is unrolled in
Python, and the trailing updates are batched matmuls.

Conventions (identical to the reference, so factors are interchangeable):

* ``Y`` is unit-lower-trapezoidal ([m, n], ones ON the diagonal stored
  explicitly, zeros above).
* ``T`` is the *negated* triangular factor: ``Q = H_0 ... H_{n-1} = I + Y T Yᵀ``.
* Reflector: β = −sign(x₀)·‖x‖, τ = (β−x₀)/β; a degenerate column
  (zero below the pivot) gets τ = 0, i.e. H = I.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

__all__ = [
    "highest_precision",
    "householder_qr_unblocked",
    "build_t_factor",
    "panel_qr_yt",
    "batched_panel_qr_yt",
    "panel_qr_yt_lapack",
    "panel_qr_yt_soa",
    "colpiv_householder_qr",
    "apply_wy",
    "form_q",
    "rank_from_diag",
    "rank_masked_triangular_solve",
    "rank_masked_solve",
    "upper_solve",
]


@contextlib.contextmanager
def highest_precision():
    """Run with full-precision fp32 matmuls: TF32 off for cuBLAS and cuDNN
    for the duration of the block (or of each call, as ``@highest_precision()``),
    previous settings restored afterwards.

    The GPU counterpart of the reference's ``jax.default_matmul_precision
    ("highest")``: TF32 keeps about three decimal digits, which degrades
    the orthogonality of a QR factor to ~1e-3."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _householder_column(A: torch.Tensor, j: int, offset: int):
    """One Householder reflection eliminating column ``j`` below row
    ``offset+j``.  Returns (A_updated, v, tau) with v the full-length
    reflector (v[pivot] = 1, zeros above).  A pivot row past the last row
    (landscape panels) is a no-op reflector: v = 0, tau = 0."""
    m = A.shape[-2]
    piv = offset + j
    if piv >= m:
        return A, A.new_zeros(A.shape[:-2] + (m,)), A.new_zeros(A.shape[:-2])
    col = A[..., :, j]
    rows = torch.arange(m, device=A.device)
    tail_mask = rows > piv
    zero = A.new_zeros(())
    one = A.new_ones(())
    x0 = col[..., piv]
    tail = torch.where(tail_mask, col, zero)
    sigma = (tail * tail).sum(-1)
    norm = torch.sqrt(x0 * x0 + sigma)
    beta = torch.where(x0 >= 0, -norm, norm)
    degenerate = sigma <= 0
    safe_denom = torch.where(degenerate, one, x0 - beta)
    v = torch.where(tail_mask, col / safe_denom[..., None], zero)
    v = torch.where(rows == piv, one, v)
    safe_beta = torch.where(norm == 0, one, beta)
    tau = torch.where(degenerate, zero, (beta - x0) / safe_beta)
    # H A = A - tau v (vᵀ A)
    w = tau[..., None] * (v[..., None, :] @ A)[..., 0, :]
    return A - v[..., :, None] * w[..., None, :], v, tau


@highest_precision()
def householder_qr_unblocked(
    A: torch.Tensor, offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unblocked Householder QR of ``A`` [..., m, n] with pivots on row
    ``offset + j``.  Returns (Y [..., m, n], taus [..., n], A_reduced)."""
    ys, taus = [], []
    for j in range(A.shape[-1]):
        A, v, tau = _householder_column(A, j, offset)
        ys.append(v)
        taus.append(tau)
    if not ys:
        return A.new_zeros(A.shape), A.new_zeros(A.shape[:-2] + (0,)), A
    return torch.stack(ys, dim=-1), torch.stack(taus, dim=-1), A


@highest_precision()
def build_t_factor(Y: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY triangular factor in the reference's sign convention:
    the forward recurrence for T_std (``H_0..H_{n-1} = I - Y T_std Yᵀ``),
    returned negated so that ``Q = I + Y T Yᵀ``."""
    n = Y.shape[-1]
    T = Y.new_zeros(Y.shape[:-2] + (n, n))
    for j in range(n):
        tau = taus[..., j]
        if j > 0:
            z = (Y[..., :, :j].mT @ Y[..., :, j : j + 1])  # [..., j, 1]
            T[..., :j, j] = -tau[..., None] * (T[..., :j, :j] @ z)[..., 0]
        T[..., j, j] = tau
    return -T


def _combine_t(T1, T2, Y1, Y2):
    """T for [Y1|Y2] given per-panel factors (negated convention):
    (I + Y1 T1 Y1ᵀ)(I + Y2 T2 Y2ᵀ) = I + [Y1 Y2] [[T1, T1 Y1ᵀY2 T2],[0, T2]] [..]ᵀ."""
    cross = T1 @ (Y1.mT @ Y2) @ T2
    top = torch.cat([T1, cross], dim=-1)
    bot = torch.cat([T2.new_zeros(T2.shape[:-1] + (T1.shape[-1],)), T2], dim=-1)
    return torch.cat([top, bot], dim=-2)


_LAPACK_QR_MIN_WIDTH = 32


@highest_precision()
def panel_qr_yt(
    A: torch.Tensor, offset: int = 0, panel_width: int = 16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked compact-WY QR: returns (Y [..., m, n], T [..., n, n], R).

    Recursively splits panels wider than ``panel_width`` so the trailing
    update is one matmul chain per sub-panel.  ``R`` is the reduced matrix
    (upper-trapezoidal below row ``offset``).  A portrait panel wider than
    ``_LAPACK_QR_MIN_WIDTH`` columns with offset 0 goes to the library's
    blocked QR (:func:`panel_qr_yt_lapack`), as in the reference: the
    recursion's per-reflector passes grow with the width.
    """
    m, n = A.shape[-2], A.shape[-1]
    if offset == 0 and n > _LAPACK_QR_MIN_WIDTH and m >= n:
        # portrait only: geqrf yields min(m, n) reflectors, so a landscape
        # panel keeps the recursion (its trapezoidal Y handles it)
        return panel_qr_yt_lapack(A, panel_width)
    if n <= panel_width:
        Y, taus, Ared = householder_qr_unblocked(A, offset)
        return Y, build_t_factor(Y, taus), Ared
    n1 = n // 2
    Y1, T1, A1 = panel_qr_yt(A[..., :, :n1], offset, panel_width)
    # Qᵀ applied to the trailing columns: A2 ← A2 + Y1 (T1ᵀ (Y1ᵀ A2))
    A2 = A[..., :, n1:]
    A2 = A2 + Y1 @ (T1.mT @ (Y1.mT @ A2))
    Y2, T2, A2r = panel_qr_yt(A2, offset + n1, panel_width)
    Y = torch.cat([Y1, Y2], dim=-1)
    return Y, _combine_t(T1, T2, Y1, Y2), torch.cat([A1, A2r], dim=-1)


def batched_panel_qr_yt(
    blocks: torch.Tensor, panel_width: int = 16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`panel_qr_yt` of each block of a ``[nb, m, n]`` batch (the
    reference's ``vmap``; the port's functions take leading axes)."""
    if blocks.dim() != 3:
        raise ValueError(f"blocks must be [nb, m, n], got {tuple(blocks.shape)}")
    return panel_qr_yt(blocks, 0, panel_width)


@highest_precision()
def panel_qr_yt_lapack(
    A: torch.Tensor, panel_width: int = 16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact-WY factors of a portrait ``A [..., m, n]`` from the library's
    blocked Householder QR (``torch.geqrf``: LAPACK on the CPU, cuSOLVER on
    the card), whose reflector and τ conventions are the reference's
    (β = −sign(x₀)‖x‖, τ = (β − x₀)/β, τ = 0 on a zero tail; so
    ``Q = I + Y·(−T_std)·Yᵀ``).  T is rebuilt per ``panel_width`` columns by
    :func:`build_t_factor` and merged pairwise with :func:`_combine_t`."""
    m, n = A.shape[-2], A.shape[-1]
    h, taus = torch.geqrf(A)
    eye = torch.eye(m, n, dtype=A.dtype, device=A.device)
    Y = torch.tril(h, -1) + eye
    R = torch.cat([torch.triu(h[..., :n, :]), h.new_zeros(h.shape[:-2] + (m - n, n))], dim=-2)

    def build(lo: int, hi: int) -> torch.Tensor:
        if hi - lo <= panel_width:
            return build_t_factor(Y[..., :, lo:hi], taus[..., lo:hi])
        mid = (lo + hi) // 2
        return _combine_t(build(lo, mid), build(mid, hi), Y[..., :, lo:mid], Y[..., :, mid:hi])

    return Y, build(0, n), R


@highest_precision()
def panel_qr_yt_soa(
    A: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched unblocked QR of a batch stored batch-last, ``A [m, n, B]``
    (the reference's lane-major layout, which its CAQR stage keeps).
    Returns ``(Y [m, n, B], T [n, n, B], R_top [n, n, B])``, R_top being the
    leading n rows of the reduced matrix; same conventions as
    :func:`householder_qr_unblocked` + :func:`build_t_factor`, which it
    runs on the batch-first view."""
    n = A.shape[1]
    Y, taus, Ared = householder_qr_unblocked(A.permute(2, 0, 1))
    T = build_t_factor(Y, taus)
    return Y.permute(1, 2, 0), T.permute(1, 2, 0), Ared[:, :n].permute(1, 2, 0)


@highest_precision()
def colpiv_householder_qr(
    A: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Column-pivoted Householder QR (Eigen ColPivHouseholderQR analog).

    Greedy max-trailing-norm pivoting, batched over leading dimensions.
    Returns (Y, taus, R, perm) with ``A[..., :, perm] = Q R`` (perm[j] =
    original index of the j-th pivot).  Landscape input runs only the
    min(m, n) elimination steps; the pivot search still ranks every column.
    The reference unrolls up to 48 columns and scans beyond; both are this
    one loop (the same operations in the same order).
    """
    m, n = A.shape[-2], A.shape[-1]
    batch = A.shape[:-2]
    cols = torch.arange(n, device=A.device)
    perm = cols.expand(batch + (n,)).clone()
    norms2 = (A * A).sum(-2)
    neg_inf = A.new_full((), float("-inf"))
    zero = A.new_zeros(())
    ys, taus = [], []
    for j in range(min(m, n)):
        masked = torch.where(cols >= j, norms2, neg_inf)
        p = torch.argmax(masked, dim=-1, keepdim=True)  # first max, as jnp.argmax
        swap = torch.where(cols == j, p, torch.where(cols == p, j, cols))
        A = torch.gather(A, -1, swap[..., None, :].expand(A.shape))
        perm = torch.gather(perm, -1, swap)
        norms2 = torch.gather(norms2, -1, swap)
        A, v, tau = _householder_column(A, j, 0)
        # downdate trailing column norms by the freshly formed R row j
        rj = torch.where(cols > j, A[..., j, :], zero)
        norms2 = torch.clamp_min(norms2 - rj * rj, 0)
        ys.append(v)
        taus.append(tau)
    if not ys:
        return A.new_zeros(batch + (m, 0)), A.new_zeros(batch + (0,)), A, perm
    return torch.stack(ys, dim=-1), torch.stack(taus, dim=-1), A, perm


@highest_precision()
def apply_wy(
    Y: torch.Tensor, T: torch.Tensor, M: torch.Tensor, transpose: bool = False
) -> torch.Tensor:
    """``Q M`` (or ``Qᵀ M``) for one compact-WY block: M + Y ((T or Tᵀ) (Yᵀ M))."""
    Tt = T.mT if transpose else T
    return M + Y @ (Tt @ (Y.mT @ M))


@highest_precision()
def form_q(Y: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Explicit dense Q = I + Y T Yᵀ  [..., m, m]."""
    m = Y.shape[-2]
    return torch.eye(m, dtype=Y.dtype, device=Y.device) + Y @ (T @ Y.mT)


@highest_precision()
def rank_masked_triangular_solve(
    R: torch.Tensor, y: torch.Tensor, k: torch.Tensor
) -> torch.Tensor:
    """Basic-solution triangular solve of rank ``k`` (a tensor, batched).

    For a column-pivoted R the dead pivots cluster at the tail, so the
    leading k×k block is the nonsingular part: rows/cols >= k are masked to
    identity, the rhs tail is zeroed, and x[k:] = 0 — Eigen
    ColPivHouseholderQR's basic least-squares solution.
    """
    n = R.shape[-1]
    i = torch.arange(n, device=R.device)
    k = torch.as_tensor(k, device=R.device)[..., None]
    live_i = i < k  # [..., n]
    live = live_i[..., :, None] & live_i[..., None, :]
    U = torch.where(live, R, torch.eye(n, dtype=R.dtype, device=R.device))
    rhs = torch.where(live_i, y, y.new_zeros(()))
    x = torch.linalg.solve_triangular(U, rhs[..., None], upper=True)[..., 0]
    return torch.where(live_i, x, x.new_zeros(()))


def rank_masked_solve(R: torch.Tensor, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """:func:`rank_masked_triangular_solve` of one ``R [n, n]`` for ``y
    [n]`` or ``[n, c]``: a matrix's columns as a batch of vector solves,
    each under the rank mask."""
    if y.dim() == 1:
        return rank_masked_triangular_solve(R, y, k)
    return rank_masked_triangular_solve(R, y.mT, k).mT


def upper_solve(R: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``R x = y`` for an upper-triangular ``R [n, n]`` and ``y [n]`` or
    ``[n, c]`` (one triangular solve over the columns)."""
    if y.dim() == 1:
        return torch.linalg.solve_triangular(R, y[:, None], upper=True)[:, 0]
    return torch.linalg.solve_triangular(R, y, upper=True)


def rank_from_diag(d: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Numerical rank from |diag(R)| [..., k] with Eigen's ColPiv-style
    threshold (eps * max(m, n) * maxpivot)."""
    d = d.abs()
    if d.shape[-1] == 0:
        return torch.zeros(d.shape[:-1], dtype=torch.int64, device=d.device)
    tol = d.amax(-1, keepdim=True).clamp_min(0) * (max(m, n) * torch.finfo(d.dtype).eps)
    return (d > tol).sum(-1)
