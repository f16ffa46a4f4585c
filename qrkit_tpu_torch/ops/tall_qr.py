"""The R-only tall-skinny QR of the block-angular steps' bottom: kernel K5
and its plain version.

No Pallas counterpart: the reference's block-angular step reduces its
bottom by a TSQR (here :mod:`~qrkit_tpu_torch.parallel.tsqr`, ``geqrf``,
the compact-WY T factors and Qᵀ on the rhs), which keeps Q; the port keeps
that for :class:`~qrkit_tpu_torch.parallel.TSQRDenseQR`.  The steps of
:mod:`~qrkit_tpu_torch.functional` (the dense
:func:`~qrkit_tpu_torch.functional.block_angular_lstsq`, one device or
``mesh=``, and the ragged ``block_angular_lstsq_ragged``) need only R2 and
y2 = (Q2ᵀ rhs)[:n] of their bottom ``[J2 | rhs]``; :func:`r_and_qtb`
computes them by Householder reflections and keeps nothing else.

The schedule (``csrc/tall_qr.cu``, panel CAQR keeping R): the n columns in
panels of ``PANEL`` (the last one narrower), the rhs always a trailing
column.  A panel's leaf factors each tile of ``TILE`` rows (the reflector
convention of :mod:`~qrkit_tpu_torch.ops.householder`, R's diagonal β
itself) and applies its compact-WY Qᵀ to the tile's trailing columns in
place; then the levels of a tree of fan-in ``TILE // PANEL`` factor the
stacks of the tiles' R blocks with their top ``PANEL`` rows' trailing
columns, until one group is left: its R and its top rows are the panel's
rows of R2 (and y2 at the rhs), which leave the working matrix as zeros.
K5 is one kernel launched ``1 + levels`` times a panel; a CTA keeps V and
T in shared memory.

The plain version repeats the panels, tiles and tree levels in torch (the
same reflectors, T by :func:`~qrkit_tpu_torch.ops.householder.build_t_factor`,
batched over the tiles): a CPU tensor runs it; a CUDA tensor launches the
kernel or raises.  The two sum in other orders, so they agree to
rounding.  Both overwrite the operand (the step's own temporary).
:func:`r_and_qtb`'s ``launches`` counts K5's launches.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _build
from .householder import build_t_factor, highest_precision

__all__ = ["PANEL", "TILE", "Plan", "plan", "r_and_qtb"]

PANEL = 32  # columns a panel (kB in the source)
TILE = 256  # rows a tile, and a tree level's virtual tile (kH)
FAN_IN = TILE // PANEL


class Plan(NamedTuple):
    """K5's schedule for an ``[m, n + 1]`` operand."""

    tiles: int  # the leaf's tiles of TILE rows (at least 1)
    levels: int  # tree levels over them
    panels: int
    launches: int  # panels × (1 + levels)
    scratch_blocks: int  # PANEL × PANEL R blocks of the two scratch buffers


def plan(m: int, n: int) -> Plan:
    """The schedule of an ``[m, n + 1]`` operand (``qrk_tall_qr_plan``)."""
    tiles = max(1, -(-m // TILE))
    levels, c = 0, tiles
    while c > 1:
        c, levels = -(-c // FAN_IN), levels + 1
    panels = -(-n // PANEL)
    return Plan(tiles, levels, panels, panels * (1 + levels), tiles + -(-tiles // FAN_IN))


# --- the plain version -------------------------------------------------------------------

def _panel_qr(P: torch.Tensor):
    """Householder QR of each panel ``P [G, TILE, pw]`` (overwritten), a
    column at a time as the kernel's CTA runs it: the reference's reflector
    (:func:`~qrkit_tpu_torch.ops.householder.householder_qr_unblocked`), v
    scaled by the reciprocal of x0 − β as LAPACK scales it, R's diagonal β
    itself.  Returns (V [G, TILE, pw], τ [G, pw], R [G, PANEL, pw]: rows
    past pw zero)."""
    G, h, pw = P.shape
    rows = torch.arange(h, device=P.device)
    V = P.new_zeros((G, h, pw))
    taus = P.new_zeros((G, pw))
    zero, one = P.new_zeros(()), P.new_ones(())
    for j in range(pw):
        x = P[:, :, j]
        x0 = x[:, j]
        tail = torch.where(rows > j, x, zero)
        sigma = (tail * tail).sum(-1)
        norm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -norm, norm)
        degenerate = sigma <= 0
        denom = torch.where(degenerate, one, x0 - beta)
        tau = torch.where(degenerate, zero, (beta - x0) / torch.where(norm == 0, one, beta))
        v = torch.where(rows > j, x * (1 / denom)[:, None], (rows == j).to(P.dtype))
        V[:, :, j], taus[:, j] = v, tau
        if j + 1 < pw:
            wv = tau[:, None] * (v[:, None, :] @ P[:, :, j + 1:])[:, 0]
            P[:, :, j + 1:] -= v[:, :, None] * wv[:, None, :]
        P[:, j, j] = torch.where(degenerate, x0, beta)
    R = P.new_zeros((G, PANEL, pw))
    R[:, :pw] = torch.triu(P[:, :pw])
    return V, taus, R


def _tile_step(panel: torch.Tensor, trail: torch.Tensor) -> torch.Tensor:
    """One level's work on tiles ``panel [G, TILE, pw]`` (copied) and their
    trailing columns ``trail [G, TILE, w]`` (updated in place by Qᵀ); returns
    the tiles' R blocks ``[G, PANEL, pw]``."""
    V, taus, R = _panel_qr(panel.clone())
    T = build_t_factor(V, taus)  # negated: Q = I + V T Vᵀ
    trail += V @ (T.mT @ (V.mT @ trail))
    return R


@highest_precision()
def _r_and_qtb_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    m, N = a.shape
    n = N - 1
    p = plan(m, n)
    R2, y2 = a.new_zeros((n, n)), a.new_zeros((n,))
    full = m // TILE
    for p0 in range(0, n, PANEL):
        pw = min(PANEL, n - p0)
        c1 = p0 + pw
        # the leaf: full tiles as a view; the short last tile zero-padded
        R = []
        if full:
            tiles = a[: full * TILE].view(full, TILE, N)
            R.append(_tile_step(tiles[..., p0:c1], tiles[..., c1:]))
        if full < p.tiles:
            rest = a.new_zeros((1, TILE, N - p0))
            rest[0, : m - full * TILE] = a[full * TILE:, p0:]
            R.append(_tile_step(rest[..., :pw], rest[..., pw:]))
            a[full * TILE:, c1:] = rest[0, : m - full * TILE, pw:]
        S = torch.cat(R)
        # the tree: a group's virtual tile is its members' R blocks and
        # their tiles' top PANEL rows; the rows that exist are a prefix (only
        # the last member's tile may be short)
        members, stride = p.tiles, 1
        while members > 1:
            groups = -(-members // FAN_IN)
            live = (members - 1) * PANEL + min(PANEL, m - (members - 1) * stride * TILE)
            i = torch.arange(members, device=a.device)
            rows = (i[:, None] * (stride * TILE) + torch.arange(PANEL, device=a.device)).reshape(-1)[:live]
            panel = a.new_zeros((groups * FAN_IN, PANEL, pw))
            panel[:members] = S
            trail = a.new_zeros((groups * TILE, N - c1))
            trail[:live] = a[rows, c1:]
            S = _tile_step(panel.reshape(groups, TILE, pw), trail.view(groups, TILE, N - c1))
            a[rows, c1:] = trail[:live]
            members, stride = groups, stride * FAN_IN
        # the panel's rows of R2 and y2 leave the working matrix
        top = min(pw, m)
        R2[p0:c1, p0:c1] = S[0, :pw]
        R2[p0:p0 + top, c1:] = a[:top, c1:n]
        y2[p0:p0 + top] = a[:top, n]
        a[:top, c1:] = 0
    return R2, y2


# --- the kernel --------------------------------------------------------------------------

def _check(a) -> None:
    if not isinstance(a, torch.Tensor) or a.dim() != 2 or a.shape[1] < 2:
        raise ValueError(f"a must be [m, n + 1] with n >= 1, got "
                         f"{tuple(a.shape) if isinstance(a, torch.Tensor) else type(a).__name__}")
    if a.dtype not in _build._SUFFIX:
        raise ValueError(f"a is {a.dtype}; K5 takes float32 or float64")
    if a.shape[0] > 1 and (a.stride(1) != 1 or a.stride(0) < a.shape[1]):
        raise ValueError(f"a's rows must be contiguous (strides {a.stride()})")


def _r_and_qtb_kernel(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if a.device.type != "cuda":
        raise ValueError(f"K5 runs on a CUDA tensor, got one on {a.device}")
    m, N = a.shape
    n = N - 1
    p = plan(m, n)
    R2, y2 = a.new_empty((n, n)), a.new_empty((n,))
    scratch = a.new_empty((p.scratch_blocks, PANEL, PANEL))
    lda = a.stride(0) if m > 1 else N
    _build.tall_qr_launcher(a.dtype)(a.device.index, a.data_ptr(), lda, m, n, R2.data_ptr(),
                                     y2.data_ptr(), scratch.data_ptr(), p.scratch_blocks)
    r_and_qtb.launches += p.launches
    return R2, y2


def r_and_qtb(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """R2 ``[n, n]`` (upper triangular) and y2 = (Q2ᵀ rhs)[:n] ``[n]`` of
    ``a = [J | rhs] [m, n + 1]`` (its rows contiguous, float32 or float64;
    any m ≥ 0): the R factor of ``[J | rhs]``'s Householder QR, its rows'
    signs as the reflectors leave them, and its last column.  ``a`` is
    overwritten.  Kernel K5 on a CUDA tensor, the plain version on a CPU
    one."""
    _check(a)
    if a.device.type == "cpu":
        return _r_and_qtb_plain(a)
    return _r_and_qtb_kernel(a)


r_and_qtb.launches = 0
