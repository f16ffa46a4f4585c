"""The lane-major damped Gauss–Newton step: kernel K3 and its plain version.

No Pallas counterpart: the reference runs ``lm_damped_step_blockdiag(1)``
(``qrkit_tpu/functional.py``, with ``_soa_tall_qr_solve``) as one jitted
XLA program.  :func:`damped_step_lane_major` solves ``min ‖[J; √λ·I] δ +
[r; 0]‖`` for ``J = [blkdiag(left_i) | right]`` with the point axis last
(``left [bl, bc, nb]``, ``right [bl, m2, nb]``, ``res [bl, nb]``) in one
cooperative launch a step (``csrc/lm_step.cu``):

* tasks: problem p's tiles of ``tile`` points split into
  :func:`schedule`'s ``segs`` contiguous runs, one a CTA of a persistent
  grid of at most :data:`CTAS`;
* per point (one thread a point of each tile of its run): bc Householder
  steps on the damped point block → its factor rows (R1, r12, y1) and bl
  complement rows of ``[right | −res]``, which the thread absorbs into its
  running ``[R | Qᵀy]`` (an m2 × (m2 + 1) triangle) by a Householder QR,
  :func:`batch_points` points' rows at a time;
* the warp merges its 32 carries (a column-wise QR, sums by a butterfly of
  shuffles), warp 0 the warps': the task's partial;
* the last task of a problem to arrive (an atomic ticket) reduces the
  partials and the ``√λ·I_m2`` tail in index order and solves for x2,
  then raises the problem's flag; every CTA then writes ``x1 = R1⁻¹(y1 −
  r12·x2)`` for its points.

The step is the same least-squares minimizer as the reference's one QR
over every lane, to rounding.  :func:`_damped_step_plain` runs the same
schedule in PyTorch, sum by sum (the absorbs, the butterflies, the
merges, the finish over the partials in index order), so a CPU test covers
the order the card sums in.

The wrapper is a ``torch.library.custom_op`` with a ``vmap`` rule, so the
batch fit (``lm.levenberg_marquardt_device_batch`` under ``torch.func.vmap``)
launches the kernel once over a leading problem axis (a ticket and a flag
a problem), and an autograd rule: the forward runs the kernel, the
backward the vector-Jacobian product of :func:`_damped_step_dense` (the
point pass, then one QR of the bottom panel; :func:`_mesh_step_vjp` for
the mesh form), in fp64.  A CUDA tensor runs
the kernel or raises; a CPU tensor runs the plain version.  The geometry
gate :func:`lm_step_fits` is the one other route: a step shape past the
kernel's per-thread registers takes the plain version on the card, decided
in :func:`_run` from the shape alone, never because a build or a launch
failed.  The mesh form (``gather=``) runs two launches, the rank's partial
and, after the gather, the finish and x1.  The wrapper's ``launches``
counter counts the steps that launched K3 (one a step, both mesh launches
included).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from . import _build

__all__ = ["CTAS", "TILE", "batch_points", "damped_step_lane_major", "lm_step_fits", "partial_step",
           "schedule"]

# points a tile, threads a CTA (kThreads in the source)
TILE = 256
# CTAs of the persistent grid at most (kCtas in the source)
CTAS = 132
M2_MAX = 16
# 32-bit registers a thread may give a point's damped block and its rows of
# [right | −res] together with its running [R | Qᵀy]
_REGISTERS = 192
# the kernel's modes: one launch a step; the mesh form's two
_FULL, _PARTIAL, _FINISH = 0, 1, 2


def lm_step_fits(bl: int, bc: int, m2: int, itemsize: int) -> bool:
    """Whether K3 takes a step of ``bl × bc`` point blocks and ``m2`` right
    columns in ``itemsize``-byte floats: ``1 ≤ m2 ≤ 16``, and a point's
    ``(bl + bc) × (bc + m2 + 1)`` values with the thread's carry of ``m2 (m2
    + 3) / 2`` within 192 registers (fp64: two each).  The ellipse's (2, 1,
    5) takes 82 registers in fp64, (7, 2, 5) 184; a shape that does not fit
    runs the plain version on the card too."""
    words = max(1, itemsize // 4)
    return (bl >= 1 and bc >= 1 and 1 <= m2 <= M2_MAX
            and ((bl + bc) * (bc + m2 + 1) + m2 * (m2 + 3) // 2) * words <= _REGISTERS)


def schedule(nb: int, nprob: int, tile: int = TILE, ctas: int = CTAS) -> Tuple[int, int, int]:
    """The kernel's task schedule (``geometry`` in the source): ``(tiles,
    segs, grid)``: a problem's ``tiles`` of ``tile`` points (one when there
    are none) split into ``segs = min(tiles, max(1, ctas // nprob))``
    contiguous runs, run s taking tiles ``s·tiles // segs`` up to ``(s + 1)
    ·tiles // segs``; ``grid = min(ctas, nprob·segs)`` CTAs."""
    tiles = max(1, -(-nb // tile))
    segs = min(tiles, max(1, ctas // nprob))
    return tiles, segs, min(ctas, nprob * segs)


def _nf(bc: int, m2: int) -> int:
    """Factor rows a point: R1's packed upper triangle, then r12 and y1."""
    return bc * (bc + 1) // 2 + bc * (m2 + 1)


def batch_points(bl: int, m2: int, itemsize: int) -> int:
    """Points a thread absorbs at once (``kBatch`` in the source): their
    ``bl`` rows of ``m2 + 1`` values each stacked within 48 registers, 1 to 4."""
    return min(4, max(1, 48 // (bl * (m2 + 1) * max(1, itemsize // 4))))


def _reflector(x0: torch.Tensor, sigma: torch.Tensor, sqrt: Callable = torch.sqrt):
    """Unnormalized Householder reflector of a column with pivot x0 and
    squared tail norm sigma: ``H = I − u uᵀ · c`` with ``u = (x0 − β,
    tail)`` and ``c = 1/(β(β − x0))`` (0 when the tail is zero, H = I).
    Returns (β, c, degenerate); one reciprocal per column (the derivation of
    ``ops.blockdiag._householder_inplace``; β(β − x0) = ‖x‖² + ‖x‖·|x0| > 0
    away from the degenerate branch)."""
    one = torch.ones_like(x0)
    norm = sqrt(x0 * x0 + sigma)
    beta = torch.where(x0 >= 0, -norm, norm)
    degen = sigma <= 0
    t = beta * (beta - x0)
    c = torch.where(degen, torch.zeros_like(x0), one / torch.where(degen, one, t))
    return beta, c, degen


def _masked_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """sqrt with sqrt(0) = 0 taken as sqrt(1) masked to 0: the plain
    version's backward through a zero column (a padded lane's) stays
    finite.  The values are sqrt's."""
    zero = sq == 0
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


def _carry_reflector(x0: torch.Tensor, sigma: torch.Tensor):
    """:func:`_reflector` of a carry column, as the kernel's
    ``carry_reflector``: also degenerate where ``β(β − x0)`` is below the
    dtype's smallest normal number (a carry of fewer rows than m2 holds
    columns of rounding noise, whose reciprocal would overflow)."""
    one = torch.ones_like(x0)
    norm = _masked_sqrt(x0 * x0 + sigma)
    beta = torch.where(x0 >= 0, -norm, norm)
    t = beta * (beta - x0)
    degen = (sigma <= 0) | (t < torch.finfo(x0.dtype).tiny)
    c = torch.where(degen, torch.zeros_like(x0), one / torch.where(degen, one, t))
    return beta, c, degen


# --- the plain version -----------------------------------------------------------------

def _point_pass_plain(left, right, res, lam):
    """The kernel's point pass on ``[P, …, nb]`` operands: (fac ``[P, nf, nb]``,
    the complement rows ``[P, bl, m2 + 1, nb]``).  Per-entry tensors, summed
    in the kernel's order."""
    P, bl, bc, nb = left.shape
    m2 = right.shape[2]
    R = m2 + 1
    zero = left.new_zeros((P, nb))
    sl = torch.sqrt(lam)[:, None].expand(P, nb)
    a = [[left[:, i, c] for c in range(bc)] for i in range(bl)]
    a += [[sl if i == c else zero for c in range(bc)] for i in range(bc)]
    B = [[right[:, i, c] for c in range(m2)] + [-res[:, i]] for i in range(bl)]
    B += [[zero] * R for _ in range(bc)]
    br = bl + bc
    r1 = [[None] * bc for _ in range(bc)]
    for j in range(bc):
        x0 = a[j][j]
        sigma = zero
        for i in range(j + 1, br):
            sigma = sigma + a[i][j] * a[i][j]
        beta, c, degen = _reflector(x0, sigma, _masked_sqrt)
        u = [None] * j + [x0 - beta] + [a[i][j] for i in range(j + 1, br)]
        for rows, cols in ((a, range(j + 1, bc)), (B, range(R))):
            for col in cols:
                w = zero
                for i in range(j, br):
                    w = w + u[i] * rows[i][col]
                w = c * w
                for i in range(j, br):
                    rows[i][col] = rows[i][col] - u[i] * w
        r1[j][j] = torch.where(degen, x0, beta)
        for col in range(j + 1, bc):
            r1[j][col] = a[j][col]
    fac = [r1[j][col] for j in range(bc) for col in range(j, bc)]
    fac += [B[j][col] for j in range(bc) for col in range(R)]
    comp = torch.stack([torch.stack(B[bc + i], 1) for i in range(bl)], 1)
    return torch.stack(fac, 1), comp


def _absorb(cr, rows):
    """The Householder QR of ``[cr; rows]`` into the carry, as the kernel's
    ``absorb``: ``cr`` a list of m2 rows ``[..., m2 + 1]`` (row j of R, zero
    before column j, then Qᵀy), ``rows [..., L, m2 + 1]``.  Per column j the
    pivot ``cr[j][j]``, σ summed over the rows in order, the reflector,
    ``w_r = c (cr[j][r] (x0 − β) + Σ_l rows[l][r] rows[l][j])`` and the
    updates.  Zero rows change no bit.  Returns the new carry rows."""
    m2 = len(cr)
    L = rows.shape[-2]
    cr = list(cr)
    for j in range(m2):
        x0 = cr[j][..., j]
        col = rows[..., :, j]
        sigma = torch.zeros_like(x0)
        for l in range(L):
            sigma = sigma + col[..., l] * col[..., l]
        beta, c, degen = _carry_reflector(x0, sigma)
        ud = x0 - beta
        acc = cr[j][..., j + 1:] * ud[..., None]
        for l in range(L):
            acc = acc + rows[..., l, j + 1:] * col[..., l, None]
        w = c[..., None] * acc
        cr[j] = torch.cat([cr[j][..., :j], torch.where(degen, x0, beta)[..., None],
                           cr[j][..., j + 1:] - w * ud[..., None]], dim=-1)
        rows = torch.cat([rows[..., : j + 1], rows[..., j + 1:] - w[..., None, :] * col[..., None]], dim=-1)
    return cr


def _butterfly(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``warp_sum`` of ``x [..., 32, k]`` over its lanes: the
    halves added (lane i + lane i + 16), then their halves, down to one."""
    while x.shape[-2] > 1:
        h = x.shape[-2] // 2
        x = x[..., :h, :] + x[..., h:, :]
    return x[..., 0, :]


def _pad_axis(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to length ``n``."""
    dim = dim % x.dim()
    extra = n - x.shape[dim]
    if extra <= 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:dim] + (extra,) + x.shape[dim + 1:])], dim=dim)


def _warp_merge(cr: torch.Tensor) -> torch.Tensor:
    """The kernel's ``warp_merge`` of ``cr [..., 32, m2, m2 + 1]`` (a carry a
    lane): the column-wise QR of the stacked triangles, lane 0's rows the
    pivots; every other lane sums its rows 0..j, the butterfly adds the
    lanes.  Returns lane 0's merged carry ``[..., m2, m2 + 1]``."""
    m2 = cr.shape[-2]
    piv = [cr[..., 0, j, :] for j in range(m2)]
    oth = [cr[..., 1:, l, :] for l in range(m2)]  # [..., 31, m2 + 1] each
    for j in range(m2):
        part = torch.zeros_like(oth[0][..., j:])
        for l in range(j + 1):
            part = part + oth[l][..., j:] * oth[l][..., j, None]
        tot = _butterfly(torch.cat([torch.zeros_like(part[..., :1, :]), part], dim=-2))
        x0, sigma = piv[j][..., j], tot[..., 0]
        beta, c, degen = _carry_reflector(x0, sigma)
        ud = x0 - beta
        w = c[..., None] * (tot[..., 1:] + piv[j][..., j + 1:] * ud[..., None])
        piv[j] = torch.cat([piv[j][..., :j], torch.where(degen, x0, beta)[..., None],
                            piv[j][..., j + 1:] - w * ud[..., None]], dim=-1)
        for l in range(j + 1):
            oth[l] = torch.cat([oth[l][..., : j + 1],
                                oth[l][..., j + 1:] - w[..., None, :] * oth[l][..., j, None]], dim=-1)
    return torch.stack(piv, dim=-2)


def _cta_merge(cr: torch.Tensor) -> torch.Tensor:
    """The kernel's ``cta_merge`` of a CTA's thread carries ``cr [..., T, m2,
    m2 + 1]``: each warp of 32 (zero carries past T) merged, then the warps'
    carries (zeros past them) by warp 0.  Zero carries change no bit."""
    *lead, T, m2, R = cr.shape
    W = -(-T // 32)
    warps = _warp_merge(_pad_axis(cr, -3, 32 * W).reshape(*lead, W, 32, m2, R))
    return _warp_merge(_pad_axis(warps, -3, 32))


def _as_stack(cr: torch.Tensor) -> torch.Tensor:
    """Carries ``[P, G, m2, m2 + 1]`` as a lane-major partial stack ``[P, m2 +
    1, G · m2]``: row c, lane g·m2 + l holds carry g's R[l][c] (zero below
    its diagonal), row m2 its Qᵀy."""
    P, G, m2, R = cr.shape
    return cr.permute(0, 3, 1, 2).reshape(P, R, G * m2)


def _task_carries_plain(comp: torch.Tensor, tile: int, segs: int, tiles: int) -> torch.Tensor:
    """Each task's partial ``[P, segs, m2, m2 + 1]`` from the complement rows
    ``[P, bl, m2 + 1, nb]``: thread t of task s takes point ``k·tile + t`` of
    each tile k of run s, absorbs their rows :func:`batch_points` tiles at a
    time as one stack (zeros past the run or the points), then the CTA
    merge."""
    P, bl, R, nb = comp.shape
    m2 = R - 1
    B = batch_points(bl, m2, comp.element_size())
    dev = comp.device
    seg = torch.arange(segs, device=dev)
    t0, t1 = seg * tiles // segs, (seg + 1) * tiles // segs
    chunks = -(-(-(-tiles // segs)) // B)  # chunks of the longest run
    tile_id = t0[:, None] + torch.arange(chunks * B, device=dev)  # [segs, chunks·B]
    p = tile_id[..., None] * tile + torch.arange(tile, device=dev)  # [segs, chunks·B, tile]
    idx = torch.where((tile_id < t1[:, None])[..., None] & (p < nb), p, torch.full_like(p, nb))
    padded = torch.cat([comp, comp.new_zeros((P, bl, R, 1))], dim=-1)  # point nb: zeros
    rows = padded[..., idx].permute(0, 3, 5, 4, 1, 2)  # [P, segs, tile, chunks·B, bl, R]
    rows = rows.reshape(P, segs, tile, chunks, B * bl, R)
    cr = [comp.new_zeros((P, segs, tile, R)) for _ in range(m2)]
    for k in range(chunks):
        cr = _absorb(cr, rows[:, :, :, k])
    return _cta_merge(torch.stack(cr, dim=-2))


def _reduce_partials_plain(stack: torch.Tensor, tile: int, sl: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's finish (``load_partials``, then the CTA merge): the Q
    partials of ``stack [P, m2 + 1, Q · m2]``, then (``sl`` given: √λ
    ``[P]``) the tail ``√λ·I_m2`` as one more triangle; thread t of
    ``tile`` copies the first of its contiguous block of ``k = ⌈count /
    tile⌉`` triangles and absorbs the rest in index order, then the CTA
    merge.  Returns the carry ``[P, m2, m2 + 1]``."""
    P, R, lanes = stack.shape
    m2 = R - 1
    if sl is not None:  # √λ in lane c of row c, 0 in y
        diag = torch.diag_embed(sl[:, None].expand(P, m2))
        stack = torch.cat([stack, torch.cat([diag, diag.new_zeros((P, 1, m2))], dim=1)], dim=-1)
    count = stack.shape[-1] // m2
    k = -(-count // tile)
    parts = _pad_axis(stack.reshape(P, R, count, m2).permute(0, 2, 3, 1), 1, tile * k)
    parts = parts.reshape(P, tile, k, m2, R)
    cr = [parts[:, :, 0, j] for j in range(m2)]
    for i in range(1, k):
        cr = _absorb(cr, parts[:, :, i])
    return _cta_merge(torch.stack(cr, dim=-2))


def _solve_x2_plain(cr: torch.Tensor) -> torch.Tensor:
    """``R x2 = (Qᵀy)[:m2]`` from carries ``[P, m2, m2 + 1]`` → x2 ``[P, m2]``."""
    m2 = cr.shape[-2]
    x2 = [None] * m2
    for i in range(m2 - 1, -1, -1):
        acc = cr[:, i, m2]
        for c in range(i + 1, m2):
            acc = acc - cr[:, i, c] * x2[c]
        x2[i] = acc / cr[:, i, i]
    return torch.stack(x2, 1)


def _backsub_plain(fac: torch.Tensor, x2: torch.Tensor, bc: int) -> torch.Tensor:
    """The kernel's x1: ``x1 [P, bc, nb]`` from the factor rows and x2 ``[P, m2]``."""
    m2 = x2.shape[1]
    e = bc * (bc + 1) // 2
    r1, k = {}, 0
    for j in range(bc):
        for col in range(j, bc):
            r1[j, col] = fac[:, k]
            k += 1
    rhs = []
    for j in range(bc):
        s = torch.zeros_like(fac[:, 0])
        for c in range(m2):
            s = s + fac[:, e + c] * x2[:, c, None]
        rhs.append(fac[:, e + m2] - s)
        e += m2 + 1
    x1 = [None] * bc
    for j in range(bc - 1, -1, -1):
        acc = rhs[j]
        for col in range(j + 1, bc):
            acc = acc - r1[j, col] * x1[col]
        x1[j] = acc / r1[j, j]
    return torch.stack(x1, 1)


def _plain_factors(left, right, res, lam, tile: int = TILE, gather: Optional[Callable] = None,
                   ctas: int = CTAS):
    """The plain version up to the finish, in the kernel's schedule
    (:func:`schedule` with ``ctas``): the per-point pass, each task's
    carries and merges, the finish over the task partials in index order
    with the tail.  Returns (the factor rows ``[P, nf, nb]``, the finish's
    carry ``[P, m2, m2 + 1]``: R2 and its Qᵀy).  ``gather``: see :func:`_run`."""
    P, bl, bc, nb = left.shape
    tiles, segs, _ = schedule(nb, P, tile, ctas)
    fac, comp = _point_pass_plain(left, right, res, lam)
    stack = _as_stack(_task_carries_plain(comp, tile, segs, tiles))
    if gather is not None:  # the rank's one partial, then every rank's
        stack = gather(_as_stack(_reduce_partials_plain(stack, tile, None)[:, None]))
    return fac, _reduce_partials_plain(stack, tile, torch.sqrt(lam))


def _damped_step_plain(left, right, res, lam, tile: int = TILE,
                       gather: Optional[Callable] = None, ctas: int = CTAS) -> torch.Tensor:
    """The plain version of :func:`damped_step_lane_major` on ``[P, …]``
    operands (``lam [P]``), in the kernel's schedule (:func:`_plain_factors`),
    then x2 and x1; returns ``[P, bc·nb + m2]``."""
    P, bl, bc, nb = left.shape
    fac, top = _plain_factors(left, right, res, lam, tile, gather, ctas)
    x2 = _solve_x2_plain(top)
    x1 = _backsub_plain(fac, x2, bc)
    return torch.cat([x1.reshape(P, bc * nb), x2], dim=1)


def _x2_dense(rows: torch.Tensor, sl: torch.Tensor) -> torch.Tensor:
    """x2 of the bottom panel by one QR, without the kernel's tiles: ``rows
    [P, n, m2 + 1]`` (the points' complement rows, ``[right | −res]``
    reduced) under the tail ``[√λ·I_m2 | 0]`` (``sl [P]``); the reduced QR
    ``[A; √λ·I] = Q R2`` of the m2 columns (R2 invertible while λ > 0),
    then ``R2 x2 = Qᵀy``.  Its derivative is the backward's route."""
    P, n, R = rows.shape
    m2 = R - 1
    A = torch.cat([rows[..., :m2], torch.diag_embed(sl[:, None].expand(P, m2))], dim=1)
    y = torch.cat([rows[..., m2], rows.new_zeros((P, m2))], dim=1)
    Q, R2 = torch.linalg.qr(A)
    return torch.linalg.solve_triangular(R2, Q.mT @ y[..., None], upper=True)[..., 0]


def _rows(comp: torch.Tensor) -> torch.Tensor:
    """Complement rows ``[P, bl, m2 + 1, nb]`` as a row stack ``[P, nb·bl, m2 + 1]``."""
    P, bl, R, nb = comp.shape
    return comp.permute(0, 3, 1, 2).reshape(P, nb * bl, R)


def _damped_step_dense(left, right, res, lam) -> torch.Tensor:
    """The step without the kernel's schedule: the point pass, then x2 by
    one QR of every point's complement rows (:func:`_x2_dense`), then x1;
    ``[P, bc·nb + m2]``.  The same minimizer as :func:`_damped_step_plain`
    to rounding; the backward differentiates this one, whose reflectors see
    no column of rounding noise (a thread's carry of fewer rows than m2
    holds such columns, and their derivatives lose up to 1e-5 of the
    gradient in fp64 and overflow fp32)."""
    P, bl, bc, nb = left.shape
    fac, comp = _point_pass_plain(left, right, res, lam)
    x2 = _x2_dense(_rows(comp), torch.sqrt(lam))
    return torch.cat([_backsub_plain(fac, x2, bc).reshape(P, bc * nb), x2], dim=1)


def _mesh_step_vjp(left, right, res, lam, stack, q: int, g1, g2, reduce: Callable):
    """The mesh form's vector-Jacobian product on this rank's ``[1, …]``
    operands (``lam [1]``), by :func:`_damped_step_dense`'s route, in fp64
    (:func:`_wide`).

    ``stack [1, m2 + 1, world·m2]`` holds every rank's partial (this rank's
    is partial ``q``, which its own complement rows stand in for); ``g1 [1,
    bc, nb]`` is the cotangent of the rank's x1, ``g2 [1, m2]`` x2's (the
    same on every rank).  x2 = F(partials, λ) is the same on every rank and
    x1 = B(fac, x2) the rank's own, so x2's whole cotangent is ``c = g2 +
    Σ_ranks ∂B/∂x2ᵀ g1``, and λ's gradient is ``∂F/∂λᵀ c`` (the tail) plus
    ``Σ_ranks (∂B/∂λᵀ g1 + cᵀ t)`` with ``t`` the derivative of x2 by λ
    through the rank's points (forward mode).  ``reduce`` sums those 2·m2 +
    1 values over the ranks: the one collective.  Each rank carries ``c``
    back through its own rows to its points' operands.  Returns the
    gradients of left, right, res and lam."""
    import torch.autograd.forward_ad as fwAD

    dtypes = [t.dtype for t in (left, right, res, lam)]
    left, right, res, lam, stack, g1, g2 = _wide(left, right, res, lam, stack, g1, g2)
    P, R, lanes = stack.shape
    bc, m2 = left.shape[2], R - 1
    parts = stack.reshape(P, R, lanes // m2, m2).permute(0, 2, 3, 1)  # [P, world, m2, m2 + 1]
    others = torch.cat([parts[:, :q], parts[:, q + 1:]], dim=1).reshape(P, -1, R)

    def x2_of(comp, s):
        return _x2_dense(torch.cat([others, _rows(comp)], dim=1), torch.sqrt(s))

    with torch.enable_grad():
        ops = [t.detach().requires_grad_() for t in (left, right, res, lam)]
        lam_tail = lam.detach().requires_grad_()
        fac, comp = _point_pass_plain(*ops)
        x2 = x2_of(comp, lam_tail)
        x2_in = x2.detach().requires_grad_()
        ga = torch.autograd.grad(_backsub_plain(fac, x2_in, bc), (*ops, x2_in), g1, retain_graph=True)
    with torch.no_grad(), fwAD.dual_level():
        dual = fwAD.make_dual(lam, torch.ones_like(lam))
        t = fwAD.unpack_dual(x2_of(_point_pass_plain(left, right, res, dual)[1], lam)).tangent
    sums = reduce(torch.cat([ga[4], ga[3][:, None], t], dim=1))
    c = g2 + sums[:, :m2]
    gb = torch.autograd.grad(x2, (*ops[:3], lam_tail), c)
    g_lam = gb[3] + sums[:, m2] + (c * sums[:, m2 + 1:]).sum(1)
    grads = (ga[0] + gb[0], ga[1] + gb[1], ga[2] + gb[2], g_lam)
    return tuple(g.to(dt) for g, dt in zip(grads, dtypes))


# --- the kernel ------------------------------------------------------------------------

def _damped_step_kernel(left, right, res, lam, tile: int, gather: Optional[Callable] = None, *,
                        partial: bool = False, extra=()) -> torch.Tensor:
    """K3 on CUDA operands ``[P, …]`` whose shape passes :func:`lm_step_fits`:
    one launch (kFull), returning ``[P, bc·nb + m2]``; with ``gather`` the
    rank's partial (kPartial), the gather, then the finish and x1
    (kFinish); with ``partial`` the first mode alone, returning each
    problem's partial ``[P, m2 + 1, m2]``.  ``extra``: a measurement
    build's defines (``_build.build_lm_step``; its C is ``QRK_CTAS``)."""
    P, bl, bc, nb = left.shape
    m2 = right.shape[2]
    dt, dev = left.dtype, left.device.index
    if tile % 32 or not 32 <= tile <= TILE:
        raise ValueError(f"tile={tile}: K3 takes a multiple of 32 points up to {TILE}")
    _, segs, _ = schedule(nb, P, tile, dict(extra).get("QRK_CTAS", CTAS))
    left, right, res, lam = (t.contiguous() for t in (left, right, res, lam))
    fac = left.new_empty((P, _nf(bc, m2), nb))
    stack = left.new_empty((P, m2 + 1, segs * m2))
    counters = left.new_empty((2 * P,), dtype=torch.int32)
    stride = bc * nb + m2
    out = left.new_empty((P, stride))
    launch = _build.lm_step_launcher("step", bl, bc, m2, dt, tuple(extra))
    ops = tuple(t.data_ptr() for t in (left, right, res, lam, fac, stack))
    if gather is None and not partial:
        launch(dev, *ops, None, 0, out.data_ptr(), stride, counters.data_ptr(), nb, P, tile, _FULL)
        damped_step_lane_major.launches += 1
        return out
    part = left.new_empty((P, m2 + 1, m2))
    launch(dev, *ops, None, 0, part.data_ptr(), 0, counters.data_ptr(), nb, P, tile, _PARTIAL)
    damped_step_lane_major.launches += 1
    if partial:
        return part
    gathered = gather(part).contiguous()
    launch(dev, *ops, gathered.data_ptr(), gathered.shape[2] // m2, out.data_ptr(), stride,
           counters.data_ptr(), nb, P, tile, _FINISH)
    return out


def partial_step(left: torch.Tensor, right: torch.Tensor, res: torch.Tensor, lam: torch.Tensor, *,
                 tile: int = TILE, extra=()) -> torch.Tensor:
    """K3's first mode alone on CUDA operands ``[P, …]`` (``lam [P]``): the
    point pass through the last CTA's reduction to each problem's one
    partial ``[P, m2 + 1, m2]``, without the tail, the wait or x1.  It
    times the point pass apart (``chip_smoke.py``, ``profile_lm_step.py``);
    counted as a step.  ``extra``: :func:`_damped_step_kernel`."""
    return _damped_step_kernel(left, right, res, lam, int(tile), partial=True, extra=extra)


def _run(left, right, res, lam, tile: int, gather=None) -> torch.Tensor:
    """The step on ``[P, …]`` operands: the kernel on CUDA tensors, the
    plain version on CPU tensors and, by the geometry gate
    :func:`lm_step_fits` alone, on CUDA tensors of a shape past it.
    ``gather`` (a mesh): takes the rank's one partial ``[1, m2 + 1, m2]``
    to the stack of every rank's ``[1, m2 + 1, world · m2]``, which the
    finish reduces with the tail."""
    if left.device.type == "cpu":
        return _damped_step_plain(left, right, res, lam, tile, gather)
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    _, bl, bc, _ = left.shape
    if not lm_step_fits(bl, bc, right.shape[2], left.element_size()):
        return _damped_step_plain(left, right, res, lam, tile, gather)
    return _damped_step_kernel(left, right, res, lam, int(tile), gather)


@torch.library.custom_op("qrkit_tpu_torch::lm_damped_step", mutates_args=())
def _step_op(left: torch.Tensor, right: torch.Tensor, res: torch.Tensor, lam: torch.Tensor,
             tile: int) -> torch.Tensor:
    """The step over a leading problem axis."""
    return _run(left, right, res, lam, tile)


@_step_op.register_fake
def _(left, right, res, lam, tile):
    return left.new_empty((left.shape[0], left.shape[2] * left.shape[3] + right.shape[2]))


def _step_setup(ctx, inputs, output):
    *operands, ctx.tile = inputs
    ctx.save_for_backward(*operands)


def _step_backward(ctx, grad):
    """The kernel computes no derivative: the backward is the
    vector-Jacobian product of :func:`_damped_step_dense` (the derivative of
    the same minimizer), recomputed from the saved operands in fp64
    (:func:`_wide`)."""
    ops = ctx.saved_tensors
    _, vjp = torch.func.vjp(_damped_step_dense, *_wide(*ops))
    return (*(g.to(t.dtype) for g, t in zip(vjp(grad.double()), ops)), None)


def _wide(*ts):
    """The backward's operands in fp64 whatever their type: an fp32 step's
    gradient is the fp64 derivative at its operands."""
    return tuple(t.double() for t in ts)


_step_op.register_autograd(_step_backward, setup_context=_step_setup)


def _step_vmap(info, in_dims, left, right, res, lam, tile):
    """vmap rule: the vmapped axis joins the problem axis (one launch of
    each kernel for the whole batch)."""
    n = info.batch_size

    def merge(t, d):
        t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
        return t.reshape(n * t.shape[1], *t.shape[2:])

    out = _step_op(*(merge(t, d) for t, d in zip((left, right, res, lam), in_dims[:4])), tile)
    return out.reshape(n, -1, out.shape[-1]), 0


torch.library.register_vmap(_step_op, _step_vmap)


def _check(left, right, res, lam):
    for name, t in (("left", left), ("right", right), ("res", res), ("lam", lam)):
        if t.dtype not in _build._SUFFIX or t.dtype != left.dtype or t.device != left.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}; the step takes float32 or float64 "
                            f"operands of one dtype on one device")
    if left.dim() < 3:
        raise ValueError(f"left must be [..., bl, bc, nb], got {tuple(left.shape)}")
    *lead, bl, bc, nb = left.shape
    if right.dim() != left.dim() or tuple(right.shape[:-2]) != (*lead, bl) or right.shape[-1] != nb:
        raise ValueError(f"right {tuple(right.shape)} does not match left {tuple(left.shape)}")
    if tuple(res.shape) != (*lead, bl, nb):
        raise ValueError(f"res {tuple(res.shape)} does not match left {tuple(left.shape)}")
    return lead


def damped_step_lane_major(left: torch.Tensor, right: torch.Tensor, res: torch.Tensor,
                           lam: torch.Tensor, *, tile: int = TILE,
                           gather: Optional[Callable] = None) -> torch.Tensor:
    """The lane-major damped step (kernel K3): ``left [..., bl, bc, nb]``,
    ``right [..., bl, m2, nb]``, ``res [..., bl, nb]``, ``lam`` a tensor
    broadcastable to the leading axes ``...`` (independent problems);
    returns ``[..., bc·nb + m2]``: x1 ``[bc, nb]`` flattened, then x2.

    ``tile``: points a tile, threads a CTA (a multiple of 32 up to 256 on
    the card; any positive count on the CPU).  ``gather`` (a mesh, no
    leading axes): the rank's one partial to every rank's stack
    (:func:`_run`).  Runs the kernel on a CUDA tensor (or raises), the
    plain version on a CPU tensor, and on either device differentiates
    through :func:`_damped_step_dense`.  The mesh form
    has no autograd rule here (``gather`` is the caller's collective), so
    it refuses operands that require grad on either device:
    ``functional.lm_damped_step_blockdiag(1)(mesh=)`` differentiates it."""
    lead = _check(left, right, res, lam)
    *_, bl, bc, nb = left.shape
    m2 = right.shape[-2]
    if tile < 1:
        raise ValueError(f"tile={tile}: a tile holds at least one point")
    P = math.prod(lead)
    flat = (left.reshape(P, bl, bc, nb), right.reshape(P, bl, m2, nb), res.reshape(P, bl, nb),
            lam.expand(lead).reshape(P))
    if gather is None:
        out = _step_op(*flat, int(tile))
    elif lead:
        raise ValueError("a mesh step takes no leading problem axes")
    elif torch.is_grad_enabled() and any(t.requires_grad for t in (left, right, res, lam)):
        raise ValueError("the mesh form of the step has no backward here: differentiate "
                         "functional.lm_damped_step_blockdiag(mesh=), whose backward "
                         "all-reduces")
    else:
        out = _run(*flat, tile, gather)
    return out.reshape(*lead, bc * nb + m2)


damped_step_lane_major.launches = 0
