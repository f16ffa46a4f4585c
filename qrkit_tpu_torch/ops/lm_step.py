"""The lane-major damped Gauss–Newton step: kernel K3 and its plain version.

No Pallas counterpart: the reference runs ``lm_damped_step_blockdiag(1)``
(``qrkit_tpu/functional.py``, with ``_soa_tall_qr_solve``) as one jitted
XLA program.  :func:`damped_step_lane_major` solves ``min ‖[J; √λ·I] δ +
[r; 0]‖`` for ``J = [blkdiag(left_i) | right]`` with the point axis last
(``left [bl, bc, nb]``, ``right [bl, m2, nb]``, ``res [bl, nb]``), as a
tiled algorithm in three phases (``csrc/lm_step.cu``):

* K3a, one thread a point: the damped point block and its ``[right |
  −res]`` rows, bc Householder steps, the point's R1 / r12 / y1 rows
  written out; the tile's ``bl·tile`` complement lanes (lane ``i·tile + t``
  for row i of the tile's point t) reduced by the lane-pivoted Householder
  QR of the skinny bottom panel to one partial ``[R | Qᵀy]`` of m2 lanes.
* K3b: the same QR over groups of partials (:func:`default_group`, from
  m2), level by level while more than a group remain, then the finish
  over the rest and the ``√λ·I_m2`` tail lanes, with the m2×m2
  back-substitution → x2.
* K3c, one thread a point: ``x1 = R1⁻¹(y1 − r12·x2)``.

The partials' lanes are the panel's rows in an order of the tiles; the
step is the same least-squares minimizer as the reference's one QR over
every lane, to rounding.  :func:`_damped_step_plain` runs the same tiled
algorithm in PyTorch (the per-point pass, the tile partials, the levels,
the finish, the back-substitution), so a CPU test covers the two-stage
summation order the card runs; only the order of each sum over a CTA's
lanes differs (the kernel's are trees).

The wrapper is a ``torch.library.custom_op`` with a ``vmap`` rule, so the
batch fit (``lm.levenberg_marquardt_device_batch`` under ``torch.func.vmap``)
launches the kernels once over a leading problem axis, and an autograd
rule: the forward runs the kernels, the backward the plain version's
vector-Jacobian product.  A CUDA tensor runs the kernels or raises; a CPU
tensor runs the plain version.  The geometry gate :func:`lm_step_fits` is
the one other route: a step shape past the kernels' per-thread registers
takes the plain version on the card, decided in :func:`_run` from the
shape alone, never because a build or a launch failed.  The wrapper's ``launches`` counter counts the steps
that launched K3 (one K3a, its levels, one K3b finish, one K3c each).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from . import _build

__all__ = ["TILE", "damped_step_lane_major", "lm_step_fits"]

# points a K3a CTA takes (its threads; kTileMax in the source)
TILE = 256
# lanes a K3b CTA holds at most (kReduceThreads · kLanesPerThread)
REDUCE_LANES = 2048
M2_MAX = 16
# 32-bit registers a thread may give a step's values: K3a holds the damped
# point block and its [right | −res] rows, K3b four lanes of m2 + 1 rows
_K3A_REGISTERS, _K3B_REGISTERS = 160, 96


def lm_step_fits(bl: int, bc: int, m2: int, itemsize: int) -> bool:
    """Whether K3 takes a step of ``bl × bc`` point blocks and ``m2`` right
    columns in ``itemsize``-byte floats: ``1 ≤ m2 ≤ 16``, a point's
    ``(bl + bc) × (bc + m2 + 1)`` values within 160 registers of its thread
    (fp64: two each) and a K3b thread's ``4 × (m2 + 1)`` within 96, and a
    tile of 256 points holding at least m2 lanes.  The ellipse's (2, 1, 5)
    takes 42 registers in fp64; a shape that does not fit runs the plain
    version on the card too."""
    words = max(1, itemsize // 4)
    return (bl >= 1 and bc >= 1 and 1 <= m2 <= M2_MAX and TILE * bl >= m2
            and (bl + bc) * (bc + m2 + 1) * words <= _K3A_REGISTERS
            and 4 * (m2 + 1) * words <= _K3B_REGISTERS)


def default_group(m2: int) -> int:
    """Partials a K3b CTA takes: as many as leave room for the finish's m2
    tail lanes among its 2,048."""
    return (REDUCE_LANES - m2) // m2


def reduce_levels(parts: int, group: int):
    """The partial counts after each level of K3b before its finish: while
    more than ``group`` remain, groups of ``group`` become one each."""
    levels = []
    while parts > group:
        parts = -(-parts // group)
        levels.append(parts)
    return levels


def _nf(bc: int, m2: int) -> int:
    """Factor rows a point: R1's packed upper triangle, then r12 and y1."""
    return bc * (bc + 1) // 2 + bc * (m2 + 1)


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
    version's backward through a zero column (a padded tile's) stays
    finite.  The values are sqrt's."""
    zero = sq == 0
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


# --- the plain version -----------------------------------------------------------------

def _point_pass_plain(left, right, res, lam):
    """K3a's per-point part on ``[P, …, nb]`` operands: (fac ``[P, nf, nb]``,
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


def _tall_qr_plain(Xy: torch.Tensor, m2: int) -> torch.Tensor:
    """The panel QR of ``Xy [..., m2 + 1, L]`` (rows: the m2 columns, then
    y; lanes last, L ≥ m2) as K3 runs it: per column j the pivot lane j,
    the sums over the lanes past it of every row r ≥ j times row j, the
    reflector, ``w_r = c (s_r + X_r[j] (x0 − β))`` and the update of rows
    j..m2.  Returns the partial ``[..., m2 + 1, m2]`` (lane l of row c:
    R[l][c] for l ≤ c, else 0; row m2: Qᵀy)."""
    L = Xy.shape[-1]
    lane = torch.arange(L, device=Xy.device)
    for j in range(m2):
        colj = Xy[..., j, :]
        x0 = colj[..., j]
        below = torch.where(lane > j, colj, torch.zeros_like(colj))
        tot = (Xy[..., j:, :] * below[..., None, :]).sum(-1)  # [..., m2 + 1 - j]
        beta, c, _ = _reflector(x0, tot[..., 0], _masked_sqrt)
        ud = x0 - beta
        w = c[..., None] * (tot + Xy[..., j:, j] * ud[..., None])
        u = torch.where(lane == j, ud[..., None], below)
        Xy = torch.cat([Xy[..., :j, :], Xy[..., j:, :] - w[..., None] * u[..., None, :]], dim=-2)
    r = torch.arange(m2 + 1, device=Xy.device)[:, None]
    l = torch.arange(m2, device=Xy.device)
    part = Xy[..., :m2]
    return torch.where((r == m2) | (l <= r), part, torch.zeros_like(part))


def _tile_partials_plain(comp: torch.Tensor, tile: int) -> torch.Tensor:
    """K3a's tile partials of the complement rows ``[P, bl, m2 + 1, nb]``:
    the stack ``[P, m2 + 1, tiles · m2]``."""
    P, bl, R, nb = comp.shape
    tiles = max(1, -(-nb // tile))
    comp = torch.cat([comp, comp.new_zeros((P, bl, R, tiles * tile - nb))], dim=-1)
    lanes = comp.reshape(P, bl, R, tiles, tile).permute(0, 3, 2, 1, 4).reshape(P, tiles, R, bl * tile)
    return _stack(_tall_qr_plain(lanes, R - 1))


def _stack(parts: torch.Tensor) -> torch.Tensor:
    """Partials ``[P, G, m2 + 1, m2]`` as a lane-major stack ``[P, m2 + 1, G · m2]``."""
    P, G, R, m2 = parts.shape
    return parts.permute(0, 2, 1, 3).reshape(P, R, G * m2)


def _reduce_plain(stack: torch.Tensor, group: int) -> torch.Tensor:
    """One level of K3b: groups of ``group`` partials of the stack, one
    partial each."""
    P, R, lanes = stack.shape
    m2 = R - 1
    groups = -(-(lanes // m2) // group)
    width = group * m2
    padded = torch.cat([stack, stack.new_zeros((P, R, groups * width - lanes))], dim=-1)
    return _stack(_tall_qr_plain(padded.reshape(P, R, groups, width).transpose(1, 2), m2))


def _finish_plain(stack: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """K3b's finish: the stack's lanes, then the √λ·I_m2 tail lanes, the
    panel QR and the back-substitution → x2 ``[P, m2]``."""
    P, R, _ = stack.shape
    m2 = R - 1
    # eye(m2 + 1, m2): √λ in lane c of row c, and 0 in y
    tail = torch.sqrt(lam)[:, None, None] * torch.eye(R, m2, dtype=stack.dtype, device=stack.device)
    part = _tall_qr_plain(torch.cat([stack, tail], dim=-1), m2)
    x2 = [None] * m2
    for i in range(m2 - 1, -1, -1):
        acc = part[:, m2, i]
        for c in range(i + 1, m2):
            acc = acc - part[:, c, i] * x2[c]
        x2[i] = acc / part[:, i, i]
    return torch.stack(x2, 1)


def _backsub_plain(fac: torch.Tensor, x2: torch.Tensor, bc: int) -> torch.Tensor:
    """K3c: ``x1 [P, bc, nb]`` from the factor rows and x2 ``[P, m2]``."""
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


def _damped_step_plain(left, right, res, lam, tile: int = TILE,
                       gather: Optional[Callable] = None) -> torch.Tensor:
    """The plain version of :func:`damped_step_lane_major` on ``[P, …]``
    operands (``lam [P]``): the per-point pass, the tile partials, K3b's
    levels and finish, the back-substitution; returns ``[P, bc·nb + m2]``.
    ``gather``: see :func:`_run`."""
    P, bl, bc, nb = left.shape
    fac, comp = _point_pass_plain(left, right, res, lam)
    stack = _tile_partials_plain(comp, tile)
    stack = _levels(stack, gather, _reduce_plain)
    x2 = _finish_plain(stack, lam)
    x1 = _backsub_plain(fac, x2, bc)
    return torch.cat([x1.reshape(P, bc * nb), x2], dim=1)


def _levels(stack, gather, reduce):
    """K3b's levels on a tile stack, in groups of :func:`default_group`
    partials: without ``gather`` while more than a group remain; with it (a
    mesh) down to the rank's one partial, then ``gather`` of that partial
    over the ranks."""
    m2 = stack.shape[1] - 1
    group = default_group(m2)
    while stack.shape[2] // m2 > (1 if gather is not None else group):
        stack = reduce(stack, group)
    return stack if gather is None else gather(stack)


# --- the kernels -----------------------------------------------------------------------

def _damped_step_kernel(left, right, res, lam, tile: int,
                        gather: Optional[Callable] = None) -> torch.Tensor:
    """K3a, K3b's levels, its finish and K3c on CUDA operands ``[P, …]``
    whose shape passes :func:`lm_step_fits`; returns ``[P, bc·nb + m2]``."""
    P, bl, bc, nb = left.shape
    m2 = right.shape[2]
    dt, dev = left.dtype, left.device.index
    if tile % 32 or not 32 <= tile <= TILE:
        raise ValueError(f"tile={tile}: K3a takes a multiple of 32 points up to {TILE}")
    if not 1 <= P <= 65535:
        raise ValueError(f"{P} problems: K3 takes 1 to 65535")
    left, right, res, lam = (t.contiguous() for t in (left, right, res, lam))
    fac = left.new_empty((P, _nf(bc, m2), nb))
    tiles = max(1, -(-nb // tile))
    stack = left.new_empty((P, m2 + 1, tiles * m2))
    launch = lambda kind: _build.lm_step_launcher(kind, bl, bc, m2, dt)  # noqa: E731
    launch("local")(dev, *(t.data_ptr() for t in (left, right, res, lam, fac, stack)), nb, P, tile)

    def reduce(stack, group):
        parts = stack.shape[2] // m2
        out = stack.new_empty((P, m2 + 1, -(-parts // group) * m2))
        launch("reduce")(dev, stack.data_ptr(), stack.shape[2], lam.data_ptr(), out.data_ptr(), 0,
                         group, P, 0)
        return out

    stack = _levels(stack, gather, reduce).contiguous()
    stride = bc * nb + m2
    out = left.new_empty((P, stride))
    x2 = out.data_ptr() + bc * nb * out.element_size()
    launch("reduce")(dev, stack.data_ptr(), stack.shape[2], lam.data_ptr(), x2, stride,
                     max(default_group(m2), stack.shape[2] // m2), P, 1)
    if nb:
        launch("backsub")(dev, fac.data_ptr(), x2, out.data_ptr(), nb, P, stride)
    damped_step_lane_major.launches += 1
    return out


def _run(left, right, res, lam, tile: int, gather=None) -> torch.Tensor:
    """The step on ``[P, …]`` operands: the kernels on CUDA tensors, the
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
    """The kernels compute no derivative: the backward is the plain
    version's vector-Jacobian product, recomputed from the saved operands
    (the same tiled algorithm, so the derivative of the same minimizer)."""
    _, vjp = torch.func.vjp(lambda *ops: _damped_step_plain(*ops, ctx.tile), *ctx.saved_tensors)
    return (*vjp(grad), None)


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

    ``tile``: points a K3a CTA takes (a multiple of 32 up to 256 on the
    card; any on the CPU with ``tile·bl ≥ m2``).  ``gather`` (a mesh, no
    leading axes): the rank's one partial to every rank's stack
    (:func:`_run`).  Runs the kernels on a CUDA tensor (or raises), the
    plain version on a CPU tensor, and on either device differentiates
    through the plain version's vector-Jacobian product; the mesh form has
    no backward on the card (its all-gather carries no gradient)."""
    lead = _check(left, right, res, lam)
    *_, bl, bc, nb = left.shape
    m2 = right.shape[-2]
    if tile * bl < m2:
        raise ValueError(f"tile={tile}: a tile of {bl}-row points must hold m2={m2} lanes")
    P = math.prod(lead)
    flat = (left.reshape(P, bl, bc, nb), right.reshape(P, bl, m2, nb), res.reshape(P, bl, nb),
            lam.expand(lead).reshape(P))
    if gather is None:
        out = _step_op(*flat, int(tile))
    elif lead:
        raise ValueError("a mesh step takes no leading problem axes")
    elif (left.device.type == "cuda" and torch.is_grad_enabled()
          and any(t.requires_grad for t in (left, right, res, lam))):
        raise ValueError("the mesh step has no backward on the card: pass operands that do "
                         "not require grad")
    else:
        out = _run(*flat, tile, gather)
    return out.reshape(*lead, bc * nb + m2)


damped_step_lane_major.launches = 0
