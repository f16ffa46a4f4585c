"""Functional pipelines: block-diagonal and block-angular factorize + solve
with implicit-diff gradients, and the lane-major damped LM steps.

Counterpart of ``qrkit_tpu/functional.py`` (``block_diagonal_factorize``,
``block_diagonal_lstsq``, ``block_angular_lstsq`` and their custom VJPs,
``_soa_tall_qr_solve``, here in :mod:`~qrkit_tpu_torch.ops.lm_step`,
``lm_damped_step_blockdiag(1)``).  As in the
reference the block-diagonal factorize and least-squares paths run no
device kernel of their own: they are batched plain torch (compact-WY QR, Qᵀ
through the implicit Y/T factors, batched triangular solves) on either
device.  The block-angular steps reduce their bottom ``[J2 | rhs]`` by the
R-only tall-skinny QR :func:`~qrkit_tpu_torch.ops.tall_qr.r_and_qtb`
(kernel K5 on the card), which keeps R2 and Qᵀ on the rhs alone.  The LM
steps keep the reference's lane-major layout (the point axis last and
contiguous) and run kernel K3 on the card
(:func:`~qrkit_tpu_torch.ops.lm_step.damped_step_lane_major`: one
cooperative launch, the point pass with each thread's carry of the bottom
panel, the merges, the last CTA's finish with the damping tail, the
per-point back-substitution); on CPU tensors its plain version, the same
schedule.

On card operands that do not require grad, :func:`block_diagonal_factorize`,
:func:`block_diagonal_lstsq`, :func:`block_angular_lstsq` and the LM steps
:func:`lm_damped_step_blockdiag` / :func:`lm_damped_step_blockdiag1` are
each one captured program, as the reference jits each
(:mod:`~qrkit_tpu_torch._program`; a ``mesh=`` call's collectives inside
its graph): captured on the second call in a row with one set of static
arguments and operand shapes, four shapes kept per function until
:func:`clear_programs`.  Operands that require grad run eagerly.

``block_angular_lstsq`` and ``lm_damped_step_blockdiag`` take a keyword-only
``mesh=`` (a ``torch.distributed`` ``DeviceMesh``), where the reference only
places its inputs sharded: each rank then passes its own blocks (points) and
their rows, the skinny bottom panel reduces across ranks as a tree (a local
R-only QR, one all-gather of the ``[R | Qᵀy]`` factors, a replicated second
R-only QR), and the block
part of x is gathered, so every rank returns the global x.  The sharded
``block_angular_lstsq`` has its backward too (the reference's ``custom_vjp``
runs under SPMD): one all-reduce of an m2-vector; so has the sharded damped
step (:class:`_ShardedDampedStep`): one all-reduce of 2·m2 + 1 values.
"""
from __future__ import annotations

import torch

from ._program import Programs
from .ops.householder import (
    build_t_factor,
    colpiv_householder_qr,
    form_q,
    highest_precision,
    panel_qr_yt,
)
from .ops.lm_step import _mesh_step_vjp, damped_step_lane_major
from .ops.tall_qr import r_and_qtb

__all__ = [
    "block_angular_lstsq",
    "block_angular_lstsq_ragged",
    "block_diagonal_factorize",
    "block_diagonal_lstsq",
    "clear_programs",
    "lm_damped_step_blockdiag",
    "lm_damped_step_blockdiag1",
]


def _qr_wy(blocks: torch.Tensor, pivot: bool):
    """Per-block compact-WY QR of [nb, br, bc]: (Y, T, reduced A, perm)."""
    nb, _, bc = blocks.shape
    if pivot:
        Y, taus, Ared, perm = colpiv_householder_qr(blocks)
        return Y, build_t_factor(Y, taus), Ared, perm
    Y, T, Ared = panel_qr_yt(blocks)
    return Y, T, Ared, torch.arange(bc, device=blocks.device).expand(nb, bc)


# the captured programs of each function below, by static arguments and
# operand shapes: one program a shape, the four shapes last captured
_FACTORIZE_PROGRAMS = Programs(limit=4)
_LSTSQ_PROGRAMS = Programs(limit=4)
_ANGULAR_PROGRAMS = Programs(limit=4)
_STEP_PROGRAMS = Programs(limit=4)
_STEP1_PROGRAMS = Programs(limit=4)
_ALL_PROGRAMS = (_FACTORIZE_PROGRAMS, _LSTSQ_PROGRAMS, _ANGULAR_PROGRAMS, _STEP_PROGRAMS,
                 _STEP1_PROGRAMS)


def clear_programs() -> None:
    """Drop every captured program of this module and free their static
    buffers and graph pools."""
    for programs in _ALL_PROGRAMS:
        programs.clear()


@highest_precision()
def _block_diagonal_factorize(blocks: torch.Tensor, pivot: bool):
    Y, T, Ared, perm = _qr_wy(blocks, pivot)
    # perm is materialized: a program's output must not be an expanded view
    return form_q(Y, T), torch.triu(Ared[:, : blocks.shape[2]]), perm.contiguous()


def block_diagonal_factorize(blocks: torch.Tensor, pivot: bool = False):
    """Batched QR of a [nb, br, bc] block-diagonal batch → (Q [nb,br,br],
    R [nb,k,bc], perm [nb,bc]) with k = min(br, bc): square R for portrait
    blocks, the wide upper trapezoid for landscape ones.  One captured
    program on the card (the module docstring)."""
    return _FACTORIZE_PROGRAMS.solve(
        None, "functional.block_diagonal_factorize", pivot,
        lambda _, blocks: _block_diagonal_factorize(blocks, pivot), blocks,
    )


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
    implicit-function-theorem backward (full-rank blocks assumed).

    On card operands that do not require grad the call is one captured
    program (the reference's jitted function; :mod:`~qrkit_tpu_torch._program`),
    captured on the second call in a row with one ``pivot`` and operand
    shapes; the four shapes last captured keep their programs, with their
    static operands and graph pool, until :func:`clear_programs`.  Operands
    that require grad run eagerly, so autograd records the call."""
    if torch.is_grad_enabled() and (blocks.requires_grad or b.requires_grad):
        return _BlockDiagonalLstsq.apply(blocks, b, pivot)
    return _LSTSQ_PROGRAMS.solve(
        None, "functional.block_diagonal_lstsq", pivot,
        lambda _, blocks, b: _block_diagonal_lstsq_primal(blocks, b, pivot)[0], blocks, b,
    )


def _solve_upper(R: torch.Tensor, y: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """R x = y (or Rᵀ x = y) for upper-triangular R [..., n, n], y [..., n]."""
    if transpose:
        return torch.linalg.solve_triangular(R.mT, y[..., None], upper=False)[..., 0]
    return torch.linalg.solve_triangular(R, y[..., None], upper=True)[..., 0]


@highest_precision()
def _block_angular_lstsq_primal(left_blocks, right, b, mesh=None, axis: str = "dp"):
    """Returns (x [m1+m2], R1 [nb,bc,bc], r12 [m1,m2], R2 [m2,m2])."""
    nb, br, bc = left_blocks.shape
    m2 = right.shape[1]

    # left: batched compact-WY QR, Q kept implicit as (Y, T)
    Y1, T1, R1 = panel_qr_yt(left_blocks)
    R1 = torch.triu(R1)[:, :bc]

    # Q1ᵀ applied to [right | b] in one pass
    rb = torch.cat([right, b[:, None]], dim=1)  # [nb*br + tail, m2+1]
    body = rb[: nb * br].reshape(nb, br, m2 + 1)
    qt_body = body + Y1 @ (T1.mT @ (Y1.mT @ body))
    econ = qt_body[:, :bc].reshape(nb * bc, m2 + 1)
    compl = qt_body[:, bc:].reshape(nb * (br - bc), m2 + 1)
    r12, y1 = econ[:, :m2], econ[:, m2]

    # R2 and y2 of the bottom [J2 | rhs], the complement rows over the tail rows: K5 on the
    # card, which overwrites its operand (each one here is the step's own)
    if mesh is None:
        R2, y2 = r_and_qtb(torch.cat([compl, rb[nb * br :]]))
    else:
        from .parallel.mesh import all_gather_leading

        # each rank's [R | y], gathered, the tail rows (the same on every rank) under the stack
        R, y = r_and_qtb(compl)
        stack = all_gather_leading(torch.cat([R, y[:, None]], dim=1), mesh, axis)
        R2, y2 = r_and_qtb(torch.cat([stack.reshape(-1, m2 + 1), rb[nb * br :]]))

    # back substitution: x2, then the structured x1
    x2 = _solve_upper(R2, y2)
    x1 = _solve_upper(R1, (y1 - r12 @ x2).reshape(nb, bc))
    if mesh is not None:
        x1 = all_gather_leading(x1, mesh, axis)
    return torch.cat([x1.reshape(-1), x2]), R1, r12, R2


def _angular_grads(left_blocks, right, b, x1, x2, u1, u2, tail: int):
    """∂b = A u, ∂A1 = per-block (r u1ᵀ − (Au) x1ᵀ) and ∂A2 = r u2ᵀ − (Au) x2ᵀ
    with r = b − A x, over the rows of ``right`` and ``b`` (the blocks'
    rows, then the ``tail`` rows)."""
    nb, br, bc = left_blocks.shape
    pad = x2.new_zeros(tail)
    A1u = torch.einsum("bij,bj->bi", left_blocks, u1).reshape(nb * br)
    A1x = torch.einsum("bij,bj->bi", left_blocks, x1).reshape(nb * br)
    Au = torch.cat([A1u, pad]) + right @ u2
    r = b - (torch.cat([A1x, pad]) + right @ x2)
    g_left = torch.einsum("bi,bj->bij", r[: nb * br].reshape(nb, br), u1) - torch.einsum(
        "bi,bj->bij", Au[: nb * br].reshape(nb, br), x1
    )
    g_right = torch.outer(r, u2) - torch.outer(Au, x2)
    return g_left, g_right, Au


class _BlockAngularLstsq(torch.autograd.Function):
    """Composite [A1 | A2] least squares with the implicit-function-theorem
    backward (the reference's ``jax.custom_vjp``)."""

    @staticmethod
    def forward(ctx, left_blocks, right, b, tail):
        x, R1, r12, R2 = _block_angular_lstsq_primal(left_blocks, right, b)
        ctx.tail = tail
        ctx.save_for_backward(left_blocks, right, b, x, R1, r12, R2)
        return x

    @staticmethod
    @highest_precision()
    def backward(ctx, g):
        """u = (AᵀA)⁻¹ḡ by forward and back substitution on the composite
        R = [[R1, R12], [0, R2]] saved from the forward pass (the QR itself
        is never differentiated), then the gradients of
        :func:`_angular_grads`."""
        left_blocks, right, b, x, R1, r12, R2 = ctx.saved_tensors
        nb, br, bc = left_blocks.shape
        m1 = nb * bc
        g1, g2 = g[:m1].reshape(nb, bc), g[m1:]
        # Rᵀ w = g (block forward substitution)
        w1 = _solve_upper(R1, g1, transpose=True)
        w2 = _solve_upper(R2, g2 - r12.T @ w1.reshape(m1), transpose=True)
        # R u = w (block back substitution)
        u2 = _solve_upper(R2, w2)
        u1 = _solve_upper(R1, (w1.reshape(m1) - r12 @ u2).reshape(nb, bc))
        grads = _angular_grads(left_blocks, right, b, x[:m1].reshape(nb, bc), x[m1:], u1, u2,
                               ctx.tail)
        return grads + (None,)


class _ShardedBlockAngularLstsq(torch.autograd.Function):
    """The ``mesh=`` form of :class:`_BlockAngularLstsq`: each rank holds
    its blocks' R1 and R12 rows, the replicated R2 and the global x.  The
    cotangent of x is the replicated output's, the same on every rank; the
    all-gather of x1 in the forward pass has a slice as its adjoint, so each
    rank solves for w1 and u1 on its own blocks, and the one collective is
    the all-reduce (sum) of the m2-vector R12ᵀ w1 before the R2 solves."""

    @staticmethod
    def forward(ctx, left_blocks, right, b, tail, mesh, axis):
        x, R1, r12, R2 = _block_angular_lstsq_primal(left_blocks, right, b, mesh, axis)
        ctx.tail, ctx.mesh, ctx.axis = tail, mesh, axis
        ctx.save_for_backward(left_blocks, right, b, x, R1, r12, R2)
        return x

    @staticmethod
    @highest_precision()
    def backward(ctx, g):
        from .parallel.mesh import all_reduce_sum, mesh_rank

        left_blocks, right, b, x, R1, r12, R2 = ctx.saved_tensors
        nb, br, bc = left_blocks.shape
        m1 = nb * bc
        rank, world = mesh_rank(ctx.mesh, ctx.axis)
        lo, top = rank * m1, world * m1  # this rank's x1 rows; where x2 starts
        g1, g2 = g[lo : lo + m1].reshape(nb, bc), g[top:]
        w1 = _solve_upper(R1, g1, transpose=True)
        s = all_reduce_sum(r12.T @ w1.reshape(m1), ctx.mesh, ctx.axis)  # Σ_ranks R12ᵀ w1
        w2 = _solve_upper(R2, g2 - s, transpose=True)
        u2 = _solve_upper(R2, w2)
        u1 = _solve_upper(R1, (w1.reshape(m1) - r12 @ u2).reshape(nb, bc))
        grads = _angular_grads(left_blocks, right, b, x[lo : lo + m1].reshape(nb, bc), x[top:],
                               u1, u2, ctx.tail)
        return grads + (None,) * 3


def block_angular_lstsq(
    left_blocks: torch.Tensor,
    right: torch.Tensor,
    b: torch.Tensor,
    n_shards: int = 1,
    tail: int = 0,
    *,
    mesh=None,
    axis: str = "dp",
) -> torch.Tensor:
    """Fused block-angular least-squares solve: batched left QR, an R-only
    QR of the right block's bottom rows
    (:func:`~qrkit_tpu_torch.ops.tall_qr.r_and_qtb`, K5 on the card), block
    back-substitution.

    ``left_blocks [nb, br, bc]`` is the block-diagonal A1 body, ``right
    [nb*br + tail, m2]`` the dense A2 (``tail`` rows below the blocks) and
    ``b [nb*br + tail]``; returns x ``[nb*bc + m2]``.  ``n_shards`` is the
    reference's TSQR shard count: it does not change the arithmetic here
    (with ``mesh=`` it must divide over the ranks).  Differentiable w.r.t.
    ``left_blocks``, ``right`` and ``b`` through an implicit-function-theorem
    backward against the saved composite R (full column rank assumed).

    With ``mesh=`` each rank passes its own blocks and their rows of
    ``right`` and ``b``, followed by the ``tail`` rows, which are the same on
    every rank.  Every rank returns the global x ``[world·nb·bc + m2]``.
    The sharded form is differentiable too: x is replicated, so its
    cotangent must be the same on every rank (every rank differentiates the
    same function of x); each rank gets the gradients of its own blocks and
    of its rows of ``right`` and ``b``, the tail rows' the same on every
    rank, and the backward pass runs one collective, an all-reduce of an
    m2-vector.

    Without a mesh, on card operands that do not require grad, the call is
    one captured program (the module docstring)."""
    if mesh is not None:
        from .parallel.mesh import mesh_rank

        world = mesh_rank(mesh, axis)[1]
        if n_shards % world:
            raise ValueError(f"n_shards={n_shards} does not divide over the {world} ranks of the mesh")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (left_blocks, right, b))
    if grad and mesh is None:
        return _BlockAngularLstsq.apply(left_blocks, right, b, tail)
    if grad:
        return _ShardedBlockAngularLstsq.apply(left_blocks, right, b, tail, mesh, axis)
    return _ANGULAR_PROGRAMS.solve(
        None, "functional.block_angular_lstsq", (tail, axis),
        lambda _, lb, r, v: _block_angular_lstsq_primal(lb, r, v, mesh, axis)[0],
        left_blocks, right, b, mesh=mesh, axis=axis,
    )


@highest_precision()
def _ragged_left(left, right, slots, b, dest, tail, tail_b, rows: int):
    """The left of :func:`block_angular_lstsq_ragged`: each bucket's block
    QR, its Q1ᵀ on the bucket's compact slabs and rhs, and the scatter of
    the complement rows into the bottom.  Returns (R1 [nb, bc, bc], r12
    [nb, bc, w·k], y1 [nb, bc] a bucket; the bottom ``[rows + t, m2 + 1]``,
    the rhs its last column)."""
    m2 = tail.shape[1]
    m = rows + tail.shape[0]
    # one row past the bottom takes the blocks' padding rows (zeros after Q1ᵀ)
    buf = tail.new_zeros((m + 1, m2 + 1))
    R1, r12, y1 = [], [], []
    for lb, rb, sb, bb, db in zip(left, right, slots, b, dest):
        nb, _, bc = lb.shape
        k = sb.shape[1]
        w = rb.shape[2] // k
        Y, T, R = panel_qr_yt(lb)
        slab = torch.cat([rb, bb[..., None]], dim=2)  # [nb, br, w·k + 1]
        qt = slab + Y @ (T.mT @ (Y.mT @ slab))
        R1.append(torch.triu(R[:, :bc]))
        r12.append(qt[:, :bc, :-1])
        y1.append(qt[:, :bc, -1])
        cols = (sb[..., None] * w + torch.arange(w, device=sb.device)).reshape(nb, k * w)
        cols = torch.cat([cols, cols.new_full((nb, 1), m2)], dim=1)
        buf.index_put_((db[:, :, None], cols[:, None, :]), qt[:, bc:])
    buf[rows:m, :m2] = tail
    buf[rows:m, m2] = tail_b
    return R1, r12, y1, buf[:m]


@highest_precision()
def _block_angular_lstsq_ragged(left, right, slots, b, dest, tail, tail_b, rows: int, marks):
    from .ops.graph_loop import mark

    R1, r12, y1, bottom = _ragged_left(left, right, slots, b, dest, tail, tail_b, rows)
    if marks:
        mark(marks[0])
    R2, y2 = r_and_qtb(bottom)  # K5 on the card; the bottom is the step's own, overwritten
    if marks:
        mark(marks[1])
    x2 = _solve_upper(R2, y2)
    x1 = []
    for R, r, y, sb in zip(R1, r12, y1, slots):
        nb, k = sb.shape
        x2_cols = x2.reshape(-1, r.shape[2] // k)[sb].reshape(nb, -1)  # each slot's block of x2
        x1.append(_solve_upper(R, y - (r @ x2_cols[..., None])[..., 0]))
    return tuple(x1), x2


class _RaggedBlockAngular(torch.autograd.Function):
    """:func:`block_angular_lstsq_ragged` where an operand requires grad:
    the forward runs, the backward raises."""

    @staticmethod
    def forward(ctx, run, *operands):
        x1, x2 = run()
        return (*x1, x2)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "block_angular_lstsq_ragged has no backward: differentiate the residuals (the LM "
            "drivers do), or use block_angular_lstsq on the dense system")


def block_angular_lstsq_ragged(
    left,
    right,
    slots,
    b,
    dest,
    tail: torch.Tensor,
    tail_b: torch.Tensor,
    rows: int,
    marks=None,
):
    """Block-angular least squares with ragged blocks and a compact right
    block: bundle adjustment's damped step, whose points see different
    numbers of cameras.

    The blocks come in buckets ``i``, each of one shape:

    * ``left[i] [nb, br, bc]``: the block-diagonal A1 blocks (every bucket
      has the same ``bc``); rows past a block's own are zero padding, at
      the end of the block (below its first ``bc`` rows);
    * ``right[i] [nb, br, w·k]`` and ``slots[i] [nb, k]``: the block's rows
      of A2 in compact form, ``k`` column blocks of width ``w`` each, slot
      ``j`` being A2's column block ``slots[i][:, j]`` (A2 has ``m2 / w``
      of them); a block's slots are distinct, and a padded slot's values
      are zero;
    * ``b[i] [nb, br]``: the blocks' rows of the rhs;
    * ``dest[i] [nb, br - bc]``: the bottom row that each row of the
      block's complement (its rows past ``bc`` after the block's Q1ᵀ)
      goes to, ``rows + t`` for a padding row (dropped).

    Under them lie ``tail [t, m2]`` (dense: the damping rows of A2) with
    rhs ``tail_b [t]``.  ``rows`` counts the complement rows that the
    blocks hand on, the padding rows left out.

    Each bucket is factored by a batched compact-WY QR, and its Q1ᵀ is
    applied to the compact slabs and the rhs: the top ``bc`` rows stay
    compact (R12 ``[nb, bc, w·k]``), the complement rows are scattered at
    their slots' columns into the dense bottom ``[rows + t, m2]``, the
    tail rows under them.  A QR that keeps R alone
    (:func:`~qrkit_tpu_torch.ops.tall_qr.r_and_qtb`, kernel K5 on the
    card) gives R2 and Qᵀ on the rhs of the bottom; then x2, and each
    block's x1 from its compact R12.  No tensor is sized by the blocks'
    count times the widest bucket, and A2 is never dense.

    Returns ``(x1, x2)``: a ``[nb, bc]`` a bucket, and ``[m2]``.  The
    function has no backward (the LM drivers differentiate the residuals,
    not the step): a call whose operands require grad runs, and its
    backward raises.  ``marks``: two names of
    :data:`~qrkit_tpu_torch.ops.graph_loop.MARKS` that the solve marks
    inside a captured loop's body, the bottom assembled and the bottom
    factored (:func:`~qrkit_tpu_torch.ops.graph_loop.mark`); None marks
    nothing."""
    operands = (tuple(left), tuple(right), tuple(slots), tuple(b), tuple(dest), tail, tail_b)

    def run():
        return _block_angular_lstsq_ragged(*operands, rows, marks)

    flat = [t for group in operands[:5] for t in group] + [tail, tail_b]
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        *x1, x2 = _RaggedBlockAngular.apply(run, *flat)
        return tuple(x1), x2
    return run()


def _as_lam(lam, like: torch.Tensor) -> torch.Tensor:
    """λ as a 0-d tensor in ``like``'s dtype on its device (a host float is
    copied here, outside any program: a capture refuses the copy)."""
    if isinstance(lam, torch.Tensor):
        return lam.to(like.dtype) if lam.dtype != like.dtype else lam
    return torch.tensor(lam, dtype=like.dtype, device=like.device)


def lm_damped_step_blockdiag(
    left: torch.Tensor,
    right: torch.Tensor,
    res: torch.Tensor,
    lam,
    *,
    mesh=None,
    axis: str = "dp",
):
    """General multi-column lane-major damped Gauss–Newton step.

    Solves ``min ‖[J; √λ·I] δ + [r; 0]‖`` for ``J = [blkdiag(left_i) |
    right]`` with ``left [bl, bc, nb]`` (the per-point Jacobian block, point
    axis last), ``right [bl, m2, nb]`` (the per-point rows of the dense right
    block) and ``res [bl, nb]``; ``lam`` is a scalar (a 0-d tensor keeps it
    on the device).  bc unrolled per-point Householder steps with trailing
    updates on the block columns, right rows and rhs; the lane-pivoted
    Householder QR of the skinny bottom panel; per-point bc×bc
    back-substitution.  The damping rows are analytic: √λ·I_bc under each
    block and √λ·I_m2 at the tail.  The bottom panel reduces as a tree: a
    carry ``[R | Qᵀy]`` per thread over its points, merged per CTA, then the
    CTAs' partials with the tail (kernel K3 on the card, its plain version
    on the CPU: :mod:`~qrkit_tpu_torch.ops.lm_step`).

    With ``mesh=`` the points (lanes) are this rank's: the rank reduces its
    points to one partial, one all-gather stacks every rank's, the tail joins
    them in the finish, and x1 is gathered over the lanes of every rank.  It
    is differentiable (:class:`_ShardedDampedStep`): the output is
    replicated, so its cotangent must be the same on every rank; each rank
    gets the gradients of its own points' operands, λ's the same on every
    rank, and the backward runs one all-reduce.

    Without a mesh the step is one captured program on the card (the module
    docstring); a host ``lam`` is copied to the device before it.

    Returns ``(x1 [bc, nb], x2 [m2])``."""
    lam = _as_lam(lam, left)
    return _STEP_PROGRAMS.solve(
        None, "functional.lm_damped_step_blockdiag", axis,
        lambda _, l, r, v, s: _damped_step(l, r, v, s, mesh, axis), left, right, res, lam,
        mesh=mesh, axis=axis,
    )


def _gather_partials(mesh, axis: str):
    """The mesh form's gather: this rank's one partial ``[1, m2 + 1, m2]``
    of the bottom panel (lane-major) to every rank's ``[1, m2 + 1, world ·
    m2]``, by one all-gather."""
    from .parallel.mesh import all_gather_leading

    def gather(part):
        stack = all_gather_leading(part, mesh, axis)  # [world, m2 + 1, m2]
        return stack.transpose(0, 1).reshape(1, stack.shape[1], -1)

    return gather


def _damped_step(left, right, res, lam, mesh=None, axis: str = "dp"):
    if mesh is not None:  # under no_grad only its forward runs
        return _ShardedDampedStep.apply(left, right, res, lam, mesh, axis)
    bc, nb = left.shape[1], left.shape[2]
    out = damped_step_lane_major(left, right, res, lam)
    return out[: bc * nb].reshape(bc, nb), out[bc * nb :]


class _ShardedDampedStep(torch.autograd.Function):
    """The ``mesh=`` form of the lane-major damped step, every call of it
    (without grad only the forward runs).

    The output (x1 over every rank's points, then x2) is replicated, so its
    cotangent is the same on every rank and the x1 all-gather's adjoint is
    a slice: each rank runs the step's vector-Jacobian product on its own
    points (:func:`~qrkit_tpu_torch.ops.lm_step._mesh_step_vjp`: the point
    pass, then one QR of its rows and the other ranks' gathered partials,
    saved by the forward); the one collective is the all-reduce of
    2·m2 + 1 values (x2's cotangent from the rank's x1 and λ's from its
    points).  The forward runs K3 (the kernel on the card)."""

    @staticmethod
    def forward(ctx, left, right, res, lam, mesh, axis):
        from .parallel.mesh import all_gather_leading

        gather = _gather_partials(mesh, axis)
        kept = []

        def gather_and_keep(part):
            kept.append(gather(part))
            return kept[-1]

        bc, nb = left.shape[1], left.shape[2]
        out = damped_step_lane_major(left, right, res, lam, gather=gather_and_keep)
        x1, x2 = out[: bc * nb].reshape(bc, nb), out[bc * nb :]
        ctx.mesh, ctx.axis = mesh, axis
        ctx.save_for_backward(left, right, res, lam, kept[0])
        return all_gather_leading(x1.T, mesh, axis).T, x2

    @staticmethod
    @highest_precision()
    def backward(ctx, g1, g2):
        from .parallel.mesh import all_reduce_sum, mesh_rank

        left, right, res, lam, stack = ctx.saved_tensors
        bc, nb = left.shape[1], left.shape[2]
        rank, _ = mesh_rank(ctx.mesh, ctx.axis)
        g1 = left.new_zeros((bc, nb)) if g1 is None else g1[:, rank * nb : (rank + 1) * nb]
        g2 = left.new_zeros(right.shape[1]) if g2 is None else g2
        grads = _mesh_step_vjp(left[None], right[None], res[None], lam.reshape(1), stack, rank,
                               g1[None], g2[None], lambda v: all_reduce_sum(v, ctx.mesh, ctx.axis))
        g_left, g_right, g_res, g_lam = (g[0] for g in grads)
        return g_left, g_right, g_res, g_lam.reshape(lam.shape), None, None


def lm_damped_step_blockdiag1(
    left: torch.Tensor,
    right: torch.Tensor,
    res: torch.Tensor,
    lam,
    *,
    mesh=None,
    axis: str = "dp",
) -> torch.Tensor:
    """Single-column (bc = 1) lane-major damped LM step: ``left [bl, nb]``
    (block i is ``left[:, i]``), ``right [bl, m2, nb]``, ``res [bl, nb]``;
    returns the flat ``[nb + m2]`` step the LM drivers consume (over a mesh,
    the rank's points in, every point's step out).  One captured program
    without a mesh, as :func:`lm_damped_step_blockdiag`."""
    lam = _as_lam(lam, left)
    return _STEP1_PROGRAMS.solve(
        None, "functional.lm_damped_step_blockdiag1", axis,
        lambda _, l, r, v, s: _damped_step1(l, r, v, s, mesh, axis), left, right, res, lam,
        mesh=mesh, axis=axis,
    )


def _damped_step1(left, right, res, lam, mesh=None, axis: str = "dp"):
    if mesh is None:  # K3 writes the flat step itself
        return damped_step_lane_major(left[:, None, :], right, res, lam)
    x1, x2 = _damped_step(left[:, None, :], right, res, lam, mesh, axis)
    return torch.cat([x1[0], x2])
