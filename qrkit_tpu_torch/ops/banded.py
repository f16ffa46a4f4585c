"""Banded chain QR: the CUDA kernels that replace the three banded Pallas
kernels, their plain PyTorch versions, and the general chain recurrence.

Counterpart of ``qrkit_tpu/ops/pallas_banded.py`` and of the XLA chain body
``_banded_factorize_chunk`` (``qrkit_tpu/solvers/banded_blocked.py:96``):

* :func:`chain_factorize` ← ``_banded_factorize_chunk``, vmapped: B
  independent chains of pre-shifted panels with any per-step column
  increment.  Per step: add the R-overlap carry to the panel's first
  ``mca`` rows, Householder QR (Eigen's β/τ, unit-diagonal Y), emit Y, τ and
  ``triu(R)[:me]``, cut the next carry ``triu(R)[ci:ci+mca, ci:ci+mc]``;
  inactive steps emit zeros and keep the carry.  The T factors are built
  afterwards by one batched ``build_t_factor``, as in the reference's
  kernel paths.
* :func:`segment_chains` ← ``pallas_segment_chains_soa`` (kernel
  ``_chain_kernel``, B3): S chains of L steps with one body increment
  ``ci``; the first step of chains ≥ 1 cuts at ``ci0_rest``.
* :func:`segment_apply_w` ← ``pallas_segment_apply_w`` (kernel
  ``_apply_w_kernel``, B4): each segment's reflectors applied to ``ko``
  operand columns through a position-indexed work buffer.
* :func:`chain_qr` ← ``pallas_chain_qr`` (kernel ``_seq_chain_kernel``,
  B5): one chain with a distinct first-step increment ``ci0``.
* :func:`banded_solve_chunk` ← the reference's ``lax.scan``
  ``_banded_solve_chunk`` (``qrkit_tpu/solvers/banded_blocked.py:238``;
  kernel K2 of ``csrc/chain_apply.cu``, no Pallas counterpart): B blocked
  back-substitutions, last block first.  Its plain version is
  :func:`_banded_solve_chunk_plain`; :func:`scan_launch` sizes K1's and
  K2's launches.

Layouts, chain index first and nothing padded (the TPU's ``[8, 128]`` lane
tiles, ``SEG_STEP`` padding, X-layout, ``nsub`` grouping and ``kg`` column
groups have no counterpart): panels and Y ``[S, L, ma, mc]``, τ
``[S, L, mc]``, R rows ``[S, L, me, mc]``, the apply's operand rows
``[S, L, ma, ko]``; :func:`chain_qr` drops the leading S.

Each kernel wrapper runs its CUDA kernel (``csrc/banded_chain.cu``) on a
CUDA tensor, on that tensor's card, or raises; it runs its plain version
only for a CPU tensor.
The launcher picks one of two forms per geometry (:func:`register_shape`):
one warp per chain (or per operand column) with the rows in registers, or
several warps with the panel (or window) in shared memory;
:func:`chain_smem_bytes` / :func:`apply_w_smem_bytes` give exactly the
shared memory it launches with, which the solvers' gates hold to
``SMEM_LIMIT``.
The plain versions are batched torch ops, one column of the recurrence per
small group of ops: :func:`chain_factorize` for B3/B5,
:func:`_segment_apply_w_plain` for B4.  Each wrapper carries a ``launches``
counter, incremented once per kernel launch and nowhere else.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .chain_plan import (
    FIRST_PASS, LEN, SEQ, START, ChainPlan, check_plan, chunk_buffers, chunked_plain,
    launch_levels,
)
from .householder import highest_precision

__all__ = [
    "banded_solve_chunk",
    "chain_factorize",
    "chain_qr",
    "chain_smem_bytes",
    "apply_w_smem_bytes",
    "register_shape",
    "segment_apply_w",
    "segment_chains",
    "solve_chunk_fits",
]

_SUFFIX = _build._SUFFIX  # the dtypes the kernels take
# dynamic shared memory a CTA can use on the H100 (the launchers opt in above
# the default 48 KB)
SMEM_LIMIT = 227 * 1024
_MAX_WARPS = 7  # operand-column warps of a K2 CTA (K1 takes fewer), beside its staging warp


def register_shape(ma: int, mc: int, itemsize: int):
    """``(rows per lane, padded columns)`` of the register kernels (one warp,
    the panel or window rows in registers), or None when the geometry takes
    the shared-memory kernels: at most 3 rows a lane (ma ≤ 96), mc padded
    to a power of two ≤ 32, and those rows within 32 registers a lane.
    ``csrc/banded_chain.cu`` (``use_reg``) applies the same rule."""
    rpl = -(-ma // 32)
    mcp = 1 << max(mc - 1, 0).bit_length()
    if 1 <= rpl <= 3 and mcp <= 32 and rpl * mcp * itemsize <= 128:
        return rpl, mcp
    return None


def chain_smem_bytes(ma: int, mc: int, mca: int, itemsize: int) -> int:
    """Shared memory the chain kernel (B3/B5) is launched with: the register
    kernel's carry stage ``[mca][MC + 1]``, else the shared-memory kernel's
    two column-major panels (odd column stride), carry, R diagonal and
    reflector reciprocals."""
    reg = register_shape(ma, mc, itemsize)
    if reg is not None:
        return mca * (reg[1] + 1) * itemsize
    return (2 * mc * (ma | 1) + mca * mc + 2 * mc) * itemsize


def apply_w_smem_bytes(ma: int, mc: int, ko: int, wrows: int, itemsize: int) -> int:
    """Shared memory the W-apply kernel (B4) is launched with: each operand
    column's work rows, plus one window per warp (at most 8) when the
    geometry takes the shared-memory kernel."""
    if ko <= 32 and register_shape(ma, mc, itemsize) is not None:
        return ko * wrows * itemsize
    return (ko * wrows + min(ko, 8) * ma) * itemsize


def _panel_qr(A: torch.Tensor):
    """Unblocked Householder QR of panels ``A [B, m, n]`` (pivot on row j)
    in the CUDA kernels' arithmetic: one division per column for τ and one
    for the reciprocal ``1/(x0 − β)``, which multiplies the reflector's tail,
    and ``vᵀa_c = a_jc + (Σ_{r>j} a_rj a_rc)/(x0 − β)`` from the unscaled
    column.  Eigen's β/τ, unit-diagonal Y, a degenerate column (σ ≤ 0) τ = 0,
    a pivot row past the panel a zero reflector.  Returns ``(Y [B, m, n],
    taus [B, n], A_reduced)``; below its diagonal A_reduced holds roundoff
    (callers take ``triu``)."""
    B, m, n = A.shape
    rows = torch.arange(m, device=A.device)
    cols = torch.arange(n, device=A.device)
    zero, one = A.new_zeros(()), A.new_ones(())
    ys, taus = [], []
    for j in range(n):
        if j >= m:
            ys.append(A.new_zeros((B, m)))
            taus.append(A.new_zeros((B,)))
            continue
        col = A[:, :, j]
        tail = torch.where(rows > j, col, zero)
        p = (tail[:, :, None] * A).sum(1)  # [B, n]: p_j = σ, p_c = Σ_{r>j} a_rj a_rc
        x0, sigma = col[:, j], p[:, j]
        norm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -norm, norm)
        degenerate = sigma <= 0
        tau = torch.where(degenerate, zero, (beta - x0) / torch.where(norm == 0, one, beta))
        inv = one / torch.where(degenerate, one, x0 - beta)
        s = tau[:, None] * (A[:, j, :] + p * inv[:, None])  # τ vᵀa_c
        s = torch.where(cols >= j, s, zero)
        v = torch.where(rows == j, one, tail * inv[:, None])
        A = A - v[:, :, None] * s[:, None, :]
        ys.append(v)
        taus.append(tau)
    if not ys:
        return A.new_zeros(A.shape), A.new_zeros((B, 0)), A
    return torch.stack(ys, -1), torch.stack(taus, -1), A


@torch.no_grad()
def chain_factorize(
    shifted: torch.Tensor, col_inc: torch.Tensor, active: torch.Tensor, mca: int, me: int
):
    """B independent banded chains, pre-shifted panels ``[B, n, ma, mc]``,
    per-step column increments ``col_inc [B, n]`` (int64) and activity
    ``active [B, n]`` (bool), all on one device.  Returns
    ``(Y [B, n, ma, mc], taus [B, n, mc], R [B, n, me, mc])``."""
    B, n, ma, mc = shifted.shape
    dev = shifted.device
    carry = shifted.new_zeros((B, mca, mc))
    rows = torch.arange(mca, device=dev)
    cols = torch.arange(mc, device=dev)
    zero = shifted.new_zeros(())
    ys, ts, vs = [], [], []
    for l in range(n):
        panel = shifted[:, l].clone()
        panel[:, :mca] += carry
        Y, taus, R = _panel_qr(panel)
        R = torch.triu(R)
        ci = col_inc[:, l, None]
        ri, cj = ci + rows, ci + cols  # [B, mca], [B, mc]
        cut = R.gather(1, ri.clamp(max=ma - 1)[..., None].expand(B, mca, mc))
        cut = cut.gather(2, cj.clamp(max=mc - 1)[:, None, :].expand(B, mca, mc))
        inside = (ri < ma)[:, :, None] & (cj < mc)[:, None, :]
        act = active[:, l, None, None]
        carry = torch.where(act & inside, cut, torch.where(act, zero, carry))
        ys.append(torch.where(act, Y, zero))
        ts.append(torch.where(active[:, l, None], taus, zero))
        vs.append(torch.where(act, R[:, :me], zero))
    return torch.stack(ys, 1), torch.stack(ts, 1), torch.stack(vs, 1)


def _check(t: torch.Tensor, name: str, dim: int) -> None:
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: expected float32 or float64, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _check_like(ref: torch.Tensor, t: torch.Tensor, name: str, shape, dtype=None) -> None:
    """``t`` has ``shape``, ``dtype`` (ref's when None) and ref's device."""
    dtype = ref.dtype if dtype is None else dtype
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != ref.device:
        raise ValueError(
            f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match "
            f"{tuple(shape)} {dtype} {ref.device}"
        )


def _check_chain(ma: int, mc: int, mca: int, me: int, itemsize: int) -> None:
    if not (1 <= mc and 1 <= mca <= ma and 0 <= me <= ma):
        raise ValueError(f"unsupported chain geometry ma={ma} mc={mc} mca={mca} me={me}")
    smem = chain_smem_bytes(ma, mc, mca, itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(f"chain panel needs {smem} bytes of shared memory > {SMEM_LIMIT}")


def _chain_outputs(panels: torch.Tensor, me: int):
    *lead, ma, mc = panels.shape
    return (
        torch.empty_like(panels),
        panels.new_empty((*lead, mc)),
        panels.new_empty((*lead, me, mc)),
    )


def _segment_chains_plain(panels, act, *, mca, me, ci, ci0_rest):
    """Plain version of :func:`segment_chains`."""
    S, L = panels.shape[:2]
    col_inc = torch.full((S, L), ci, dtype=torch.int64, device=panels.device)
    col_inc[1:, 0] = ci0_rest
    return chain_factorize(panels, col_inc, act > 0.5, mca, me)


def segment_chains(
    panels: torch.Tensor, act: torch.Tensor, *, mca: int, me: int, ci: int, ci0_rest: int
):
    """S independent banded chains of L steps (kernel B3).

    ``panels [S, L, ma, mc]`` are pre-shifted (block rows below the carry
    rows), ``act [S, L]`` (same dtype, > 0.5 = active).  Segment 0 cuts every
    carry at ``ci``; segments ≥ 1 cut their first step's carry at
    ``ci0_rest`` (their dropped leading overlap) and the rest at ``ci``.
    Returns ``(Y [S, L, ma, mc], taus [S, L, mc], R [S, L, me, mc])``.  A
    CUDA tensor runs the CUDA kernel (built at first use) or raises; a CPU
    tensor runs the plain version."""
    _check(panels, "panels", 4)
    S, L, ma, mc = panels.shape
    _check_like(panels, act, "act", (S, L))
    _check_chain(ma, mc, mca, me, panels.element_size())
    if not 0 <= ci <= mc or not 0 <= ci0_rest <= mc:
        raise ValueError(f"column increments ci={ci} ci0_rest={ci0_rest} outside [0, {mc}]")
    if panels.device.type == "cpu":
        return _segment_chains_plain(panels, act, mca=mca, me=me, ci=ci, ci0_rest=ci0_rest)
    if not (panels.is_contiguous() and act.is_contiguous()):
        raise ValueError("panels and act must be contiguous")
    y, tau, v = _chain_outputs(panels, me)
    if S == 0 or L == 0:
        return y, tau, v
    _build.banded_launcher("segment_chains", panels.dtype)(
        panels.device.index, *(t.data_ptr() for t in (panels, act, y, tau, v)),
        S, L, ma, mc, mca, me, ci, ci0_rest,
    )
    segment_chains.launches += 1
    return y, tau, v


segment_chains.launches = 0


def _chain_qr_plain(panels, act, *, mca, me, ci, ci0):
    """Plain version of :func:`chain_qr`."""
    col_inc = torch.full((1, panels.shape[0]), ci, dtype=torch.int64, device=panels.device)
    col_inc[0, 0] = ci0
    y, t, v = chain_factorize(panels[None], col_inc, act[None] > 0.5, mca, me)
    return y[0], t[0], v[0]


def chain_qr(
    panels: torch.Tensor, act: torch.Tensor, *, mca: int, me: int, ci: int, ci0: int
):
    """One sequential banded chain of ``nb`` steps in one launch (kernel B5).

    ``panels [nb, ma, mc]`` pre-shifted, ``act [nb]``; the first step cuts
    its carry at ``ci0``, the others at ``ci``.  Returns ``(Y [nb, ma, mc],
    taus [nb, mc], R [nb, me, mc])``.  Same device rules as
    :func:`segment_chains`."""
    _check(panels, "panels", 3)
    nb, ma, mc = panels.shape
    _check_like(panels, act, "act", (nb,))
    _check_chain(ma, mc, mca, me, panels.element_size())
    if not 0 <= ci <= mc or not 0 <= ci0 <= mc:
        raise ValueError(f"column increments ci={ci} ci0={ci0} outside [0, {mc}]")
    if panels.device.type == "cpu":
        return _chain_qr_plain(panels, act, mca=mca, me=me, ci=ci, ci0=ci0)
    if not (panels.is_contiguous() and act.is_contiguous()):
        raise ValueError("panels and act must be contiguous")
    y, tau, v = _chain_outputs(panels, me)
    if nb == 0:
        return y, tau, v
    _build.banded_launcher("chain_qr", panels.dtype)(
        panels.device.index, *(t.data_ptr() for t in (panels, act, y, tau, v)),
        nb, ma, mc, mca, me, ci, ci0,
    )
    chain_qr.launches += 1
    return y, tau, v


chain_qr.launches = 0


def _window_rows(ab: torch.Tensor, ma: int, mca: int, h: int):
    """Per-step W rows of the window (``[L, ma]``: head rows at
    ``min(a, h) + r``, tail rows at ``min(b, h) + r - mca``) and whether each
    row's unclamped position lies below ``h`` (it is written back)."""
    r = torch.arange(ma, device=ab.device)
    head = r < mca
    a, b = ab[:, :1].long(), ab[:, 1:].long()
    pos = torch.where(head, a + r, b + r - mca)
    row = torch.where(head, a.clamp(max=h) + r, b.clamp(max=h) + r - mca)
    return row, pos < h


@torch.no_grad()
def _segment_apply_w_plain(y, tau, w, ab, *, mca, h, wrows):
    """Plain version of :func:`segment_apply_w`."""
    S, L, ma, mc = y.shape
    W = w.new_zeros((S, wrows, w.shape[3]))
    rows, written = _window_rows(ab, ma, mca, h)
    out = []
    for l in range(L):
        idx = rows[l]
        wl = W[:, idx] + w[:, l]  # [S, ma, ko]
        for j in range(mc):
            v = y[:, l, j:, j, None]  # [S, ma - j, 1]
            s = tau[:, l, j, None] * (v * wl[:, j:]).sum(1)  # [S, ko]
            wl[:, j:] -= v * s[:, None, :]
        out.append(wl)
        W[:, idx] = torch.where(written[l, None, :, None], wl, W[:, idx])
    return torch.stack(out, 1)


def segment_apply_w(
    y: torch.Tensor,
    tau: torch.Tensor,
    w: torch.Tensor,
    ab: torch.Tensor,
    *,
    mca: int,
    h: int,
    wrows: int,
) -> torch.Tensor:
    """Each segment's chain of reflectors applied to ``ko`` operand columns,
    Qᵀ order (kernel B4).

    ``y [S, L, ma, mc]`` and ``tau [S, L, mc]`` are :func:`segment_chains`'
    outputs; ``w [S, L, ma, ko]`` holds, for each step's window row, the
    pristine operand value of a position's first toucher and 0 otherwise;
    ``ab [L, 2]`` (int32, on the same device) the per-step window starts.
    Window row r of step l lives at work-buffer row ``min(a_l, h) + r``
    (r < mca) or ``min(b_l, h) + r - mca``; rows whose unclamped position is
    ≥ h are never written back, so they read 0.  Returns every step's
    post-transform window rows ``[S, L, ma, ko]``; the caller composes the
    result with its last-writer map (``solvers.segmented_plan.prepare_p2w``).
    Same device rules as :func:`segment_chains`."""
    _check(y, "y", 4)
    S, L, ma, mc = y.shape
    _check_like(y, tau, "tau", (S, L, mc))
    if w.dim() != 4:
        raise ValueError(f"w must be [S, L, ma, ko], got {tuple(w.shape)}")
    ko = w.shape[3]
    _check_like(y, w, "w", (S, L, ma, ko))
    if ab.dtype != torch.int32 or tuple(ab.shape) != (L, 2) or ab.device != y.device:
        raise ValueError(f"ab must be int32 [{L}, 2] on {y.device}, got {ab.dtype} {tuple(ab.shape)}")
    if not (1 <= mca < ma and 0 <= h and wrows >= h + max(ma - mca, mca) and 1 <= ko <= 1024):
        raise ValueError(f"unsupported W geometry ma={ma} mca={mca} h={h} wrows={wrows} ko={ko}")
    smem = apply_w_smem_bytes(ma, mc, ko, wrows, y.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"W buffer needs {smem} bytes of shared memory > {SMEM_LIMIT}")
    if y.device.type == "cpu":
        return _segment_apply_w_plain(y, tau, w, ab, mca=mca, h=h, wrows=wrows)
    if not all(t.is_contiguous() for t in (y, tau, w, ab)):
        raise ValueError("y, tau, w and ab must be contiguous")
    wq = torch.empty_like(w)
    if S == 0 or L == 0:
        return wq
    _build.banded_launcher("apply_w", y.dtype)(
        y.device.index, *(t.data_ptr() for t in (y, tau, w, ab, wq)),
        S, L, ma, mc, mca, ko, h, wrows,
    )
    segment_apply_w.launches += 1
    return wq


segment_apply_w.launches = 0


# --- the chain scans' shared helpers and the back-substitution (K2) ---

def _rows(M: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``M[b, idx[b, i], :]`` for ``M [B, m, k]`` and ``idx [B, n]``."""
    return M.gather(1, idx[..., None].expand(-1, -1, M.shape[2]))


def scan_launch(k: int, per_stage: int, per_warp: int, itemsize: int, max_warps: int = _MAX_WARPS):
    """``(warps, stages)`` of a K1 / K2 launch, or None when one warp with
    one stage already exceeds ``SMEM_LIMIT``: a CTA holds ``stages`` copies
    of a step's panel (``per_stage`` elements) and the scratch of ``warps``
    operand columns (``per_warp`` elements each).  Two stages first, with
    the most warps (at most ``max_warps``, at most k) that fit."""
    for stages in (2, 1):
        warps = max(min(k, max_warps), 1)
        while warps >= 1:
            if (stages * per_stage + warps * per_warp) * itemsize <= SMEM_LIMIT:
                return warps, stages
            warps //= 2
    return None


def solve_chunk_launch(max_emit: int, max_cols: int, k: int, itemsize: int):
    """K2's ``(warps, stages)`` for ``max_emit × max_cols`` R panels on k
    columns: a stage holds a panel at the odd row stride ``max_cols | 1``, a
    warp two sets of the window of x and of y's rows, the right-hand side
    and the rows solved (``launch_solve`` in ``csrc/chain_apply.cu`` counts
    the same bytes)."""
    return scan_launch(k, max_emit * (max_cols | 1), 2 * max_cols + 4 * max_emit, itemsize)


def solve_chunk_fits(max_emit: int, max_cols: int, itemsize: int) -> bool:
    """Whether K2 takes ``max_emit × max_cols`` R panels."""
    return (0 <= max_emit <= max_cols and max_cols >= 1
            and solve_chunk_launch(max_emit, max_cols, 1, itemsize) is not None)


def banded_solve_chunk(
    ypad: torch.Tensor,
    r_panels: torch.Tensor,
    cols: torch.Tensor,
    emit_rows: torch.Tensor,
    ncols: torch.Tensor,
    active: torch.Tensor,
    *,
    max_emit: int,
    max_cols: int,
    plan: Optional[ChainPlan] = None,
) -> torch.Tensor:
    """Blocked back-substitution of B independent banded chains, last block
    first (kernel K2).  ``ypad [B, n + max_cols, k]``; ``r_panels [B, L, E,
    max_cols]`` with ``E ≥ max_emit`` (rows past ``max_emit`` unread);
    ``cols``, ``emit_rows``, ``ncols`` ``[B, L]`` (int64) and ``active
    [B, L]`` (bool).  Per step: subtract the already-solved overlap columns
    ``[er, nc)``, then one triangular solve of the live ``er`` rows (padded
    rows become identity); only live rows of active steps are written.
    Returns ``xpad``, same shape as ``ypad``.  A CUDA tensor runs the CUDA
    kernel (built at first use) or raises; a CPU tensor runs the plain
    version :func:`_banded_solve_chunk_plain`.  On the card every operand
    must be contiguous.  ``plan``: the chunk plan
    (:func:`~qrkit_tpu_torch.ops.chain_plan.solve_plan`, on ypad's
    device): the kernel runs its chunks side by side; None runs the whole
    back-substitution in one launch."""
    _check(ypad, "ypad", 3)
    B, rows, k = ypad.shape
    if cols.dim() != 2 or cols.shape[0] != B:
        raise ValueError(f"cols must be [{B}, L], got {tuple(cols.shape)}")
    L = cols.shape[1]
    for name, t in (("cols", cols), ("emit_rows", emit_rows), ("ncols", ncols)):
        _check_like(ypad, t, name, (B, L), torch.int64)
    _check_like(ypad, active, "active", (B, L), torch.bool)
    if r_panels.dim() != 4 or r_panels.shape[2] < max_emit:
        raise ValueError(f"r_panels must be [{B}, {L}, >= {max_emit}, {max_cols}], "
                         f"got {tuple(r_panels.shape)}")
    E = r_panels.shape[2]
    _check_like(ypad, r_panels, "r_panels", (B, L, E, max_cols))
    if not (0 <= max_emit <= max_cols and rows >= max_cols):
        raise ValueError(f"unsupported solve geometry max_emit={max_emit} max_cols={max_cols} "
                         f"rows={rows}")
    if ypad.device.type == "cpu":
        return _banded_solve_chunk_plain(
            ypad, r_panels, cols, emit_rows, ncols, active, max_emit=max_emit, max_cols=max_cols
        )
    if not all(t.is_contiguous() for t in (ypad, r_panels, cols, emit_rows, ncols, active)):
        raise ValueError("ypad, r_panels, cols, emit_rows, ncols and active must be contiguous")
    launch = solve_chunk_launch(max_emit, max_cols, k, ypad.element_size())
    if launch is None:
        raise ValueError(
            f"R panels max_emit={max_emit} max_cols={max_cols} ({ypad.dtype}) exceed the "
            "kernel's shared memory"
        )
    if plan is not None:
        check_plan(plan, "solve", (B, L), ypad.device)
    xpad = torch.zeros_like(ypad)
    if B and L and k:
        if plan is None:
            _build.chain_launcher("solve", ypad.dtype)(
                ypad.device.index,
                *(t.data_ptr() for t in (ypad, r_panels, cols, emit_rows, ncols, active, xpad)),
                B, L, E, max_emit, max_cols, rows, k, *launch,
            )
        else:
            _solve_chunked(ypad, r_panels, cols, emit_rows, ncols, active, xpad, max_emit,
                           max_cols, plan)
        banded_solve_chunk.launches += 1
    return xpad


banded_solve_chunk.launches = 0


def _solve_chunked(ypad, r_panels, cols, emit_rows, ncols, active, xpad, me: int, mc: int,
                   plan: ChainPlan) -> None:
    """K2's chunked form into the zeroed ``xpad``: per level P1, P2 and P3
    (:func:`~qrkit_tpu_torch.ops.chain_plan.launch_levels`)."""
    B, rows, k = ypad.shape
    L, E = r_panels.shape[1], r_panels.shape[2]
    t = plan.tensors
    scr, inb, outb = chunk_buffers(plan, xpad)
    dev, isz = ypad.device.index, ypad.element_size()
    chunk = _build.chain_launcher("solve_chunk", ypad.dtype)
    join = _build.chain_launcher("join", ypad.dtype)
    ptrs = [x.data_ptr() for x in (ypad, r_panels, cols, t["steps"], emit_rows, ncols, active,
                                   t["chunks"], t["rows"], t["iface_out"], xpad, scr, inb, outb)]

    def phase(lv, mode):
        wl = lv.width if mode == FIRST_PASS else 0
        launch = solve_chunk_launch(me, mc, k + wl, isz)
        chunk(dev, *ptrs, L, E, me, mc, rows, k, *launch, lv.begin, lv.end - lv.begin, plan.wmax,
              wl, mode)

    launch_levels(plan, phase, lambda lv: join(
        dev, t["chunks"].data_ptr(), outb.data_ptr(), inb.data_ptr(), lv.begin, lv.end, k,
        plan.wmax))


@highest_precision()
def _banded_solve_chunk_plain(
    ypad: torch.Tensor,
    r_panels: torch.Tensor,
    cols: torch.Tensor,
    emit_rows: torch.Tensor,
    ncols: torch.Tensor,
    active: torch.Tensor,
    *,
    max_emit: int,
    max_cols: int,
) -> torch.Tensor:
    """Plain version of :func:`banded_solve_chunk`: the scan as a Python
    loop of a gather, a product, a masked triangular solve and a scatter a
    step."""
    xpad = torch.zeros_like(ypad)
    _banded_solve_steps(ypad, r_panels, cols, cols, emit_rows, ncols, active, xpad,
                        range(cols.shape[1] - 1, -1, -1), max_emit, max_cols)
    return xpad


def _banded_solve_steps(ypad, r_panels, ycols, xcols, emit_rows, ncols, active, xpad, order,
                        max_emit: int, max_cols: int) -> None:
    """Steps ``order`` of the plain back-substitution on ``xpad [B, rows,
    k]``, in place; step l reads y at ``ycols[:, l]`` and x at ``xcols[:,
    l]`` (the same rows but in a chunk's layout)."""
    dev, dt = ypad.device, ypad.dtype
    r_iota = torch.arange(max_emit, device=dev)
    c_iota = torch.arange(max_cols, device=dev)
    eye = torch.eye(max_emit, dtype=dt, device=dev)
    zero = ypad.new_zeros(())
    for l in order:
        V = r_panels[:, l, :max_emit]  # [B, me, mc]
        c0, er, nc = xcols[:, l, None], emit_rows[:, l, None], ncols[:, l, None]
        xwin = _rows(xpad, c0 + c_iota)
        overlap = ((c_iota >= er) & (c_iota < nc))[..., None]
        rhs_sub = V @ torch.where(overlap, xwin, zero)
        er_rows = c0 + r_iota
        live = r_iota < er  # [B, me]
        rhs = torch.where(live[..., None], _rows(ypad, ycols[:, l, None] + r_iota) - rhs_sub, zero)
        U = torch.where(live[:, :, None] & live[:, None, :], V[:, :, :max_emit], eye)
        xblk = torch.linalg.solve_triangular(U, rhs, upper=True)
        keep = (live & active[:, l, None])[..., None]
        new = torch.where(keep, xblk, _rows(xpad, er_rows))
        xpad.scatter_(1, er_rows[..., None].expand(-1, -1, xpad.shape[2]), new)


@highest_precision()
def _banded_solve_chunked_plain(ypad, r_panels, cols, emit_rows, ncols, active, *,
                                max_emit: int, max_cols: int, plan: ChainPlan) -> torch.Tensor:
    """A torch model of K2's chunked form (P1–P3 on ``plan``, from
    :func:`~qrkit_tpu_torch.ops.chain_plan.solve_plan`): each chunk runs the
    plain back-substitution's steps on its own layout of x's rows; P1's unit
    columns see y = 0.  For tests and ``chip_smoke.py``; no path calls it."""
    L = cols.shape[1]
    k = ypad.shape[2]
    xpad = torch.zeros_like(ypad)
    lc = torch.as_tensor(plan.steps, device=ypad.device)

    def steps(c, local, ky):
        b, i0, ln = (int(v) for v in plan.chunks[c, [SEQ, START, LEN]])
        sl = slice(b, b + 1)
        y = ypad[sl]
        if local.shape[2] > ky:
            y = torch.cat([y, y.new_zeros((1, y.shape[1], local.shape[2] - ky))], dim=2)
        _banded_solve_steps(y, r_panels[sl], cols[sl], lc[sl], emit_rows[sl], ncols[sl],
                            active[sl], local, [L - 1 - i for i in range(i0, i0 + ln)],
                            max_emit, max_cols)

    chunked_plain(plan, xpad, steps, max_cols)
    return xpad
