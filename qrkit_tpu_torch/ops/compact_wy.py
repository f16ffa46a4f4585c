"""Implicit Q as a sequence of compact-WY blocks, on torch tensors.

Counterpart of ``qrkit_tpu/ops/compact_wy.py`` (``CompactWYSeq``,
``TwoSegmentWYSeq``, ``_apply_seq``, ``_apply_two_seg``,
``_apply_two_seg_cols``, ``_to_sparse_q``).  Block k applies
``w += Y_k ((T_k or T_kᵀ) (Y_kᵀ w))`` to its rows of the operand; ``Qᵀ``
runs the blocks forward, ``Q`` in reverse.  ``lax.scan`` becomes a Python
loop of batched torch ops whose window offsets stay on the device (gather /
scatter, no host sync).

The reference has two layouts of the two-segment apply, row-major
(``_apply_two_seg``) and lane-major for narrow operands
(``_apply_two_seg_cols``), which differ only in TPU lane padding.  Here both
are :func:`two_segment_apply`, batched over independent sequences so that
the segmented solver's per-segment applies (``_segment_apply``,
``_segment_apply_cols``) are the same function.  Y and T are stored 3-D
(``[nb, A, C]``); the reference flattens them only against TPU lane padding.

:func:`two_segment_apply` is the wrapper of kernel K1
(``csrc/chain_apply.cu``): on a CUDA tensor it runs the whole scan in one
launch or raises; on a CPU tensor it runs the plain version
:func:`_two_segment_apply_plain`, the scan as a Python loop of batched torch
ops.  Its ``launches`` counter counts the kernel's launches.  A solver sends
a geometry whose shared memory the kernel cannot hold
(:func:`two_segment_fits`) to the plain version, decided once at analysis.
:class:`CompactWYSeq` (blocked thin QR's few large windows) stays plain.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from .banded import _check, _check_like, _rows, scan_launch
from .chain_plan import (
    FIRST_PASS, LEN, SEQ, START, ChainPlan, check_plan, chunk_buffers, chunked_plain,
    launch_levels,
)
from .householder import highest_precision

# operand columns of a K1 CTA: its staging warp brings in and writes back
# every column's rows each step, and past two columns it, not the columns'
# arithmetic, would set the step's time
_K1_COLUMNS = 2

__all__ = [
    "CompactWYSeq", "TwoSegmentWYSeq", "two_segment_apply", "two_segment_fits",
    "two_segment_launch",
]


def _to_sparse_q(seq, chunk: int = 512, drop_tol: float = 0.0):
    """Explicit sparse Q by application to unit-column slabs of ``chunk``
    columns (Q·I, chunked): device memory O(m·chunk), host O(nnz(Q))."""
    from ..sparse import SparseCSR

    m = seq.m
    rows_l, cols_l, vals_l = [], [], []
    for c0 in range(0, m, chunk):
        k = min(chunk, m - c0)
        slab = seq.Y.new_zeros((m, k))
        slab[c0 + torch.arange(k, device=slab.device), torch.arange(k, device=slab.device)] = 1
        q_slab = seq.apply_q(slab).cpu().numpy()
        r, c = np.nonzero(np.abs(q_slab) > drop_tol)
        rows_l.append(r)
        cols_l.append(c + c0)
        vals_l.append(q_slab[r, c])
    return SparseCSR.from_triplets(
        np.concatenate(rows_l), np.concatenate(cols_l), np.concatenate(vals_l), (m, m)
    )


def two_segment_launch(A: int, C: int, k: int, itemsize: int):
    """K1's ``(warps, stages)`` for ``A × C`` panels on k operand columns: a
    stage holds Y and T at the odd row stride ``C | 1``, a warp three sets
    of the A gathered rows and the A tail rows' start-of-step values, and
    two C-vectors (``launch_two_seg`` in ``csrc/chain_apply.cu`` counts the
    same bytes)."""
    return scan_launch(k, (A + C) * (C | 1), 6 * A + 2 * C, itemsize, _K1_COLUMNS)


def two_segment_fits(A: int, C: int, itemsize: int) -> bool:
    """Whether K1 takes ``A × C`` panels (one warp and one stage within a
    CTA's shared memory)."""
    return A >= 1 and C >= 1 and two_segment_launch(A, C, 1, itemsize) is not None


def two_segment_apply(
    Y: torch.Tensor,
    T: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    split: torch.Tensor,
    M: torch.Tensor,
    h1: int,
    transpose: bool,
    plan: Optional[ChainPlan] = None,
) -> torch.Tensor:
    """Q (or Qᵀ) of B independent two-segment sequences on ``M [B, m, k]``
    (kernel K1).

    ``Y [B, n, A, C]`` and ``T [B, n, C, C]`` are in panel coordinates;
    ``s1``, ``s2``, ``split`` ``[B, n]`` (int64, on M's device) give each
    step's carry segment start, block segment start and the number of panel
    rows taken from the carry segment (``0 ≤ split ≤ min(h1, A)``).  Rows
    ``[0, split)`` of the panel gather from ``s1 + r``, the rest from
    ``s2 + r - split``; after the update the head is written back, then the
    tail, so a row shared by the padded segments keeps the owning side's
    value.  A step with ``Y = T = 0`` (a padded, inactive step) is an exact
    no-op.  A CUDA tensor runs the CUDA kernel (built at first use) or
    raises; a CPU tensor runs the plain version.  Y, T and the index arrays
    must be contiguous on the card; M may have any layout (the result is a
    new tensor).  ``plan``: the direction's chunk plan
    (:func:`~qrkit_tpu_torch.ops.chain_plan.two_segment_plan`, on M's
    device): the kernel runs its chunks side by side, level by level; None
    runs the whole scan in one launch."""
    _check(Y, "Y", 4)
    B, n, A, C = Y.shape
    _check_like(Y, T, "T", (B, n, C, C))
    for name, t in (("s1", s1), ("s2", s2), ("split", split)):
        _check_like(Y, t, name, (B, n), torch.int64)
    if M.dim() != 3 or M.shape[0] != B:
        raise ValueError(f"M must be [{B}, m, k], got {tuple(M.shape)}")
    _check_like(Y, M, "M", M.shape)
    h1 = int(h1)
    if h1 < 1:
        raise ValueError(f"h1 must be >= 1, got {h1}")
    if M.device.type == "cpu":
        return _two_segment_apply_plain(Y, T, s1, s2, split, M, h1, transpose)
    if not all(t.is_contiguous() for t in (Y, T, s1, s2, split)):
        raise ValueError("Y, T, s1, s2 and split must be contiguous")
    m, k = M.shape[1], M.shape[2]
    launch = two_segment_launch(A, C, k, Y.element_size())
    if launch is None:
        raise ValueError(
            f"two-segment panels A={A} C={C} ({Y.dtype}) exceed the kernel's shared memory"
        )
    if plan is not None:
        check_plan(plan, "two_seg", (2, B, n), Y.device, bool(transpose))
    Mp = torch.cat([M, M.new_zeros((B, h1 + A, k))], dim=1)
    if B and n and k:
        if plan is None:
            _build.chain_launcher("two_seg", Y.dtype)(
                Y.device.index, *(t.data_ptr() for t in (Y, T, s1, s2, split, Mp)),
                B, n, A, C, h1, m + h1 + A, k, int(bool(transpose)), *launch,
            )
        else:
            _two_segment_chunked(Y, T, split, Mp, h1, transpose, plan)
        two_segment_apply.launches += 1
    return Mp[:, :m]


two_segment_apply.launches = 0


def _two_segment_chunked(Y, T, split, Mp, h1: int, transpose: bool, plan: ChainPlan) -> None:
    """K1's chunked form on ``Mp`` in place: per level P1, P2 and P3
    (:func:`~qrkit_tpu_torch.ops.chain_plan.launch_levels`)."""
    B, n, A, C = Y.shape
    mp, k = Mp.shape[1], Mp.shape[2]
    t = plan.tensors
    scr, inb, outb = chunk_buffers(plan, Mp)
    dev, isz = Y.device.index, Y.element_size()
    chunk = _build.chain_launcher("two_seg_chunk", Y.dtype)
    join = _build.chain_launcher("join", Y.dtype)
    ptrs = [x.data_ptr() for x in (Y, T, t["steps"][0], t["steps"][1], split, t["chunks"],
                                   t["rows"], t["iface_out"], Mp, scr, inb, outb)]

    def phase(lv, mode):
        wl = lv.width if mode == FIRST_PASS else 0
        launch = two_segment_launch(A, C, k + wl, isz)
        chunk(dev, *ptrs, n, A, C, h1, mp, k, int(bool(transpose)), *launch, lv.begin,
              lv.end - lv.begin, plan.wmax, wl, mode)

    launch_levels(plan, phase, lambda lv: join(
        dev, t["chunks"].data_ptr(), outb.data_ptr(), inb.data_ptr(), lv.begin, lv.end, k,
        plan.wmax))


@highest_precision()
def _two_segment_apply_plain(
    Y: torch.Tensor,
    T: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    split: torch.Tensor,
    M: torch.Tensor,
    h1: int,
    transpose: bool,
) -> torch.Tensor:
    """Plain version of :func:`two_segment_apply`: the scan as a Python loop
    of batched gathers, three small products and two scatters a step."""
    B, n, A, _ = Y.shape
    m, k = M.shape[1], M.shape[2]
    Mp = torch.cat([M, M.new_zeros((B, h1 + A, k))], dim=1)
    order = range(n) if transpose else range(n - 1, -1, -1)
    _two_seg_steps(Y, T, s1, s2, split, Mp, h1, transpose, order)
    return Mp[:, :m]


def _two_seg_steps(Y, T, s1, s2, split, Mp, h1: int, transpose: bool, order) -> None:
    """Steps ``order`` of the plain scan on ``Mp [B, rows, k]``, in place
    (rows ``s1 + [0, h1)`` and ``s2 + [0, A)`` of every step inside it)."""
    A = Y.shape[2]
    k = Mp.shape[2]
    dev = Mp.device
    jA = torch.arange(A, device=dev)
    j1 = torch.arange(h1, device=dev)
    head_rows = jA.clamp(max=h1 - 1)
    back_rows = j1.clamp(max=A - 1)
    for l in order:
        sp = split[:, l, None]  # [B, 1]
        i1 = s1[:, l, None] + j1
        i2 = s2[:, l, None] + jA
        w1 = _rows(Mp, i1)
        w2 = _rows(Mp, i2)
        wg = torch.where(
            (jA < sp)[..., None], w1[:, head_rows], _rows(w2, (jA - sp).clamp(0, A - 1))
        )
        Yk, Tk = Y[:, l], T[:, l]
        Tt = Tk.mT if transpose else Tk
        wg = wg + Yk @ (Tt @ (Yk.mT @ wg))
        w1o = torch.where((j1 < sp)[..., None], wg[:, back_rows], w1)
        w2o = torch.where(
            (jA + sp < A)[..., None], _rows(wg, (jA + sp).clamp(max=A - 1)), w2
        )
        Mp.scatter_(1, i1[..., None].expand(-1, -1, k), w1o)
        Mp.scatter_(1, i2[..., None].expand(-1, -1, k), w2o)


@highest_precision()
def _two_segment_apply_chunked_plain(Y, T, s1, s2, split, M, h1: int, transpose: bool,
                                     plan: ChainPlan) -> torch.Tensor:
    """A torch model of K1's chunked form (P1–P3 on ``plan``, the
    direction's :func:`~qrkit_tpu_torch.ops.chain_plan.two_segment_plan`):
    each chunk runs the plain scan's steps on its own layout of rows.  For
    tests and ``chip_smoke.py``; no path calls it."""
    B, n, A, _ = Y.shape
    m, k = M.shape[1], M.shape[2]
    Mp = torch.cat([M, M.new_zeros((B, h1 + A, k))], dim=1)
    ls = torch.as_tensor(plan.steps, device=M.device)

    def steps(c, local, ky):
        b, i0, ln = (int(v) for v in plan.chunks[c, [SEQ, START, LEN]])
        pos = range(i0, i0 + ln)
        order = pos if transpose else [n - 1 - i for i in pos]
        sl = slice(b, b + 1)
        _two_seg_steps(Y[sl], T[sl], ls[0, sl], ls[1, sl], split[sl], local, h1, transpose, order)

    chunked_plain(plan, Mp, steps, h1 + A)
    return Mp[:, :m]


class TwoSegmentWYSeq:
    """Compact-WY sequence in panel coordinates with a two-segment
    gather/scatter (the reference's ``getVectorSegments`` /
    ``setVectorSegments`` with ``numZeros`` gap rows).

    Block k's panel ``Y[k]`` (``[A, C]``, A = carry pad + block rows) acts on
    the carry segment at ``s1[k]`` (``split[k]`` rows live) and the block
    segment at ``s2[k]``; the store is O(nb·A·C) however long the chain.
    ``kernel``: apply through K1's wrapper (:func:`two_segment_apply`), else
    its plain version (the solver's route); ``plan``: the wrapper's chunk
    plans ``(Qᵀ, Q)`` (:func:`~qrkit_tpu_torch.ops.chain_plan.two_segment_plan`),
    None for one launch a product."""

    def __init__(self, Y, T, s1, s2, split, *, h1: int, m: int, kernel: bool = True, plan=None):
        self.Y, self.T = Y, T
        self.kernel = kernel
        self.plan = (None, None) if plan is None else tuple(plan)
        dev = Y.device
        self.s1, self.s2, self.split = (
            torch.as_tensor(a, dtype=torch.int64, device=dev) for a in (s1, s2, split)
        )
        self.h1, self.m = int(h1), int(m)

    @property
    def num_blocks(self) -> int:
        return self.Y.shape[0]

    def _apply(self, M: torch.Tensor, transpose: bool) -> torch.Tensor:
        vec = M.dim() == 1
        M2 = M[:, None] if vec else M
        args = (self.Y[None], self.T[None], self.s1[None], self.s2[None], self.split[None],
                M2[None], self.h1, transpose)
        if self.kernel:
            out = two_segment_apply(*args, plan=self.plan[0 if transpose else 1])[0]
        else:
            out = _two_segment_apply_plain(*args)[0]
        return out[:, 0] if vec else out

    def apply_q(self, M: torch.Tensor) -> torch.Tensor:
        return self._apply(M, transpose=False)

    def apply_qt(self, M: torch.Tensor) -> torch.Tensor:
        return self._apply(M, transpose=True)

    def to_dense_q(self) -> torch.Tensor:
        return self.apply_q(torch.eye(self.m, dtype=self.Y.dtype, device=self.Y.device))

    def to_sparse_q(self, chunk: int = 512, drop_tol: float = 0.0):
        return _to_sparse_q(self, chunk, drop_tol)


class CompactWYSeq:
    """Stacked compact-WY blocks in window coordinates: ``Y [nb, W, C]``,
    ``T [nb, C, C]``, ``start [nb]``; block k updates rows
    ``[start[k], start[k] + W)`` of the operand (gap rows are zero rows of
    Y).  Padding rows and columns of Y and T are zero."""

    def __init__(self, Y, T, start, m: int):
        self.Y, self.T = Y, T
        self.start = torch.as_tensor(start, dtype=torch.int64, device=Y.device)
        self.m = int(m)

    @property
    def num_blocks(self) -> int:
        return self.Y.shape[0]

    @property
    def window(self) -> int:
        return self.Y.shape[1]

    @highest_precision()
    def _apply(self, M: torch.Tensor, transpose: bool) -> torch.Tensor:
        vec = M.dim() == 1
        M2 = M[:, None] if vec else M
        W = self.window
        Mp = torch.cat([M2, M2.new_zeros((W, M2.shape[1]))])
        rows = torch.arange(W, device=M.device)
        order = range(self.num_blocks) if transpose else range(self.num_blocks - 1, -1, -1)
        for k in order:
            idx = self.start[k] + rows
            w = Mp[idx]
            Tt = self.T[k].mT if transpose else self.T[k]
            Mp[idx] = w + self.Y[k] @ (Tt @ (self.Y[k].mT @ w))
        out = Mp[: self.m]
        return out[:, 0] if vec else out

    def apply_q(self, M: torch.Tensor) -> torch.Tensor:
        """Q · M: blocks in reverse order."""
        return self._apply(M, transpose=False)

    def apply_qt(self, M: torch.Tensor) -> torch.Tensor:
        """Qᵀ · M: blocks in forward order."""
        return self._apply(M, transpose=True)

    def to_dense_q(self) -> torch.Tensor:
        return self.apply_q(torch.eye(self.m, dtype=self.Y.dtype, device=self.Y.device))

    def to_sparse_q(self, chunk: int = 512, drop_tol: float = 0.0):
        return _to_sparse_q(self, chunk, drop_tol)

    @staticmethod
    def single(Y: torch.Tensor, T: torch.Tensor, start: int, m: int) -> "CompactWYSeq":
        return CompactWYSeq(Y[None], T[None], [start], m)

    @staticmethod
    def concat(a: "CompactWYSeq", b: "CompactWYSeq") -> "CompactWYSeq":
        """a's blocks then b's (Qᵀ order), padded to the common window and
        panel width."""
        if a.m != b.m:
            raise ValueError(f"sequences act on {a.m} and {b.m} rows")
        W = max(a.window, b.window)
        C = max(a.Y.shape[2], b.Y.shape[2])

        def pad(seq):
            Y = seq.Y.new_zeros((seq.num_blocks, W, C))
            Y[:, : seq.window, : seq.Y.shape[2]] = seq.Y
            T = seq.T.new_zeros((seq.num_blocks, C, C))
            T[:, : seq.T.shape[1], : seq.T.shape[2]] = seq.T
            return Y, T

        (Ya, Ta), (Yb, Tb) = pad(a), pad(b)
        return CompactWYSeq(
            torch.cat([Ya, Yb]), torch.cat([Ta, Tb]), torch.cat([a.start, b.start]), a.m
        )
