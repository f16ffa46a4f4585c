"""Carry state from the JAX package into the port, through NumPy.

No counterpart module in ``qrkit_tpu``: this is the bridge the port adds.
Each function takes plain NumPy arrays and Python values (``np.asarray`` of
a ``qrkit_tpu`` object's arrays), never imports jax, and puts the arrays on
``device`` (default CUDA).

* :func:`block_diagonal_from_numpy` — a ``qrkit_tpu.BlockDiagonal``'s AoS or
  SoA storage → the port's :class:`~qrkit_tpu_torch.containers.BlockDiagonal`.
* :func:`block_diagonal_qr_from_numpy` — a computed
  ``qrkit_tpu.BlockDiagonalQR``'s factors → a computed port
  :class:`~qrkit_tpu_torch.solvers.BlockDiagonalQR`, from either tier:
  XLA (``Q``, ``R``, local pivots) or Pallas (``_a_pad``, ``_r_soa``).  The
  Pallas tier pads its SoA batch axis to 1024/4096 lanes with identity
  blocks; the port does not pad, so those columns are dropped here.
* :func:`banded_qr_from_numpy` — a computed ``qrkit_tpu.BandedBlockedQR``'s
  factors → a computed port
  :class:`~qrkit_tpu_torch.solvers.BandedBlockedQR` on the same matrix.
* :func:`segmented_banded_qr_from_numpy` — a computed
  ``qrkit_tpu.SegmentedBandedQR``'s factors → a computed port
  :class:`~qrkit_tpu_torch.solvers.SegmentedBandedQR` on the same matrix.
* :func:`dense_qr_from_numpy` — a computed ``qrkit_tpu.DenseHouseholderQR``
  or ``DenseColPivQR`` (Y, T, R, pivot order) → the port's solver.
* :func:`blocked_thin_qr_from_numpy` — a computed
  ``qrkit_tpu.BlockedThinDenseQR`` or ``BlockedThinSparseQR`` (the Q
  sequence's Y, T and window starts, R, the permutations) → the port's
  solver.
* :func:`block_angular_qr_from_numpy` — a computed
  ``qrkit_tpu.BlockAngularQR`` on the fused dense path → a computed port
  :class:`~qrkit_tpu_torch.solvers.BlockAngularQR` on the same matrix.

The banded converters re-run the port's own (host-only) pattern analysis on
the matrix, which equals the reference's plan, and install the factors in
the port's layouts: the reference stores per-segment factors with the
segment axis last and flattens its WY blocks; the port keeps the segment
axis first and 3-D blocks.  A converted solver solves, applies Q and
exports R; ``factorize_values`` needs one ``compute`` first.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from . import _device
from .containers import BlockDiagonal, BlockMatrix1x2
from .ops.compact_wy import TwoSegmentWYSeq
from .solvers.banded_blocked import BandedBlockedQR
from .solvers.base import _diag_health
from .solvers.block_angular import BlockAngularQR
from .solvers.block_diagonal import BlockDiagonalQR, QFormat
from .solvers.blocked_thin import BlockedThinDenseQR, BlockedThinSparseQR
from .solvers.dense import DenseColPivQR, DenseHouseholderQR
from .solvers.segmented_banded import SegmentedBandedQR
from .sparse import Permutation, SparseCSR

__all__ = [
    "banded_qr_from_numpy",
    "block_angular_qr_from_numpy",
    "block_diagonal_from_numpy",
    "block_diagonal_qr_from_numpy",
    "blocked_thin_qr_from_numpy",
    "dense_qr_from_numpy",
    "segmented_banded_qr_from_numpy",
]


def block_diagonal_from_numpy(
    nrows: int,
    ncols: int,
    *,
    blocks=None,
    blocks_soa=None,
    block_rows=None,
    block_cols=None,
    device=None,
    dtype=None,
) -> BlockDiagonal:
    """The port's container from AoS ``blocks [nb, br, bc]`` or from SoA
    ``blocks_soa [br*bc, nb]`` with ``block_rows``/``block_cols``."""
    if (blocks is None) == (blocks_soa is None):
        raise ValueError("give exactly one of blocks (AoS) or blocks_soa (SoA)")
    if blocks is not None:
        return BlockDiagonal.from_dense_batch(
            np.array(blocks), nrows, ncols, device=device, dtype=dtype
        )
    return BlockDiagonal.from_soa(
        np.array(blocks_soa), block_rows, block_cols, nrows, ncols,
        device=device, dtype=dtype,
    )


def _q_format(value) -> QFormat:
    if isinstance(value, QFormat):
        return value
    if isinstance(value, str):
        return QFormat[value]
    if isinstance(value, int):
        return QFormat(value)
    return QFormat[value.name]  # an enum member of the reference package


def block_diagonal_qr_from_numpy(
    state: Mapping[str, Any], *, device=None, dtype=None
) -> BlockDiagonalQR:
    """A computed port solver from a reference solver's factors.

    ``state`` keys: ``nb``, ``br``, ``bc``, ``nrows``, ``ncols``, ``pivot``,
    ``q_format`` (member, name or value), optionally ``row_perm`` (index
    array), and either the XLA tier's ``Q [nb,br,br]``, ``R [nb,k,bc]`` and
    ``local_perm [nb,bc]`` (needed when ``pivot``), or the Pallas tier's
    ``a_pad [br*bc, npad]`` and ``r_soa [ntri, npad]``.
    """
    nb, br, bc = int(state["nb"]), int(state["br"]), int(state["bc"])
    nrows, ncols = int(state["nrows"]), int(state["ncols"])
    pivot = bool(state["pivot"])
    kernel_tier = "a_pad" in state
    qr = BlockDiagonalQR(
        _q_format(state["q_format"]), pivot=pivot, use_kernel=kernel_tier
    )
    qr._landscape = bc > br
    qr._nrows, qr._ncols = nrows, ncols
    qr._nb, qr._br, qr._bc = nb, br, bc
    qr._shard()
    row_perm = state.get("row_perm")
    qr._row_perm = Permutation(np.asarray(row_perm)) if row_perm is not None else None

    def tensor(x):  # a private, writable copy of the (possibly read-only) array
        return _device.as_tensor(np.array(x), device, dtype)

    if kernel_tier:
        if pivot:
            raise ValueError("the kernel tier is non-pivoting")
        qr._kernel_mode = True
        qr._a_soa = tensor(np.asarray(state["a_pad"])[:, :nb]).contiguous()
        qr._r_soa = tensor(np.asarray(state["r_soa"])[:, :nb]).contiguous()
        qr.Q = qr.R = None
        qr._local_perm = None
    else:
        qr._kernel_mode = False
        qr.Q, qr.R = tensor(state["Q"]), tensor(state["R"])
        qr._local_perm = (
            _device.as_tensor(np.array(state["local_perm"]), device, torch.int64)
            if pivot
            else None
        )
    qr._computed = True
    qr._set_success()
    return qr


def _wy_blocks(Yf, Tf, nb: int, A: int, C: int, like: torch.Tensor):
    """Flattened WY blocks ``[nb, A*C]`` / ``[nb, C*C]`` → 3-D tensors."""
    Y = torch.as_tensor(np.array(Yf), device=like.device, dtype=like.dtype).reshape(nb, A, C)
    T = torch.as_tensor(np.array(Tf), device=like.device, dtype=like.dtype).reshape(nb, C, C)
    return Y, T


def banded_qr_from_numpy(
    mat: SparseCSR,
    state: Mapping[str, Any],
    *,
    suggested_block_cols: int = 2,
    block_rows=None,
    block_cols=None,
    block_overlap=None,
    device=None,
    dtype=None,
) -> BandedBlockedQR:
    """A computed port ``BandedBlockedQR`` on ``mat`` from a reference
    solver's factors.  ``state`` keys: ``Yf [nb, A*C]``, ``Tf [nb, C*C]``
    (``q_seq.Yf`` / ``q_seq.Tf``) and ``r_panels_f [nb, me*mc]``; the
    constructor arguments must be the reference solver's."""
    qr = BandedBlockedQR(
        block_rows, block_cols, block_overlap, suggested_block_cols, device=device, dtype=dtype
    )
    qr.analyze_pattern(mat)
    nb = qr.plan.num_blocks
    like = torch.empty(0, device=qr.device, dtype=qr.dtype)
    Y, T = _wy_blocks(state["Yf"], state["Tf"], nb, qr._max_active, qr._max_cols, like)
    g = qr._geom_dev
    plans = qr._chain_plans
    qr.q_seq = TwoSegmentWYSeq(
        Y, T, g["cols"], g["rows"], g["carry_rows"], h1=qr._max_carry, m=qr.rows,
        kernel=qr._scan_kernel, plan=(plans["qt"], plans["q"]),
    )
    qr._r_panels = torch.as_tensor(
        np.array(state["r_panels_f"]), device=qr.device, dtype=qr.dtype
    ).reshape(nb, qr._max_emit, qr._max_cols)
    qr._set_success(_diag_health(qr.r_diagonal()))
    return qr


def segmented_banded_qr_from_numpy(
    mat: SparseCSR,
    state: Mapping[str, Any],
    *,
    suggested_block_cols: int = 8,
    segment_blocks: int = SegmentedBandedQR.DEFAULT_SEGMENT_BLOCKS,
    block_rows=None,
    block_cols=None,
    block_overlap=None,
    device=None,
    dtype=None,
) -> SegmentedBandedQR:
    """A computed port ``SegmentedBandedQR`` on ``mat`` from a reference
    solver's factors.  ``state`` keys, in the reference's stored layouts:
    ``Yws [L, ma, mc, S]``, ``Ts [L, mc, mc, S]``, ``r_panels [L, me, mc,
    S]``, ``j2_top [S, 2o, nloc]``, ``Yb [rbot, 2o, S]``, ``Tb [S, 2o, 2o]``,
    ``chain_Yf`` / ``chain_Tf`` (the boundary chain's ``TwoSegmentWYSeq``
    leaves) and ``chain_r [nbc, me2, mc2]``.  Raises if the plan delegates
    to the plain solver (convert that one with :func:`banded_qr_from_numpy`)."""
    qr = SegmentedBandedQR(
        suggested_block_cols, segment_blocks, block_rows, block_cols, block_overlap,
        device=device, dtype=dtype,
    )
    qr.analyze_pattern(mat)
    if qr._delegate is not None:
        raise ValueError("this plan delegates to BandedBlockedQR; use banded_qr_from_numpy")

    def tensor(x, *perm):
        t = torch.as_tensor(np.array(x), device=qr.device, dtype=qr.dtype)
        return t.permute(*perm).contiguous() if perm else t

    qr._Yws = tensor(state["Yws"], 3, 0, 1, 2)
    qr._Ts = tensor(state["Ts"], 3, 0, 1, 2)
    qr._r_panels = tensor(state["r_panels"], 3, 0, 1, 2)
    qr._j2_top = tensor(state["j2_top"], 0, 2, 1)
    qr._Yb, qr._Tb = tensor(state["Yb"]), tensor(state["Tb"])
    ckw, cg = qr._chain_kw, qr._chain_geom_dev
    nbc = len(qr._chain_geom["ncols"])
    Yc, Tc = _wy_blocks(
        state["chain_Yf"], state["chain_Tf"], nbc, ckw["max_active"], ckw["max_cols"], qr._Yb
    )
    plans = qr._chain_plans
    qr._chain_seq = TwoSegmentWYSeq(
        Yc, Tc, cg["cols"], cg["rows"], cg["carry_rows"], h1=ckw["max_carry"], m=qr._nbot2,
        kernel=qr._scan_kernel, plan=(plans["qt"], plans["q"]),
    )
    qr._chain_r = tensor(state["chain_r"])
    qr._set_success(_diag_health(qr.r_diagonal()))
    return qr


def dense_qr_from_numpy(state: Mapping[str, Any], *, device=None, dtype=None):
    """A computed port dense solver from a reference solver's factors.

    ``state`` keys: ``Y [m, k]``, ``T [k, k]``, ``R [m, n]`` (``_Y``, ``_T``,
    ``_R``) and, for a ``DenseColPivQR``, ``perm [n]`` (``_perm_dev``); the
    solver class follows from whether ``perm`` is present."""
    def tensor(x):
        return _device.as_tensor(np.array(x), device, dtype)

    R = tensor(state["R"])
    m, n = R.shape
    if state.get("perm") is None:
        qr = DenseHouseholderQR()
        qr._adopt_factors(m, n, tensor(state["Y"]), tensor(state["T"]), R,
                          _diag_health(torch.diagonal(R), check_zero=True))
    else:
        qr = DenseColPivQR()
        perm = torch.as_tensor(np.array(state["perm"]), dtype=torch.int64, device=R.device)
        qr._adopt_factors(m, n, tensor(state["Y"]), tensor(state["T"]), R,
                          _diag_health(torch.diagonal(R), check_zero=False), perm_dev=perm)
    return qr


def blocked_thin_qr_from_numpy(state: Mapping[str, Any], *, device=None, dtype=None):
    """A computed port blocked thin solver from a reference solver's state.

    ``state`` keys: ``Y [nb, W, C]``, ``T [nb, C, C]``, ``start [nb]`` (the
    ``q_seq``'s ``Y``, ``T``, ``start``), ``R [m, n]`` and, for a
    ``BlockedThinSparseQR``, ``col_perm`` and ``row_perm`` (the index arrays
    of ``cols_permutation()`` / ``rows_permutation()``); the solver class
    follows from whether ``col_perm`` is present."""
    from .ops.compact_wy import CompactWYSeq

    def tensor(x):
        return _device.as_tensor(np.array(x), device, dtype)

    R = tensor(state["R"])
    m, n = R.shape
    seq = CompactWYSeq(tensor(state["Y"]), tensor(state["T"]), np.array(state["start"]), m)
    if state.get("col_perm") is None:
        qr = BlockedThinDenseQR(device=R.device, dtype=R.dtype)
        qr._m, qr._n, qr.q_seq, qr._R = m, n, seq, R
        qr._set_success()
        return qr
    qr = BlockedThinSparseQR(device=R.device, dtype=R.dtype)
    qr._m, qr._n, qr.q_seq, qr._R = m, n, seq, R
    qr._diag_dev = torch.diagonal(R[:n, :n])
    qr._out_col_perm = Permutation(np.asarray(state["col_perm"]))
    qr._row_perm = Permutation(np.asarray(state["row_perm"]))
    qr._deficiency_cache = qr._repair = None
    qr._set_success(_diag_health(qr._diag_dev, check_zero=False))
    return qr


def block_angular_qr_from_numpy(
    mat: BlockMatrix1x2, state: Mapping[str, Any], *, device=None, dtype=None
) -> BlockAngularQR:
    """A computed port ``BlockAngularQR`` on ``mat`` (the port's container of
    the same matrix) from a reference solver computed on the fused dense
    path.  ``state`` keys: ``Q [nb, br, br]``, ``R [nb, bc, bc]`` (the left
    child's ``Q``/``R``), ``j2_top``, ``Y2``, ``T2``, ``R2`` (the right
    child's ``_Y``/``_T``/``_R``), ``perm2``, ``r12`` and ``colpiv`` (the
    right child is a ``DenseColPivQR``)."""
    def tensor(x):
        return _device.as_tensor(np.array(x), device, dtype)

    colpiv = bool(state["colpiv"])
    qr = BlockAngularQR(
        BlockDiagonalQR(QFormat.FULL_Q, pivot=False),
        DenseColPivQR() if colpiv else DenseHouseholderQR(),
    )
    qr._compute_preamble(mat)
    if not qr._uses_fused_dense(mat):
        raise ValueError("the matrix does not take the fused dense path")
    Q, R, R2 = tensor(state["Q"]), tensor(state["R"]), tensor(state["R2"])
    h1 = _diag_health(torch.diagonal(R, dim1=1, dim2=2).reshape(-1), check_zero=True)
    h2 = _diag_health(torch.diagonal(R2), check_zero=not colpiv)
    perm2 = torch.as_tensor(np.array(state["perm2"]), dtype=torch.int64, device=Q.device)
    qr._adopt_dense_outputs(mat, (
        Q, R, tensor(state["j2_top"]), tensor(state["Y2"]), tensor(state["T2"]), R2, perm2,
        tensor(state["r12"]), h1, h2,
    ), colpiv)
    return qr
