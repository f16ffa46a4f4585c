"""Carry state from the JAX package into the port, through NumPy.

No counterpart module in ``qrkit_tpu``: this is the bridge the port adds.
Both functions take plain NumPy arrays and Python values (``np.asarray`` of
a ``qrkit_tpu`` object's arrays) and never import jax.

* :func:`block_diagonal_from_numpy` — a ``qrkit_tpu.BlockDiagonal``'s AoS or
  SoA storage → the port's :class:`~qrkit_tpu_torch.containers.BlockDiagonal`.
* :func:`block_diagonal_qr_from_numpy` — a computed
  ``qrkit_tpu.BlockDiagonalQR``'s factors → a computed port
  :class:`~qrkit_tpu_torch.solvers.BlockDiagonalQR`, from either tier:
  XLA (``Q``, ``R``, local pivots) or Pallas (``_a_pad``, ``_r_soa``).  The
  Pallas tier pads its SoA batch axis to 1024/4096 lanes with identity
  blocks; the port does not pad, so those columns are dropped here.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .containers import BlockDiagonal
from .solvers.block_diagonal import BlockDiagonalQR, QFormat
from .sparse import Permutation

__all__ = ["block_diagonal_from_numpy", "block_diagonal_qr_from_numpy"]


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
    row_perm = state.get("row_perm")
    qr._row_perm = Permutation(np.asarray(row_perm)) if row_perm is not None else None

    def tensor(x):  # a private, writable copy of the (possibly read-only) array
        return torch.as_tensor(np.array(x), device=device, dtype=dtype)

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
            torch.as_tensor(np.array(state["local_perm"]), dtype=torch.int64, device=device)
            if pivot
            else None
        )
    qr._computed = True
    qr._set_success()
    return qr
