"""Block-diagonal and block-angular containers on torch tensors.

Counterpart of ``qrkit_tpu/containers.py`` (``BlockDiagonal``, the
reference's ``SparseBlockDiagonal``, and ``BlockMatrix1x2``).  One uniform block shape, stored
either as the AoS batch ``[nb, br, bc]`` or as the SoA form ``[br*bc, nb]``
(entry (r, c) of block i at ``[r*bc + c, i]``), the block index contiguous:
on the GPU that is the coalesced layout, one block per thread, and the form
the CUDA kernels read.  Either form materializes the other lazily through
:attr:`blocks` / :meth:`soa`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from . import _device
from .analysis import as_banded_as_possible, block_banded_info
from .ops.blockdiag import to_aos, to_soa
from .sparse import Permutation, SparseCSR

__all__ = ["BlockDiagonal", "BlockMatrix1x2"]


class BlockDiagonal:
    """Uniform block-diagonal matrix as a stacked dense batch.

    ``blocks[i]`` sits at rows ``i*br``, cols ``i*bc`` of the logical matrix;
    ``nrows/ncols`` may exceed ``nb*br`` / ``nb*bc`` (zero tail rows and
    columns).  Build it with :meth:`from_soa`, :meth:`from_dense_batch`,
    :meth:`from_block_diagonal_pattern` or :meth:`from_sparse_matrix`, or
    directly from an AoS tensor.
    """

    def __init__(
        self,
        blocks: Optional[torch.Tensor],
        nrows: int,
        ncols: int,
        blocks_soa: Optional[torch.Tensor] = None,
        block_rows: Optional[int] = None,
        block_cols: Optional[int] = None,
    ):
        if blocks is None and blocks_soa is None:
            raise ValueError("BlockDiagonal needs AoS or SoA block storage")
        self._blocks = blocks
        self._blocks_soa = blocks_soa
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self._br = block_rows
        self._bc = block_cols
        self._aos_cache = None
        self._soa_cache = None

    @classmethod
    def from_soa(
        cls,
        blocks_soa,
        block_rows: int,
        block_cols: int,
        nrows: Optional[int] = None,
        ncols: Optional[int] = None,
        *,
        device=None,
        dtype=None,
    ) -> "BlockDiagonal":
        """Wrap SoA block storage ``[br*bc, nb]`` (entry (r, c) of block i at
        ``[r*bc + c, i]``) — the layout the CUDA kernels consume without
        relayout."""
        soa = _device.as_tensor(blocks_soa, device, dtype)
        ebc, nb = soa.shape
        if ebc != block_rows * block_cols:
            raise ValueError(
                f"SoA row count {ebc} != block_rows*block_cols "
                f"{block_rows * block_cols}"
            )
        return cls(
            None,
            nrows if nrows is not None else nb * block_rows,
            ncols if ncols is not None else nb * block_cols,
            soa.contiguous(),
            block_rows,
            block_cols,
        )

    @property
    def blocks(self) -> torch.Tensor:
        """AoS batch [nb, br, bc] (materialized lazily from SoA storage)."""
        if self._blocks is not None:
            return self._blocks
        if self._aos_cache is None:
            self._aos_cache = to_aos(self._blocks_soa, self._br, self._bc)
        return self._aos_cache

    def soa(self) -> torch.Tensor:
        """Contiguous SoA storage [br*bc, nb] (materialized lazily from AoS)."""
        if self._blocks_soa is not None:
            return self._blocks_soa
        if self._soa_cache is None:
            self._soa_cache = to_soa(self._blocks)
        return self._soa_cache

    @property
    def is_soa(self) -> bool:
        return self._blocks_soa is not None

    @property
    def num_blocks(self) -> int:
        if self._blocks is not None:
            return self._blocks.shape[0]
        return self._blocks_soa.shape[1]

    @property
    def block_rows(self) -> int:
        return self._blocks.shape[1] if self._blocks is not None else self._br

    @property
    def block_cols(self) -> int:
        return self._blocks.shape[2] if self._blocks is not None else self._bc

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def device(self) -> torch.device:
        return (self._blocks if self._blocks is not None else self._blocks_soa).device

    @property
    def dtype(self) -> torch.dtype:
        return (self._blocks if self._blocks is not None else self._blocks_soa).dtype

    # --- constructors -------------------------------------------------------------
    @staticmethod
    def from_block_diagonal_pattern(
        mat: SparseCSR, block_rows: int, block_cols: int, *, device=None, dtype=None
    ) -> "BlockDiagonal":
        """Split an already-block-diagonal sparse matrix into the dense batch
        (host extraction, one copy to ``device``)."""
        nb = mat.ncols // block_cols
        blocks = mat.blocks_dense(
            [(i * block_rows, i * block_cols, block_rows, block_cols) for i in range(nb)],
            block_rows,
            block_cols,
        )
        return BlockDiagonal(
            _device.as_tensor(blocks, device, dtype), mat.nrows, mat.ncols
        )

    @staticmethod
    def from_sparse_matrix(
        mat: SparseCSR, suggested_block_cols: int = 3, *, device=None, dtype=None
    ) -> Tuple["BlockDiagonal", Permutation]:
        """Detect block structure in a general sparse matrix (as-banded-as-
        possible row sort + block detection) and return the container plus
        the row permutation that was applied."""
        perm, has_perm = as_banded_as_possible(mat)
        sorted_mat = mat.permute_rows(perm) if has_perm else mat
        plan = block_banded_info(sorted_mat, suggested_block_cols)
        if plan.num_blocks == 0:
            raise ValueError("no block structure detected in the matrix")
        br = plan.max_block_rows
        bc = plan.max_block_cols
        # the dense batch assumes block i at (i*br, i*bc) with one shape
        for i, b in enumerate(plan.blocks):
            if (b.nrows, b.ncols, b.row, b.col) != (br, bc, i * br, i * bc):
                raise ValueError(
                    "detected plan is not a uniform block diagonal at "
                    f"(i*{br}, i*{bc}) (block {i} at ({b.row}, {b.col}) is "
                    f"{b.nrows}x{b.ncols})"
                )
        blocks = sorted_mat.blocks_dense([b.astuple() for b in plan.blocks], br, bc)
        mat_out = BlockDiagonal(
            _device.as_tensor(blocks, device, dtype), mat.nrows, mat.ncols
        )
        return mat_out, perm

    @staticmethod
    def from_dense_batch(
        blocks, nrows: Optional[int] = None, ncols: Optional[int] = None, *,
        device=None, dtype=None,
    ) -> "BlockDiagonal":
        blocks = _device.as_tensor(blocks, device, dtype)
        nb, br, bc = blocks.shape
        return BlockDiagonal(blocks, nrows or nb * br, ncols or nb * bc)

    def to_dense(self) -> np.ndarray:
        """Dense host copy [nrows, ncols] (tests and interop)."""
        b = self.blocks.detach().cpu().numpy()
        out = np.zeros(self.shape, dtype=b.dtype)
        br, bc = self.block_rows, self.block_cols
        for i in range(self.num_blocks):
            out[i * br : (i + 1) * br, i * bc : (i + 1) * bc] = b[i]
        return out


@dataclasses.dataclass
class BlockMatrix1x2:
    """``[Left | Right]`` composite with heterogeneous halves.

    ``left`` is a :class:`BlockDiagonal`, a host :class:`SparseCSR` or a
    dense tensor; ``right`` is dense (``[m, m2]``) or a host
    :class:`SparseCSR`.  The halves share a row count.

    ``right_t=True`` marks a dense right block stored transposed
    (``[m2, m]``, the m2 angular columns as rows): with the point axis
    contiguous it is the layout the lane-major fused solver path reads with
    coalesced loads, and no relayout is needed.
    """

    left: Any
    right: Any
    right_t: bool = False

    def __post_init__(self):
        if self.left_rows != self.right_rows:
            raise ValueError(
                f"row counts must match: left {self.left_rows}, right {self.right_rows}"
            )

    @staticmethod
    def _rows(block) -> int:
        if isinstance(block, (BlockDiagonal, SparseCSR)):
            return block.nrows
        return int(block.shape[0])

    @staticmethod
    def _cols(block) -> int:
        if isinstance(block, (BlockDiagonal, SparseCSR)):
            return block.ncols
        return int(block.shape[1])

    @property
    def left_rows(self) -> int:
        return self._rows(self.left)

    @property
    def right_rows(self) -> int:
        if self.right_t:
            return int(self.right.shape[1])
        return self._rows(self.right)

    @property
    def left_cols(self) -> int:
        return self._cols(self.left)

    @property
    def right_cols(self) -> int:
        if self.right_t:
            return int(self.right.shape[0])
        return self._cols(self.right)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.left_rows, self.left_cols + self.right_cols)
