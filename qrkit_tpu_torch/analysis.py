"""Host-side structure analysis: orderings + block detection (NumPy only).

Counterpart of ``qrkit_tpu/analysis.py`` (``column_density``,
``as_banded_as_possible``, ``block_banded_info``,
``from_block_diagonal_pattern``, ``from_block_banded_pattern``).  Pure pattern work over CSR index arrays,
with the optional native C++ engine (:mod:`qrkit_tpu_torch._native`); it
produces the same :class:`~qrkit_tpu_torch.plan.StructurePlan` as the
reference package on the same input.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import _native
from .plan import BlockInfo, StructurePlan
from .sparse import Permutation, SparseCSR

__all__ = [
    "column_density",
    "as_banded_as_possible",
    "block_banded_info",
    "from_block_diagonal_pattern",
    "from_block_banded_pattern",
]


def column_density(mat: SparseCSR) -> Permutation:
    """Column permutation sorting columns by ascending nonzero count (stable):
    ``mat * P`` has its densest columns last."""
    return Permutation(np.argsort(mat.col_nnz(), kind="stable"))


def as_banded_as_possible(mat: SparseCSR) -> Tuple[Permutation, bool]:
    """Row permutation stable-sorting rows by their band start column.

    Returns (P, has_permutation); ``mat.permute_rows(P)`` is as-banded-as-possible.
    """
    starts, _ = mat.row_ranges()
    if _native.available():
        indices, has_perm = _native.abap_order(np.ascontiguousarray(starts))
        return Permutation(indices), has_perm
    has_perm = bool(np.any(np.diff(starts) < 0))
    order = np.argsort(starts, kind="stable")  # order[newIdx] = origIdx
    indices = np.empty(mat.nrows, dtype=np.int64)
    indices[order] = np.arange(mat.nrows)
    return Permutation(indices), has_perm


def _merge_blocks(
    blocks: List[BlockInfo], max_col_step: int, suggested_block_cols: int
) -> List[BlockInfo]:
    """Merge candidate blocks into valid portrait panels: each emitted block
    is portrait, at least ``max_col_step`` and ``suggested_block_cols``
    columns wide; blocks column-contained in the previous emitted block are
    folded into it, and a trailing remainder into the last emitted block."""
    new_blocks: List[BlockInfo] = []
    first: Optional[BlockInfo] = None
    curr_rows = curr_cols = 0

    for curr in blocks:
        if new_blocks:
            last = new_blocks[-1]
            if curr.col + curr.ncols <= last.col + last.ncols:
                new_blocks[-1] = BlockInfo(
                    last.row, last.col, last.nrows + curr.nrows, last.ncols
                )
                continue
        if first is None:
            first = curr
            curr_rows, curr_cols = curr.nrows, curr.ncols
        else:
            curr_rows = curr.row + curr.nrows - first.row
            curr_cols = curr.col + curr.ncols - first.col

        if (
            curr_rows > curr_cols
            and curr_cols >= max_col_step
            and curr_cols >= suggested_block_cols
        ):
            new_blocks.append(BlockInfo(first.row, first.col, curr_rows, curr_cols))
            first = None

    if first is not None:
        if (
            curr_rows > curr_cols
            and curr_cols >= max_col_step
            and curr_cols >= suggested_block_cols
        ):
            new_blocks.append(BlockInfo(first.row, first.col, curr_rows, curr_cols))
        elif new_blocks:
            last = new_blocks[-1]
            new_blocks[-1] = BlockInfo(
                last.row,
                last.col,
                last.nrows + curr_rows,
                first.col + curr_cols - last.col,
            )
    return new_blocks


def block_banded_info(mat: SparseCSR, suggested_block_cols: int = 2) -> StructurePlan:
    """Detect the block-banded structure of an (already row-sorted) matrix:
    consecutive runs of rows sharing a band-start column form candidate
    blocks (width = max band width in the run), which are then merged."""
    starts, ends = mat.row_ranges()
    ncols = mat.ncols

    if _native.available():
        blocks_arr, nnz_q = _native.block_detect(
            mat.nrows, ncols, np.ascontiguousarray(starts),
            np.ascontiguousarray(ends), suggested_block_cols,
        )
        blocks = tuple(BlockInfo(*map(int, b)) for b in blocks_arr)
        return StructurePlan(mat.nrows, mat.ncols, blocks, nnz_q)

    widths = ends - starts + 1
    max_col_step = max(int(np.diff(starts).max(initial=0)), 0) if mat.nrows > 1 else 0

    blocks: List[BlockInfo] = []
    nnz_q = 0
    i = 0
    nrows = mat.nrows
    while i < nrows:
        s = int(starts[i])
        if s >= ncols:  # empty row: out of band
            i += 1
            continue
        j = i
        w = 0
        while j < nrows and int(starts[j]) == s:
            w = max(w, int(widths[j]))
            j += 1
        blocks.append(BlockInfo(i, s, j - i, w))
        nnz_q += (j - i) * (j - i)
        i = j

    merged = _merge_blocks(blocks, max_col_step, suggested_block_cols)
    return StructurePlan(mat.nrows, mat.ncols, tuple(merged), nnz_q)


def from_block_diagonal_pattern(
    nrows: int, ncols: int, block_rows: int, block_cols: int
) -> StructurePlan:
    """Known block-diagonal structure: no merging."""
    num_blocks = ncols // block_cols
    blocks = tuple(
        BlockInfo(i * block_rows, i * block_cols, block_rows, block_cols)
        for i in range(num_blocks)
    )
    return StructurePlan(nrows, ncols, blocks, num_blocks * block_rows * block_rows)


def from_block_banded_pattern(
    nrows: int,
    ncols: int,
    block_rows: int,
    block_cols: int,
    block_overlap: int,
    suggested_block_cols: int = 2,
) -> StructurePlan:
    """Known block-banded structure with a fixed overlap.  The pattern must
    tile the matrix: ``ncols == num_blocks * (block_cols - block_overlap)``
    (the last block carries no trailing overlap) and ``nrows >= num_blocks *
    block_rows``; anything else raises (use pattern analysis instead)."""
    max_col_step = block_cols - block_overlap
    num_blocks = ncols // max_col_step
    if ncols % max_col_step != 0 or nrows < num_blocks * block_rows:
        raise ValueError(
            f"static block-banded pattern does not tile a {nrows}x{ncols} "
            f"matrix: need ncols divisible by block_cols-block_overlap="
            f"{max_col_step} and nrows >= num_blocks*block_rows "
            f"({num_blocks}*{block_rows}); run pattern analysis instead"
        )
    blocks = []
    for i in range(num_blocks):
        nc = block_cols if i < num_blocks - 1 else block_cols - block_overlap
        blocks.append(BlockInfo(i * block_rows, i * max_col_step, block_rows, nc))
    merged = _merge_blocks(blocks, max_col_step, suggested_block_cols)
    return StructurePlan(
        nrows, ncols, tuple(merged), num_blocks * block_rows * block_rows
    )
