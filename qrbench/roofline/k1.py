"""K1, the two-segment compact-WY chain apply (``ops/compact_wy.py`` →
``chain_apply.cu``): Qᵀ of a banded chain on ``columns`` columns."""


def cost(steps: int, block_rows: int, block_cols: int, rows: int, columns: int,
         itemsize: int = 4):
    """(bytes, operations) of Qᵀ over a chain of ``steps`` blocks: each
    step's reflectors, a ``(block_rows + block_cols) × block_cols`` panel
    (the block's rows below the rows it carries), and its ``block_cols ×
    block_cols`` T factor read, three 8-byte index words a step, the
    operand ``[rows, columns]`` read and written; per step and column Yᵀw,
    T'u and Yz."""
    a, c = block_rows + block_cols, block_cols
    nbytes = itemsize * (steps * a * c + steps * c * c + 2 * rows * columns) + 3 * 8 * steps
    return nbytes, steps * (4 * a * c + 2 * c * c) * columns
