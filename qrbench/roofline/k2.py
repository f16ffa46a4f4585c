"""K2, the blocked banded back-substitution (``ops/banded.py`` →
``chain_apply.cu``): ``R x = y`` over a banded chain on ``columns``
columns."""


def cost(steps: int, block_cols: int, unknowns: int, columns: int, itemsize: int = 4):
    """(bytes, operations) of one back-substitution: each step's ``block_cols
    × block_cols`` R panel and 25 bytes of index words read, ``y
    [unknowns, columns]`` read and ``x`` written; per step and column the
    overlap product and the triangular solve of its ``block_cols`` rows."""
    c = block_cols
    nbytes = itemsize * (steps * c * c + 2 * unknowns * columns) + steps * (3 * 8 + 1)
    return nbytes, steps * (2 * c * c + c * c) * columns
