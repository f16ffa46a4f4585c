"""Plain least-squares solve of a sparse system by its normal equations.

``AᵀA`` is gathered from every row's outer product, ``Aᵀb`` likewise, and
``AᵀA x = Aᵀb`` is solved by a dense Cholesky factorization.  For the
block-banded configuration (a condition number near 10) the float64
normal equations lose about 1e-14 of relative accuracy: far below the
float32 QR under test.  The route shares nothing with the program's
banded QR.

``precision="float64"`` is the reference.  ``"tf32"`` is the control: every
product of ``AᵀA`` and ``Aᵀb`` takes its operands rounded to TF32's 10-bit
mantissa and adds in float32, as a tensor core does in TF32 mode, and the
Cholesky factorization and solve run in float32 with TF32 allowed.
"""
from __future__ import annotations

import numpy as np
import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest value with a 10-bit mantissa."""
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class NormalEquations:
    """The Cholesky factor of ``AᵀA`` for one value set; :meth:`solve`
    takes any right-hand side of the same rows.

    ``rows``, ``cols``: the stored entries' coordinates (host arrays);
    ``values``: their values (a tensor on the device to work on)."""

    def __init__(self, rows, cols, shape, values: torch.Tensor, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision must be 'float64' or 'tf32', got {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        dev = values.device
        m, n = shape
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        counts = np.bincount(rows, minlength=m)
        width = int(counts.max())
        # each row's entries in slots 0..count-1 of a [m, width] table; the
        # empty slots hold the value 0 at column 0
        order = np.lexsort((cols, rows))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(rows.size) - starts[rows[order]]
        col_tab = np.zeros((m, width), dtype=np.int64)
        col_tab[rows[order], slot] = cols[order]
        self.shape, self.width = (m, n), width
        self.cols = torch.as_tensor(col_tab, device=dev)
        self.pos = torch.as_tensor(rows[order] * width + slot, device=dev)
        self.order = torch.as_tensor(order, device=dev)
        vt = torch.zeros(m * width, dtype=self.dtype, device=dev)
        vt[self.pos] = self._operand(values.to(self.dtype)[self.order])
        self.vals = vt.reshape(m, width)
        outer = self.vals[:, :, None] * self.vals[:, None, :]
        gram = torch.zeros(n * n, dtype=self.dtype, device=dev)
        idx = self.cols[:, :, None] * n + self.cols[:, None, :]
        gram.index_add_(0, idx.reshape(-1), outer.reshape(-1))
        with _tf32(precision == "tf32"):
            self.chol = torch.linalg.cholesky(gram.reshape(n, n))

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        return tf32_round(t) if self.precision == "tf32" else t

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """The least-squares solution for ``b [m]`` or ``[m, k]``, float64."""
        m, n = self.shape
        bb = self._operand(b.to(self.dtype)).reshape(m, 1, -1)
        prod = self.vals[:, :, None] * bb                         # [m, width, k]
        atb = torch.zeros((n, prod.shape[-1]), dtype=self.dtype, device=b.device)
        atb.index_add_(0, self.cols.reshape(-1), prod.reshape(m * self.width, -1))
        with _tf32(self.precision == "tf32"):
            x = torch.cholesky_solve(atb, self.chol)
        x = x.to(torch.float64)
        return x[:, 0] if b.dim() == 1 else x


class _tf32:
    """Allow TF32 in matmuls and cuDNN within the block (restored after)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
