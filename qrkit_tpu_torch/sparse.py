"""Host-side sparse-matrix container and permutations (NumPy only).

Counterpart of ``qrkit_tpu/sparse.py`` (``Permutation``, ``coo_to_csr``,
``SparseCSR`` and the MatrixMarket reader and writer).  These are
structure-plane objects: they live on the host, feed the structure analysis
in :mod:`qrkit_tpu_torch.analysis`, and never touch the device.  The port
keeps its own copy instead of importing ``qrkit_tpu.sparse`` because that
import runs ``qrkit_tpu/__init__.py``, which imports jax.

Conventions follow Eigen, exactly as in the reference package:

* ``Permutation.indices[src] = dest`` — ``P @ v`` scatters ``v[i]`` to ``dest``.
* ``A @ P`` gathers columns: new column ``i`` = old column ``indices[i]``.

The banded solvers also use the pattern-only maps (``row_perm_data_map``,
``panels_gather_map``) and the layout token ``pattern_fingerprint``.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Tuple

import numpy as np

from . import _native

__all__ = ["Permutation", "SparseCSR", "coo_to_csr", "load_matrix_market", "save_matrix_market"]

# stored-nonzero layouts seen by pattern_fingerprint: (weak indices, weak
# indptr, token), most recent last
_LAYOUT_REGISTRY = []
_LAYOUT_MAX = 8
_layout_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class Permutation:
    """Eigen-style permutation: ``indices[src] = dest``.

    ``apply(v) == P * v`` (Eigen semantics, scatter), and ``inverse().apply``
    undoes it.  ``permute_cols(M) == M * P`` (gather columns).
    """

    indices: np.ndarray  # int array, indices[src] = dest

    def __post_init__(self):
        object.__setattr__(self, "indices", np.asarray(self.indices, dtype=np.int64))

    @staticmethod
    def identity(n: int) -> "Permutation":
        return Permutation(np.arange(n, dtype=np.int64))

    @property
    def size(self) -> int:
        return int(self.indices.shape[0])

    def is_identity(self) -> bool:
        return bool(np.all(self.indices == np.arange(self.size)))

    def inverse(self) -> "Permutation":
        inv = np.empty_like(self.indices)
        inv[self.indices] = np.arange(self.size)
        return Permutation(inv)

    def apply(self, v: np.ndarray) -> np.ndarray:
        """P * v : out[indices[i]] = v[i] (rows scattered)."""
        out = np.empty_like(v)
        out[self.indices, ...] = v
        return out

    def apply_inverse(self, v: np.ndarray) -> np.ndarray:
        """P^-1 * v : out[i] = v[indices[i]]."""
        return v[self.indices, ...]

    def permute_rows(self, m: np.ndarray) -> np.ndarray:
        return self.apply(m)

    def permute_cols(self, m: np.ndarray) -> np.ndarray:
        """M * P : out[:, i] = M[:, indices[i]]."""
        return m[..., self.indices]

    def then(self, other: "Permutation") -> "Permutation":
        """Permutation equivalent to applying ``self`` first, then ``other``."""
        return Permutation(other.indices[self.indices])

    def gather_indices(self) -> np.ndarray:
        """``src_of_dest`` array g with ``(P*v)[j] == v[g[j]]``."""
        return self.inverse().indices


def coo_to_csr(rows, cols, vals, shape) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build CSR arrays from COO triplets, summing duplicates (Eigen setFromTriplets)."""
    nrows, _ = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        key_same = np.zeros(rows.size, dtype=bool)
        key_same[1:] = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        group = np.cumsum(~key_same) - 1
        ur = np.empty(group[-1] + 1, dtype=np.int64)
        uc = np.empty_like(ur)
        uv = np.zeros(ur.shape, dtype=vals.dtype)
        ur[group] = rows
        uc[group] = cols
        np.add.at(uv, group, vals)
        rows, cols, vals = ur, uc, uv
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, cols, vals


class SparseCSR:
    """Minimal host-side CSR matrix (float64 by default): triplet
    construction, row permutation, block extraction to dense panels, and
    dense conversion for tests."""

    def __init__(self, shape, indptr, indices, data):
        self.shape = (int(shape[0]), int(shape[1]))
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.data = np.asarray(data)

    # --- constructors ---------------------------------------------------------------
    @staticmethod
    def from_triplets(rows, cols, vals, shape) -> "SparseCSR":
        indptr, indices, data = coo_to_csr(rows, cols, vals, shape)
        return SparseCSR(shape, indptr, indices, data)

    @staticmethod
    def from_dense(m: np.ndarray, tol: float = 0.0) -> "SparseCSR":
        rows, cols = np.nonzero(np.abs(m) > tol)
        return SparseCSR.from_triplets(rows, cols, m[rows, cols], m.shape)

    @staticmethod
    def from_scipy(m) -> "SparseCSR":
        """Build from any ``scipy.sparse`` matrix in canonical CSR form
        (sorted column indices, summed duplicates).  The input is never
        mutated and the result shares no buffers with it."""
        csr = m.tocsr()
        if csr is m:
            csr = csr.copy()
        csr.sum_duplicates()
        csr.sort_indices()
        return SparseCSR(csr.shape, csr.indptr, csr.indices, np.array(csr.data))

    def to_scipy(self):
        """The matrix as ``scipy.sparse.csr_matrix``; the values are copied
        (scipy copies the index arrays on construction anyway)."""
        import scipy.sparse as sp

        return sp.csr_matrix((self.data.copy(), self.indices, self.indptr), shape=self.shape)

    # --- basic properties -----------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype if self.nnz else np.float64)
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        out[row_ids, self.indices] = self.data
        return out

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def col_nnz(self) -> np.ndarray:
        if _native.available():
            return _native.col_nnz(self.indices, self.ncols)
        counts = np.zeros(self.ncols, dtype=np.int64)
        np.add.at(counts, self.indices, 1)
        return counts

    def row_ranges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(start, end) column index of first/last nonzero per row; empty
        rows get ``start = end = ncols`` (out of band)."""
        if _native.available():
            return _native.row_ranges(self.nrows, self.ncols, self.indptr, self.indices)
        starts = np.full(self.nrows, self.ncols, dtype=np.int64)
        ends = np.full(self.nrows, self.ncols, dtype=np.int64)
        nonempty = np.diff(self.indptr) > 0
        starts[nonempty] = self.indices[self.indptr[:-1][nonempty]]
        ends[nonempty] = self.indices[self.indptr[1:][nonempty] - 1]
        return starts, ends

    def matvec(self, v: np.ndarray) -> np.ndarray:
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        out = np.zeros(self.nrows, dtype=np.result_type(self.data, v))
        np.add.at(out, row_ids, self.data * v[self.indices])
        return out

    # --- permutation / slicing ------------------------------------------------------
    def permute_rows(self, perm: Permutation) -> "SparseCSR":
        """P * A — row src goes to row perm.indices[src]."""
        src_of_dest = perm.gather_indices()
        if _native.available() and self.data.dtype == np.float64:
            ip, ix, d = _native.permute_rows_csr(
                self.nrows, self.indptr, self.indices, self.data, src_of_dest
            )
            return SparseCSR(self.shape, ip, ix, d)
        counts = np.diff(self.indptr)[src_of_dest]
        new_indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        new_indptr[1:] = np.cumsum(counts)
        old_starts = self.indptr[:-1][src_of_dest]
        pos = np.arange(self.nnz) - np.repeat(new_indptr[:-1], counts)
        gather = np.repeat(old_starts, counts) + pos
        return SparseCSR(self.shape, new_indptr, self.indices[gather], self.data[gather])

    def row_perm_data_map(self, perm: Permutation) -> np.ndarray:
        """Pattern-only data gather for :meth:`permute_rows`:
        ``permute_rows(perm).data == self.data[map]``.  Lets a solver reorder
        a value vector on the device (``factorize_values``) without
        rebuilding the permuted matrix on the host."""
        src_of_dest = perm.gather_indices()
        counts = np.diff(self.indptr)[src_of_dest]
        new_indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        new_indptr[1:] = np.cumsum(counts)
        old_starts = self.indptr[:-1][src_of_dest]
        pos = np.arange(self.nnz) - np.repeat(new_indptr[:-1], counts)
        return np.repeat(old_starts, counts) + pos

    def permute_cols(self, perm: Permutation) -> "SparseCSR":
        """A * P — new column i = old column perm.indices[i] (per-row reorder)."""
        inv = perm.inverse().indices  # old col -> new col
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        return SparseCSR.from_triplets(row_ids, inv[self.indices], self.data, self.shape)

    def hstack_dense_block(self, c0: int, nc: int) -> np.ndarray:
        """Dense copy of columns [c0, c0+nc) over every row."""
        return self.block_dense(0, c0, self.nrows, nc)

    def slice_cols(self, c0: int, nc: int) -> "SparseCSR":
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        sel = (self.indices >= c0) & (self.indices < c0 + nc)
        return SparseCSR.from_triplets(
            row_ids[sel], self.indices[sel] - c0, self.data[sel], (self.nrows, nc)
        )

    def slice_rows(self, r0: int, nr: int) -> "SparseCSR":
        lo, hi = self.indptr[r0], self.indptr[r0 + nr]
        indptr = self.indptr[r0 : r0 + nr + 1] - self.indptr[r0]
        return SparseCSR((nr, self.ncols), indptr, self.indices[lo:hi], self.data[lo:hi])

    def block_dense(self, r0: int, c0: int, nr: int, nc: int) -> np.ndarray:
        """Dense copy of the block [r0:r0+nr, c0:c0+nc]."""
        out = np.zeros((nr, nc), dtype=self.data.dtype if self.nnz else np.float64)
        for i in range(nr):
            lo, hi = self.indptr[r0 + i], self.indptr[r0 + i + 1]
            cols = self.indices[lo:hi]
            sel = (cols >= c0) & (cols < c0 + nc)
            out[i, cols[sel] - c0] = self.data[lo:hi][sel]
        return out

    def blocks_dense(self, blocks, pad_rows: int, pad_cols: int) -> np.ndarray:
        """Stacked dense panels [nb, pad_rows, pad_cols] for a list of
        (row, col, nrows, ncols) tuples; panels zero-padded to uniform shape."""
        nb = len(blocks)
        if _native.available() and nb and (self.nnz == 0 or self.data.dtype == np.float64):
            return _native.extract_panels(
                self.nrows, self.ncols, self.indptr, self.indices,
                self.data.astype(np.float64, copy=False),
                np.asarray([tuple(b) for b in blocks], dtype=np.int64),
                pad_rows, pad_cols,
            )
        out = np.zeros((nb, pad_rows, pad_cols), dtype=self.data.dtype if self.nnz else np.float64)
        for k, (r0, c0, nr, nc) in enumerate(blocks):
            out[k, :nr, :nc] = self.block_dense(r0, c0, nr, nc)
        return out

    def panels_gather_map(self, blocks, pad_rows: int, pad_cols: int) -> np.ndarray:
        """Pattern-only index map for panel extraction on the device:
        ``[nb, pad_rows, pad_cols]`` with ``map[k, r, c]`` the index into
        ``self.data`` of panel entry (r, c) of block k, or ``nnz`` (the
        sentinel) for a structural zero, so that
        ``concat([data, [0]])[map] == blocks_dense(blocks, ...)``.  int32
        whenever the sentinel fits.  The blocks' row ranges must be pairwise
        disjoint (true of every banded and segment plan); entries outside
        their row block's column span are dropped, as in
        :meth:`blocks_dense`."""
        nnz = self.nnz
        dtype = np.int32 if nnz + 1 < 2**31 else np.int64
        gm = np.full((len(blocks), pad_rows, pad_cols), nnz, dtype=dtype)
        if not len(blocks) or nnz == 0:
            return gm
        binfo = np.asarray([tuple(b) for b in blocks], dtype=np.int64)
        r0, c0, nr, nc = binfo.T
        live = np.nonzero(nr > 0)[0]
        order = live[np.argsort(r0[live], kind="stable")]
        starts = r0[order]
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        pos = np.searchsorted(starts, row_ids, side="right") - 1
        has_blk = pos >= 0
        b = order[np.clip(pos, 0, None)]
        lr = row_ids - r0[b]
        lc = self.indices - c0[b]
        good = (
            has_blk
            & (lr < nr[b]) & (lr < pad_rows)
            & (lc >= 0) & (lc < nc[b]) & (lc < pad_cols)
        )
        gm[b[good], lr[good], lc[good]] = np.nonzero(good)[0]
        return gm

    def pattern_fingerprint(self):
        """Exact token of the stored-nonzero layout (``indptr`` and
        ``indices``).  Anything keyed on data positions (the device gather
        maps) must be rebuilt when the layout changes, not only when the
        plan does.  Layouts are interned in a small registry, by object
        identity first and exact array equality second: equal layouts get
        equal tokens, distinct layouts distinct ones.  Mutating a
        fingerprinted ``indices``/``indptr`` array in place is not
        detected."""
        memo = self.__dict__.get("_fp_memo")
        if memo is not None:
            return memo
        ind, ptr = self.indices, self.indptr
        token = None
        live = []
        for wind, wptr, tok in _LAYOUT_REGISTRY:
            i2, p2 = wind(), wptr()
            if i2 is None or p2 is None:
                continue
            live.append((wind, wptr, tok))
            if token is None and (
                (i2 is ind and p2 is ptr)
                or (
                    i2.shape == ind.shape
                    and p2.shape == ptr.shape
                    and np.array_equal(p2, ptr)
                    and np.array_equal(i2, ind)
                )
            ):
                token = tok
        if token is None:
            token = (self.nnz, next(_layout_counter))
        live.append((weakref.ref(ind), weakref.ref(ptr), token))
        _LAYOUT_REGISTRY[:] = live[-_LAYOUT_MAX:]
        self._fp_memo = token
        return token


def load_matrix_market(path: str) -> SparseCSR:
    """Read a MatrixMarket coordinate file (``general`` or ``symmetric``,
    ``real``/``integer`` or ``pattern``), summing duplicate entries."""
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file")
        parts = header.split()
        symmetric = "symmetric" in parts
        pattern = "pattern" in parts
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(v) for v in line.split())
        data = np.loadtxt(f, max_rows=nnz, ndmin=2) if nnz else np.zeros((0, 3))
        rows = data[:, 0].astype(np.int64) - 1
        cols = data[:, 1].astype(np.int64) - 1
        vals = np.ones(nnz, dtype=np.float64) if pattern else data[:, 2].astype(np.float64)
    if symmetric:
        off = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    return SparseCSR.from_triplets(rows, cols, vals, (nrows, ncols))


def save_matrix_market(path: str, mat: SparseCSR):
    """Write a MatrixMarket coordinate file (``real general``, values to 17
    significant digits, so a float64 round trip is exact)."""
    row_ids = np.repeat(np.arange(mat.nrows), np.diff(mat.indptr))
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{mat.nrows} {mat.ncols} {mat.nnz}\n")
        if mat.nnz:
            np.savetxt(
                f,
                np.rec.fromarrays(
                    [row_ids + 1, mat.indices + 1, mat.data.astype(np.float64)],
                    names="r,c,v",
                ),
                fmt="%d %d %.17g",
            )
