"""Port host layer (sparse / analysis / plan / native) against qrkit_tpu.

Structure analysis is integer pattern work, so the port must reproduce the
reference package exactly: equal permutation indices, equal block plans,
equal extracted panels — with the native engine and with the NumPy
fallback.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import qrkit_tpu._native as jnative
from qrkit_tpu import analysis as janalysis
from qrkit_tpu import sparse as jsparse
from qrkit_tpu.containers import BlockDiagonal as JBlockDiagonal

import qrkit_tpu_torch._native as tnative
from qrkit_tpu_torch import analysis as tanalysis
from qrkit_tpu_torch import plan as tplan
from qrkit_tpu_torch import sparse as tsparse
from qrkit_tpu_torch.containers import BlockDiagonal

from generators import block_diagonal_matrix, overlapping_block_diagonal_matrix


def _port(m):
    return tsparse.SparseCSR(m.shape, m.indptr, m.indices, m.data)


def _set_native(monkeypatch, native):
    if not native:
        monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_TRIED", True)
        monkeypatch.setattr(tnative, "available", lambda: False)
    elif not (jnative.available() and tnative.available()):
        pytest.skip("native library not built (make -C native)")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("permute_rows", [False, True])
def test_abap_and_block_plan_match(rng, monkeypatch, native, permute_rows):
    _set_native(monkeypatch, native)
    jm = overlapping_block_diagonal_matrix(64, 224, rng, permute_rows=permute_rows)
    tm = _port(jm)
    jp, jh = janalysis.as_banded_as_possible(jm)
    tp, th = tanalysis.as_banded_as_possible(tm)
    assert th == jh
    np.testing.assert_array_equal(tp.indices, jp.indices)
    jplan = janalysis.block_banded_info(jm.permute_rows(jp), 2)
    tplan_ = tanalysis.block_banded_info(tm.permute_rows(tp), 2)
    assert [b.astuple() for b in tplan_.blocks] == [b.astuple() for b in jplan.blocks]
    assert tplan_.nnz_q_estimate == jplan.nnz_q_estimate
    assert tplan_.overlaps() == jplan.overlaps()
    assert tplan_.solved_rows() == jplan.solved_rows()


@pytest.mark.parametrize("native", [True, False])
def test_row_ranges_col_nnz_and_density_match(rng, monkeypatch, native):
    _set_native(monkeypatch, native)
    jm = overlapping_block_diagonal_matrix(40, 140, rng, permute_rows=True)
    tm = _port(jm)
    for got, want in zip(tm.row_ranges(), jm.row_ranges()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.col_nnz(), jm.col_nnz())
    np.testing.assert_array_equal(
        tanalysis.column_density(tm).indices, janalysis.column_density(jm).indices
    )


@pytest.mark.parametrize("native", [True, False])
def test_permute_rows_and_blocks_dense_match(rng, monkeypatch, native):
    _set_native(monkeypatch, native)
    jm = overlapping_block_diagonal_matrix(40, 140, rng, permute_rows=False)
    tm = _port(jm)
    perm = rng.permutation(jm.nrows)
    np.testing.assert_array_equal(
        tm.permute_rows(tsparse.Permutation(perm)).to_dense(),
        jm.permute_rows(jsparse.Permutation(perm)).to_dense(),
    )
    blocks = [(0, 0, 9, 4), (7, 2, 9, 4), (120, 34, 14, 6)]
    np.testing.assert_array_equal(tm.blocks_dense(blocks, 14, 6), jm.blocks_dense(blocks, 14, 6))


def test_from_block_diagonal_pattern_plan_matches():
    jplan = janalysis.from_block_diagonal_pattern(77, 22, 7, 2)
    tplan_ = tanalysis.from_block_diagonal_pattern(77, 22, 7, 2)
    assert [b.astuple() for b in tplan_.blocks] == [b.astuple() for b in jplan.blocks]
    assert tplan_.nnz_q_estimate == jplan.nnz_q_estimate
    assert tplan_.is_uniform() and tplan_.num_blocks == 11
    assert tplan_.max_block_rows == 7 and tplan_.max_block_cols == 2
    for got, want in zip(tplan_.as_arrays(), jplan.as_arrays()):
        np.testing.assert_array_equal(got, want)
    assert isinstance(tplan_, tplan.StructurePlan)


def test_permutation_conventions_match(rng):
    """Eigen conventions: P*v scatters rows, A*P gathers columns."""
    idx = rng.permutation(9)
    other = rng.permutation(9)
    P, JP = tsparse.Permutation(idx), jsparse.Permutation(idx)
    v = rng.normal(size=(9, 3))
    np.testing.assert_array_equal(P.apply(v), JP.apply(v))
    np.testing.assert_array_equal(P.apply_inverse(v), JP.apply_inverse(v))
    np.testing.assert_array_equal(P.permute_cols(v.T), JP.permute_cols(v.T))
    np.testing.assert_array_equal(P.inverse().indices, JP.inverse().indices)
    np.testing.assert_array_equal(P.gather_indices(), JP.gather_indices())
    np.testing.assert_array_equal(
        P.then(tsparse.Permutation(other)).indices, JP.then(jsparse.Permutation(other)).indices
    )
    np.testing.assert_array_equal(P.inverse().apply(P.apply(v)), v)
    assert tsparse.Permutation.identity(4).is_identity() and not P.is_identity()


def test_triplets_dense_scipy_roundtrip_match(rng):
    rows = rng.integers(0, 12, size=60)
    cols = rng.integers(0, 9, size=60)  # duplicates are summed
    vals = rng.normal(size=60)
    tm = tsparse.SparseCSR.from_triplets(rows, cols, vals, (12, 9))
    jm = jsparse.SparseCSR.from_triplets(rows, cols, vals, (12, 9))
    np.testing.assert_array_equal(tm.indptr, jm.indptr)
    np.testing.assert_array_equal(tm.indices, jm.indices)
    np.testing.assert_array_equal(tm.data, jm.data)
    assert (tm.nnz, tm.nrows, tm.ncols) == (jm.nnz, jm.nrows, jm.ncols)
    dense = jm.to_dense()
    np.testing.assert_array_equal(tm.to_dense(), dense)
    np.testing.assert_array_equal(tsparse.SparseCSR.from_dense(dense).to_dense(), dense)
    s = sp.csr_matrix(dense)
    np.testing.assert_array_equal(tsparse.SparseCSR.from_scipy(s).to_dense(), dense)
    x = rng.normal(size=9)
    np.testing.assert_allclose(tm.matvec(x), dense @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("permute_rows", [False, True])
def test_block_diagonal_from_sparse_matrix_matches(rng, permute_rows):
    jm = block_diagonal_matrix(20, 70, rng, permute_rows=permute_rows)
    jblk, jperm = JBlockDiagonal.from_sparse_matrix(jm, 2)
    tblk, tperm = BlockDiagonal.from_sparse_matrix(_port(jm), 2)
    np.testing.assert_array_equal(tperm.indices, jperm.indices)
    np.testing.assert_array_equal(tblk.blocks.numpy(), np.asarray(jblk.blocks))
    np.testing.assert_array_equal(tblk.to_dense(), jblk.to_dense())
    assert tblk.shape == jblk.shape


def test_block_diagonal_from_pattern_matches(rng):
    jm = block_diagonal_matrix(16, 56, rng, permute_rows=False)
    jblk = JBlockDiagonal.from_block_diagonal_pattern(jm, 7, 2)
    tblk = BlockDiagonal.from_block_diagonal_pattern(_port(jm), 7, 2)
    np.testing.assert_array_equal(tblk.blocks.numpy(), np.asarray(jblk.blocks))
    assert (tblk.num_blocks, tblk.block_rows, tblk.block_cols) == (8, 7, 2)
