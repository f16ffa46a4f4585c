"""The port's block-angular solver stack against qrkit_tpu, fp64.

``BlockMatrix1x2``, the dense solvers, the single-device TSQR and
``BlockAngularQR`` on its fused dense, fused lane-major (SoA), generic,
sparse-A2 and banded-left paths, plus the state converters.  The same
NumPy inputs go through both packages; factors, pivot orders, Q products,
R and solutions agree to rtol 1e-10 (atol 1e-10 where entries cancel to
roundoff), pivot orders exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import qrkit_tpu as jq
from qrkit_tpu.parallel import tsqr as jtsqr
from qrkit_tpu.solvers.block_diagonal import QFormat as JQFormat

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import convert
from qrkit_tpu_torch.parallel import TSQRDenseQR, tsqr_apply, tsqr_factorize
from qrkit_tpu_torch.solvers.block_angular import _RowSubsetQR

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

TOL = dict(rtol=1e-10, atol=1e-10)


def close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), **(tol or TOL),
    )


def _port_csr(m):
    return qt.SparseCSR(m.shape, m.indptr, m.indices, m.data)


# --- containers ---------------------------------------------------------------------
def test_block_matrix_1x2_shapes(rng):
    blocks = rng.normal(size=(6, 3, 2))
    a2 = rng.normal(size=(20, 4))
    for right_t in (False, True):
        r = a2.T.copy() if right_t else a2
        tm = qt.BlockMatrix1x2(qt.BlockDiagonal(torch.as_tensor(blocks), 20, 12), torch.as_tensor(r),
                               right_t=right_t)
        jm = jq.BlockMatrix1x2(jq.BlockDiagonal(jnp.asarray(blocks), 20, 12), jnp.asarray(r),
                               right_t=right_t)
        got = (tm.shape, tm.left_rows, tm.left_cols, tm.right_rows, tm.right_cols)
        assert got == (jm.shape, jm.left_rows, jm.left_cols, jm.right_rows, jm.right_cols)
        assert got == ((20, 16), 20, 12, 20, 4)
    sp = qt.SparseCSR.from_dense(rng.normal(size=(20, 12)))
    assert qt.BlockMatrix1x2(sp, qt.SparseCSR.from_dense(a2)).shape == (20, 16)
    with pytest.raises(ValueError, match="row counts"):
        qt.BlockMatrix1x2(sp, torch.as_tensor(a2[:19]))


# --- dense solvers --------------------------------------------------------------------
def _dense_case(rng, case):
    if case == "tall":
        return rng.normal(size=(40, 7))
    if case == "rank_deficient":
        a = rng.normal(size=(30, 6))
        a[:, 4] = a[:, 1] - 2.0 * a[:, 0]
        return a
    return rng.normal(size=(5, 9))  # wide


@pytest.mark.parametrize(
    "colpiv,case",
    [(False, "tall"), (True, "tall"), (True, "rank_deficient"), (True, "wide")],
    ids=["householder-tall", "colpiv-tall", "colpiv-rank_deficient", "colpiv-wide"],
)
def test_dense_qr_matches(rng, colpiv, case):
    a = _dense_case(rng, case)
    b = rng.normal(size=a.shape[0])
    jcls, tcls = (jq.DenseColPivQR, qt.DenseColPivQR) if colpiv else (
        jq.DenseHouseholderQR, qt.DenseHouseholderQR)
    jqr = jcls().compute(jnp.asarray(a))
    tqr = tcls().compute(torch.as_tensor(a))
    assert tqr.info() == qt.ComputationInfo.SUCCESS
    assert tqr.rank == jqr.rank
    k = tqr.rank
    # a dead pivot's reflector is roundoff noise that two summation orders
    # resolve differently: compare the live part of the factorization
    close(tqr._Y[:, :k], jqr._Y[:, :k])
    close(tqr._T[:k, :k], jqr._T[:k, :k])
    close(tqr.matrix_r_dense()[:k], jqr.matrix_r_dense()[:k])
    np.testing.assert_array_equal(
        tqr.cols_permutation().indices[:k], jqr.cols_permutation().indices[:k]
    )
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
    if case == "rank_deficient":
        assert k == 5
        return
    M = rng.normal(size=(a.shape[0], 3))
    close(tqr.apply_qt(torch.as_tensor(M)), jqr.apply_qt(jnp.asarray(M)))
    close(tqr.apply_q(torch.as_tensor(M)), jqr.apply_q(jnp.asarray(M)))


def test_dense_qr_raw_programs_match(rng):
    from qrkit_tpu.solvers import dense as jdense

    from qrkit_tpu_torch.solvers import dense as tdense

    a = rng.normal(size=(24, 6))
    for got, want in zip(tdense._dense_qr(torch.as_tensor(a)), jdense._dense_qr(jnp.asarray(a))):
        close(got, want)
    for got, want in zip(tdense._dense_colpiv_qr(torch.as_tensor(a)),
                         jdense._dense_colpiv_qr(jnp.asarray(a))):
        close(got, want)


# --- TSQR ---------------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_tsqr_matches(rng, n_shards):
    a = rng.normal(size=(48, 5))
    tf = tsqr_factorize(torch.as_tensor(a), n_shards)
    jf = jtsqr.tsqr_factorize(jnp.asarray(a), n_shards)
    for got, want in zip(tf, jf):
        close(got, want)
    for v in (rng.normal(size=48), rng.normal(size=(48, 3))):
        for transpose in (False, True):
            close(tsqr_apply(*tf[:4], torch.as_tensor(v), n_shards, transpose),
                  jtsqr.tsqr_apply(*jf[:4], jnp.asarray(v), n_shards, transpose))
    # the solver: rows padded to whole shards, solve and R against the reference
    m = a[:45]
    b = rng.normal(size=45)
    tqr = TSQRDenseQR(n_shards).compute(torch.as_tensor(m))
    jqr = jtsqr.TSQRDenseQR(n_shards).compute(jnp.asarray(m))
    assert tqr._s_eff == jqr._s_eff
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
    close(tqr.matrix_r_dense(), jqr.matrix_r_dense())
    close(tqr.apply_q(tqr.apply_qt(torch.as_tensor(b))), b)


def test_tsqr_mesh_is_slice_4(rng):
    """The mesh is taken, not refused: TSQRDenseQR and BlockAngularQR keep
    it, and a mesh on the composite or its left solver switches the fused
    programs off, as in the reference (the sharded paths themselves run in
    tests/test_torch_parallel.py)."""
    mesh = object()
    assert TSQRDenseQR(2, mesh=mesh, axis="x").mesh is mesh
    blocks = rng.uniform(0.5, 5.0, size=(8, 3, 2))
    mat = qt.BlockMatrix1x2(qt.BlockDiagonal.from_dense_batch(blocks, device=DEV),
                            torch.as_tensor(rng.uniform(0.5, 5.0, size=(24, 2))))
    flagship = lambda m, left_m: qt.BlockAngularQR(  # noqa: E731
        qt.BlockDiagonalQR(pivot=False, mesh=left_m), qt.DenseColPivQR(), mesh=m)
    assert flagship(None, None)._uses_fused_dense(mat)
    assert not flagship(mesh, None)._uses_fused_dense(mat)
    assert not flagship(None, mesh)._uses_fused_dense(mat)


# --- BlockAngularQR -------------------------------------------------------------------------
def _problem(rng, N=40, br=3, bc=2, m2=5, tail=0):
    blocks = rng.uniform(0.5, 5.0, size=(N, br, bc))
    n1 = N * br + tail
    a2 = rng.uniform(0.5, 5.0, size=(n1, m2))
    return blocks, a2, rng.normal(size=n1)


def _mats(blocks, a2, left_soa=False, right_t=False):
    """(port, reference) BlockMatrix1x2 of the same numbers."""
    N, br, bc = blocks.shape
    n1 = a2.shape[0]
    r = np.ascontiguousarray(a2.T) if right_t else a2
    if left_soa:
        soa = blocks.transpose(1, 2, 0).reshape(br * bc, N)
        tl = qt.BlockDiagonal.from_soa(soa, br, bc, nrows=n1, device=DEV)
        jl = jq.BlockDiagonal.from_soa(jnp.asarray(soa), br, bc, nrows=n1)
    else:
        tl = qt.BlockDiagonal(torch.as_tensor(blocks), n1, N * bc)
        jl = jq.BlockDiagonal(jnp.asarray(blocks), n1, N * bc)
    return (qt.BlockMatrix1x2(tl, torch.as_tensor(r), right_t=right_t),
            jq.BlockMatrix1x2(jl, jnp.asarray(r), right_t=right_t))


def _solvers(colpiv):
    tr, jr = (qt.DenseColPivQR(), jq.DenseColPivQR()) if colpiv else (
        qt.DenseHouseholderQR(), jq.DenseHouseholderQR())
    return (qt.BlockAngularQR(qt.BlockDiagonalQR(qt.QFormat.FULL_Q, pivot=False), tr),
            jq.BlockAngularQR(jq.BlockDiagonalQR(JQFormat.FULL_Q, pivot=False), jr))


def _check_surfaces(rng, tqr, jqr, b):
    n1 = b.shape[0]
    assert tqr.info() == qt.ComputationInfo.SUCCESS
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
    close(tqr.r_diagonal(), jqr.r_diagonal())
    M = rng.normal(size=(n1, 2))
    close(tqr.solve(torch.as_tensor(M)), jqr.solve(jnp.asarray(M)))
    close(tqr.apply_qt(torch.as_tensor(M)), jqr.apply_qt(jnp.asarray(M)))
    close(tqr.apply_q(torch.as_tensor(b)), jqr.apply_q(jnp.asarray(b)))
    close(tqr.matrix_r_dense(), jqr.matrix_r_dense())
    np.testing.assert_array_equal(tqr.cols_permutation().indices, jqr.cols_permutation().indices)
    np.testing.assert_array_equal(tqr.rows_permutation().indices, jqr.rows_permutation().indices)
    assert tqr.rank == jqr.rank


@pytest.mark.parametrize("colpiv", [True, False], ids=["colpiv", "householder"])
@pytest.mark.parametrize("tail", [0, 3])
def test_fused_dense_matches(rng, colpiv, tail):
    blocks, a2, b = _problem(rng, tail=tail)
    tm, jm = _mats(blocks, a2)
    tqr, jqr = _solvers(colpiv)
    tqr.compute(tm)
    jqr.compute(jm)
    assert tqr._fused_dense and jqr._fused_dense and not tqr._fused_soa
    np.testing.assert_array_equal(tqr._fused_perm2.numpy(), np.asarray(jqr._fused_perm2))
    _check_surfaces(rng, tqr, jqr, b)
    close(tqr.compute_solve(tm, torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
    sparse_r = tqr.matrix_r_sparse().to_dense()
    np.testing.assert_allclose(sparse_r, jqr.matrix_r_sparse().to_dense(), **TOL)


@pytest.mark.parametrize("colpiv", [True, False], ids=["colpiv", "householder"])
@pytest.mark.parametrize("tail", [0, 3])
@pytest.mark.parametrize("layout", ["soa_left", "right_t"])
def test_fused_soa_matches(rng, colpiv, tail, layout):
    blocks, a2, b = _problem(rng, br=2, bc=1, tail=tail)
    tm, jm = _mats(blocks, a2, left_soa=layout == "soa_left", right_t=layout == "right_t")
    tqr, jqr = _solvers(colpiv)
    x = tqr.compute_solve(tm, torch.as_tensor(b))
    jqr.compute(jm)
    assert tqr._fused_soa and jqr._fused_soa
    close(x, jqr.solve(jnp.asarray(b)))
    np.testing.assert_array_equal(tqr._fused_perm2.numpy(), np.asarray(jqr._fused_perm2))
    # the factors of the lane-major program against the reference's
    for got, want in zip(
        (tqr._sU1, tqr._sc1, tqr._sR1, tqr._sj2t, tqr._sU2, tqr._sc2, tqr._sR2, tqr._sr12t),
        (jqr._sU1, jqr._sc1, jqr._sR1, jqr._sj2t, jqr._sU2, jqr._sc2, jqr._sR2, jqr._sr12t),
    ):
        close(got, want)
    tqr.compute(tm)
    _check_surfaces(rng, tqr, jqr, b)


def test_block_diagonal_adopt_factors_matches_compute(rng):
    """A BlockDiagonalQR that adopts the reference's per-block Q/R (as the
    fused dense path hands its left child) answers as the reference solver
    computed on the same matrix; a pivoting solver refuses."""
    blocks, _, b = _problem(rng, tail=3)
    N, br, bc = blocks.shape
    n1 = b.shape[0]
    jqr = jq.BlockDiagonalQR(JQFormat.FULL_Q, pivot=False).compute(
        jq.BlockDiagonal(jnp.asarray(blocks), n1, N * bc))
    mat = qt.BlockDiagonal(torch.as_tensor(blocks), n1, N * bc)
    tqr = qt.BlockDiagonalQR(qt.QFormat.FULL_Q, pivot=False)
    tqr._adopt_factors(mat, torch.as_tensor(np.array(jqr.Q)), torch.as_tensor(np.array(jqr.R)),
                       None)
    assert not tqr._kernel_mode and tqr.info() == qt.ComputationInfo.SUCCESS
    assert (tqr.rows, tqr.cols) == (n1, N * bc)
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
    close(tqr.apply_qt(torch.as_tensor(b)), jqr.apply_qt(jnp.asarray(b)))
    close(tqr.matrix_r_dense(), jqr.matrix_r_dense())
    np.testing.assert_array_equal(tqr.rows_permutation().indices, jqr.rows_permutation().indices)
    np.testing.assert_array_equal(tqr.cols_permutation().indices, np.arange(N * bc))
    close(tqr.solve(torch.as_tensor(b)), qt.BlockDiagonalQR(pivot=False).compute(mat).solve(
        torch.as_tensor(b)))
    with pytest.raises(ValueError, match="non-pivoting"):
        qt.BlockDiagonalQR(pivot=True)._adopt_factors(mat, None, None, None)


def test_fused_soa_taller_blocks(rng):
    """The lane-major program is not 2x1-specific: 5x2 blocks, ColPiv."""
    blocks, a2, b = _problem(rng, N=30, br=5, bc=2, m2=4)
    tm, jm = _mats(blocks, a2, left_soa=True)
    tqr, jqr = _solvers(True)
    tqr.compute(tm)
    jqr.compute(jm)
    assert tqr._fused_soa
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))


@pytest.mark.parametrize("colpiv", [True, False], ids=["colpiv", "householder"])
def test_generic_composition_matches(rng, colpiv):
    blocks, a2, b = _problem(rng, tail=4)
    tm, jm = _mats(blocks, a2)
    tqr, jqr = _solvers(colpiv)
    for s in (tqr, jqr):
        s._uses_fused_dense = lambda mat: False  # force the generic path
    tqr.compute(tm)
    jqr.compute(jm)
    assert not tqr._fused_dense and not jqr._fused_dense
    _check_surfaces(rng, tqr, jqr, b)
    # the fused path gives the same answer
    tf, _ = _solvers(colpiv)
    close(tf.compute(tm).solve(torch.as_tensor(b)), tqr.solve(torch.as_tensor(b)))


def _sparse_a2(rng, nb=40, m2=6, tail=2):
    br, bc = 3, 1
    n1 = nb * br + tail
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    nnz = max(int(n1 * m2 * 0.05), m2 + 1)
    rows = np.concatenate([rng.integers(0, n1, size=nnz), rng.integers(0, n1, size=m2)])
    cols = np.concatenate([rng.integers(0, m2, size=nnz), np.arange(m2)])
    a2 = jq.SparseCSR.from_triplets(rows, cols, rng.normal(size=rows.size), (n1, m2))
    return blocks, a2


def test_sparse_a2_matches_and_caches_plans(rng):
    blocks, ja2 = _sparse_a2(rng)
    nb, br, bc = blocks.shape
    n1 = ja2.nrows
    tl = qt.BlockDiagonal(torch.as_tensor(blocks), n1, nb * bc)
    jl = jq.BlockDiagonal(jnp.asarray(blocks), n1, nb * bc)
    tqr, jqr = _solvers(True)
    tqr.compute(qt.BlockMatrix1x2(tl, _port_csr(ja2)))
    jqr.compute(jq.BlockMatrix1x2(jl, ja2))
    assert tqr._r12_coo is not None and isinstance(tqr.right, _RowSubsetQR)
    assert tqr.right._k == jqr.right._k
    b = rng.normal(size=n1)
    _check_surfaces(rng, tqr, jqr, b)
    # a second compute on the same pattern reuses both plans
    plans = (tqr._plan_cache["blockdiag_a2"], tqr._plan_cache["rowsubset"])
    scaled = jq.SparseCSR(ja2.shape, ja2.indptr, ja2.indices, ja2.data * 2.0)
    tqr.compute(qt.BlockMatrix1x2(tl, _port_csr(scaled)))
    jqr.compute(jq.BlockMatrix1x2(jl, scaled))
    assert (tqr._plan_cache["blockdiag_a2"], tqr._plan_cache["rowsubset"]) == plans
    assert tqr._plan_cache["blockdiag_a2"] is plans[0]
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
    dense = np.concatenate([tl.to_dense(), scaled.to_dense()], axis=1)
    x_true = rng.normal(size=dense.shape[1])
    close(tqr.solve(torch.as_tensor(dense @ x_true)), x_true, rtol=0, atol=1e-8)


def test_sparse_a2_kernel_tier_left(rng):
    """The sparse-A2 path with the left solver in its kernel tier (the CUDA
    default; here the kernels' plain versions): the packed-R compute, then
    dense factors for the per-block Qᵀ."""
    blocks, ja2 = _sparse_a2(rng)
    nb, br, bc = blocks.shape
    tl = qt.BlockDiagonal(torch.as_tensor(blocks), ja2.nrows, nb * bc)
    tqr = qt.BlockAngularQR(qt.BlockDiagonalQR(pivot=False, use_kernel=True), qt.DenseColPivQR())
    tqr.compute(qt.BlockMatrix1x2(tl, _port_csr(ja2)))
    assert tqr.left._kernel_mode
    jqr = jq.BlockAngularQR(jq.BlockDiagonalQR(pivot=False), jq.DenseColPivQR())
    jqr.compute(jq.BlockMatrix1x2(jq.BlockDiagonal(jnp.asarray(blocks), ja2.nrows, nb * bc), ja2))
    b = rng.normal(size=ja2.nrows)
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))


def _banded_left(rng, N=40):
    """The ellipse stack's banded left (3x1 blocks, no overlap, 5 zero tail
    rows) and a dense A2, as EllipseFitting.damped_step_banded builds them."""
    vals = rng.uniform(0.5, 5.0, size=3 * N)
    left = jq.SparseCSR.from_triplets(np.arange(3 * N), np.repeat(np.arange(N), 3), vals,
                                      (3 * N + 5, N))
    a2 = rng.normal(size=(3 * N + 5, 5))
    return left, a2


def test_banded_left_dense_a2_matches(rng):
    left, a2 = _banded_left(rng)
    kw = dict(block_rows=3, block_cols=1, block_overlap=0, suggested_block_cols=1)
    tqr = qt.BlockAngularQR(qt.BandedBlockedQR(use_kernel=True, **kw, device=DEV), qt.DenseColPivQR())
    jqr = jq.BlockAngularQR(jq.BandedBlockedQR(**kw), jq.DenseColPivQR())
    tqr.compute(qt.BlockMatrix1x2(_port_csr(left), torch.as_tensor(a2)))
    jqr.compute(jq.BlockMatrix1x2(left, jnp.asarray(a2)))
    assert tqr.left._fac_kernel  # B5's plain version ran the chain
    b = rng.normal(size=left.nrows)
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))
    close(tqr.apply_qt(torch.as_tensor(b)), jqr.apply_qt(jnp.asarray(b)))
    close(tqr.matrix_r_dense(), jqr.matrix_r_dense())
    np.testing.assert_array_equal(tqr.cols_permutation().indices, jqr.cols_permutation().indices)


def test_banded_left_sparse_a2_is_slice_4(rng):
    """A banded left with a sparse A2 (once left for a later slice) keeps A2
    sparse through the planned Qᵀ product and solves like the reference."""
    left, a2 = _banded_left(rng, N=8)
    a2[rng.random(a2.shape) < 0.5] = 0.0
    ja2 = jq.SparseCSR.from_dense(a2)
    kw = dict(block_rows=3, block_cols=1, block_overlap=0, suggested_block_cols=1)
    tqr = qt.BlockAngularQR(qt.BandedBlockedQR(**kw, device=DEV), qt.DenseColPivQR())
    jqr = jq.BlockAngularQR(jq.BandedBlockedQR(**kw), jq.DenseColPivQR())
    tqr.compute(qt.BlockMatrix1x2(_port_csr(left), _port_csr(ja2)))
    jqr.compute(jq.BlockMatrix1x2(left, ja2))
    assert tqr._r12_coo is not None and "banded_a2" in tqr._plan_cache
    b = rng.normal(size=left.nrows)
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))


class _Ops(TorchDispatchMode):
    """The ATen ops a block issues, by overload packet."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(func.overloadpacket)
        return func(*args, **(kwargs or {}))


def _bundle_like(rng, nb=24, cams=2):
    """A bundle-shaped system: points of ``2C + 3`` rows and 3 columns
    (the block-diagonal left), each point's observation rows against its
    cameras' 6 columns, the camera damping rows on the left's zero tail."""
    br, c6 = 2 * cams + 3, 6 * cams
    n1 = nb * br + c6
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, 3))
    p, c, k, j = np.meshgrid(np.arange(nb), np.arange(cams), np.arange(2), np.arange(6),
                             indexing="ij")
    rows = np.concatenate([(p * br + 2 * c + k).ravel(), nb * br + np.arange(c6)])
    cols = np.concatenate([(6 * c + j).ravel(), np.arange(c6)])
    a2 = jq.SparseCSR.from_triplets(rows, cols, rng.normal(size=rows.size), (n1, c6))
    return blocks, a2


def test_r12_sum_has_a_fixed_order(rng):
    """R12's products are summed row by row in a fixed order, whatever the
    order its COO entries are stored in: ``solve_r`` issues no
    ``index_add`` (atomics on the card) and equals qrkit_tpu's ``.at[rows]
    .add`` at fp64 rtol 1e-12, for a vector and a matrix."""
    import jax

    from qrkit_tpu_torch.solvers.block_angular import _row_sum_map

    blocks, ja2 = _bundle_like(rng)
    nb, br, bc = blocks.shape
    n1 = ja2.nrows
    tqr = qt.BlockAngularQR(qt.BlockDiagonalQR(pivot=False, use_kernel=True), qt.DenseColPivQR())
    tqr.compute(qt.BlockMatrix1x2(qt.BlockDiagonal(torch.as_tensor(blocks), n1, nb * bc),
                                  _port_csr(ja2)))
    jqr = jq.BlockAngularQR(jq.BlockDiagonalQR(pivot=False), jq.DenseColPivQR())
    jqr.compute(jq.BlockMatrix1x2(jq.BlockDiagonal(jnp.asarray(blocks), n1, nb * bc), ja2))
    assert tqr.left._kernel_mode and tqr._r12_coo is not None
    rows, cols, vals = tqr._r12_coo
    shuffle = torch.as_tensor(rng.permutation(rows.shape[0]))
    tqr._r12_coo = (rows[shuffle], cols[shuffle], vals[shuffle])
    tqr._r12_sum = _row_sum_map(rows[shuffle].numpy(), tqr._m1, DEV)
    assert tqr._r12_sum.shape[1] == 6 * 2  # a row sums 6C products
    y = rng.normal(size=(tqr.cols, 3))
    for yy, want in ((y[:, 0], jqr.solve_r(jnp.asarray(y[:, 0]))),
                     (y, jax.vmap(jqr.solve_r, in_axes=1, out_axes=1)(jnp.asarray(y)))):
        with _Ops() as ops:
            got = tqr.solve_r(torch.as_tensor(yy))
        assert torch.ops.aten.index_add not in ops.seen and torch.ops.aten.index_add_ not in ops.seen
        close(got, want, rtol=1e-12, atol=1e-13)


def _segmented_left(rng, nb=32, br=10, bc=4, ov=2):
    """A tall banded left the segmented solver splits (8 blocks a segment)."""
    step = bc - ov
    ncols = step * nb + ov
    i, r, c = np.meshgrid(np.arange(nb), np.arange(br), np.arange(bc), indexing="ij")
    rows, cols = (i * br + r).ravel(), (i * step + c).ravel()
    keep = cols < ncols
    return jq.SparseCSR.from_triplets(rows[keep], cols[keep], rng.uniform(0.5, 5.0, size=keep.sum()),
                                      (br * nb, ncols))


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("left_kind", ["banded", "segmented"])
def test_generic_solve_matrix_rhs(rng, left_kind, k):
    """The generic solve of a ``[rows, k]`` rhs over a banded or segmented
    left and a sparse A2: one back-substitution over the columns, equal to
    qrkit_tpu's (its ``solve_r`` mapped over them) at fp64 rtol 1e-10."""
    if left_kind == "banded":
        left, a2 = _banded_left(rng)
        kw = dict(block_rows=3, block_cols=1, block_overlap=0, suggested_block_cols=1)
        tleft, jleft = qt.BandedBlockedQR(**kw, device=DEV), jq.BandedBlockedQR(**kw)
    else:
        left = _segmented_left(rng)
        a2 = rng.normal(size=(left.nrows, 5))
        kw = dict(suggested_block_cols=4, segment_blocks=8, fallback=False)
        tleft = qt.SegmentedBandedQR(**kw, device=DEV)
        jleft = jq.SegmentedBandedQR(**kw, use_pallas=False)
    a2[rng.random(a2.shape) < 0.5] = 0.0
    a2[np.arange(5), np.arange(5)] = 1.0  # no empty column
    ja2 = jq.SparseCSR.from_dense(a2)
    tqr = qt.BlockAngularQR(tleft, qt.DenseColPivQR())
    jqr = jq.BlockAngularQR(jleft, jq.DenseColPivQR())
    tqr.compute(qt.BlockMatrix1x2(_port_csr(left), _port_csr(ja2)))
    jqr.compute(jq.BlockMatrix1x2(left, ja2))
    assert tqr._r12_coo is not None
    if left_kind == "segmented":
        assert tqr.left._delegate is None
    b = rng.normal(size=(left.nrows, k))
    got = tqr.solve(torch.as_tensor(b))
    assert got.shape == (tqr.cols, k)
    close(got, jqr.solve(jnp.asarray(b)))
    for i in range(k):  # each column is the vector solve's
        close(got[:, i], tqr.solve(torch.as_tensor(b[:, i])), rtol=1e-12, atol=1e-13)


# --- state converters -------------------------------------------------------------------
@pytest.mark.parametrize("colpiv", [True, False], ids=["colpiv", "householder"])
def test_convert_dense_qr(rng, colpiv):
    a = rng.normal(size=(30, 6))
    b = rng.normal(size=30)
    jqr = (jq.DenseColPivQR() if colpiv else jq.DenseHouseholderQR()).compute(jnp.asarray(a))
    state = {"Y": jqr._Y, "T": jqr._T, "R": jqr._R, "perm": jqr._perm_dev if colpiv else None}
    tqr = convert.dense_qr_from_numpy(state, device=DEV)
    assert isinstance(tqr, qt.DenseColPivQR if colpiv else qt.DenseHouseholderQR)
    assert tqr.info() == qt.ComputationInfo.SUCCESS
    close(tqr.solve(torch.as_tensor(b)), jqr.solve(jnp.asarray(b)))


@pytest.mark.parametrize("colpiv", [True, False], ids=["colpiv", "householder"])
def test_convert_block_angular_qr(rng, colpiv):
    blocks, a2, b = _problem(rng, tail=3)
    tm, jm = _mats(blocks, a2)
    _, jqr = _solvers(colpiv)
    jqr.compute(jm)
    state = {
        "Q": jqr.left.Q, "R": jqr.left.R, "j2_top": jqr._j2_top, "Y2": jqr.right._Y,
        "T2": jqr.right._T, "R2": jqr.right._R, "perm2": jqr._fused_perm2, "r12": jqr._r12,
        "colpiv": colpiv,
    }
    tqr = convert.block_angular_qr_from_numpy(tm, state, device=DEV)
    assert tqr._fused_dense
    _check_surfaces(rng, tqr, jqr, b)
