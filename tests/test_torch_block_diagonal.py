"""The port's BlockDiagonalQR, both tiers, against qrkit_tpu.BlockDiagonalQR.

Same seeded fp64 blocks on both sides.  The batched-torch tier is held
against the JAX XLA tier over pivot, Q format, zero tail rows/columns and
landscape blocks; the kernel tier (on CPU tensors: the CUDA kernels' plain
versions) against the JAX Pallas tier run in interpret mode.  Tolerances:
factors rtol 1e-10 / atol 1e-12 (same recurrence, fp64), solutions atol 1e-9.

Sparse R deviates from the reference in one place: under BLOCK_DIAGONAL_Q
with tall blocks the port puts each block's R rows where dense R has them
(at i*br), so Q·R = A holds for the sparse exports too; the reference's
sparse R keeps the FULL_Q stride there, so the port is held against the
reference's dense R in that case.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrkit_tpu.containers import BlockDiagonal as JBlockDiagonal
from qrkit_tpu.solvers import BlockDiagonalQR as JBlockDiagonalQR
from qrkit_tpu.solvers.block_diagonal import QFormat as JQFormat

from qrkit_tpu_torch import BlockDiagonal, BlockDiagonalQR, ComputationInfo, QFormat
from qrkit_tpu_torch import profiling

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

FACT = dict(rtol=1e-10, atol=1e-12)
SOL = dict(rtol=0, atol=1e-9)

GEOMETRIES = {
    # name: (nb, br, bc, tail_rows, tail_cols)
    "plain": (6, 7, 2, 0, 0),
    "tail_rows": (6, 7, 2, 3, 0),
    "tail_cols": (6, 7, 2, 0, 2),
    "landscape": (5, 3, 5, 0, 0),
}


def _pair(rng, geometry):
    nb, br, bc, tr, tc = GEOMETRIES[geometry]
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    nrows, ncols = nb * br + tr, nb * bc + tc
    jmat = JBlockDiagonal(jnp.asarray(blocks), nrows, ncols)
    tmat = BlockDiagonal(torch.as_tensor(blocks), nrows, ncols)
    return jmat, tmat


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_surfaces(rng, jqr, tqr, nrows, solve_vec, solve_mat):
    # zero tail columns make a non-pivoting R singular: both flag it
    assert tqr.info().name == jqr.info().name
    np.testing.assert_allclose(_np(tqr.r_diagonal()), _np(jqr.r_diagonal()), **FACT)
    assert tqr.rank == jqr.rank
    np.testing.assert_array_equal(
        tqr.cols_permutation().indices, jqr.cols_permutation().indices
    )
    np.testing.assert_array_equal(
        tqr.rows_permutation().indices, jqr.rows_permutation().indices
    )
    m = rng.normal(size=(nrows, 3))
    np.testing.assert_allclose(
        _np(tqr.apply_qt(torch.as_tensor(m))), _np(jqr.apply_qt(jnp.asarray(m))), **FACT
    )
    np.testing.assert_allclose(
        _np(tqr.apply_q(torch.as_tensor(m[:, 0]))), _np(jqr.apply_q(jnp.asarray(m[:, 0]))), **FACT
    )
    np.testing.assert_allclose(_np(tqr.matrix_r_dense()), _np(jqr.matrix_r_dense()), **FACT)
    np.testing.assert_allclose(
        tqr.matrix_q_sparse().to_dense(), jqr.matrix_q_sparse().to_dense(), **FACT
    )
    tall_bdq = tqr.q_format == QFormat.BLOCK_DIAGONAL_Q and not tqr._landscape
    r_ref = _np(jqr.matrix_r_dense()) if tall_bdq else jqr.matrix_r_sparse().to_dense()
    np.testing.assert_allclose(tqr.matrix_r_sparse().to_dense(), r_ref, **FACT)
    b = rng.normal(size=nrows)
    B = rng.normal(size=(nrows, 2))
    if solve_vec:
        np.testing.assert_allclose(
            _np(tqr.solve(torch.as_tensor(b))), _np(jqr.solve(jnp.asarray(b))), **SOL
        )
    if solve_mat:
        np.testing.assert_allclose(
            _np(tqr.solve(torch.as_tensor(B))), _np(jqr.solve(jnp.asarray(B))), **SOL
        )
    else:  # the generic solve needs a globally triangular R
        with pytest.raises(ValueError, match="FULL_Q"):
            tqr.solve(torch.as_tensor(B))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("fmt", ["FULL_Q", "BLOCK_DIAGONAL_Q"])
@pytest.mark.parametrize("pivot", [False, True], ids=["nopivot", "pivot"])
def test_batched_tier_matches_xla_tier(rng, geometry, fmt, pivot):
    jmat, tmat = _pair(rng, geometry)
    jqr = JBlockDiagonalQR(JQFormat[fmt], pivot=pivot, use_pallas=False).compute(jmat)
    tqr = BlockDiagonalQR(QFormat[fmt], pivot=pivot, use_kernel=False).compute(tmat)
    assert not tqr._kernel_mode
    can_solve = fmt == "FULL_Q" or geometry == "landscape"
    _check_surfaces(rng, jqr, tqr, tmat.nrows, can_solve, can_solve)


def _jax_kernel_tier(fmt):
    qr = JBlockDiagonalQR(JQFormat[fmt], pivot=False, use_pallas=True)
    qr._pallas_interpret = True
    return qr


@pytest.mark.parametrize("geometry", ["tail_rows", "tail_cols"])
@pytest.mark.parametrize("fmt", ["FULL_Q", "BLOCK_DIAGONAL_Q"])
def test_kernel_tier_matches_pallas_tier(rng, geometry, fmt):
    jmat, tmat = _pair(rng, geometry)
    jqr = _jax_kernel_tier(fmt).compute(jmat)
    profiling.reset_launch_counts()
    tqr = BlockDiagonalQR(QFormat[fmt], pivot=False, use_kernel=True).compute(tmat)
    assert tqr._kernel_mode and jqr._pallas_mode
    assert tqr.Q is None  # dense factors only on demand
    # a vector rhs is one fused kernel solve in either Q format
    _check_surfaces(rng, jqr, tqr, tmat.nrows, True, fmt == "FULL_Q")
    # CPU tensors run the plain versions: no kernel was launched
    assert not any(profiling.launch_counts().values())


@pytest.mark.parametrize("br,bc", [(2, 1), (7, 2), (5, 3), (8, 8)], ids=["bc1", "bc2", "bc3", "bc8"])
def test_packed_r_diagonal_index(rng, br, bc):
    """The kernel tier reads R's diagonal at packed row j*bc - j*(j-1)//2."""
    blocks = rng.uniform(0.5, 5.0, size=(4, br, bc))
    jmat = JBlockDiagonal(jnp.asarray(blocks), 4 * br, 4 * bc + 1)
    tmat = BlockDiagonal(torch.as_tensor(blocks), 4 * br, 4 * bc + 1)
    tk = BlockDiagonalQR(pivot=False, use_kernel=True).compute(tmat)
    tb = BlockDiagonalQR(pivot=False, use_kernel=False).compute(tmat)
    jk = _jax_kernel_tier("FULL_Q").compute(jmat)
    np.testing.assert_allclose(_np(tk.r_diagonal()), _np(jk.r_diagonal()), **FACT)
    np.testing.assert_allclose(_np(tk.r_diagonal()), _np(tb.r_diagonal()), **FACT)
    assert _np(tk.r_diagonal())[-1] == 0.0  # the zero tail column


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "batched"])
def test_info_is_lazy_and_flags_singular_block(rng, use_kernel):
    blocks = rng.uniform(0.5, 5.0, size=(5, 7, 2))
    blocks[3, :, 1] = 0.0  # singular block: an exactly zero pivot
    mat = BlockDiagonal.from_dense_batch(blocks, device=DEV)
    qr = BlockDiagonalQR(pivot=False, use_kernel=use_kernel).compute(mat)
    assert isinstance(qr._health, torch.Tensor)  # left on the device by compute
    assert qr.info() == ComputationInfo.NUMERICAL_ISSUE
    assert qr._health is None


def test_auto_selects_batched_tier_on_cpu(rng):
    _, tmat = _pair(rng, "plain")
    qr = BlockDiagonalQR(pivot=False).compute(tmat)
    assert qr.use_kernel == "auto" and not qr._kernel_mode


@pytest.mark.parametrize(
    "kwargs,match",
    [(dict(pivot=True, use_kernel=True), "use_kernel"), (dict(use_kernel="yes"), "use_kernel")],
    ids=["pivot_forced", "bad_value"],
)
def test_kernel_tier_rejects_unsupported(rng, kwargs, match):
    _, tmat = _pair(rng, "plain")
    with pytest.raises(ValueError, match=match):
        BlockDiagonalQR(**kwargs).compute(tmat)


def test_soa_container_roundtrip_and_solver(rng):
    nb, br, bc = 50, 2, 1
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    soa = blocks.transpose(1, 2, 0).reshape(br * bc, nb)
    m_soa = BlockDiagonal.from_soa(soa, br, bc, device=DEV)
    assert m_soa.is_soa and m_soa.shape == (nb * br, nb * bc)
    np.testing.assert_array_equal(m_soa.blocks.numpy(), blocks)
    m_aos = BlockDiagonal.from_dense_batch(blocks, device=DEV)
    np.testing.assert_array_equal(m_aos.soa().numpy(), soa)
    np.testing.assert_array_equal(m_soa.to_dense(), m_aos.to_dense())
    b = torch.as_tensor(rng.normal(size=nb * br))
    xk = BlockDiagonalQR(pivot=False, use_kernel=True).compute(m_soa).solve(b)
    xb = BlockDiagonalQR(pivot=False, use_kernel=False).compute(m_aos).solve(b)
    np.testing.assert_allclose(xk.numpy(), xb.numpy(), **SOL)


EXPORT_CASES = [
    (shape, fmt, tier)
    for shape in ("tall", "square", "landscape")
    for fmt in ("FULL_Q", "BLOCK_DIAGONAL_Q")
    for tier in ("batched", "batched_pivot", "kernel")
    if not (shape == "landscape" and tier == "kernel")  # the kernel tier takes portrait blocks
]


@pytest.mark.parametrize("shape,fmt,tier", EXPORT_CASES)
def test_sparse_and_dense_exports_agree(rng, shape, fmt, tier):
    """Sparse R equals dense R under both Q formats, for tall, square and
    landscape blocks, on both tiers; without pivoting the sparse factors
    multiply back to A (fp64, 1e-12)."""
    br, bc = {"tall": (7, 2), "square": (3, 3), "landscape": (3, 5)}[shape]
    nb = 6
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    mat = BlockDiagonal.from_dense_batch(blocks, device=DEV)
    qr = BlockDiagonalQR(QFormat[fmt], pivot=tier == "batched_pivot", use_kernel=tier == "kernel")
    qr.compute(mat)
    assert qr._kernel_mode == (tier == "kernel")
    r_sparse = qr.matrix_r_sparse().to_dense()
    np.testing.assert_allclose(r_sparse, _np(qr.matrix_r_dense()), rtol=0, atol=1e-12)
    if tier != "batched_pivot":
        qr_prod = qr.matrix_q_sparse().to_dense() @ r_sparse
        np.testing.assert_allclose(qr_prod, mat.to_dense(), rtol=0, atol=1e-12)
