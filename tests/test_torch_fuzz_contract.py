"""Randomized cross-solver contract fuzz of tests/test_fuzz_contract.py, in
the port, against qrkit_tpu, fp64 on the CPU.

The same random banded structures (block shape, overlap, chain length, row
shuffles; the same seeds) through ``BandedBlockedQR``, ``SegmentedBandedQR``
(segment_blocks 3: short chains take the documented fallback), ``auto_qr``
and ``BlockAngularQR(BandedBlockedQR, DenseColPivQR)``: the full QR
contract (``P_r A P_c = Q R``, orthogonal Q, sparse exports equal to the
dense ones, ``apply_qt`` is Qᵀ, healthy ``info()``, an exact
least-squares round trip), and the least-squares solution equal to
qrkit_tpu's (XLA path; unique for these full-rank systems) at rtol 1e-9.
A solver takes its kernel route (``use_kernel=True``, the kernels' plain
versions on the CPU) where its plan admits it, else ``"auto"``.

The ``cuda`` case replays each geometry's refactorize and solve against the
same calls under ``_program.eager()``, bitwise, on the card (JAX imported
inside the helpers: ``python -m pytest --noconftest -m cuda
tests/test_torch_fuzz_contract.py``).
"""
import numpy as np
import pytest
import torch

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import _program

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA
XTOL = dict(rtol=1e-9, atol=1e-10)  # the port's x against qrkit_tpu's

CASES = [
    # (br, bc, overlap, nb, permute_rows)
    (5, 2, 1, 8, False),
    (5, 2, 1, 8, True),
    (7, 3, 2, 6, False),
    (7, 4, 1, 9, True),
    (9, 4, 3, 7, False),
    (6, 2, 0, 10, True),   # zero overlap: block diagonal
    (4, 3, 2, 12, True),   # narrow tall-ish blocks, wide overlap
    (8, 5, 4, 6, False),   # overlap = bc - 1
]
IDS = [str(c) for c in CASES]


def banded_fixture(br, bc, ov, nb, permute, seed):
    """The reference test's ``banded_fixture``, built as a port SparseCSR."""
    rng = np.random.default_rng(seed)
    step = bc - ov
    ncols = step * nb + ov
    rows, cols, vals = [], [], []
    for i in range(nb):
        for r in range(br):
            for c in range(bc):
                col = i * step + c
                if col < ncols:
                    rows.append(i * br + r)
                    cols.append(col)
                    vals.append(rng.uniform(0.5, 5.0))
    m = qt.SparseCSR.from_triplets(rows, cols, vals, (br * nb, ncols))
    if permute:
        m = m.permute_rows(qt.Permutation(rng.permutation(m.nrows)))
    return m, rng


def _case(case):
    br, bc, ov, nb, permute = case
    return banded_fixture(br, bc, ov, nb, permute, seed=hash(case) % 2**31)


def _jax_sparse(m):
    from qrkit_tpu.sparse import SparseCSR as JSparse

    return JSparse(m.shape, m.indptr, m.indices, m.data)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kernel_route(qr, mat):
    """Analyze, then take the kernel route where the plan admits it."""
    qr.analyze_pattern(mat)
    inner = qr._delegate if getattr(qr, "_delegate", None) is not None else qr
    gate = inner._chain_kernel is not None if isinstance(inner, qt.BandedBlockedQR) else inner._kernel_gate
    inner.use_kernel = True if gate else "auto"
    return qr.compute(mat)


def _banded(bc, device=DEV):
    return qt.BandedBlockedQR(suggested_block_cols=bc, device=device)


def _segmented(bc, device=DEV):
    return qt.SegmentedBandedQR(suggested_block_cols=bc, segment_blocks=3, device=device)


def check_contract(qr, mat, rng, atol=1e-8):
    dense = mat.to_dense()
    assert qr.info() == qt.ComputationInfo.SUCCESS
    Q = _np(qr.matrix_q_dense())
    R = _np(qr.matrix_r_dense())
    pap = qr.rows_permutation().apply(dense)[:, qr.cols_permutation().indices]
    assert np.allclose(Q @ R, pap, atol=atol), np.abs(Q @ R - pap).max()
    assert np.allclose(Q.T @ Q, np.eye(Q.shape[0]), atol=atol)
    assert np.allclose(qr.matrix_r_sparse().to_dense(), R, atol=1e-12)
    assert np.allclose(qr.matrix_q_sparse().to_dense(), Q, atol=atol)
    probe = rng.normal(size=(mat.nrows, 3))
    assert np.allclose(_np(qr.apply_qt(torch.as_tensor(probe))), Q.T @ probe, atol=atol)
    x_true = rng.normal(size=mat.ncols)
    b = qr.rows_permutation().apply(dense @ x_true)
    x = _np(qr.solve(torch.as_tensor(b)))
    assert np.allclose(x, x_true, atol=1e-6), np.abs(x - x_true).max()
    return b, x


def _jax_solve(jq, b):
    import jax.numpy as jnp

    return _np(jq.solve(jnp.asarray(b)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fuzz_banded_blocked(case):
    from qrkit_tpu.solvers import BandedBlockedQR as JBanded

    mat, rng = _case(case)
    qr = _kernel_route(_banded(case[1]), mat)
    b, x = check_contract(qr, mat, rng)
    jq = JBanded(suggested_block_cols=case[1], use_pallas=False).compute(_jax_sparse(mat))
    np.testing.assert_array_equal(qr.rows_permutation().indices, jq.rows_permutation().indices)
    np.testing.assert_allclose(x, _jax_solve(jq, b), **XTOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fuzz_segmented(case):
    from qrkit_tpu.solvers import SegmentedBandedQR as JSegmented

    mat, rng = _case(case)
    qr = _kernel_route(_segmented(case[1]), mat)
    b, x = check_contract(qr, mat, rng)
    jq = JSegmented(suggested_block_cols=case[1], segment_blocks=3, use_pallas=False)
    jq.compute(_jax_sparse(mat))
    assert (qr._delegate is None) == (jq._delegate is None)
    np.testing.assert_allclose(x, _jax_solve(jq, b), **XTOL)


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_fuzz_auto(case):
    from qrkit_tpu import auto_qr as j_auto_qr

    mat, rng = _case(case)
    qr = qt.auto_qr(mat, suggested_block_cols=case[1], device=DEV)
    x_true = rng.normal(size=mat.ncols)
    b = qr.rows_permutation().apply(mat.to_dense() @ x_true)
    x = _np(qr.solve(torch.as_tensor(b)))
    assert np.allclose(x, x_true, atol=1e-6)
    jq = j_auto_qr(_jax_sparse(mat), suggested_block_cols=case[1])
    assert type(qr).__name__ == type(jq).__name__
    np.testing.assert_allclose(x, _jax_solve(jq, b), **XTOL)


ANGULAR_CASES = [(c, m2) for c in CASES[:4] for m2 in (2, 5)]


@pytest.mark.parametrize("case,m2", ANGULAR_CASES, ids=[f"{c}+{m2}" for c, m2 in ANGULAR_CASES])
def test_fuzz_block_angular(case, m2):
    """Random banded left + dense right through the composition solver."""
    import jax.numpy as jnp

    from qrkit_tpu.containers import BlockMatrix1x2 as JBlockMatrix1x2
    from qrkit_tpu.solvers import BandedBlockedQR as JBanded
    from qrkit_tpu.solvers import BlockAngularQR as JBlockAngularQR
    from qrkit_tpu.solvers import DenseColPivQR as JColPiv

    left, rng = _case(case)
    right = rng.normal(size=(left.nrows, m2))
    qr = qt.BlockAngularQR(_banded(case[1]), qt.DenseColPivQR())
    qr.compute(qt.BlockMatrix1x2(left, torch.as_tensor(right)))
    dense = np.concatenate([left.to_dense(), right], axis=1)
    x_true = rng.normal(size=dense.shape[1])
    b = qr.rows_permutation().apply(dense @ x_true)
    x = _np(qr.solve(torch.as_tensor(b)))
    assert np.allclose(x, x_true, atol=1e-6), np.abs(x - x_true).max()
    Q = _np(qr.matrix_q_dense())
    R = _np(qr.matrix_r_dense())
    pap = qr.rows_permutation().apply(dense)[:, qr.cols_permutation().indices]
    assert np.allclose(Q @ R, pap, atol=1e-8)
    jq = JBlockAngularQR(JBanded(suggested_block_cols=case[1], use_pallas=False), JColPiv())
    jq.compute(JBlockMatrix1x2(_jax_sparse(left), jnp.asarray(right)))
    np.testing.assert_allclose(x, _jax_solve(jq, b), **XTOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["banded", "segmented"])
def test_cuda_replays_match_eager(kind, cuda_device):
    """Every geometry's refactorize and solves (vector, k = 3) replayed on
    the card, bitwise equal to the same calls made eagerly."""
    for case in CASES:
        mat, rng = _case(case)
        qr = _kernel_route((_banded if kind == "banded" else _segmented)(case[1], cuda_device), mat)
        v = torch.as_tensor(mat.data * 1.25, device=cuda_device)
        b = torch.as_tensor(rng.normal(size=mat.nrows), device=cuda_device)
        B = torch.as_tensor(rng.normal(size=(mat.nrows, 3)), device=cuda_device)
        for _ in range(3):  # eager, the capture, then a replay
            qr.factorize_values(v)
            x, X = qr.solve(b), qr.solve(B)
        with _program.eager():
            qr.factorize_values(v)
            d_eager, x_eager, X_eager = qr.r_diagonal(), qr.solve(b), qr.solve(B)
        qr.factorize_values(v)
        torch.cuda.synchronize()
        assert torch.equal(qr.r_diagonal(), d_eager), case
        assert torch.equal(x, x_eager) and torch.equal(X, X_eager), case
        assert torch.equal(qr.solve(b), x_eager), case
        assert qr.info() == qt.ComputationInfo.SUCCESS
