"""Randomized geometry fuzz of tests/test_fuzz_segmented_surfaces.py over
every public surface of the port's SegmentedBandedQR, against qrkit_tpu,
fp64 on the CPU.

The same 14 gapped / tall-block / ragged / permuted geometries (the same
seeds; 4 in the p2w regime, where the W-apply gate admits the plan at
segment_blocks 8) through ``apply_q`` / ``apply_qt`` (vector and matrix,
against the solver's own explicit dense Q), the matrix-rhs solve (against
the port's plain chain and qrkit_tpu's segmented solve, both at the unique
least-squares solution), ``apply_q_sparse`` / ``apply_qt_sparse`` (dense
agreement and exact nnz parity) and ``factorize_values`` (equal to a fresh
compute).  Each geometry runs in the general route (``use_kernel=False``),
and the reference's Pallas subset (cases 0, 2, 5 and the four p2w cases)
in the kernel route too (``use_kernel=True``: the kernels' plain versions
on the CPU); ``test_fuzz_kernel_gate_coverage`` pins that the subset
reaches the chain kernel and the W apply.

The ``cuda`` case replays each geometry's refactorize and matrix-rhs solve
against the same calls under ``_program.eager()``, bitwise, on the card
(``python -m pytest --noconftest -m cuda
tests/test_torch_fuzz_segmented_surfaces.py``).
"""
import numpy as np
import pytest
import torch

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import _program

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

# (seed, bc, ov, row multiplier, nblocks, ragged): the reference's p2w cases
P2W_CASES = {
    10: (2000, 4, 2, 5, 32, False),
    11: (2001, 6, 2, 5, 28, True),
    12: (2002, 4, 1, 6, 40, False),
    13: (2004, 6, 3, 5, 30, False),
}
CASE_IDS = list(range(10)) + sorted(P2W_CASES)


def _random_geometry(idx: int):
    """The reference's randomized geometry for case ``idx``."""
    if idx in P2W_CASES:
        seed, bc, ov, mult, nb, ragged = P2W_CASES[idx]
        rng = np.random.default_rng(seed)
        return (bc - ov) * mult, bc, ov, nb, False, ragged, rng
    rng = np.random.default_rng(1000 + idx)
    if idx < 3:  # tall blocks: br ≫ step, the gapped regime
        bc = int(rng.integers(4, 7))
        ov = int(rng.integers(1, bc // 2 + 1))
        br = int((bc - ov) * rng.integers(5, 9))
        nb = int(rng.integers(9, 14))
    else:
        bc = int(rng.integers(2, 7))
        ov = int(rng.integers(1, bc // 2 + 1))
        br = int(rng.integers(bc + 1, 3 * bc + 2))
        nb = int(rng.integers(8, 16))
    permute = bool(idx % 3 == 2)
    ragged = bool(idx % 2 == 1)
    return br, bc, ov, nb, permute, ragged, rng


def _build(br, bc, ov, nb, permute, ragged, rng):
    step = bc - ov
    ncols = step * nb + ov
    rows, cols, vals = [], [], []
    nrows = 0
    for i in range(nb):
        bri = br
        if ragged and i == nb - 1:  # ragged tail block: fewer rows
            bri = int(rng.integers(bc, br + 1))
        for r in range(bri):
            for c in range(bc):
                col = i * step + c
                if col < ncols:
                    rows.append(nrows + r)
                    cols.append(col)
                    vals.append(rng.uniform(0.5, 5.0))
        nrows += bri
    m = qt.SparseCSR.from_triplets(rows, cols, vals, (nrows, ncols))
    if permute:
        m = m.permute_rows(qt.Permutation(rng.permutation(nrows)))
    return m


def _sparse_operand(rng, m, m2=5):
    r_, c_, v_ = [], [], []
    for j in range(m2 - 1):
        nzr = rng.choice(m, size=min(4, m), replace=False)
        r_.extend(nzr)
        c_.extend([j] * len(nzr))
        v_.extend(rng.normal(size=len(nzr)))
    spread = list(range(0, m, 5))
    r_.extend(spread)
    c_.extend([m2 - 1] * len(spread))
    v_.extend(rng.normal(size=len(spread)))
    return qt.SparseCSR.from_triplets(r_, c_, v_, (m, m2))


def _segment_blocks(idx):
    return 8 if idx in P2W_CASES else 3


def _make_seg(bc, idx, kernel, device=DEV):
    return qt.SegmentedBandedQR(
        suggested_block_cols=bc, segment_blocks=_segment_blocks(idx), fallback=False,
        use_kernel=kernel, device=device,
    )


# the kernel route on the reference's Pallas subset: tall/gapped, ragged and
# permuted chains plus the four p2w-regime cases (gates pinned below)
KERNEL_CASE_IDS = [0, 2, 5] + sorted(P2W_CASES)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_JAX_SOLVES = {}  # case -> qrkit_tpu's matrix-rhs solution (the same for both routes)


def _jax_solve(idx, mat, bc, Bs):
    if idx not in _JAX_SOLVES:
        import jax.numpy as jnp

        from qrkit_tpu.solvers import SegmentedBandedQR as JSegmented
        from qrkit_tpu.sparse import SparseCSR as JSparse

        jq = JSegmented(suggested_block_cols=bc, segment_blocks=_segment_blocks(idx),
                        fallback=False, use_pallas=False)
        jq.compute(JSparse(mat.shape, mat.indptr, mat.indices, mat.data))
        _JAX_SOLVES[idx] = _np(jq.solve(jnp.asarray(Bs)))
    return _JAX_SOLVES[idx]


@pytest.mark.parametrize(
    "idx,kernel",
    [(i, False) for i in CASE_IDS] + [(i, True) for i in KERNEL_CASE_IDS],
    ids=[f"{i}-general" for i in CASE_IDS] + [f"{i}-kernel" for i in KERNEL_CASE_IDS],
)
def test_fuzz_segmented_all_surfaces(idx, kernel):
    br, bc, ov, nb, permute, ragged, rng = _random_geometry(idx)
    mat = _build(br, bc, ov, nb, permute, ragged, rng)
    seg = _make_seg(bc, idx, kernel).compute(mat)
    assert seg.info() == qt.ComputationInfo.SUCCESS and seg._fac_kernel == kernel
    dense = mat.to_dense()

    # own-Q oracle: the explicit dense Q of THIS factorization
    Q = _np(seg.matrix_q_dense())
    m = mat.nrows
    assert np.allclose(Q.T @ Q, np.eye(m), atol=1e-8)

    # 1-2) dense applies, vector and matrix operands
    vec = rng.normal(size=m)
    mt = rng.normal(size=(m, 3))
    for op in (vec, mt):
        assert np.allclose(_np(seg.apply_qt(torch.as_tensor(op))), Q.T @ op, atol=1e-8)
        assert np.allclose(_np(seg.apply_q(torch.as_tensor(op))), Q @ op, atol=1e-8)

    # 3) matrix-rhs solve against the plain chain and qrkit_tpu's segmented
    # solve (the least-squares solution of a full-rank system is unique)
    plain = qt.BandedBlockedQR(suggested_block_cols=bc, device=DEV).compute(mat)
    X_true = rng.normal(size=(mat.ncols, 3))
    B = dense @ X_true
    Bs = seg.rows_permutation().apply(B)
    Xs = _np(seg.solve(torch.as_tensor(Bs)))
    Xp = _np(plain.solve(torch.as_tensor(plain.rows_permutation().apply(B))))
    assert np.allclose(Xs, X_true, atol=1e-6), np.abs(Xs - X_true).max()
    assert np.allclose(Xs, Xp, atol=1e-6)
    np.testing.assert_allclose(Xs, _jax_solve(idx, mat, bc, Bs), rtol=1e-9, atol=1e-10)

    # 4) sparse-operand Q products: dense agreement AND exact nnz parity
    S = _sparse_operand(rng, m)
    for fn, ref in ((seg.apply_qt_sparse, Q.T), (seg.apply_q_sparse, Q)):
        out = fn(S)
        refd = ref @ S.to_dense()
        assert np.abs(out.to_dense() - refd).max() < 1e-8
        assert out.nnz == int((np.abs(refd) > 0).sum())

    # 5) factorize_values: device-resident refactorize == fresh compute
    scale = 1.0 + rng.uniform(0.1, 0.5)
    seg.factorize_values(torch.as_tensor(mat.data) * scale)
    assert seg.info() == qt.ComputationInfo.SUCCESS
    mat2 = qt.SparseCSR(mat.shape, mat.indptr, mat.indices, mat.data * scale)
    seg2 = _make_seg(bc, idx, kernel).compute(mat2)
    np.testing.assert_allclose(_np(seg.r_diagonal()), _np(seg2.r_diagonal()), rtol=1e-12, atol=1e-12)
    b2 = mat2.to_dense() @ X_true[:, 0]
    x_refac = _np(seg.solve(torch.as_tensor(seg.rows_permutation().apply(b2))))
    assert np.allclose(x_refac, X_true[:, 0], atol=1e-6)


def test_fuzz_kernel_gate_coverage():
    """The kernel subset reaches the production kernels: the segment-chain
    gate admits every case of it, and the W apply (p2w) every p2w-regime
    case."""
    for idx in KERNEL_CASE_IDS:
        br, bc, ov, nb, permute, ragged, rng = _random_geometry(idx)
        seg = _make_seg(bc, idx, False)
        seg.analyze_pattern(_build(br, bc, ov, nb, permute, ragged, rng))
        assert seg._kernel_gate, idx
        assert (seg._p2w is not None) == (idx in P2W_CASES), idx


def test_fuzz_covers_gapped_geometry():
    """The sweep hits gap rows (num_zeros > 0 in the chain geometry)."""
    from qrkit_tpu_torch.solvers.banded_blocked import banded_geometry

    saw_gap = 0
    for idx in CASE_IDS:
        br, bc, ov, nb, permute, ragged, rng = _random_geometry(idx)
        qr = qt.BandedBlockedQR(suggested_block_cols=bc, device=DEV)
        qr.analyze_pattern(_build(br, bc, ov, nb, permute, ragged, rng))
        saw_gap += int(np.max(banded_geometry(qr.plan)["num_zeros"])) > 0
    assert saw_gap >= 3, f"only {saw_gap} gapped cases in the sweep"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_replays_match_eager(cuda_device):
    """Each geometry's refactorize and matrix-rhs solve replayed on the card
    (kernel route where the plan admits it), bitwise equal to the same calls
    made eagerly."""
    for idx in CASE_IDS:
        br, bc, ov, nb, permute, ragged, rng = _random_geometry(idx)
        mat = _build(br, bc, ov, nb, permute, ragged, rng)
        seg = _make_seg(bc, idx, "auto", cuda_device).compute(mat)
        v = torch.as_tensor(mat.data * 1.5, device=cuda_device)
        B = torch.as_tensor(rng.normal(size=(mat.nrows, 3)), device=cuda_device)
        for _ in range(3):  # eager, the capture, then a replay
            seg.factorize_values(v)
            X = seg.solve(B)
        with _program.eager():
            seg.factorize_values(v)
            d_eager, X_eager = seg.r_diagonal(), seg.solve(B)
        seg.factorize_values(v)
        torch.cuda.synchronize()
        assert torch.equal(seg.r_diagonal(), d_eager) and torch.equal(X, X_eager), idx
        assert torch.equal(seg.solve(B), X_eager), idx
