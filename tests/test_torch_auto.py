"""The port's auto_qr, MatrixMarket CLI, plan persistence and profiling
helpers against qrkit_tpu, fp64, on the CPU (``device="cpu"``).

``auto_qr`` picks the reference's selection tag on every family of
tests/test_auto.py and solves to the reference's solution; the CLI returns
the same code, reports the same selection and writes exports that satisfy
``P_r A P_c = Q R`` (and equal the reference's where both factor the same
way); a plan saved by either package loads in the other; the dispatch
counter nests and counts host reads.  The block-diagonal stacks of the port
factor without pivoting (kernel B2 on the card; its plain version here
with ``use_kernel=True``), so only their solutions, not their R, are held
against the reference's pivoting ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qrkit_tpu as jq
from qrkit_tpu import persist as jpersist
from qrkit_tpu.__main__ import main as jmain

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import persist as tpersist
from qrkit_tpu_torch import profiling
from qrkit_tpu_torch.__main__ import main as tmain
from qrkit_tpu_torch.auto import ColumnSplitQR

from generators import block_angular_matrix, block_diagonal_matrix, overlapping_block_diagonal_matrix

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA


def _port(m):
    return qt.SparseCSR(m.shape, m.indptr, m.indices, m.data)


def _solve_both(tqr, jqr, dense, rng):
    """Each solver's x for b = A x_true (its own row permutation applied)."""
    x_true = rng.normal(size=dense.shape[1])
    b = dense @ x_true
    xt = tqr.solve(torch.as_tensor(tqr.rows_permutation().apply(b))).numpy()
    xj = np.asarray(jqr.solve(jnp.asarray(jqr.rows_permutation().apply(b))))
    np.testing.assert_allclose(xt, x_true, atol=1e-8)
    return xt, xj


def _unstructured(rng, m=120, n=10):
    rows = np.repeat(np.arange(m), 3)
    cols = rng.integers(0, n, size=m * 3)
    return jq.SparseCSR.from_triplets(rows, cols, rng.normal(size=m * 3), (m, n))


def _interleaved(rng):
    base = block_angular_matrix(32, 3, 112, rng)
    perm_idx = np.concatenate([np.arange(32, base.ncols), np.arange(32)])
    return base.permute_cols(jq.Permutation(np.argsort(perm_idx)))


FAMILIES = {  # name -> (matrix maker, auto_qr keywords, expected tag)
    "block_diagonal": (lambda rng: block_diagonal_matrix(64, 224, rng, permute_rows=True), {},
                       "block_diagonal"),
    "banded": (lambda rng: overlapping_block_diagonal_matrix(64, 224, rng, permute_rows=True),
               dict(suggested_block_cols=4), "banded_blocked"),
    "prefer_segmented": (
        lambda rng: overlapping_block_diagonal_matrix(256, 896, rng, permute_rows=False),
        dict(suggested_block_cols=4, prefer_segmented=True), "segmented_banded"),
    "block_angular_split": (lambda rng: block_angular_matrix(64, 5, 224, rng),
                            dict(suggested_block_cols=4), "block_angular(banded_blocked, dense_colpiv)"),
    "block_angular_interleaved": (_interleaved, dict(suggested_block_cols=4),
                                  "block_angular(blocked_thin_sparse, dense_colpiv)"),
    "unstructured": (_unstructured, {}, "blocked_thin_sparse"),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_auto_qr_selection_matches(rng, family):
    build, kw, tag = FAMILIES[family]
    mat = build(rng)
    tqr = qt.auto_qr(_port(mat), device=DEV, **kw)
    jqr = jq.auto_qr(mat, **kw)
    assert tqr.selection == jqr.selection == tag
    assert tqr.info() == qt.ComputationInfo.SUCCESS
    if tag.startswith("block_angular"):
        assert isinstance(tqr, ColumnSplitQR)
        np.testing.assert_array_equal(tqr.cols_permutation().indices, jqr.cols_permutation().indices)
    xt, xj = _solve_both(tqr, jqr, mat.to_dense(), rng)
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-10)


def test_auto_qr_dense_and_container_inputs(rng):
    tall, small = rng.normal(size=(200, 10)), rng.normal(size=(12, 9))
    for a, tag in ((tall, "blocked_thin_dense"), (small, "dense_colpiv")):
        tqr = qt.auto_qr(a, device=DEV)
        jqr = jq.auto_qr(a)
        assert tqr.selection == jqr.selection == tag
        assert tqr.matrix_r_dense().dtype == torch.float64
        b = rng.normal(size=a.shape[0])
        np.testing.assert_allclose(tqr.solve(torch.as_tensor(b)).numpy(),
                                   np.asarray(jqr.solve(jnp.asarray(b))), rtol=1e-10, atol=1e-10)
    # a BlockDiagonal and a [BlockDiagonal | dense] composite
    blocks = rng.uniform(0.5, 5.0, size=(30, 4, 2))
    a2 = rng.normal(size=(120, 3))
    tl, jl = qt.BlockDiagonal(torch.as_tensor(blocks), 120, 60), jq.BlockDiagonal(jnp.asarray(blocks), 120, 60)
    b = rng.normal(size=120)
    for tin, jin in ((tl, jl), (qt.BlockMatrix1x2(tl, torch.as_tensor(a2)), jq.BlockMatrix1x2(jl, jnp.asarray(a2)))):
        tqr, jqr = qt.auto_qr(tin), jq.auto_qr(jin)
        assert tqr.selection == jqr.selection
        np.testing.assert_allclose(tqr.solve(torch.as_tensor(b)).numpy(),
                                   np.asarray(jqr.solve(jnp.asarray(b))), rtol=1e-10, atol=1e-10)


def test_auto_qr_block_diagonal_kernel_tier(rng):
    """On a CPU operand with use_kernel=True the block-diagonal selection
    runs B2's plain version (the card runs the kernel under "auto")."""
    mat = block_diagonal_matrix(64, 224, rng, permute_rows=True)
    from qrkit_tpu_torch.auto import _csr_solver

    solver, tag = _csr_solver(_port(mat), 2, False, device=DEV)  # 7x2 blocks
    assert tag == "block_diagonal" and not solver.pivot
    solver.use_kernel = True
    solver.compute(_port(mat))
    assert solver._kernel_mode
    jqr = jq.auto_qr(mat, suggested_block_cols=2)
    _solve_both(solver, jqr, mat.to_dense(), rng)


def _run_cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().err


def test_cli_matches(tmp_path, rng, capsys):
    mat = block_diagonal_matrix(40, 140, rng, permute_rows=True)
    a = tmp_path / "a.mtx"
    qt.sparse.save_matrix_market(str(a), _port(mat))
    outs = {}
    for label, main, extra in (("port", tmain, ["--device", "cpu"]), ("ref", jmain, [])):
        paths = [tmp_path / f"{label}_{k}.mtx" for k in ("x", "r", "q")]
        rc, err = _run_cli(main, [str(a), "--rhs-random", "-o", str(paths[0]), "--export-r",
                                  str(paths[1]), "--export-q", str(paths[2]),
                                  "--suggested-block-cols", "3"] + extra, capsys)
        assert rc == 0
        assert "solver=block_diagonal rank=40/40 info=SUCCESS" in err
        assert "recovery rel err" in err
        outs[label] = [qt.sparse.load_matrix_market(str(p)) for p in paths]
    np.testing.assert_allclose(outs["port"][0].to_dense(), outs["ref"][0].to_dense(), rtol=1e-10)
    # the port's exports reconstruct P_r A P_c with the port's permutations
    tqr = qt.auto_qr(_port(mat), suggested_block_cols=3, device=DEV)
    pap = tqr.rows_permutation().apply(mat.to_dense())[:, tqr.cols_permutation().indices]
    R, Q = outs["port"][1].to_dense(), outs["port"][2].to_dense()
    np.testing.assert_allclose(Q @ R, pap, atol=1e-10)


@pytest.mark.parametrize("solver", ["banded", "thin"])
def test_cli_forced_solver_matches(tmp_path, rng, capsys, solver):
    mat = overlapping_block_diagonal_matrix(40, 140, rng, permute_rows=False)
    a = tmp_path / "a.mtx"
    jq.sparse.save_matrix_market(str(a), mat)
    exports = {}
    for label, main, extra in (("port", tmain, ["--device", "cpu"]), ("ref", jmain, [])):
        r = tmp_path / f"{label}_r.mtx"
        rc, err = _run_cli(main, [str(a), "--solver", solver, "--suggested-block-cols", "4",
                                  "--rhs-random", "--export-r", str(r)] + extra, capsys)
        assert rc == 0 and f"solver={solver} " in err
        exports[label] = qt.sparse.load_matrix_market(str(r)).to_dense()
    np.testing.assert_allclose(exports["port"], exports["ref"], rtol=1e-10, atol=1e-10)


def test_cli_without_card_raises(tmp_path, rng):
    """The CLI's default device is the card; with none it raises rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mat = block_diagonal_matrix(8, 28, rng, permute_rows=False)
    a = tmp_path / "a.mtx"
    qt.sparse.save_matrix_market(str(a), _port(mat))
    with pytest.raises((RuntimeError, AssertionError)):
        tmain([str(a)])


def test_matrix_market_round_trip_across_packages(tmp_path, rng):
    mat = overlapping_block_diagonal_matrix(20, 70, rng, permute_rows=True)
    p1, p2 = tmp_path / "port.mtx", tmp_path / "ref.mtx"
    qt.sparse.save_matrix_market(str(p1), _port(mat))
    jq.sparse.save_matrix_market(str(p2), mat)
    assert p1.read_text() == p2.read_text()
    back = qt.sparse.load_matrix_market(str(p2))
    np.testing.assert_array_equal(back.to_dense(), mat.to_dense())
    # the CSR surface the auto split uses
    t = _port(mat)
    np.testing.assert_array_equal(t.slice_cols(3, 5).to_dense(), mat.slice_cols(3, 5).to_dense())
    np.testing.assert_array_equal(t.slice_rows(4, 9).to_dense(), mat.slice_rows(4, 9).to_dense())
    np.testing.assert_array_equal(t.hstack_dense_block(2, 4), mat.hstack_dense_block(2, 4))
    np.testing.assert_array_equal(t.row_nnz(), mat.row_nnz())
    perm = np.random.default_rng(1).permutation(mat.ncols)
    np.testing.assert_array_equal(t.permute_cols(qt.Permutation(perm)).to_dense(),
                                  mat.permute_cols(jq.Permutation(perm)).to_dense())
    np.testing.assert_array_equal(t.to_scipy().toarray(), mat.to_scipy().toarray())


def test_persisted_analysis_loads_in_both_packages(tmp_path, rng):
    mat = overlapping_block_diagonal_matrix(64, 224, rng, permute_rows=True)
    perm, _ = qt.as_banded_as_possible(_port(mat))
    plan = qt.block_banded_info(_port(mat).permute_rows(perm), 4)
    assert tpersist.plan_to_json(plan) == jpersist.plan_to_json(
        jpersist.plan_from_json(tpersist.plan_to_json(plan)))
    port_file, ref_file = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    qt.save_analysis(port_file, plan, row_perm=perm)
    jplan, jrp, jcp = jq.load_analysis(port_file)
    jq.save_analysis(ref_file, jplan, row_perm=jrp)
    tplan, trp, tcp = qt.load_analysis(ref_file)
    assert tplan == plan and hash(tplan) == hash(plan) and tcp is None and jcp is None
    np.testing.assert_array_equal(trp.indices, perm.indices)
    # resume: a solver set from the reference's file refactorizes without
    # analysis and solves like a fresh one
    fresh = qt.BandedBlockedQR(suggested_block_cols=4, device=DEV).compute(_port(mat))
    resumed = qt.BandedBlockedQR(suggested_block_cols=4, device=DEV)
    resumed.set_analysis(tplan, trp)
    resumed.compute(_port(mat))
    x_true = rng.normal(size=mat.ncols)
    b = torch.as_tensor(resumed.rows_permutation().apply(mat.to_dense() @ x_true))
    np.testing.assert_allclose(resumed.solve(b).numpy(), fresh.solve(b).numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="version"):
        qt.plan_from_json('{"version": 2}')


def test_count_dispatches_and_trace(tmp_path, rng):
    blocks = rng.uniform(0.5, 5.0, size=(16, 4, 2))
    mat = qt.BlockDiagonal(torch.as_tensor(blocks), 64, 32)
    with qt.count_dispatches() as outer:
        qr = qt.BlockDiagonalQR(pivot=False).compute(mat)
        with qt.count_dispatches() as inner:
            assert qr.info() == qt.ComputationInfo.SUCCESS  # one read of the health flag
    assert inner.host_reads == 1 and 0 < inner.ops < outer.ops
    assert outer.count == outer.ops and not any(outer.launches.values())
    ops_then = outer.count
    qr.compute(mat)
    assert outer.count == ops_then  # nothing counted after the block
    with qt.trace(str(tmp_path / "tr")):
        qr.solve(torch.ones(64, dtype=torch.float64))
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    timer = qt.Timer()
    with timer("section"):
        pass
    out, secs = qt.timed(lambda: torch.ones(8) * 2)
    assert float(out[0]) == 2.0 and secs >= 0 and "section" in timer.summary()
    assert profiling.launch_counts().keys() == outer.launches.keys()
