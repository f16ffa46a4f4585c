"""The port's slice end to end against qrkit_tpu, the state converter, and
the port's packaging guarantees (no jax import, no CPU kernel launches, no
silent fallback when the CUDA build cannot run)."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qrkit_tpu as jq
from qrkit_tpu.solvers.block_diagonal import QFormat as JQFormat

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import convert, profiling
from qrkit_tpu_torch.ops import _build
from qrkit_tpu_torch.ops import blockdiag as bd
from qrkit_tpu_torch.ops import graph_loop
from qrkit_tpu_torch.ops import tall_qr

from generators import block_diagonal_matrix, tall_banded_matrix

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

REPO = Path(__file__).resolve().parents[1]
SOL = dict(rtol=0, atol=1e-9)


def _port(m):
    return qt.SparseCSR(m.shape, m.indptr, m.indices, m.data)


def _consistent(rng, nb, br=7, bc=2, tail_rows=0):
    """Block-diagonal triplets with a consistent rhs b = A x_true."""
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    i, r, c = np.meshgrid(np.arange(nb), np.arange(br), np.arange(bc), indexing="ij")
    rows, cols = (i * br + r).ravel(), (i * bc + c).ravel()
    shape = (nb * br + tail_rows, nb * bc)
    x_true = rng.normal(size=nb * bc)
    b = np.concatenate([np.einsum("bij,bj->bi", blocks, x_true.reshape(nb, bc)).ravel(),
                        np.zeros(tail_rows)])
    return rows, cols, blocks.ravel(), shape, b, x_true


def _jax_solver(pivot, kernel):
    qr = jq.BlockDiagonalQR(pivot=pivot, use_pallas=kernel)
    qr._pallas_interpret = kernel
    return qr


@pytest.mark.parametrize(
    "pivot,kernel", [(False, True), (False, False), (True, False)],
    ids=["kernel_tier", "batched_nopivot", "batched_pivot"],
)
def test_slice_end_to_end_matches_jax(rng, pivot, kernel):
    rows, cols, vals, shape, b, x_true = _consistent(rng, 40, tail_rows=2)
    jmat = jq.BlockDiagonal.from_block_diagonal_pattern(
        jq.SparseCSR.from_triplets(rows, cols, vals, shape), 7, 2
    )
    tmat = qt.BlockDiagonal.from_block_diagonal_pattern(
        qt.SparseCSR.from_triplets(rows, cols, vals, shape), 7, 2, device="cpu"
    )
    jqr = _jax_solver(pivot, kernel).compute(jmat)
    tqr = qt.BlockDiagonalQR(pivot=pivot, use_kernel=kernel).compute(tmat)
    assert tqr._kernel_mode == kernel == jqr._pallas_mode
    assert tqr.info() == qt.ComputationInfo.SUCCESS and jqr.info().name == "SUCCESS"
    x = tqr.solve(torch.as_tensor(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(jqr.solve(jnp.asarray(b))), **SOL)
    np.testing.assert_allclose(x.numpy(), x_true, rtol=0, atol=1e-9)


def test_slice_from_sparse_matrix_with_row_permutation(rng):
    jm = block_diagonal_matrix(24, 84, rng, permute_rows=True)
    tm = qt.SparseCSR(jm.shape, jm.indptr, jm.indices, jm.data)
    jblk, jperm = jq.BlockDiagonal.from_sparse_matrix(jm, 2)
    tblk, tperm = qt.BlockDiagonal.from_sparse_matrix(tm, 2, device=DEV)
    b = rng.normal(size=jm.nrows)
    jqr = jq.BlockDiagonalQR(pivot=True).compute(jblk, row_perm=jperm)
    tqr = qt.BlockDiagonalQR(pivot=True).compute(tblk, row_perm=tperm)
    # the caller pre-applies the row permutation (Eigen contract)
    pb = tqr.rows_permutation().apply(b)
    np.testing.assert_array_equal(pb, jqr.rows_permutation().apply(b))
    np.testing.assert_allclose(
        tqr.solve(torch.as_tensor(pb)).numpy(), np.asarray(jqr.solve(jnp.asarray(pb))), **SOL
    )


def _jax_state(jqr):
    state = dict(
        nb=jqr._nb, br=jqr._br, bc=jqr._bc, nrows=jqr._nrows, ncols=jqr._ncols,
        pivot=jqr.pivot, q_format=jqr.q_format.name,
        row_perm=jqr.rows_permutation().indices,
    )
    if jqr._pallas_mode:
        state.update(a_pad=np.asarray(jqr._a_pad), r_soa=np.asarray(jqr._r_soa))
    else:
        state.update(Q=np.asarray(jqr.Q), R=np.asarray(jqr.R))
        if jqr.pivot:
            state["local_perm"] = np.asarray(jqr._local_perm_dev)
    return state


@pytest.mark.parametrize(
    "pivot,kernel", [(False, True), (False, False), (True, False)],
    ids=["kernel_tier", "xla_nopivot", "xla_pivot"],
)
def test_convert_solver_state_roundtrip(rng, pivot, kernel):
    blocks = rng.uniform(0.5, 5.0, size=(30, 7, 2))
    jmat = jq.BlockDiagonal(jnp.asarray(blocks), 30 * 7 + 1, 30 * 2)
    jqr = _jax_solver(pivot, kernel).compute(jmat)
    tqr = convert.block_diagonal_qr_from_numpy(_jax_state(jqr), device=DEV)
    assert tqr._kernel_mode == kernel
    if kernel:  # the port keeps no Pallas padding
        assert tqr._a_soa.shape == (14, 30) and tqr._r_soa.shape == (3, 30)
    assert tqr.info() == qt.ComputationInfo.SUCCESS
    b = rng.normal(size=jmat.nrows)
    np.testing.assert_allclose(
        tqr.solve(torch.as_tensor(b)).numpy(), np.asarray(jqr.solve(jnp.asarray(b))), **SOL
    )
    np.testing.assert_allclose(tqr.r_diagonal().numpy(), np.asarray(jqr.r_diagonal()),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(tqr.cols_permutation().indices, jqr.cols_permutation().indices)
    assert tqr.q_format == qt.QFormat[JQFormat.FULL_Q.name] and tqr.rank == jqr.rank


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_convert_block_diagonal(rng, layout):
    blocks = rng.uniform(0.5, 5.0, size=(9, 3, 2))
    if layout == "aos":
        jmat = jq.BlockDiagonal(jnp.asarray(blocks), 28, 19)
        tmat = convert.block_diagonal_from_numpy(28, 19, blocks=np.asarray(jmat.blocks), device=DEV)
    else:
        soa = blocks.transpose(1, 2, 0).reshape(6, 9)
        jmat = jq.BlockDiagonal.from_soa(jnp.asarray(soa), 3, 2, 28, 19)
        tmat = convert.block_diagonal_from_numpy(
            28, 19, blocks_soa=np.asarray(jmat.soa()), block_rows=3, block_cols=2, device=DEV
        )
    assert tmat.is_soa == jmat.is_soa
    np.testing.assert_array_equal(tmat.to_dense(), jmat.to_dense())


PORT_MODULES = {  # every module of the port, the banded family's included
    "qrkit_tpu_torch.analysis", "qrkit_tpu_torch.containers", "qrkit_tpu_torch.convert",
    "qrkit_tpu_torch.functional", "qrkit_tpu_torch.plan", "qrkit_tpu_torch.profiling",
    "qrkit_tpu_torch.sparse", "qrkit_tpu_torch.ops.banded", "qrkit_tpu_torch.ops.blockdiag",
    "qrkit_tpu_torch.ops.compact_wy", "qrkit_tpu_torch.ops.householder",
    "qrkit_tpu_torch.solvers.banded_blocked", "qrkit_tpu_torch.solvers.block_diagonal",
    "qrkit_tpu_torch.solvers.segmented_apply", "qrkit_tpu_torch.solvers.segmented_banded",
    "qrkit_tpu_torch.solvers.segmented_factorize", "qrkit_tpu_torch.solvers.segmented_plan",
    "qrkit_tpu_torch.solvers.segmented_solve",
}


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import qrkit_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(qrkit_tpu_torch.__path__, 'qrkit_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'qrkit_tpu.')) or k == 'qrkit_tpu')\n"
        "print(' '.join(names))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert PORT_MODULES <= set(proc.stdout.split("\n")[0].split()), proc.stdout


def test_cpu_tensors_launch_no_kernel(rng, monkeypatch):
    def no_build(*args):
        raise AssertionError("a CPU tensor must not reach the CUDA build")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "load_banded", no_build)
    monkeypatch.setattr(_build, "load_chain", no_build)
    monkeypatch.setattr(_build, "load_graph_loop", no_build)
    monkeypatch.setattr(_build, "load_lm_step", no_build)
    monkeypatch.setattr(_build, "load_tall_qr", no_build)
    profiling.reset_launch_counts()
    blocks = rng.uniform(0.5, 5.0, size=(8, 7, 2))
    mat = qt.BlockDiagonal.from_dense_batch(blocks, device=DEV)
    qr = qt.BlockDiagonalQR(pivot=False, use_kernel=True).compute(mat)
    qr.solve(torch.as_tensor(rng.normal(size=56)))
    bd.block_diagonal_lstsq(torch.as_tensor(blocks), torch.as_tensor(rng.normal(size=56)))
    bd.block_diagonal_qr_r(torch.as_tensor(blocks))
    banded = _port(tall_banded_matrix(64, rng, br=10, bc=4, ov=2))
    seg = qt.SegmentedBandedQR(4, 8, use_kernel=True, device=DEV).compute(banded)
    plain = qt.BandedBlockedQR(suggested_block_cols=4, use_kernel=True, device=DEV).compute(banded)
    assert seg._fac_kernel and seg._p2w is not None and seg._chain_kernel and plain._fac_kernel
    graph_loop.loop_condition(torch.zeros(3, dtype=torch.bool), torch.tensor(0, dtype=torch.int32), 5)
    seg.solve(torch.as_tensor(rng.normal(size=banded.nrows)))
    plain.solve(torch.as_tensor(rng.normal(size=banded.nrows)))
    assert seg._scan_kernel and plain._scan_kernel
    step = [torch.as_tensor(rng.normal(size=shape)) for shape in ((2, 1, 9), (2, 5, 9), (2, 9))]
    qt.functional.lm_damped_step_blockdiag(*step, 0.5)
    tall_qr.r_and_qtb(torch.as_tensor(rng.normal(size=(300, 11))))
    assert set(profiling.launch_counts()) == {
        "blockdiag_lstsq", "blockdiag_qr_r", "banded_segment_chains", "banded_apply_w",
        "banded_chain_qr", "graph_loop_cond", "chain_two_seg", "chain_solve", "lm_step",
        "ellipse_residuals", "ellipse_residuals_vjp", "ellipse_jacobian", "loop_mark", "tall_qr",
    }
    assert not any(profiling.launch_counts().values())


def _isolate_build(monkeypatch, tmp_path, cuda_home):
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty_path"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if cuda_home is None:
        monkeypatch.delenv("CUDA_HOME", raising=False)
    else:
        monkeypatch.setenv("CUDA_HOME", str(cuda_home))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path, None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(7, 2)
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    _isolate_build(monkeypatch, tmp_path, tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="sm_90a refused"):
        _build.build(3, 3)
    assert not any((tmp_path / "build").glob("*.so"))  # no half-built library left


def test_build_banded_source_one_library(monkeypatch, tmp_path):
    """The banded source builds as one library with no -D defines (its
    kernels take every shape as arguments), keyed by a hash of source and
    flags; the block-diagonal source keeps one library per shape."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    log = tmp_path / "nvcc_args"
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'printf "" > "$2"\n'
    )
    nvcc.chmod(0o755)
    _isolate_build(monkeypatch, tmp_path, tmp_path / "cuda")
    path = _build.build_source(_build.BANDED_SOURCE)
    assert path.exists() and path.name.startswith("banded_chain_") and path.parent == tmp_path / "build"
    assert _build.build_source(_build.BANDED_SOURCE) == path  # cached: nvcc ran once
    bd_path = _build.build(7, 2)
    assert bd_path.name.startswith("blockdiag_qr_7x2_")
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert "-D" not in calls[0] and calls[0].endswith("banded_chain.cu")
    assert "-DQRK_BR=7 -DQRK_BC=2" in calls[1] and "--fmad=false" in calls[0]
