"""The sparse-operand recomputes as captured programs: the three pins of
tests/test_dispatch_count.py that keep a host operand's values flowing,
in the port.

* ``test_sparse_qproduct_recompute_one_dispatch``: a same-layout
  ``apply_qt_sparse`` / ``apply_q_sparse`` of ``BandedBlockedQR`` and
  ``SegmentedBandedQR`` is at most 2 (the upload of the operand's values
  and one program; the fetch of the values is a copy, not a launch);
* ``test_thin_fused_compute_dispatch_budget``: a same-layout
  ``BlockedThinSparseQR.compute`` is at most 9;
* ``test_block_angular_recompute_dispatch_budget``: the banded-left
  sparse-A2 ``BlockAngularQR`` recompute is at most 6, and so here is the
  block-diagonal-left one (the bundle's and config 4's).

"Counted" is :class:`~qrkit_tpu_torch.profiling.DispatchCount`'s ``count``
(ATen ops, replays, host-issued launches) less its host reads, the
reference's count of executions: a fetch to the host is a copy, not a
launch.  A warm call replays the left solver's program (the block-angular
paths) and one program for the rest, reads the host at most once (the
sparse products' fetch; none on the CPU, where the fetch is a NumPy copy)
and issues no launch from the host.  Its result equals the same call under
``_program.eager()`` bitwise and qrkit_tpu's at fp64 rtol 1e-10; a new
pattern between warm calls builds new maps and captures again.

On the CPU the programs run through the recording backend of
tests/test_torch_dispatch_count.py; the matrices are built here, so the
``cuda`` cases run on a GPU machine without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_sparse_programs.py``.
"""
import numpy as np
import pytest
import torch

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import _program

from test_torch_dispatch_count import GEOMETRIES, Recording, overlapping_matrix

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA
TOL = dict(rtol=1e-10, atol=1e-11)
WARM = 3  # calls before the counted one: eager, capture, first replay


@pytest.fixture
def recording():
    with _program._use_backend(Recording):
        yield


def block_angular_matrix(num_params, num_angular_params, num_residuals, rng):
    """``generators.block_angular_matrix``: the overlapping banded left and
    dense right columns."""
    rows, cols, vals = [], [], []
    for i in range(num_params // 2):
        for j in range(i * 2, min(i * 2 + 2, num_params)):
            for k in range(7):
                rows.append(i * 7 + k)
                cols.append(j)
                vals.append(rng.uniform(0.5, 5.0))
            if j < num_params - 2:
                rows.append(i * 7 + 6)
                cols.append(j + 2)
                vals.append(rng.uniform(0.5, 5.0))
    for i in range(num_residuals):
        for j in range(num_angular_params):
            rows.append(i)
            cols.append(num_params + j)
            vals.append(rng.uniform(0.5, 5.0))
    return qt.SparseCSR.from_triplets(rows, cols, vals,
                                      (num_residuals, num_params + num_angular_params))


def scaled(mat, s):
    """``mat``'s layout (its fingerprint handed on, as the reference's test
    does) with its values times ``s``."""
    out = qt.SparseCSR(mat.shape, mat.indptr, mat.indices, mat.data * s)
    out._fp_memo = mat.pattern_fingerprint()
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j(m):
    from qrkit_tpu.sparse import SparseCSR as JSparse

    return JSparse(m.shape, m.indptr, m.indices, m.data)


def _flat(*xs):
    """One fresh float64 host vector of what a call produced."""
    return np.concatenate([np.asarray(_np(x), dtype=np.float64).reshape(-1) for x in xs])


# --- the paths ------------------------------------------------------------------------
class SparseProduct:
    """``apply_qt_sparse`` / ``apply_q_sparse`` of a banded or segmented
    solver on the reference test's operand (6 columns of 5 nonzeros), over
    the reference test's matrix (``uniform``) or the full-rank tall-block
    geometry (``tallblock_p2w``).  The uniform matrix's overlap columns
    are rank deficient inside their panels, so there Q's first n columns
    agree with qrkit_tpu's only up to the signs of R's rows, and the rest
    of Q only up to a rotation: the product's part in the span of those n
    columns is held to qrkit_tpu's, sign by sign, and the whole product to
    the port's dense apply; the tall-block geometry's product is held to
    qrkit_tpu's entry by entry."""

    programs, budget, card_reads = 1, 2, 1

    def __init__(self, kind, method, geom, rng, device):
        self.kind, self.method, self.geom = kind, method, geom
        self.mat = GEOMETRIES[geom](rng)
        self.qr = self._solver(device).compute(self.mat)
        self.S = self.operand(rng, 5)

    def _solver(self, device):
        if self.kind == "banded":
            return qt.BandedBlockedQR(suggested_block_cols=4, device=device)
        return qt.SegmentedBandedQR(suggested_block_cols=4, segment_blocks=8, fallback=False,
                                    device=device)

    def operand(self, rng, per_col):
        r_, c_, v_ = [], [], []
        for j in range(6):
            r_.extend(rng.choice(self.mat.nrows, size=per_col, replace=False))
            c_.extend([j] * per_col)
            v_.extend(rng.normal(size=per_col))
        return qt.SparseCSR.from_triplets(r_, c_, v_, (self.mat.nrows, 6))

    def call(self, k):
        return getattr(self.qr, self.method)(scaled(self.S, 1.0 + k))

    def read(self, out):
        return out

    def equal(self, a, b):
        return all(np.array_equal(x, y) for x, y in
                   ((a.indptr, b.indptr), (a.indices, b.indices), (a.data, b.data)))

    def change(self, rng):
        self.S = self.operand(rng, 7)

    def program_names(self):
        return [k[0] for k in self.qr._programs.programs() if k[0].endswith("_sparse")]

    def kernels(self):
        """K1 once a chain: the plain chain's Q product, or the segments'
        and the boundary chain's."""
        if not self.qr._scan_kernel:
            return {}
        return {"chain_two_seg": 1 if self.kind == "banded" else 2}

    def check_reference(self, got, k):
        from qrkit_tpu.solvers import BandedBlockedQR as JBanded
        from qrkit_tpu.solvers import SegmentedBandedQR as JSegmented

        if self.kind == "banded":
            jq = JBanded(suggested_block_cols=4, use_pallas=False)
        else:
            jq = JSegmented(suggested_block_cols=4, segment_blocks=8, fallback=False, use_pallas=False)
        S = scaled(self.S, 1.0 + k)
        want = getattr(jq.compute(_j(self.mat)), self.method)(_j(S))
        dense = getattr(self.qr, self.method.replace("_sparse", ""))(
            torch.as_tensor(S.to_dense(), device=self.qr.device))
        np.testing.assert_allclose(got.to_dense(), _np(dense), **TOL)
        if self.geom == "uniform":
            import jax.numpy as jnp

            n = self.mat.ncols
            sign = np.sign(_np(self.qr.r_diagonal()) * np.asarray(jq.r_diagonal()))[:, None]
            if self.method == "apply_qt_sparse":  # Q1ᵀS: its rows up to R's row signs
                np.testing.assert_allclose(sign * got.to_dense()[:n], want.to_dense()[:n], **TOL)
            else:  # qrkit_tpu's Q1ᵀ takes QS back to S's top rows, up to R's row signs
                back = np.asarray(jq.apply_qt(jnp.asarray(got.to_dense())))
                np.testing.assert_allclose(back[:n], sign * S.to_dense()[:n], **TOL)
            return
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, **TOL)

    def info(self):
        return self.qr.info()


class ThinCompute:
    """``BlockedThinSparseQR.compute`` on the reference test's 112 × 32."""

    programs, budget, card_reads = 1, 9, 0

    def __init__(self, rng, device):
        self.mat = overlapping_matrix(32, 112, rng)
        self.qr = qt.BlockedThinSparseQR(suggested_block_cols=2, device=device)
        self.b = rng.normal(size=self.mat.nrows)

    def call(self, k):
        return self.qr.compute(scaled(self.mat, 1.0 + 0.5 * k))

    def read(self, qr):
        return _flat(qr._R, qr.q_seq.Y, qr.q_seq.T, qr._lperms)

    def equal(self, a, b):
        return np.array_equal(a, b)

    def change(self, rng):
        dense = self.mat.to_dense()
        dense[rng.random(dense.shape) < 0.1] = 0.0
        dense[np.arange(32), np.arange(32)] = rng.uniform(0.5, 5.0, size=32)
        self.mat = qt.SparseCSR.from_dense(dense)

    def program_names(self):
        return [k[0] for k in self.qr._programs.programs()]

    def kernels(self):
        return {}

    def check_reference(self, got, k):
        from qrkit_tpu.solvers import BlockedThinSparseQR as JThin

        mat = scaled(self.mat, 1.0 + 0.5 * k)
        jq = JThin(suggested_block_cols=2).compute(_j(mat))
        np.testing.assert_allclose(_np(self.qr.matrix_r_dense()), np.asarray(jq.matrix_r_dense()), **TOL)
        np.testing.assert_array_equal(self.qr.cols_permutation().indices, jq.cols_permutation().indices)
        pb = self.qr.rows_permutation().apply(self.b)
        np.testing.assert_allclose(_np(self.qr.solve(torch.as_tensor(pb, device=self.qr.device))),
                                   np.asarray(jq.solve(pb)), **TOL)
        assert self.qr.rank == jq.rank == 32

    def info(self):
        return self.qr.info()


class AngularRecompute:
    """``BlockAngularQR.compute`` with a sparse A2 on a banded left (the
    reference test's ``block_angular_matrix(96, 5, 336)``, 40% of the
    dense right kept) or a block-diagonal left in its kernel tier (3×1
    blocks, a 2-row tail), ``DenseColPivQR`` right."""

    programs, budget, card_reads = 2, 6, 0

    def __init__(self, left, rng, device):
        self.left_kind, self.device = left, device
        if left == "banded":
            am = block_angular_matrix(96, 5, 336, rng)
            self.left_m = am.slice_cols(0, 96)
            dense_r = am.hstack_dense_block(96, 5)
            self.keep = 0.4
            left_solver = qt.BandedBlockedQR(suggested_block_cols=4, device=device)
        else:
            nb, tail = 40, 2
            self.blocks = rng.uniform(0.5, 5.0, size=(nb, 3, 1))
            self.left_m = qt.BlockDiagonal(torch.as_tensor(self.blocks, device=device), 3 * nb + tail, nb)
            dense_r = rng.normal(size=(3 * nb + tail, 6))
            self.keep = 0.15
            left_solver = qt.BlockDiagonalQR(pivot=False, use_kernel=True)
        self.dense_r = dense_r
        self.a2 = self.sparsify(rng)
        self.qr = qt.BlockAngularQR(left_solver, qt.DenseColPivQR())
        self.b = rng.normal(size=dense_r.shape[0])

    def sparsify(self, rng):
        d = np.where(rng.random(self.dense_r.shape) < self.keep, self.dense_r, 0.0)
        d[np.arange(d.shape[1]), np.arange(d.shape[1])] = 1.0  # no empty column
        return qt.SparseCSR.from_dense(d)

    def call(self, k):
        return self.qr.compute(qt.BlockMatrix1x2(self.left_m, scaled(self.a2, 1.0 + 0.7 * k)))

    def read(self, qr):
        """What the compute left: R's diagonal, R12 and the right factors
        (the solve over them has its own program and tests)."""
        rows, cols, vals = qr._r12_coo
        inner = qr.right.inner
        return _flat(qr.r_diagonal(), cols, vals, inner._R, inner._Y, inner._perm_dev)

    def equal(self, a, b):
        return np.array_equal(a, b)

    def change(self, rng):
        self.a2 = self.sparsify(rng)

    def program_names(self):
        return [k[0] for k in self.qr._programs.programs()]

    def kernels(self):
        if self.left_kind == "banded":  # its refactorize, then Q1ᵀ A2 (K1)
            left = self.qr.left
            return {**({"banded_chain_qr": 1} if left._fac_kernel else {}),
                    **({"chain_two_seg": 1} if left._scan_kernel else {})}
        return {"blockdiag_qr_r": 1} if self.qr.left._kernel_mode else {}

    def check_reference(self, got, k):
        import jax.numpy as jnp

        from qrkit_tpu.containers import BlockDiagonal as JBlockDiagonal
        from qrkit_tpu.containers import BlockMatrix1x2 as JMatrix
        from qrkit_tpu.solvers import BandedBlockedQR as JBanded
        from qrkit_tpu.solvers import BlockAngularQR as JAngular
        from qrkit_tpu.solvers import BlockDiagonalQR as JBlockDiagonalQR
        from qrkit_tpu.solvers import DenseColPivQR as JColPiv

        a2 = _j(scaled(self.a2, 1.0 + 0.7 * k))
        if self.left_kind == "banded":
            jq = JAngular(JBanded(suggested_block_cols=4, use_pallas=False), JColPiv())
            left = _j(self.left_m)
        else:
            jq = JAngular(JBlockDiagonalQR(pivot=False), JColPiv())
            left = JBlockDiagonal(jnp.asarray(self.blocks), self.left_m.nrows, self.left_m.ncols)
        jq.compute(JMatrix(left, a2))
        qr = self.qr
        np.testing.assert_array_equal(qr.rows_permutation().indices, jq.rows_permutation().indices)
        np.testing.assert_array_equal(qr.cols_permutation().indices, jq.cols_permutation().indices)
        np.testing.assert_allclose(np.abs(_np(qr.r_diagonal())), np.abs(np.asarray(jq.r_diagonal())),
                                   **TOL)
        pb = qr.rows_permutation().apply(self.b)
        np.testing.assert_allclose(_np(qr.solve(torch.as_tensor(pb, device=qr.r_diagonal().device))),
                                   np.asarray(jq.solve(jnp.asarray(pb))), **TOL)

    def info(self):
        return self.qr.info()


PATHS = {
    f"{kind}_{method}_{geom}": (lambda rng, dev, kind=kind, method=method, geom=geom:
                                SparseProduct(kind, method, geom, rng, dev))
    for kind in ("banded", "segmented")
    for method in ("apply_qt_sparse", "apply_q_sparse")
    for geom in GEOMETRIES
}
PATHS.update({
    "thin_compute": ThinCompute,
    "angular_banded_left": lambda rng, dev: AngularRecompute("banded", rng, dev),
    "angular_blockdiag_left": lambda rng, dev: AngularRecompute("blockdiag", rng, dev),
})


def _counted(d) -> int:
    """The reference's count: every op, replay and host-issued launch, a
    fetch to the host (a copy, not a launch) left out."""
    return d.count - d.host_reads


def _warm(p):
    """The warm-up calls, then the counted one: (its result, the count)."""
    for k in range(WARM):
        p.call(k)
    with qt.count_dispatches() as d:
        out = p.call(WARM)
    return p.read(out), d


def test_block_angular_matrix_matches_generators():
    """The matrix built here is the reference test's."""
    from generators import block_angular_matrix as reference

    mine = block_angular_matrix(96, 5, 336, np.random.default_rng(3))
    theirs = reference(96, 5, 336, np.random.default_rng(3))
    np.testing.assert_array_equal(mine.to_dense(), theirs.to_dense())


@pytest.mark.parametrize("path", list(PATHS))
def test_warm_call_budget_and_agreement(path, recording):
    """A warm same-pattern call within the reference's pin, no host read
    and no host-issued launch; bitwise equal to the eager call; within
    fp64 rtol 1e-10 of qrkit_tpu."""
    p = PATHS[path](np.random.default_rng(0), DEV)
    out, d = _warm(p)
    assert d.programs == p.programs, (path, d)
    assert _counted(d) <= p.budget and d.host_reads == 0, (path, d)
    assert not any(d.host_launches.values()), d.host_launches
    with _program.eager():
        eager = p.read(p.call(WARM))
    assert p.equal(out, eager), path
    assert p.info() == qt.ComputationInfo.SUCCESS
    p.check_reference(out, WARM)


@pytest.mark.parametrize("path", list(PATHS))
def test_changed_pattern_recaptures(path, recording):
    """A new pattern after the warm calls builds new maps, runs eagerly
    once, captures again and replays; the old pattern's program is gone,
    and every call equals the eager call on the new pattern (which the
    warm test holds to qrkit_tpu)."""
    rng = np.random.default_rng(1)
    p = PATHS[path](rng, DEV)
    _warm(p)
    names = sorted(p.program_names())
    p.change(rng)
    outs = [p.read(p.call(k)) for k in range(WARM + 1)]
    assert sorted(p.program_names()) == names, (path, p.program_names())
    with _program.eager():
        want = [p.read(p.call(k)) for k in range(WARM + 1)]
    assert all(p.equal(o, w) for o, w in zip(outs, want)), path


def test_thin_pivots_stay_on_the_device(recording):
    """The thin compute fetches nothing; the column permutation, the rank
    and the deficient columns read the pivots at their first use and are
    reset by the next compute."""
    p = ThinCompute(np.random.default_rng(2), DEV)
    p.call(0)
    assert p.qr._out_col_perm is None and p.qr._deficiency_cache is None
    perm = p.qr.cols_permutation()
    assert p.qr._out_col_perm is perm and p.qr.rank == 32 and not p.qr.deficient_cols().size
    p.call(1)
    assert p.qr._out_col_perm is None and p.qr._deficiency_cache is None
    np.testing.assert_array_equal(p.qr.cols_permutation().indices, perm.indices)


def test_nested_compute_runs_inline(recording):
    """The right solver's compute inside the sparse-A2 program runs inline
    (no program of its own), and its factors are the outer program's
    outputs: a later recompute overwrites them in place."""
    p = AngularRecompute("banded", np.random.default_rng(4), DEV)
    for k in range(WARM + 1):
        p.call(k)
    inner = p.qr.right.inner
    assert not inner._programs.programs()
    (prog,) = [q for key, q in p.qr._programs.programs().items()
               if key[0] == "BlockAngularQR.sparse_a2_chunked"]
    assert any(t is inner._R for t in prog.out) and any(t is inner._perm_dev for t in prog.out)
    r = inner._R
    p.call(WARM + 1)
    assert p.qr.right.inner._R is r


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_cuda_warm_budget_and_bitwise(path, cuda_device):
    """On the card: the warm call within its pin, its one host read (the
    sparse products' fetch) or none, no host-issued launch, the replays'
    launches counted; bitwise equal to the eager call."""
    p = PATHS[path](np.random.default_rng(0), cuda_device)
    out, d = _warm(p)
    torch.cuda.synchronize()
    assert d.programs == p.programs and _counted(d) <= p.budget, (path, d)
    assert d.host_reads == p.card_reads, (path, d)
    assert not any(d.host_launches.values()), d.host_launches
    assert {k: v for k, v in d.launches.items() if v} == p.kernels(), d.launches
    with _program.eager():
        eager = p.read(p.call(WARM))
    assert p.equal(out, eager) and p.equal(p.read(p.call(WARM)), eager), path
    assert p.info() == qt.ComputationInfo.SUCCESS
