"""The one-program contract of tests/test_dispatch_count.py, in the port:
each refactorize and solve that qrkit_tpu runs as one jitted program is
one captured program (``qrkit_tpu_torch._program``), at the reference
test's sizes.

On the CPU the calls run eagerly (the caller asked for the CPU), so the
bookkeeping is driven through :class:`Recording`, a test-only capture
backend: its capture runs the function once on the program's static
inputs and raises on what a capture on the card refuses (a host read, an
op whose output size depends on device data); its replay runs the function
again on the same static buffers and writes the results into the same
static outputs, so an output handed out without its clone, or a graph
reading other tensors than the ones it was captured with, shows.  Results
are held against qrkit_tpu's (XLA path) at fp64 rtol 1e-10, eagerly and
through a program, and a program's result equals the eager one bitwise
(the same ops on the same data).

The ``cuda`` cases hold each path to its budget on the card (one replay,
at most 3 ATen ops, no host-issued launch, no host read per warm call, the
launches attributed to the replay) and its replay bitwise equal to the same
call under ``_program.eager()``.  JAX is imported inside the helpers and
the matrices are built here, so they run on a GPU machine without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_dispatch_count.py``.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import _program, functional, profiling
from qrkit_tpu_torch.solvers import banded_blocked, segmented_factorize

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA
TOL = dict(rtol=1e-10, atol=1e-11)
BUDGET_OPS = 3  # copy in, clone out, one view
aten = torch.ops.aten
_SYNCS = {
    aten._local_scalar_dense.default, aten.nonzero.default, aten.masked_select.default,
    aten._unique2.default, aten.unique_consecutive.default, aten.unique_dim.default,
    aten.repeat_interleave.Tensor,
}
_INDEXING = {aten.index.Tensor, aten.index_put.default, aten.index_put_.default,
             aten._index_put_impl_.default}


class _NoHostSync(TorchDispatchMode):
    """Raises on an op that makes the host wait for the device: a capture on
    the card refuses it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bool_index = func in _INDEXING and any(
            isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in args[1] if t is not None
        )
        if func in _SYNCS or bool_index:
            raise RuntimeError(f"host synchronization during capture: {func}")
        return func(*args, **(kwargs or {}))


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


class Recording:
    """Test-only capture backend (``_program._use_backend``): see the module
    docstring."""

    def __init__(self, fn, static_in, pool, stream):
        self.fn, self.static_in = fn, static_in
        with _NoHostSync():
            self.out = fn(*static_in)

    def replay(self):
        saved, issued = profiling.launch_counts(), profiling.collective_counts()
        with _disable_current_modes():
            for s, n in zip(_tuple(self.out), _tuple(self.fn(*self.static_in))):
                if s is not None and s is not n:
                    s.copy_(n)
        profiling._set_launch_counts(saved)  # the program adds what its capture issued
        profiling._set_collective_counts(issued)


@pytest.fixture
def recording():
    with _program._use_backend(Recording):
        yield


# --- the reference test's matrices, built here (no qrkit_tpu import) ----------
def overlapping_matrix(num_params, num_residuals, rng):
    """``generators.overlapping_block_diagonal_matrix(..., permute_rows=False)``."""
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
    return qt.SparseCSR.from_triplets(rows, cols, vals, (num_residuals, num_params))


def tall_banded(nb, rng, br, bc, ov):
    """``generators.tall_banded_matrix``."""
    step = bc - ov
    ncols = step * nb + ov
    i, r, c = np.meshgrid(np.arange(nb), np.arange(br), np.arange(bc), indexing="ij")
    rows, cols = (i * br + r).ravel(), (i * step + c).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return qt.SparseCSR.from_triplets(rows[keep], cols[keep], vals[keep], (br * nb, ncols))


GEOMETRIES = {
    "uniform": lambda rng: overlapping_matrix(96, 336, rng),
    "tallblock_p2w": lambda rng: tall_banded(32, rng, br=10, bc=4, ov=2),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- the captured paths ----------------------------------------------------------
# Each path: (setup(rng, device) -> state, calls(state) -> [(label, call,
# read)], reference(state) -> {label: value}).  ``call()`` is the counted
# call; ``read(out)`` the tensor it is held to (a factorize: the R diagonal
# of the factors it left; a banded one's magnitude, since a row of R is
# fixed only up to its sign where the overlapping fixture's overlap columns
# are rank deficient and their pivots roundoff).


def _banded_setup(kind, geom):
    def setup(rng, device):
        mat = GEOMETRIES[geom](rng)
        if kind == "banded":
            qr = qt.BandedBlockedQR(suggested_block_cols=4, device=device)
        else:
            qr = qt.SegmentedBandedQR(suggested_block_cols=4, segment_blocks=8, fallback=False,
                                      device=device)
        qr.analyze_pattern(mat)
        qr.use_kernel = True if _gate(qr) else "auto"
        qr.compute(mat)
        v = torch.as_tensor(mat.data * 1.000001, device=device)
        b = torch.as_tensor(rng.normal(size=mat.nrows), device=device)
        B = torch.as_tensor(rng.normal(size=(mat.nrows, 3)), device=device)
        n = mat.ncols
        # Q's operands: on the uniform fixture only Q's first n columns are
        # fixed (up to R's row signs), so Q is applied to rows past n zeroed
        qb, qB = (x.clone() for x in (b, B))
        if geom == "uniform":
            qb[n:], qB[n:] = 0.0, 0.0
        return dict(mat=mat, qr=qr, v=v, b=b, B=B, qb=qb, qB=qB, y=b[:n], Y=B[:n], n=n,
                    kind=kind, geom=geom)
    return setup


def _gate(qr) -> bool:
    """The kernel gate of a banded solver's plan (its kernels' plain versions
    run on the CPU under ``use_kernel=True``)."""
    if isinstance(qr, qt.BandedBlockedQR):
        return qr._chain_kernel is not None
    return qr._kernel_gate


def _kernels(qr):
    """The kernels one factorize of a banded solver launches, by name."""
    if isinstance(qr, qt.BandedBlockedQR):
        return {"banded_chain_qr": 1} if qr._fac_kernel else {}
    gates = (("banded_segment_chains", qr._fac_kernel),
             ("banded_apply_w", qr._fac_kernel and qr._p2w is not None),
             ("banded_chain_qr", qr._fac_kernel and qr._chain_kernel is not None))
    return {name: 1 for name, on in gates if on}


def _same(out):
    return out


def _banded_calls(st):
    qr, n = st["qr"], st["n"]
    # Qᵀ's rows past n are Q's complement, fixed only up to a rotation on
    # the uniform fixture
    top = (lambda out: out[:n]) if st["geom"] == "uniform" else _same
    return [
        ("factorize_values", lambda: qr.factorize_values(st["v"]), lambda _: qr.r_diagonal().abs()),
        ("solve", lambda: qr.solve(st["b"]), _same),
        ("solve_k3", lambda: qr.solve(st["B"]), _same),
        ("apply_qt", lambda: qr.apply_qt(st["b"]), top),
        ("apply_qt_k3", lambda: qr.apply_qt(st["B"]), top),
        ("apply_q", lambda: qr.apply_q(st["qb"]), _same),
        ("apply_q_k3", lambda: qr.apply_q(st["qB"]), _same),
        ("solve_r", lambda: qr.solve_r(st["y"]), _same),
        ("solve_r_k3", lambda: qr.solve_r(st["Y"]), _same),
    ]


def _banded_reference(st):
    """qrkit_tpu's values of every call, R's row signs taken into the
    port's: with ``D = sign(diag R_port · diag R_ref)``, ``Qᵀb`` is ``D``
    times the reference's on its first n rows, ``Q x`` the reference's
    ``Q (D x)`` and ``R⁻¹ y`` the reference's ``R⁻¹ (D y)``."""
    import jax
    import jax.numpy as jnp

    from qrkit_tpu.solvers import BandedBlockedQR as JBanded
    from qrkit_tpu.solvers import SegmentedBandedQR as JSegmented
    from qrkit_tpu.sparse import SparseCSR as JSparse

    m, n = st["mat"], st["n"]
    jm = JSparse(m.shape, m.indptr, m.indices, m.data)
    if st["kind"] == "banded":
        jq = JBanded(suggested_block_cols=4, use_pallas=False)
    else:
        jq = JSegmented(suggested_block_cols=4, segment_blocks=8, fallback=False, use_pallas=False)
    jq.compute(jm)
    jq.factorize_values(jnp.asarray(_np(st["v"])))
    with _program.eager():  # the port's factors of v, whose row signs the calls see
        st["qr"].factorize_values(st["v"])
    sign = np.sign(_np(st["qr"].r_diagonal()) * np.asarray(jq.r_diagonal()))

    def signed(x):  # D on the first n rows
        x = np.array(_np(x), dtype=np.float64)
        x[:n] *= sign.reshape((n,) + (1,) * (x.ndim - 1))
        return x

    def qt_rows(x):
        out = signed(jq.apply_qt(jnp.asarray(_np(x))))
        return out[:n] if st["geom"] == "uniform" else out

    return {
        "factorize_values": abs(jq.r_diagonal()),
        "solve": jq.solve(jnp.asarray(_np(st["b"]))),
        "solve_k3": jq.solve(jnp.asarray(_np(st["B"]))),
        "apply_qt": qt_rows(st["b"]),
        "apply_qt_k3": qt_rows(st["B"]),
        "apply_q": jq.apply_q(jnp.asarray(signed(st["qb"]))),
        "apply_q_k3": jq.apply_q(jnp.asarray(signed(st["qB"]))),
        "solve_r": jq.solve_r(jnp.asarray(signed(st["y"]))),
        # qrkit_tpu's solve_r takes a vector: its columns, as its
        # BlockAngularQR.solve maps them
        "solve_r_k3": jax.vmap(jq.solve_r, in_axes=1, out_axes=1)(jnp.asarray(signed(st["Y"]))),
    }


def _dense_setup(rng, device):
    a = torch.as_tensor(rng.normal(size=(24, 8)), device=device)
    return dict(a=a, qrs=(qt.DenseHouseholderQR(), qt.DenseColPivQR()))


def _dense_calls(st):
    return [(type(qr).__name__, lambda qr=qr: qr.compute(st["a"]), lambda qr: qr.matrix_r_dense())
            for qr in st["qrs"]]


def _dense_reference(st):
    import jax.numpy as jnp

    from qrkit_tpu.solvers import DenseColPivQR as JColPiv
    from qrkit_tpu.solvers import DenseHouseholderQR as JHouse

    a = jnp.asarray(_np(st["a"]))
    return {name: cls().compute(a).matrix_r_dense()
            for name, cls in (("DenseHouseholderQR", JHouse), ("DenseColPivQR", JColPiv))}


def _blockdiag_setup(rng, device):
    blocks = torch.as_tensor(rng.uniform(0.5, 5.0, size=(512, 7, 2)), device=device)
    b = torch.as_tensor(rng.normal(size=512 * 7), device=device)
    mat = qt.BlockDiagonal(blocks, 512 * 7, 512 * 2)
    return dict(blocks=blocks, b=b, mat=mat, qr=qt.BlockDiagonalQR(pivot=False, use_kernel=True))


def _blockdiag_calls(st):
    qr = st["qr"]
    return [
        ("compute", lambda: qr.compute(st["mat"]), lambda _: qr.r_diagonal()),
        ("solve", lambda: qr.solve(st["b"]), _same),
        ("lstsq", lambda: functional.block_diagonal_lstsq(st["blocks"], st["b"]), _same),
    ]


def _blockdiag_reference(st):
    import jax.numpy as jnp

    from qrkit_tpu import functional as jfunctional
    from qrkit_tpu.containers import BlockDiagonal as JBlockDiagonal
    from qrkit_tpu.solvers import BlockDiagonalQR as JBlockDiagonalQR

    blocks, b = jnp.asarray(_np(st["blocks"])), jnp.asarray(_np(st["b"]))
    jq = JBlockDiagonalQR(pivot=False).compute(JBlockDiagonal(blocks, 512 * 7, 512 * 2))
    return {"compute": jq.r_diagonal(), "solve": jq.solve(b),
            "lstsq": jfunctional.block_diagonal_lstsq(blocks, b)}


def _angular_setup(rng, device):
    N, m2 = 64, 5
    blocks = torch.as_tensor(rng.normal(size=(N, 2, 1)), device=device)
    a2 = torch.as_tensor(rng.normal(size=(N * 2, m2)), device=device)
    b = torch.as_tensor(rng.normal(size=N * 2), device=device)
    qr = qt.BlockAngularQR(qt.BlockDiagonalQR(qt.QFormat.FULL_Q, pivot=False), qt.DenseColPivQR())
    return dict(blocks=blocks, a2=a2, b=b, qr=qr,
                mat=qt.BlockMatrix1x2(qt.BlockDiagonal(blocks, N * 2, N), a2))


def _angular_calls(st):
    qr = st["qr"]
    return [
        ("compute", lambda: qr.compute(st["mat"]), lambda _: qr.r_diagonal()),
        ("solve", lambda: qr.solve(st["b"]), _same),
    ]


def _angular_reference(st):
    import jax.numpy as jnp

    from qrkit_tpu.containers import BlockDiagonal as JBlockDiagonal
    from qrkit_tpu.containers import BlockMatrix1x2 as JBlockMatrix1x2
    from qrkit_tpu.solvers import BlockAngularQR as JBlockAngularQR
    from qrkit_tpu.solvers import BlockDiagonalQR as JBlockDiagonalQR
    from qrkit_tpu.solvers import DenseColPivQR as JColPiv
    from qrkit_tpu.solvers.block_diagonal import QFormat as JQFormat

    blk = JBlockDiagonal(jnp.asarray(_np(st["blocks"])), 128, 64)
    jq = JBlockAngularQR(JBlockDiagonalQR(JQFormat.FULL_Q, pivot=False), JColPiv())
    jq.compute(JBlockMatrix1x2(blk, jnp.asarray(_np(st["a2"]))))
    return {"compute": jq.r_diagonal(), "solve": jq.solve(jnp.asarray(_np(st["b"])))}


def _angular_banded_setup(rng, device):
    """``BlockAngularQR(BandedBlockedQR, DenseColPivQR)`` on the uniform
    fixture with a sparse 5-column A2 (40% kept), computed three times: the
    left's factorize program and the sparse-A2 program are captured, so
    the generic solve reads program outputs."""
    left = overlapping_matrix(96, 336, rng)
    dense = np.where(rng.random((336, 5)) < 0.4, rng.normal(size=(336, 5)), 0.0)
    dense[np.arange(5), np.arange(5)] = 1.0  # no empty column
    a2 = qt.SparseCSR.from_dense(dense)
    qr = qt.BlockAngularQR(qt.BandedBlockedQR(suggested_block_cols=4, device=device),
                           qt.DenseColPivQR())
    mat = qt.BlockMatrix1x2(left, a2)
    for _ in range(3):
        qr.compute(mat)
    b = torch.as_tensor(rng.normal(size=336), device=device)
    B = torch.as_tensor(rng.normal(size=(336, 3)), device=device)
    return dict(left=left, a2=a2, qr=qr, b=b, B=B)


def _angular_banded_calls(st):
    qr = st["qr"]
    return [("solve", lambda: qr.solve(st["b"]), _same),
            ("solve_k3", lambda: qr.solve(st["B"]), _same)]


def _angular_banded_reference(st):
    import jax.numpy as jnp

    from qrkit_tpu.containers import BlockMatrix1x2 as JBlockMatrix1x2
    from qrkit_tpu.solvers import BandedBlockedQR as JBanded
    from qrkit_tpu.solvers import BlockAngularQR as JBlockAngularQR
    from qrkit_tpu.solvers import DenseColPivQR as JColPiv
    from qrkit_tpu.sparse import SparseCSR as JSparse

    j = lambda m: JSparse(m.shape, m.indptr, m.indices, m.data)  # noqa: E731
    jq = JBlockAngularQR(JBanded(suggested_block_cols=4, use_pallas=False), JColPiv())
    jq.compute(JBlockMatrix1x2(j(st["left"]), j(st["a2"])))
    return {"solve": jq.solve(jnp.asarray(_np(st["b"]))),
            "solve_k3": jq.solve(jnp.asarray(_np(st["B"])))}


def _tsqr_setup(rng, device):
    """``TSQRDenseQR`` with 4 shards, no mesh: its factorize, Q products and
    back-substitution are programs (the reference's jitted
    ``tsqr_factorize`` / ``tsqr_apply``)."""
    a = torch.as_tensor(rng.normal(size=(67, 6)), device=device)
    v = torch.as_tensor(rng.normal(size=67), device=device)
    return dict(a=a, v=v, qr=qt.parallel.TSQRDenseQR(4))


def _tsqr_calls(st):
    qr, v = st["qr"], st["v"]
    return [
        ("compute", lambda: qr.compute(st["a"]), lambda _: qr.matrix_r_dense()),
        ("apply_qt", lambda: qr.apply_qt(v), _same),
        ("apply_q", lambda: qr.apply_q(v), _same),
        ("solve_r", lambda: qr.solve_r(v[:6]), _same),
    ]


def _tsqr_reference(st):
    import jax.numpy as jnp

    from qrkit_tpu.parallel import TSQRDenseQR as JTSQR

    jq = JTSQR(n_shards=4).compute(jnp.asarray(_np(st["a"])))
    v = jnp.asarray(_np(st["v"]))
    return {"compute": jq.matrix_r_dense(), "apply_qt": jq.apply_qt(v), "apply_q": jq.apply_q(v),
            "solve_r": jq.solve_r(v[:6])}


PATHS = {
    "banded_uniform": (_banded_setup("banded", "uniform"), _banded_calls, _banded_reference),
    "banded_tallblock_p2w": (_banded_setup("banded", "tallblock_p2w"), _banded_calls,
                             _banded_reference),
    "segmented_uniform": (_banded_setup("segmented", "uniform"), _banded_calls, _banded_reference),
    "segmented_tallblock_p2w": (_banded_setup("segmented", "tallblock_p2w"), _banded_calls,
                                _banded_reference),
    "dense_24x8": (_dense_setup, _dense_calls, _dense_reference),
    "block_diagonal_512x7x2": (_blockdiag_setup, _blockdiag_calls, _blockdiag_reference),
    "block_angular_fused_dense": (_angular_setup, _angular_calls, _angular_reference),
    "block_angular_banded_left": (_angular_banded_setup, _angular_banded_calls,
                                  _angular_banded_reference),
    "tsqr_67x6_4_shards": (_tsqr_setup, _tsqr_calls, _tsqr_reference),
}


def _warm(call, read):
    """Two calls (the first runs eagerly, the second captures), then the
    first replay, counted; returns (what it is held to, the count)."""
    call()
    call()
    with qt.count_dispatches() as d:
        out = call()
    return read(out), d


def _solvers(st):
    return st["qrs"] if "qrs" in st else (st["qr"],)


def test_matrices_match_generators():
    """The matrices built here are the reference test's."""
    from generators import overlapping_block_diagonal_matrix, tall_banded_matrix

    for mine, theirs in (
        (overlapping_matrix(96, 336, np.random.default_rng(3)),
         overlapping_block_diagonal_matrix(96, 336, np.random.default_rng(3), permute_rows=False)),
        (tall_banded(32, np.random.default_rng(4), br=10, bc=4, ov=2),
         tall_banded_matrix(32, np.random.default_rng(4), br=10, bc=4, ov=2)),
    ):
        np.testing.assert_array_equal(mine.to_dense(), theirs.to_dense())


@pytest.mark.parametrize("path", list(PATHS))
def test_captured_call_budget_and_agreement(path, recording):
    """Every warm call of a captured path: one program, at most 3 ATen ops,
    no host read; its result equals the eager call's bitwise and agrees
    with qrkit_tpu at fp64 rtol 1e-10."""
    setup, calls, reference = PATHS[path]
    st = setup(np.random.default_rng(0), DEV)
    if path.startswith(("banded", "segmented")):
        assert st["qr"]._fac_kernel, "the kernel route (plain versions on the CPU)"
        if path == "segmented_tallblock_p2w":
            assert st["qr"]._p2w is not None, "the fused W-apply gate must fire here"
    ref = reference(st)
    for label, call, read in calls(st):
        out, d = _warm(call, read)
        assert d.programs == 1 and d.ops <= BUDGET_OPS and d.host_reads == 0, (label, d)
        assert not any(d.host_launches.values()), (label, d.host_launches)
        with _program.eager():
            eager = read(call())
        assert torch.equal(out, eager), label
        np.testing.assert_allclose(_np(out), _np(ref[label]), **TOL, err_msg=label)
    for qr in _solvers(st):
        assert qr.info() == qt.ComputationInfo.SUCCESS


def test_cpu_calls_run_eagerly():
    """Without a capture backend the CPU runs every call eagerly: no program
    is cached and the warm call is its plain ops."""
    st = _banded_setup("segmented", "uniform")(np.random.default_rng(1), DEV)
    qr = st["qr"]
    qr.solve(st["b"])
    with qt.count_dispatches() as d:
        qr.solve(st["b"])
    assert d.programs == 0 and d.ops > BUDGET_OPS and not qr._programs.programs()


def test_solve_output_is_a_fresh_tensor(recording):
    """``|x − x_warm| == 0`` after a second solve (test_dispatch_count.py),
    and x_warm survives a solve of another rhs: each replay's output is a
    clone, never the program's static output."""
    st = _banded_setup("banded", "uniform")(np.random.default_rng(2), DEV)
    qr, b = st["qr"], st["b"]
    qr.solve(b)  # eager
    qr.solve(b)  # the capture
    x_warm = qr.solve(b)
    x = qr.solve(b)
    assert (x - x_warm).abs().max() == 0
    kept = x.clone()
    qr.solve(b * 3.0)
    assert torch.equal(x, kept)


def test_factorize_values_replay_equals_fresh_compute(recording):
    """A refactorize replay writes the new factors into the same tensors,
    and a solve captured against the old values reads them: both equal a
    fresh solver's compute on the scaled matrix."""
    for kind in ("banded", "segmented"):
        st = _banded_setup(kind, "tallblock_p2w")(np.random.default_rng(3), DEV)
        qr, mat, b = st["qr"], st["mat"], st["b"]
        qr.factorize_values(st["v"])  # the capture (compute ran the first call)
        qr.solve(b)
        qr.solve(b)  # captured against the factors of v
        scaled = torch.as_tensor(mat.data * 1.5)
        qr.factorize_values(scaled)  # first replay of the factorize program
        panels = qr._r_panels.data_ptr()
        qr.factorize_values(scaled)
        assert qr._r_panels.data_ptr() == panels
        fresh = _banded_setup(kind, "tallblock_p2w")(np.random.default_rng(3), DEV)["qr"]
        fresh.compute(qt.SparseCSR(mat.shape, mat.indptr, mat.indices, mat.data * 1.5))
        assert torch.equal(qr.r_diagonal(), fresh.r_diagonal()), kind
        assert torch.equal(qr.solve(b), fresh.solve(b)), kind
        assert qr.info() == qt.ComputationInfo.SUCCESS


def test_new_keys_recapture(recording):
    """A new rhs shape, a new pattern and a new dtype each capture their own
    program; an eager factorization drops the solve programs."""
    st = _banded_setup("banded", "uniform")(np.random.default_rng(4), DEV)
    qr = st["qr"]
    names = lambda: sorted(k[0] for k in qr._programs.programs())  # noqa: E731
    qr.factorize_values(st["v"])
    for rhs in (st["b"], st["b"], st["B"], st["B"]):
        qr.solve(rhs)
    assert names() == ["BandedBlockedQR.factorize", "BandedBlockedQR.solve",
                       "BandedBlockedQR.solve"]
    # a new pattern: new layout maps, a new factorize program, the solves dropped
    other = tall_banded(40, np.random.default_rng(5), br=7, bc=4, ov=2)
    qr.compute(other, force_pattern_analysis=True)
    assert names() == ["BandedBlockedQR.factorize"]
    qr.compute(other)
    assert names() == ["BandedBlockedQR.factorize", "BandedBlockedQR.factorize"]
    with _program.eager():
        qr.compute(other)
    assert names() == ["BandedBlockedQR.factorize", "BandedBlockedQR.factorize"]
    # a new dtype: the block-diagonal compute keyed by its operand
    bd = qt.BlockDiagonalQR(pivot=False, use_kernel=True)
    blocks = np.random.default_rng(6).uniform(0.5, 5.0, size=(16, 7, 2))
    mats = {dt: qt.BlockDiagonal(torch.as_tensor(blocks, dtype=dt), 112, 32)
            for dt in (torch.float64, torch.float32)}
    for dt in (torch.float64, torch.float32, torch.float64):
        for _ in range(3):
            bd.compute(mats[dt])
            bd.solve(torch.ones(112, dtype=dt))
    progs = bd._programs.programs()
    assert sorted(k[0] for k in progs) == ["BlockDiagonalQR.compute", "BlockDiagonalQR.compute",
                                           "BlockDiagonalQR.solve"]
    assert {k[2][0][2] for k in progs if k[0] == "BlockDiagonalQR.compute"} == {
        torch.float32, torch.float64}


def test_grad_inputs_run_eagerly(recording):
    """A call whose inputs require grad runs eagerly (no program), and its
    gradient is the eager autograd path's."""
    rng = np.random.default_rng(7)
    blocks_np, b_np = rng.uniform(0.5, 5.0, size=(8, 3, 2)), rng.normal(size=24)
    before = len(functional._LSTSQ_PROGRAMS.programs())

    def grads():
        blocks = torch.tensor(blocks_np, requires_grad=True)
        b = torch.tensor(b_np, requires_grad=True)
        (functional.block_diagonal_lstsq(blocks, b) ** 2).sum().backward()
        return blocks.grad, b.grad

    got = grads()
    assert len(functional._LSTSQ_PROGRAMS.programs()) == before
    with _program.eager():
        want = grads()
    for g, w in zip(got, want):
        assert g is not None and torch.equal(g, w)


def test_grad_factors_run_eagerly(recording):
    """A solve against factors that require grad runs eagerly every time
    (its output requires grad), so each call's gradient is its own: the
    block-diagonal kernel tier computed from blocks that require grad,
    three solves of other rhs, each gradient equal to the eager path's.
    The fused dense ``BlockAngularQR`` computed from an A2 that requires
    grad caches no program either (its backward is not differentiable
    eagerly: an in-place op, as before the programs)."""
    rng = np.random.default_rng(9)
    blocks_np = rng.uniform(0.5, 5.0, size=(16, 7, 2))
    rhs = [torch.as_tensor(rng.normal(size=112)) for _ in range(3)]

    def grads():
        blocks = torch.tensor(blocks_np, requires_grad=True)
        qr = qt.BlockDiagonalQR(pivot=False, use_kernel=True)
        qr.compute(qt.BlockDiagonal(blocks, 112, 32))
        assert qr._kernel_mode
        out = [torch.autograd.grad((qr.solve(b) ** 2).sum(), blocks)[0] for b in rhs]
        assert not qr._programs.programs()
        return out

    got = grads()
    with _program.eager():
        want = grads()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], got[1])

    st = _angular_setup(rng, DEV)
    a2 = st["a2"].clone().requires_grad_(True)
    qr = st["qr"]
    qr.compute(qt.BlockMatrix1x2(qt.BlockDiagonal(st["blocks"], 128, 64), a2))
    assert qr._fused_dense
    for _ in range(3):
        assert qr.solve(st["b"]).requires_grad
    assert not qr._programs.programs()


def test_first_call_runs_eagerly(recording):
    """A solver called once captures nothing (``auto_qr``, the CLI, one LM
    iteration's solver); the second call in a row of a key captures.  The
    block-diagonal compute reads its container's operand in place: another
    container runs eagerly until it is computed twice in a row, and its
    program then replaces the first."""
    rng = np.random.default_rng(10)
    st = _blockdiag_setup(rng, DEV)
    qr, mat, b = st["qr"], st["mat"], st["b"]
    qr.compute(mat)
    qr.solve(b)
    assert not qr._programs.programs()
    qr.compute(mat)
    (slot, prog), = qr._programs.programs().items()
    assert prog.addrs == (mat.soa().data_ptr(),) and prog.static_in == (None,)
    other = qt.BlockDiagonal(torch.as_tensor(rng.uniform(0.5, 5.0, size=(512, 7, 2))),
                             512 * 7, 512 * 2)
    for m in (other, mat, other):  # alternating: the other runs eagerly each time
        with qt.count_dispatches() as d:
            qr.compute(m)
        assert d.programs == (m is mat), d
    with qt.count_dispatches() as d:
        qr.compute(other)  # twice in a row: captured, in place of mat's
    assert d.programs == 0
    (slot2, prog2), = qr._programs.programs().items()
    assert slot2 == slot and prog2.addrs == (other.soa().data_ptr(),)
    fresh = qt.BlockDiagonalQR(pivot=False, use_kernel=True).compute(other)
    qr.compute(other)  # a replay
    assert torch.equal(qr.r_diagonal(), fresh.r_diagonal())
    assert torch.equal(qr.solve(b), fresh.solve(b))


def test_lstsq_programs_are_bounded(recording):
    """``functional.block_diagonal_lstsq`` keeps one program a shape and the
    four shapes last captured; ``clear_programs`` drops them all."""
    functional.clear_programs()
    rng = np.random.default_rng(11)
    for nb in range(4, 10):
        blocks = torch.as_tensor(rng.uniform(0.5, 5.0, size=(nb, 3, 2)))
        b = torch.ones(nb * 3, dtype=torch.float64)
        x0 = functional.block_diagonal_lstsq(blocks, b)
        x1 = functional.block_diagonal_lstsq(blocks * 2.0, b)  # a new operand: no new program
        assert torch.equal(x1, x0 / 2.0) or torch.allclose(x1, x0 / 2.0, **TOL)
    progs = functional._LSTSQ_PROGRAMS.programs()
    assert sorted(p[2][0][0][0] for p in progs) == [6, 7, 8, 9]
    functional.clear_programs()
    assert not functional._LSTSQ_PROGRAMS.programs()


def test_exported_factors_survive_a_recompute(recording):
    """The export methods return copies: an R kept from one compute is not
    overwritten by the next replay of the same program on another matrix."""
    rng = np.random.default_rng(12)
    a, a2 = (torch.as_tensor(rng.normal(size=(24, 8))) for _ in range(2))
    for cls in (qt.DenseHouseholderQR, qt.DenseColPivQR):
        qr = cls()
        qr.compute(a)
        qr.compute(a)  # the capture
        kept = qr.matrix_r_dense()
        want = kept.clone()
        with qt.count_dispatches() as d:
            qr.compute(a2)
        assert d.programs == 1 and torch.equal(kept, want)
        assert not torch.equal(qr.matrix_r_dense(), want)
    st = _banded_setup("banded", "tallblock_p2w")(rng, DEV)
    qr = st["qr"]
    qr.factorize_values(st["v"])  # the capture
    kept = qr.r_panels
    want = kept.clone()
    with qt.count_dispatches() as d:
        qr.factorize_values(st["v"] * 2.0)
    assert d.programs == 1 and torch.equal(kept, want)


def _counting(fn):
    """``fn`` counting a launch into its wrapper's counter, as the CUDA
    kernel does (the plain versions on the CPU count none)."""
    def wrapped(*args, **kw):
        fn.launches += 1
        return fn(*args, **kw)
    return wrapped


def test_replays_attribute_their_launches(recording, monkeypatch):
    """A capture's launches are not counted (it runs nothing); each replay
    adds them; nested counters count the replays and their launches, and
    none as issued by the host."""
    from qrkit_tpu_torch.ops import banded as bk

    for mod, name in ((banded_blocked, "chain_qr"), (segmented_factorize, "chain_qr"),
                      (segmented_factorize, "segment_chains"),
                      (segmented_factorize, "segment_apply_w")):
        monkeypatch.setattr(mod, name, _counting(getattr(bk, name)))
    with qt.count_dispatches() as first:  # compute: the warm-up launches, the capture does not
        st = _banded_setup("segmented", "tallblock_p2w")(np.random.default_rng(8), DEV)
    qr = st["qr"]
    want = _kernels(qr)
    assert want == {"banded_segment_chains": 1, "banded_apply_w": 1}
    assert {k: v for k, v in first.launches.items() if v} == want and first.programs == 0
    with qt.count_dispatches() as capture:  # the warm-up launches, the capture does not
        qr.factorize_values(st["v"])
    assert {k: v for k, v in capture.launches.items() if v} == want and capture.programs == 0
    with qt.count_dispatches() as outer:
        qr.factorize_values(st["v"])
        with qt.count_dispatches() as inner:
            qr.factorize_values(st["v"])
    assert inner.programs == 1 and outer.programs == 2
    assert {k: v for k, v in inner.launches.items() if v} == want
    assert {k: v for k, v in outer.launches.items() if v} == {k: 2 for k in want}
    assert not any(outer.host_launches.values())
    assert outer.count == outer.ops + 2


def test_inner_calls_run_inline(recording):
    """A solve program calls ``apply_qt`` and ``solve_r``, themselves
    programs: they run inline, so the solver records one solve graph and
    none of its own for them; the generic ``BlockAngularQR`` solve likewise
    records one graph, its banded left none."""
    for kind in ("banded", "segmented"):
        st = _banded_setup(kind, "tallblock_p2w")(np.random.default_rng(13), DEV)
        qr = st["qr"]
        for _ in range(3):
            qr.solve(st["b"])
        names = [k[0] for k in qr._programs.programs()]
        assert names == [f"{type(qr).__name__}.solve"], names
    st = _angular_banded_setup(np.random.default_rng(14), DEV)
    qr = st["qr"]
    for _ in range(3):
        qr.solve(st["b"])
    assert sorted(k[0] for k in qr.left._programs.programs()) == ["BandedBlockedQR.factorize"]
    assert [k[0] for k in qr._programs.programs()].count("BlockAngularQR.generic_solve") == 1


def _bundle_like(rng, device, nb=30, cams=2):
    """A bundle-shaped sparse-A2 system: ``nb`` points of ``2C + 3`` rows
    and 3 columns (the block-diagonal left in its kernel tier), each point's
    ``2C`` observation rows against its cameras' 6 columns, and the ``6C``
    camera damping rows as the left's zero tail (a row of R12 sums 6C
    products)."""
    br, c6 = 2 * cams + 3, 6 * cams
    n1 = nb * br + c6
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, 3))
    p, c, k, j = np.meshgrid(np.arange(nb), np.arange(cams), np.arange(2), np.arange(6),
                             indexing="ij")
    rows = np.concatenate([(p * br + 2 * c + k).ravel(), nb * br + np.arange(c6)])
    cols = np.concatenate([(6 * c + j).ravel(), np.arange(c6)])
    a2 = qt.SparseCSR.from_triplets(rows, cols, rng.normal(size=rows.size), (n1, c6))
    left = qt.BlockDiagonal(torch.as_tensor(blocks, device=device), n1, 3 * nb)
    qr = qt.BlockAngularQR(qt.BlockDiagonalQR(pivot=False, use_kernel=True), qt.DenseColPivQR())
    b = torch.as_tensor(rng.normal(size=n1), device=device)
    return qr, qt.BlockMatrix1x2(left, a2), b


def test_kernel_tier_left_factors_are_program_outputs(recording):
    """The kernel-tier left's explicit Q1, R1, which the generic solve
    reads, are outputs of the sparse-A2 program (formed there from the
    left's operand), not made inside the solve's capture: a recompute
    overwrites them in place, and the captured solve then equals an eager
    solve on the new factors."""
    qr, mat, b = _bundle_like(np.random.default_rng(15), DEV)
    for _ in range(3):  # eager, capture, replay of the sparse-A2 program
        qr.compute(mat)
    assert qr.left._kernel_mode and qr._left_from_program
    (prog,) = [p for k, p in qr._programs.programs().items()
               if k[0] == "BlockAngularQR.sparse_a2_blockdiag"]
    assert any(t is qr.left.Q for t in prog.out) and any(t is qr.left.R for t in prog.out)
    for _ in range(3):
        qr.solve(b)
    assert [k[0] for k in qr._programs.programs()].count("BlockAngularQR.generic_solve") == 1
    Q = qr.left.Q
    blocks = mat.left.blocks * 1.5
    other = qt.BlockMatrix1x2(qt.BlockDiagonal(blocks, mat.left.nrows, mat.left.ncols), mat.right)
    qr.compute(other)  # the left computes eagerly (a new container), the program replays
    assert qr.left.Q is Q
    with qt.count_dispatches() as d:
        x = qr.solve(b)
    assert d.programs == 1 and d.ops <= BUDGET_OPS, d
    with _program.eager():
        assert torch.equal(x, qr.solve(b))


def test_host_read_in_a_capture_raises(recording):
    """What a capture on the card refuses raises with the program's name; a
    path never carries on eagerly."""
    progs = _program.Programs()
    x = torch.ones(4)
    for name, fn in (("demo.read", lambda _, x: x * x.sum().item()),
                     ("demo.mask", lambda _, x: x[x > 0])):
        progs.solve(None, name, (), fn, x)  # the first call runs eagerly
        with pytest.raises(RuntimeError, match=name):
            progs.solve(None, name, (), fn, x)
    assert not progs.programs()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    return torch.device("cuda")


def _scan_kernels(path, label, st):
    """The chain-scan kernels (K1 ``chain_two_seg``, K2 ``chain_solve``)
    one call of a banded path launches: a Q product one K1 a chain, a
    back-substitution one K2 a chain (the segmented solver runs its
    segments' and its boundary chain's), a segmented factorize one K1 for
    the phase-2 slabs that B4 does not take."""
    if path.startswith("block_angular_banded"):
        return {"chain_two_seg": 1, "chain_solve": 1}  # the left's Qᵀ and solve_r
    if not path.startswith(("banded", "segmented")):
        return {}
    qr = st["qr"]
    seg = isinstance(qr, qt.SegmentedBandedQR)
    op = label.replace("_k3", "")
    if op == "factorize_values":
        fused = seg and qr._fac_kernel and qr._p2w is not None
        return {"chain_two_seg": 1} if seg and (not fused or qr._p2w["excl"].numel()) else {}
    n = 2 if seg else 1
    return {"solve": {"chain_two_seg": n, "chain_solve": n}, "apply_qt": {"chain_two_seg": n},
            "apply_q": {"chain_two_seg": n}, "solve_r": {"chain_solve": n}}[op]


def _cuda_kernels(path, label, st):
    """The kernels launched inside one replay of a path's call."""
    if label == "factorize_values":
        return {**_kernels(st["qr"]), **_scan_kernels(path, label, st)}
    if path.startswith("block_diagonal"):
        return {"compute": {"blockdiag_qr_r": 1}, "solve": {"blockdiag_lstsq": 1}}.get(label, {})
    return _scan_kernels(path, label, st)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_cuda_budget_and_bitwise(path, cuda_device):
    """On the card each warm call is one replay, at most 3 ATen ops, no
    host-issued launch, no host read, the replay's launches counted; it is
    bitwise equal to the same call under ``_program.eager()``."""
    setup, calls, _ = PATHS[path]
    st = setup(np.random.default_rng(0), cuda_device)
    if path.startswith(("banded", "segmented")):
        assert st["qr"]._fac_kernel
    for label, call, read in calls(st):
        out, d = _warm(call, read)
        torch.cuda.synchronize()
        assert d.programs == 1 and d.ops <= BUDGET_OPS and d.host_reads == 0, (label, d)
        assert not any(d.host_launches.values()), (label, d.host_launches)
        want = _cuda_kernels(path, label, st)
        assert {k: v for k, v in d.launches.items() if v} == want, (label, d.launches)
        with _program.eager():
            eager = read(call())
        replay = read(call())
        torch.cuda.synchronize()
        assert torch.equal(out, eager) and torch.equal(replay, eager), label


@pytest.mark.cuda
def test_cuda_block_angular_solve_is_reproducible(cuda_device):
    """Two solves on the same factors are bitwise equal on the card (R12's
    products summed in a fixed order, no atomics), eagerly and replayed, on
    a bundle-shaped sparse-A2 system."""
    qr, mat, b = _bundle_like(np.random.default_rng(16), cuda_device, nb=2000, cams=8)
    for _ in range(3):
        qr.compute(mat)
    with _program.eager():
        first, second = qr.solve(b), qr.solve(b)
    replays = [qr.solve(b) for _ in range(4)][2:]
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert all(torch.equal(first, x) for x in replays)
