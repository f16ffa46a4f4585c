"""The port's mesh paths on 2 gloo ranks (CPU, fp64), held against the
port's ``mesh=None`` results and against qrkit_tpu on the same inputs.

Mirrors tests/test_parallel.py's mesh tests (``test_tsqr_on_mesh``,
``test_sharded_block_diagonal``, ``test_sharded_block_angular_end_to_end``,
``test_soa_damped_step_sharded_matches``) and
tests/test_segmented_sharded.py, and adds the point-sharded bundle fit, the
four dry-run steps, the ValueError on an uneven block split and the
segmented no-op when S does not tile the mesh.  The reference runs on its
8-device CPU mesh (tests/conftest.py) where its test uses one, otherwise
with ``mesh=None``; the port to reference tolerance is rtol 1e-10.

One module-scoped fixture spawns the ranks once
(``qrkit_tpu_torch.dryrun.launch``, a FileStore in a temporary directory,
no network port), runs every case (``qrkit_tpu_torch.dryrun.mesh_cases``)
and loads each rank's saved results; each test asserts one case.  The
ranks run while this process builds the reference's solvers.

The ``programs`` case runs every mesh path as a captured program on each
rank (``dryrun.program_checks``) through the test-only capture backends of
tests/test_torch_dispatch_count.py (``Recording``) and
tests/test_torch_lm_programs.py (``RecordingLoop``), handed to the ranks
by reference: a warm call is one replay with at most 3 ATen ops outside
it, no host read and no host-issued launch, nothing its capture ran reads
the host (``_NoHostSync``), its result equals the same call under
``_program.eager()`` bitwise and issues the same collectives
(``dryrun.count_collectives``), and agrees with ``mesh=None`` at fp64 rtol
1e-10 (and with qrkit_tpu where the tests above compare with it); the
``reduce=`` bundle fit is one launch and one host read a chunk of its
chunked loop, bitwise the eager loop's.
"""
import inspect
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from qrkit_tpu.containers import BlockDiagonal as JBlocks, BlockMatrix1x2 as JMatrix1x2
from qrkit_tpu.examples import bundle as jb
from qrkit_tpu.examples.ellipse import Ellipse, _damped_step_aux as j_damped_step_aux, ellipse_points
from qrkit_tpu.examples.ellipse import _residuals as j_residuals
from qrkit_tpu.parallel import TSQRDenseQR as JTSQR, default_mesh as j_default_mesh
from qrkit_tpu.sparse import SparseCSR as JSparseCSR
from qrkit_tpu.solvers import (
    BlockAngularQR as JBlockAngular,
    BlockDiagonalQR as JBlockDiagonalQR,
    QFormat as JQFormat,
    SegmentedBandedQR as JSegmented,
)

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import dryrun
from qrkit_tpu_torch.examples import bundle as tb
from qrkit_tpu_torch.parallel import TSQRDenseQR

from generators import overlapping_block_diagonal_matrix, tall_banded_matrix
from test_torch_dispatch_count import Recording
from test_torch_lm_programs import RecordingLoop

WORLD = 2


def _close_ref(got, want):
    """Port against qrkit_tpu: rtol 1e-10 (atol 1e-10·max|want| for the
    entries near zero)."""
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dense_blocks(blocks):
    nb, br, bc = blocks.shape
    out = np.zeros((nb * br, nb * bc))
    for i in range(nb):
        out[i * br : (i + 1) * br, i * bc : (i + 1) * bc] = blocks[i]
    return out


def _csr(m):
    return (m.shape, np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data))


def _make_inputs():
    """Every case's inputs, made with numpy from seeds."""
    rng = np.random.default_rng(42)
    inp = {"tsqr_A": rng.normal(size=(16 * WORLD, 7)), "tsqr_x": rng.normal(size=7)}
    nb = WORLD * 8
    inp["bd_blocks"] = rng.normal(size=(nb, 7, 2))
    inp["bd_b"] = rng.normal(size=nb * 7)
    nb = WORLD * 4
    inp["ba_blocks"] = rng.normal(size=(nb, 3, 1))
    inp["ba_right"] = rng.normal(size=(nb * 3, 4))
    dense = np.concatenate([_dense_blocks(inp["ba_blocks"]), inp["ba_right"]], axis=1)
    inp["ba_x"] = rng.normal(size=dense.shape[1])
    inp["ba_b"] = dense @ inp["ba_x"]
    nb = WORLD * 3
    inp["lg_blocks"] = rng.normal(size=(nb, 4, 2))
    inp["lg_right"] = rng.normal(size=(nb * 4 + 3, 3))
    inp["lg_b"] = rng.normal(size=nb * 4 + 3)
    inp["lg_w"] = rng.normal(size=nb * 2 + 3)
    n = 16 * WORLD
    inp["soa_pts"] = ellipse_points(Ellipse(), n)
    params = np.zeros(n + 5)
    params[:n] = np.arange(n) * 0.02
    params[n : n + 4] = (6.0, 3.0, 15.0, 20.0)
    inp["soa_params"] = params
    for key, spj, cfg in (
        ("seg", overlapping_block_diagonal_matrix(256, 896, rng, permute_rows=False), (2, 16, "auto")),
        ("seg_kernel", tall_banded_matrix(64, rng, br=10, bc=4, ov=2), (4, 8, True)),
        ("seg_untiled", overlapping_block_diagonal_matrix(96, 336, rng, permute_rows=False), (2, 16, "auto")),
    ):
        x_true = rng.normal(size=spj.ncols)
        inp[key] = _csr(spj)
        inp[key + "_cfg"] = cfg
        inp[key + "_x"] = x_true
        inp[key + "_b"] = spj.to_dense() @ x_true  # row-sorted inputs: no row permutation
    cams, pts, uv = jb.make_scene(n_cams=2, n_pts=WORLD * 4, noise=0.0, seed=9)
    prng = np.random.default_rng(13)
    inp["bf_cams0"] = cams + 0.02 * prng.normal(size=cams.shape)
    inp["bf_pts0"] = pts + 0.05 * prng.normal(size=pts.shape)
    inp["bf_uv"] = uv
    cams, pts, uv = jb.make_scene(n_cams=2, n_pts=WORLD * 8, noise=0.0, seed=4)
    inp["bs_x0"] = np.concatenate([(pts + 0.05 * prng.normal(size=pts.shape)).ravel(),
                                   (cams + 0.02 * prng.normal(size=cams.shape)).ravel()])
    inp["bs_uv"] = uv
    inp["step_grad"] = dryrun.step_grad_inputs(WORLD)
    inp["dryrun_bundle_points"] = 64
    inp["backends"] = (Recording, RecordingLoop)  # the programs case's capture backends
    return inp


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(inputs, reference segmented solvers, the ranks' results); the ranks
    run in a background thread while the reference solvers are built."""
    inp = _make_inputs()
    d = tmp_path_factory.mktemp("mesh")
    failure = []

    def run():
        try:
            dryrun.launch(dryrun.mesh_cases, WORLD, "cpu", str(d), (inp, str(d)), timeout=300)
        except BaseException as e:  # re-raised in the fixture
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    refs = {}
    for key in ("seg", "seg_kernel"):
        sbc, L, _ = inp[key + "_cfg"]
        spj = JSparseCSR(*inp[key])
        refs[key] = JSegmented(suggested_block_cols=sbc, segment_blocks=L, mesh=j_default_mesh()).compute(spj)
        assert refs[key].rows_permutation().is_identity()
    thread.join()
    if failure:
        raise failure[0]
    return inp, refs, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The ``step_grad`` case on one gloo rank, 2,000 points (eight tiles,
    a thread's carry of two rows): (its inputs, its results)."""
    inp = {"step_grad": dryrun.step_grad_inputs(1, nb=2000)}
    d = tmp_path_factory.mktemp("mesh1")
    dryrun.launch(dryrun.mesh_cases, 1, "cpu", str(d), (inp, str(d), ("step_grad",)), timeout=300)
    return inp, [torch.load(d / "rank0.pt", weights_only=False)]


@pytest.fixture(scope="module")
def ranks(inputs):
    """Each rank's results by case (``mesh_cases``)."""
    return inputs[2]


def _case(ranks, name):
    """A case's rank-0 results, after checking that it ran and that every
    rank returned the same global values."""
    r0 = ranks[0][name]
    assert "error" not in r0, r0
    for other in ranks[1:]:
        _same(r0, other[name], name)
    return r0


def _same(a, b, path):
    if isinstance(a, dict):
        for k in a:
            if not k.startswith("local"):
                _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), f"{path} differs between ranks"
    else:
        assert a == b, f"{path} differs between ranks"


def test_mesh_keywords_on_every_class():
    """``mesh=``/``axis=`` are keywords of the five distributed entry points
    (the cases call each of them so)."""
    for fn in (qt.BlockDiagonalQR, qt.SegmentedBandedQR, qt.BlockAngularQR, TSQRDenseQR,
               tb.fit_bundle_device):
        params = inspect.signature(fn).parameters
        assert params["mesh"].default is None and params["axis"].default == "dp", fn
    assert qt.parallel.default_mesh is not None and qt.parallel.shard_leading_axis is not None


def test_tsqr_on_mesh(ranks, inputs):
    c = _case(ranks, "tsqr")
    A = inputs[0]["tsqr_A"]
    Q, R = _np(c["mesh"]["Q"]), _np(c["mesh"]["R"])
    assert np.allclose(Q @ R, A, atol=1e-9)
    for k in ("Q", "R", "x"):
        np.testing.assert_allclose(_np(c["mesh"][k]), _np(c["none"][k]), rtol=0, atol=1e-9)
    assert c["mesh"]["local_shards"] == 1 and c["none"]["local_shards"] == WORLD
    assert ranks[1]["tsqr"]["mesh"]["local_shards"] == 1
    jq = JTSQR(n_shards=WORLD, mesh=j_default_mesh()).compute(jnp.asarray(A))
    _close_ref(R, jq.matrix_r_dense())
    _close_ref(Q, jq.matrix_q_dense())
    np.testing.assert_allclose(_np(c["mesh"]["x"]), inputs[0]["tsqr_x"], atol=1e-8)


@pytest.mark.parametrize("case", ["blockdiag_pivot", "blockdiag_kernel"])
def test_sharded_block_diagonal(ranks, inputs, case):
    """Pivoting (batched-torch tier) and the kernel tier (B2 compute and the
    B1 solve, as their plain versions) per rank."""
    c = _case(ranks, case)
    m, n = c["mesh"], c["none"]
    np.testing.assert_allclose(_np(m["R"]), _np(n["R"]), rtol=0, atol=1e-12)
    for k in ("x", "qtb", "qb", "diag", "perm"):
        np.testing.assert_allclose(_np(m[k]), _np(n[k]), rtol=0, atol=1e-12)
    assert (m["rank"], m["info"], m["kernel"]) == (n["rank"], n["info"], n["kernel"])
    assert m["kernel"] == (case == "blockdiag_kernel")
    nb = inputs[0]["bd_blocks"].shape[0]
    assert all(r[case]["mesh"]["local_blocks"] == nb // WORLD for r in ranks)
    jq = JBlockDiagonalQR(JQFormat.FULL_Q, pivot=case == "blockdiag_pivot", mesh=j_default_mesh())
    jq.compute(JBlocks.from_dense_batch(jnp.asarray(inputs[0]["bd_blocks"])))
    _close_ref(m["R"], jq.R)
    _close_ref(m["x"], jq.solve(jnp.asarray(inputs[0]["bd_b"])))
    np.testing.assert_array_equal(_np(m["perm"]), jq.cols_permutation().indices)


def test_uneven_block_split_raises(ranks):
    for r in ranks:
        msg = r["uneven"]["message"]
        assert msg is not None and "does not divide" in msg, msg


def test_shard_leading_axis(ranks):
    """Each rank's contiguous chunk of every tensor in a dict or tuple; a
    leading axis the mesh does not divide raises ValueError."""
    for r in ranks:
        c = r["shard"]
        k = c["rank"]
        assert torch.equal(c["shards"]["a"], torch.arange(4 * k, 4 * k + 4))
        assert isinstance(c["shards"]["b"], tuple) and c["shards"]["b"][0].shape == (2, 3)
        assert c["odd"] is not None and "does not divide" in c["odd"]


@pytest.mark.parametrize("tail", [0, 3])
def test_sharded_block_angular_lstsq_gradients(ranks, inputs, tail):
    """∂left_blocks, ∂right and ∂b of a loss of the replicated x through
    the sharded ``functional.block_angular_lstsq``: each rank's own blocks
    and rows, and the tail rows (the same on every rank), against
    ``jax.grad`` of qrkit_tpu's on the same global inputs, fp64 rtol 1e-9."""
    from qrkit_tpu import functional as jfunctional

    inp = inputs[0]
    blocks, b, w = inp["lg_blocks"], inp["lg_b"], inp["lg_w"]
    nb, br, bc = blocks.shape
    right = inp["lg_right"][: nb * br + tail]
    c = _case(ranks, "lstsq_grad")[f"tail{tail}"]

    def loss(lb, r, v):
        x = jfunctional.block_angular_lstsq(lb, r, v, n_shards=WORLD, tail=tail)
        return jnp.sum(jnp.asarray(w[: x.shape[0]]) * x) + 0.5 * jnp.sum(x * x)

    args = (jnp.asarray(blocks), jnp.asarray(right), jnp.asarray(b[: nb * br + tail]))
    want = jax.grad(loss, argnums=(0, 1, 2))(*args)
    got = (
        np.concatenate([_np(r["lstsq_grad"][f"tail{tail}"]["local_left"]) for r in ranks]),
        np.concatenate([_np(r["lstsq_grad"][f"tail{tail}"]["local_right"]) for r in ranks]
                       + [_np(c["tail_right"])]),
        np.concatenate([_np(r["lstsq_grad"][f"tail{tail}"]["local_b"]) for r in ranks]
                       + [_np(c["tail_b"])]),
    )
    for g, wnt, name in zip(got, want, ("left_blocks", "right", "b")):
        wnt = np.asarray(wnt)
        assert g.shape == wnt.shape, name
        np.testing.assert_allclose(g, wnt, rtol=1e-9, atol=1e-9 * np.abs(wnt).max(), err_msg=name)
    x = jfunctional.block_angular_lstsq(*args, n_shards=WORLD, tail=tail)
    _close_ref(c["x"], x)


def test_sharded_block_angular_lstsq_backward_one_collective(ranks):
    """The sharded backward pass issues exactly one collective on every
    rank, the all-reduce of R12ᵀ w1 (the forward's all-gathers have a
    slice as their adjoint)."""
    for r in ranks:
        for tail in ("tail0", "tail3"):
            assert r["lstsq_grad"][tail]["collectives"] == {"all_reduce": 1}, r["lstsq_grad"][tail]


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("form", ["bc2", "bc1"])
def test_mesh_step_gradients(inputs, one_rank, world, form):
    """C6: ∂left, ∂right, ∂res and ∂λ of a loss of the replicated step
    through ``lm_damped_step_blockdiag(mesh=)`` (bc = 2) and ``…1`` (bc = 1)
    on 1 and 2 gloo ranks: each rank's own points' gradients and λ's (the
    same on every rank) against ``mesh=None``'s on every point, fp64 rtol
    1e-10; nonzero (the fault returned zeros); one collective in the
    backward, the all-reduce of 2·m2 + 1 values."""
    rs = inputs[2] if world == 2 else one_rank[1]
    for r in rs:
        c = r["step_grad"]
        assert "error" not in c, c
        c = c[form]
        _close_step(c["x"], c["x_none"])
        lo, hi = c["lo"], c["hi"]
        assert hi - lo == c["none_res"].shape[-1] // world
        for k in ("left", "right", "res"):
            assert c[f"local_{k}"].abs().max() > 0, k
            _close_step(c[f"local_{k}"], c[f"none_{k}"][..., lo:hi])
        _close_step(c["lam"], c["none_lam"])
        assert c["collectives"] == {"all_reduce": 1}, c["collectives"]
    assert torch.equal(rs[0]["step_grad"][form]["lam"], rs[-1]["step_grad"][form]["lam"])


@pytest.mark.parametrize("form", ["bc2", "bc1"])
def test_mesh_step_gradients_match_reference(inputs, form):
    """The 2-rank mesh step's gradients, put together from the ranks,
    against ``jax.grad`` of qrkit_tpu's ``lm_damped_step_blockdiag`` (bc =
    2) and ``lm_damped_step_blockdiag1`` (bc = 1) on the global operands,
    fp64 rtol 1e-9 (as the sharded lstsq's)."""
    from qrkit_tpu import functional as jfunctional

    op = inputs[0]["step_grad"][form]

    def loss(left, right, res, lam):
        if form == "bc1":
            x = jfunctional.lm_damped_step_blockdiag1(left, right, res, lam)
        else:
            x1, x2 = jfunctional.lm_damped_step_blockdiag(left, right, res, lam)
            x = jnp.concatenate([x1.reshape(-1), x2])
        return jnp.sum(jnp.asarray(op["w"]) * x) + 0.5 * jnp.sum(x * x)

    left = op["left"][:, 0] if form == "bc1" else op["left"]
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (left, op["right"], op["res"])),
                                                jnp.asarray(op["lam"]))
    cases = [r["step_grad"][form] for r in inputs[2]]
    got = [np.concatenate([_np(c[f"local_{k}"]) for c in cases], axis=-1) for k in ("left", "right", "res")]
    for g, w, name in zip(got + [_np(cases[0]["lam"])], want, ("left", "right", "res", "lam")):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * np.abs(w).max(), err_msg=name)


def _close_step(got, want):
    """Mesh against ``mesh=None``: fp64 rtol 1e-10 (atol 1e-10·max|want|)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_sharded_block_angular_end_to_end(ranks, inputs):
    c = _case(ranks, "block_angular")
    inp = inputs[0]
    np.testing.assert_allclose(_np(c["mesh"]["x"]), _np(c["none"]["x"]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(c["mesh"]["x"]), inp["ba_x"], atol=1e-8)
    assert c["mesh"]["local_blocks"] == inp["ba_blocks"].shape[0] // WORLD
    mesh = j_default_mesh()
    blk = JBlocks.from_dense_batch(jnp.asarray(inp["ba_blocks"]))
    jq = JBlockAngular(
        JBlockDiagonalQR(JQFormat.FULL_Q, pivot=False, mesh=mesh),
        JTSQR(n_shards=WORLD, mesh=mesh), mesh=mesh,
    ).compute(JMatrix1x2(blk, jnp.asarray(inp["ba_right"])))
    _close_ref(c["mesh"]["x"], jq.solve(jnp.asarray(inp["ba_b"])))


def test_soa_damped_step_sharded_matches(ranks, inputs):
    c = _case(ranks, "soa_step")
    np.testing.assert_allclose(_np(c["mesh"]), _np(c["none"]), rtol=0, atol=1e-9)
    inp = inputs[0]
    mesh = j_default_mesh()
    pts = jnp.asarray(inp["soa_pts"])
    params = jnp.asarray(inp["soa_params"])
    step = jax.jit(j_damped_step_aux, in_shardings=(None, None, None, NamedSharding(mesh, P(None, "dp"))))
    d = step(params, j_residuals(params, pts), jnp.asarray(1e-3),
             jax.device_put(pts, NamedSharding(mesh, P(None, "dp"))))
    _close_ref(c["mesh"], d)


@pytest.mark.parametrize("key", ["seg", "seg_kernel", "seg_untiled"])
def test_segmented_sharded_matches(ranks, inputs, key):
    """S = 8 tiles the two ranks (each keeps 4 segments' factors), in the
    general forms and with the kernels (B3 with rank 1's idle leading
    segment, B4, B5; their plain versions here); S = 3 does not tile them,
    and then nothing is sharded."""
    case = {"seg": "segmented", "seg_kernel": "segmented_kernel", "seg_untiled": "segmented_untiled"}[key]
    c = _case(ranks, case)
    m, n = c["mesh"], c["none"]
    assert not m["delegate"]
    assert m["kernels"] == n["kernels"] == ((True,) * 3 if key == "seg_kernel" else (False, False, False))
    tiles = m["S"] % WORLD == 0
    assert tiles == (key != "seg_untiled") and m["sharded"] == tiles
    assert all(r[case]["mesh"]["local_segments"] == m["S"] // (WORLD if tiles else 1) for r in ranks)
    np.testing.assert_allclose(_np(m["x"]), inputs[0][key + "_x"], atol=1e-7)
    for k in ("x", "x_fv", "qtb", "R", "diag"):
        np.testing.assert_allclose(_np(m[k]), _np(n[k]), rtol=0, atol=1e-12)
    assert m["info"] == n["info"] == "SUCCESS"
    if key in inputs[1]:  # the untiled case runs the mesh=None path
        _close_ref(m["x"], inputs[1][key].solve(jnp.asarray(inputs[0][key + "_b"])))


def test_bundle_device_sharded_matches(ranks):
    """The point-sharded device LM fit (the reference's test_bundle.py
    oracle, atol 1e-6) reaches the mesh=None optimum on every rank."""
    c = _case(ranks, "bundle_fit")
    assert c["mesh"]["cost"] < 1e-14, c["mesh"]["cost"]
    np.testing.assert_allclose(_np(c["mesh"]["x"]), _np(c["none"]["x"]), atol=1e-6)


def test_bundle_step_sharded_matches(ranks, inputs):
    """One point-sharded bundle damped step (TSQR over the ranks) against the
    port's mesh=None step and qrkit_tpu's fused step on the same scene."""
    c = _case(ranks, "bundle_step")
    np.testing.assert_allclose(_np(c["mesh"]), _np(c["none"]), rtol=0, atol=1e-9)
    inp = inputs[0]
    x0, uv = jnp.asarray(inp["bs_x0"]), jnp.asarray(inp["bs_uv"])
    want = jax.jit(jb._make_damped_step(1))(x0, jb.residuals(x0, uv), jnp.asarray(1e-3), uv)
    _close_ref(c["mesh"], want)


@pytest.mark.parametrize("step", dryrun.STEPS)
def test_dryrun_steps(ranks, step):
    res = _case(ranks, "dryrun")[step]
    assert res["max_abs_diff"] < 1e-9, res


# --- every mesh path as a captured program (the ``programs`` case) -------------
PROGRAM_PATHS = (
    "blockdiag16.compute", "blockdiag16.solve", "blockdiag16_pivot.compute",
    "segmented.factorize_values", "segmented.solve", "segmented.apply_qt", "segmented.apply_q",
    "segmented.solve_r", "segmented.apply_qt_sparse", "segmented.apply_q_sparse",
    "block_angular_sparse_a2.compute", "block_angular_sparse_a2.solve",
    "block_angular_tsqr.solve", "tsqr.compute", "tsqr.apply_qt", "tsqr.apply_q", "tsqr.solve_r",
    "functional.block_angular_lstsq", "ellipse._damped_step_aux", "bundle._damped_step",
)


def _programs(ranks):
    """Each rank's ``programs`` results, after checking that they ran."""
    out = [r["programs"] for r in ranks]
    for res in out:
        assert "setup" not in res, res["setup"]
    return out


def test_mesh_program_paths(ranks):
    """The programs case ran every path of ``PROGRAM_PATHS`` and the
    ``reduce=`` fit, on every rank, in that order."""
    for res in _programs(ranks):
        assert tuple(res) == PROGRAM_PATHS + ("bundle.fit_reduce",)


@pytest.mark.parametrize("path", PROGRAM_PATHS)
def test_mesh_program_warm_call(ranks, path):
    """A warm call of a mesh path on each rank: one replay (two for the
    sparse-A2 recompute: the left's compute and its own), at most 3 ATen
    ops outside it (6 for the recompute, as the one-device pin), no host
    read, no host-issued launch, the first call eager (the collectives'
    communicator made before any capture); bitwise the eager call's, with
    the same collectives (one or more where the path is sharded); within
    fp64 rtol 1e-10 of ``mesh=None``; the same on every rank."""
    recompute = path == "block_angular_sparse_a2.compute"
    values = []
    for res in _programs(ranks):
        r = res[path]
        assert "error" not in r, r["error"]
        assert r["first_programs"] == 0, r
        assert r["programs"] == 1 + recompute and r["ops"] <= (6 if recompute else 3), r
        assert r["host_reads"] == 0 and r["host_launches"] == 0, r
        assert r["bitwise_equal_eager"], path
        assert r["collectives_replay"] == r["collectives_eager"], r
        assert bool(r["collectives_replay"]) == (path != "tsqr.solve_r"), r
        _close_ref(r["value"], _np(r["none"]))
        values.append(r["value"])
    for v in values[1:]:
        assert torch.equal(v, values[0]), f"{path} differs between ranks"


def _program_input(key):
    return dryrun.program_inputs(WORLD, "small")[key]


def _ref_programs(path):
    """qrkit_tpu's value of a mesh path, on its 8-device CPU mesh where the
    tests above use one."""
    from qrkit_tpu import functional as jfunctional

    mesh = j_default_mesh()
    if path == "blockdiag16.solve":
        blocks, b = _program_input("bd16")
        jq = JBlockDiagonalQR(JQFormat.FULL_Q, pivot=False, mesh=mesh)
        jq.compute(JBlocks.from_dense_batch(jnp.asarray(blocks)))
        return jq.solve(jnp.asarray(b))
    if path == "tsqr.compute":
        A, _ = _program_input("tsqr")
        # rows the reference's mesh does not divide (35): its unsharded TSQR
        return JTSQR(n_shards=WORLD).compute(jnp.asarray(A)).matrix_r_dense()
    if path == "block_angular_tsqr.solve":
        blocks, a2, _, b = _program_input("ba")
        jq = JBlockAngular(JBlockDiagonalQR(JQFormat.FULL_Q, pivot=False, mesh=mesh),
                           JTSQR(n_shards=WORLD, mesh=mesh), mesh=mesh)
        jq.compute(JMatrix1x2(JBlocks.from_dense_batch(jnp.asarray(blocks)), jnp.asarray(a2)))
        return jq.solve(jnp.asarray(b))
    if path == "segmented.solve":
        spj, b, *_, (br, bc, ov, L, sbc) = _program_input("seg")
        jq = JSegmented(suggested_block_cols=sbc, segment_blocks=L, mesh=mesh)
        jq.compute(JSparseCSR(*_csr(spj)))
        jq.factorize_values(jnp.asarray(spj.data * 1.5))
        return jq.solve(jnp.asarray(b))
    pts = jnp.asarray(_program_input("ellipse"))
    if path in ("functional.block_angular_lstsq", "ellipse._damped_step_aux"):
        from qrkit_tpu.examples import ellipse as jell

        params = jnp.asarray(qt.examples.ellipse.EllipseFitting(
            np.asarray(pts), device="cpu").initial_params().numpy())
        r = j_residuals(params, pts)
        if path == "ellipse._damped_step_aux":
            return j_damped_step_aux(params, r, jnp.asarray(1e-3), pts)
        left_d, right_d, rhs = jell._damped_system(*jell._jacobian_blocks(params, pts), r,
                                                   jnp.asarray(1e-3))
        return jfunctional.block_angular_lstsq(left_d, right_d, rhs, n_shards=WORLD, tail=5)
    x0, uv = (jnp.asarray(a) for a in _program_input("step"))
    return jax.jit(jb._make_damped_step(1))(x0, jb.residuals(x0, uv), jnp.asarray(1e-3), uv)


@pytest.mark.parametrize("path", ["blockdiag16.solve", "tsqr.compute", "block_angular_tsqr.solve",
                                  "segmented.solve", "functional.block_angular_lstsq",
                                  "ellipse._damped_step_aux", "bundle._damped_step"])
def test_mesh_program_matches_reference(ranks, path):
    """The captured mesh path against qrkit_tpu on the same global inputs,
    fp64 rtol 1e-10."""
    _close_ref(_programs(ranks)[0][path]["value"], _ref_programs(path))


def test_mesh_reduce_fit_chunked_launches(ranks):
    """A warm ``fit_bundle_device(mesh=)`` (a ``reduce=`` LM fit) on each
    rank is one graph launch and one host read (the fetch) a chunk of its
    chunked loop (NCCL's collectives cannot sit inside a WHILE node's body:
    ``_program._ChunkedLoop``), its all-reduces and all-gathers counted
    through the loop's iterations (two of each an iteration: the eager
    loop's, and the gated iterations' past the end of its last chunk), and x,
    cost and the iteration count bitwise the eager loop's
    (``_program.eager()``), the same on every rank."""
    from qrkit_tpu_torch import _program

    fits = [res["bundle.fit_reduce"] for res in _programs(ranks)]
    for r in fits:
        assert "error" not in r, r["error"]
        chunks = _program.loop_chunks(r["iterations"], dryrun.FIT_CFG_ITERS)
        assert r["programs"] == chunks and r["lm_host_reads"] == chunks, r
        assert r["bitwise_equal_eager"], r
        assert torch.equal(r["x"], r["eager_x"]) and r["cost"] == r["eager_cost"]
        assert r["iterations"] == r["eager_iterations"] > _program.LOOP_CHUNK
        # the last chunk's gated iterations past the end run their
        # collectives too: the eager loop's counts and theirs
        calls = r["collectives_replay"]
        padding = chunks * _program.LOOP_CHUNK - r["iterations"]
        assert r["padding_iterations"] == padding and calls == r["collectives_expected"], r
        assert all(calls[k] == r["collectives_eager"][k] + 2 * padding for k in calls), r
        assert r["cost"] < 1e-14
    for r in fits[1:]:
        assert torch.equal(r["x"], fits[0]["x"]) and r["iterations"] == fits[0]["iterations"]
