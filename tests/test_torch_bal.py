"""BAL bundle adjustment (``qrkit_tpu_torch.examples.bal``) and the ragged
block-angular step (``functional.block_angular_lstsq_ragged``) against the
benchmark's plain reference (``qrbench/reference/bal_lm.py``: the model by
``torch.func``, the damped step by the Schur complement of the normal
equations), and against today's dense-A2 ``block_angular_lstsq`` on the
same system with every point padded to the longest track.  fp64 on the CPU,
a seeded scene of 6 cameras and 300 points with tracks of 2 to 6.  The
captured loop's marks (kernel L2 on the card) run here through the test
loop backend, which stamps the host's clock.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from qrbench.reference import bal_lm
from qrkit_tpu_torch import _program, functional, lm, profiling
from qrkit_tpu_torch.examples import bal
from qrkit_tpu_torch.lm import LMConfig
from qrkit_tpu_torch.ops import graph_loop

from test_torch_dispatch_count import Recording
from test_torch_lm_programs import RecordingLoop

DEV = "cpu"
C, P = 6, 300
CFG = LMConfig(max_iters=50, ftol=1e-6, xtol=1e-8)


@pytest.fixture(scope="module")
def scene():
    cams, pts, obs_cam, obs_pt, uv = bal.make_scene(C, P, (2, 6), noise=1.0, seed=7)
    rng = np.random.default_rng(8)
    cams0 = cams + np.r_[[0.01] * 3, [0.05] * 3, [8.0], [0.0, 0.0]] * rng.normal(size=cams.shape)
    pts0 = pts + 0.05 * rng.normal(size=pts.shape)
    x0 = torch.as_tensor(np.concatenate([pts0.ravel(), cams0.ravel()]))
    return cams0, pts0, obs_cam, obs_pt, uv, x0


def _aux(scene):
    _, _, obs_cam, obs_pt, uv, _ = scene
    cam, pt, order, buckets, inverse, rows = bal._device_plan(obs_cam, obs_pt, P, C, DEV)
    return (cam, pt, torch.as_tensor(uv)[order], buckets, inverse, C, rows)


def _ref_operands(scene):
    _, _, obs_cam, obs_pt, uv, x0 = scene
    return (x0, torch.as_tensor(obs_cam), torch.as_tensor(obs_pt), torch.as_tensor(uv),
            bal_lm.Tracks(obs_pt, P, DEV))


def test_residuals_and_jacobian_blocks_match_reference(scene):
    x0, oc, op, uv, _ = _ref_operands(scene)
    r = bal.residuals(x0, oc, op, uv, C)
    jp, jc = bal.jacobian_blocks(x0, oc, op, C)
    rr = bal_lm.residuals(x0, oc, op, uv, C).reshape(-1)
    rjp, rjc = bal_lm.jacobian(x0, oc, op, C)
    assert jp.shape == (len(oc), 2, 3) and jc.shape == (len(oc), 2, bal.CAMERA)
    for got, want in ((r, rr), (jp, rjp), (jc, rjc)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("lam", [1e-3, 0.5, 40.0])
def test_ragged_step_matches_the_schur_step(scene, lam):
    """The port's step against the reference's normal equations with the
    points eliminated, in the residuals' order of the port (sorted by
    point) and of the reference (as given)."""
    x0, oc, op, uv, tracks = _ref_operands(scene)
    aux = _aux(scene)
    lam_t = torch.tensor(lam, dtype=torch.float64)
    got = bal._damped_step_aux(x0, bal._residuals_aux(x0, aux), lam_t, aux)
    want, _ = bal_lm.damped_step(x0, bal_lm.residuals(x0, oc, op, uv, C), lam_t, oc, op, tracks, C)
    torch.testing.assert_close(got, want, rtol=1e-8, atol=1e-8 * float(want.abs().max()))


def _padded_dense_step(scene, lam):
    """Today's uniform, dense-A2 ``block_angular_lstsq`` on the system with
    every point padded to the longest track: blocks ``[P, 2k_max + 3, 3]``
    (the damping rows, the observation rows, zero rows), A2 dense."""
    x0, oc, op, uv, _ = _ref_operands(scene)
    jp, jc = bal.jacobian_blocks(x0, oc, op, C)
    r = bal.residuals(x0, oc, op, uv, C).reshape(-1, 2)
    track = np.bincount(op.numpy(), minlength=P)
    kmax, m2 = int(track.max()), bal.CAMERA * C
    br = 2 * kmax + 3
    left = torch.zeros((P, br, 3), dtype=torch.float64)
    left[:, :3] = lam ** 0.5 * torch.eye(3, dtype=torch.float64)
    a2 = torch.zeros((P, br, m2), dtype=torch.float64)
    b = torch.zeros((P, br), dtype=torch.float64)
    slot = np.zeros(P, dtype=int)
    for i, (c, p) in enumerate(zip(oc.tolist(), op.tolist())):
        row = 3 + 2 * slot[p]
        slot[p] += 1
        left[p, row : row + 2] = jp[i]
        a2[p, row : row + 2, 9 * c : 9 * c + 9] = jc[i]
        b[p, row : row + 2] = -r[i]
    a2 = torch.cat([a2.reshape(P * br, m2), lam ** 0.5 * torch.eye(m2, dtype=torch.float64)])
    b = torch.cat([b.reshape(-1), torch.zeros(m2, dtype=torch.float64)])
    return functional.block_angular_lstsq(left, a2, b, tail=m2)


def test_ragged_step_matches_the_padded_dense_step(scene):
    x0 = scene[-1]
    aux = _aux(scene)
    lam = 0.7
    lam_t = torch.tensor(lam, dtype=torch.float64)
    got = bal._damped_step_aux(x0, bal._residuals_aux(x0, aux), lam_t, aux)
    want = _padded_dense_step(scene, lam)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9 * float(want.abs().max()))


@pytest.mark.parametrize("marks", [("bottom", "tsqr"), None])
def test_the_solve_marks_what_its_caller_names(scene, marks, monkeypatch):
    """Inside a loop body's capture (``graph_loop.marking``) the step marks
    its entry, and the solve the two points its caller names, in order; a
    solve given no names marks nothing.  A name outside ``MARKS`` raises."""
    x0 = scene[-1]
    aux = _aux(scene)
    r = bal._residuals_aux(x0, aux)
    solve = functional.block_angular_lstsq_ragged
    monkeypatch.setattr(bal, "block_angular_lstsq_ragged",
                        lambda *a, **k: solve(*a, **{**k, "marks": marks}))
    buf = torch.zeros((3, len(graph_loop.MARKS)), dtype=torch.int64)
    with graph_loop.marking(buf, torch.tensor(1, dtype=torch.int32)) as sink:
        bal._damped_step_aux(x0, r, torch.tensor(0.1, dtype=torch.float64), aux)
    assert sink.used and not buf[0].any() and not buf[2].any()
    row = dict(zip(graph_loop.MARKS, buf[1].tolist()))
    if marks is None:
        assert row["step"] > 0 and row["bottom"] == row["tsqr"] == 0
    else:
        assert 0 < row["step"] < row["bottom"] < row["tsqr"]
    with pytest.raises(ValueError, match="none of"):
        graph_loop.mark("solve")


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_the_bottom_and_the_largest_tensor(scene):
    """The bottom holds exactly 2·N + 9C rows and the camera columns (then
    the rhs); its rows of a point's padding stay out, and no tensor of the
    step is larger than its buffer: neither a dense A2 nor blocks padded to
    the longest track."""
    x0 = scene[-1]
    aux = _aux(scene)
    cam, _, _, buckets, _, _, rows = aux
    n_obs, m2 = cam.shape[0], bal.CAMERA * C
    assert rows == 2 * n_obs
    seen = torch.cat([d.reshape(-1) for _, _, d in buckets])
    real = seen[seen < rows]
    assert torch.equal(torch.sort(real).values, torch.arange(rows))  # each row once
    r = bal._residuals_aux(x0, aux)
    captured = {}
    ragged_left = functional._ragged_left

    def keep(*a, **k):
        captured["out"] = ragged_left(*a, **k)
        return captured["out"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(functional, "_ragged_left", keep)
        with _Shapes() as shapes:
            bal._damped_step_aux(x0, r, torch.tensor(0.1, dtype=torch.float64), aux)
    bottom = captured["out"][3]
    assert bottom.shape == (2 * n_obs + m2, m2 + 1)
    largest = max(int(np.prod(s)) for s in shapes.shapes)
    assert largest <= (2 * n_obs + m2 + 1) * (m2 + 1)


def test_bucket_plan():
    _, _, obs_cam, obs_pt, _ = bal.make_scene(C, 120, (1, 6), seed=3)
    plan = bal.bucket_plan(obs_cam, obs_pt, 120, C)
    track = np.bincount(obs_pt, minlength=120)
    assert np.array_equal(obs_pt[plan.order], np.sort(obs_pt))
    for pts, obs, slots, dest in plan.buckets:
        k = obs.shape[1]
        assert (track[pts] <= k).all()
        for p, o, s in zip(pts, obs, slots):
            kp = track[p]
            assert (o[kp:] == len(obs_cam)).all()
            assert np.array_equal(s[:kp], obs_cam[plan.order][o[:kp]])
            assert len(set(s.tolist())) == k  # padded slots: cameras the track lacks
    flat = np.concatenate([bk[0] for bk in plan.buckets])
    assert np.array_equal(flat[plan.inverse], np.arange(120))
    assert bal.bucket_widths(52)[:8] == list(range(1, 9))
    widths = bal.bucket_widths(52)
    assert widths[-1] == 52 and all(b - a <= max(1, a // 4) for a, b in zip(widths, widths[1:]))


def test_the_ragged_step_has_no_backward(scene):
    x0 = scene[-1]
    aux = _aux(scene)
    r = bal._residuals_aux(x0, aux)
    lam = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    out = bal._damped_step_aux(x0, r, lam, aux)
    with pytest.raises(RuntimeError, match="no backward"):
        out.sum().backward()


def test_fit_matches_the_reference_fit(scene):
    cams0, pts0, obs_cam, obs_pt, uv, _ = scene
    res = bal.fit_bal_device(cams0, pts0, obs_cam, obs_pt, uv, CFG, device=DEV,
                             dtype=torch.float64)
    settings = bal_lm.LMSettings(max_iters=CFG.max_iters, ftol=CFG.ftol, xtol=CFG.xtol)
    x, it, conv, cost = bal_lm.fit(cams0, pts0, obs_cam, obs_pt, uv, settings)
    assert res.converged and conv and res.iterations == it > 1
    assert abs(res.cost - cost) <= 1e-9 * cost
    assert np.isclose(bal_lm.cost64(res.x, obs_cam, obs_pt, uv, C), cost, rtol=1e-9)


@pytest.fixture
def recording():
    lm.clear_programs()
    with _program._use_backend(Recording), _program._use_loop_backend(RecordingLoop):
        yield
    lm.clear_programs()


def test_the_step_marks_its_parts(scene, recording):
    """A warm fit is one launch and one fetch.  In the captured loop (the
    test backend: the host's clock) each iteration marks the step's entry,
    its bottom and its TSQR in that order, between the stamps of the
    condition around it; the marks reach ``loop_records()`` under a
    profiler only."""
    cams0, pts0, obs_cam, obs_pt, uv, _ = scene

    def fit():
        return bal.fit_bal_device(cams0, pts0, obs_cam, obs_pt, uv, CFG, device=DEV,
                                  dtype=torch.float64)

    fit()
    n = len(profiling.loop_records())
    reads = lm.levenberg_marquardt_device.host_reads
    with profiling.count_dispatches() as d:
        fit()  # warm: one launch of the captured loop, one fetch
    assert d.programs == 1 and lm.levenberg_marquardt_device.host_reads == reads + 1
    assert len(profiling.loop_records()) == n  # no profiler: no record
    with profile(activities=[ProfilerActivity.CPU]):
        res = fit()
    recs = profiling.loop_records()
    assert len(recs) == n + 1
    rec = recs[-1]
    k = res.iterations
    assert rec["iterations"] == k and len(rec["marks"]) == k
    for i, row in enumerate(rec["marks"]):
        s0, s1, s2 = row["step"], row["bottom"], row["tsqr"]
        assert rec["stamps"][i] < s0 < s1 < s2 < rec["stamps"][i + 1]
