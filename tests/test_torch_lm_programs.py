"""One LM fit as one program, and the programs the fits run, in the port.

The reference runs each device fit as one compiled ``lax.while_loop``
(``qrkit_tpu/lm.py:levenberg_marquardt_device(_batch)``) and jits the
functional entry points the fits call (``block_diagonal_factorize``,
``block_angular_lstsq``, ``lm_damped_step_blockdiag(1)``) and the
lane-major ``BlockAngularQR`` route (``tests/test_block_angular_soa.py``'s
one-program pins).  In the port each of these is one captured program
(``qrkit_tpu_torch._program``); a fit is one launch of a graph whose
conditional WHILE node replays the iteration while kernel L1
(``ops/graph_loop.py``) finds the condition true.

On the CPU the calls run eagerly, so the bookkeeping runs through test-only
backends: ``Recording`` (``tests/test_torch_dispatch_count.py``) for the
programs and :class:`RecordingLoop` for the loops, whose launch runs init,
then the body while the plain condition ``(k < max_iters) & ~done.all()``
holds (counting each evaluation and writing it into the program's log and
the host's clock into its stamps, as L1 does with the device's), then the
tail, under a mode that raises on what a capture on the
card refuses.
Each program is held against ``qrkit_tpu`` at fp64 rtol 1e-10 and bitwise
against the same call under ``_program.eager()``; each fit's iterations
equal ``qrkit_tpu``'s, its x agrees at rtol 1e-10, and a warm fit is one
program and one host read with x, cost, λ, iterations and converged
bitwise equal to the eager loop's.

The ``cuda`` cases run the same on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_lm_programs.py``
(JAX is imported inside the reference helpers only).
"""
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import _program, functional, lm, profiling
from qrkit_tpu_torch.examples import ellipse as tell
from qrkit_tpu_torch.ops import graph_loop

from test_torch_dispatch_count import BUDGET_OPS, Recording, _NoHostSync

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA
TOL = dict(rtol=1e-10, atol=1e-12)


class RecordingLoop:
    """Test-only loop backend (``_program._use_loop_backend``): see the
    module docstring.  Nothing it runs is counted."""

    l1_counts = True  # each evaluation adds one to the program's count, as L1 does

    def __init__(self, init, body, tail, prog, pool, stream):
        self.parts, self.prog = (init, body, tail), prog

    def _run(self, fn):
        # a graph runs no Python: the steps' own programs are part of the body
        with _disable_current_modes(), _NoHostSync(), _program.eager():
            fn()

    def launch(self) -> None:
        init, body, tail = self.parts
        p = self.prog
        saved, issued = profiling.launch_counts(), profiling.collective_counts()
        self._run(init)
        while True:
            with _disable_current_modes():
                cond = bool(graph_loop._loop_condition_plain(p.done, p.k, p.max_iters))
                p.count.add_(int(self.l1_counts))
                p.log[int(p.k)] = int(cond)
                p.stamps[int(p.k)] = time.perf_counter_ns()
            if not cond:
                break
            self._run(body)
        self._run(tail)
        profiling._set_launch_counts(saved)  # the loop program adds what its capture issued
        profiling._set_collective_counts(issued)

    def close(self) -> None:
        self.parts = None


@pytest.fixture
def recording():
    with _program._use_backend(Recording), _program._use_loop_backend(RecordingLoop):
        yield
    functional.clear_programs()
    lm.clear_programs()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_tuple(a), _tuple(b)))


# --- the functional programs -----------------------------------------------------
def _functional_cases(rng, device):
    """name -> (call, reference); the reference imports JAX when called."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    blocks = rng.uniform(0.5, 5.0, size=(12, 7, 2))
    nb, br, bc, m2, tail = 24, 3, 2, 5, 5
    lblocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    right = rng.normal(size=(nb * br + tail, m2))
    b = rng.normal(size=nb * br + tail)
    left = rng.normal(size=(2, 2, 40))
    left1 = rng.normal(size=(2, 40))
    sright = rng.normal(size=(2, 5, 40))
    res = rng.normal(size=(2, 40))
    lam = 0.37
    tb, tl, tr, tv = t(blocks), t(lblocks), t(right), t(b)
    tleft, tleft1, tsright, tres = t(left), t(left1), t(sright), t(res)
    tlam = torch.tensor(lam, dtype=torch.float64, device=device)

    def ref(name):
        import jax.numpy as jnp

        from qrkit_tpu import functional as jf

        j = jnp.asarray
        return {
            "block_diagonal_factorize": lambda: jf.block_diagonal_factorize(j(blocks)),
            "block_diagonal_factorize_pivot": lambda: jf.block_diagonal_factorize(
                j(blocks), pivot=True),
            "block_angular_lstsq": lambda: jf.block_angular_lstsq(
                j(lblocks), j(right), j(b), n_shards=2, tail=tail),
            "lm_damped_step_blockdiag": lambda: jf.lm_damped_step_blockdiag(
                j(left), j(sright), j(res), j(lam)),
            "lm_damped_step_blockdiag1": lambda: jf.lm_damped_step_blockdiag1(
                j(left1), j(sright), j(res), j(lam)),
        }[name]()

    calls = {
        "block_diagonal_factorize": lambda: functional.block_diagonal_factorize(tb),
        "block_diagonal_factorize_pivot": lambda: functional.block_diagonal_factorize(
            tb, pivot=True),
        "block_angular_lstsq": lambda: functional.block_angular_lstsq(tl, tr, tv, 2, tail),
        "lm_damped_step_blockdiag": lambda: functional.lm_damped_step_blockdiag(
            tleft, tsright, tres, tlam),
        "lm_damped_step_blockdiag1": lambda: functional.lm_damped_step_blockdiag1(
            tleft1, tsright, tres, tlam),
    }
    return {name: (call, lambda name=name: ref(name)) for name, call in calls.items()}


FUNCTIONAL = ["block_diagonal_factorize", "block_diagonal_factorize_pivot", "block_angular_lstsq",
              "lm_damped_step_blockdiag", "lm_damped_step_blockdiag1"]


def _warm(call):
    """The first call (eager), the second (capture), then a replay, counted."""
    call()
    call()
    with qt.count_dispatches() as d:
        out = call()
    return out, d


def _budget(label, d):
    assert d.programs == 1 and d.ops <= BUDGET_OPS and d.host_reads == 0, (label, d)
    assert not any(d.host_launches.values()), (label, d.host_launches)


@pytest.mark.parametrize("name", FUNCTIONAL)
def test_functional_program(name, recording):
    """Each functional entry point: a warm call is one program, at most 3
    ATen ops, no host read; bitwise equal to the eager call and agreeing
    with qrkit_tpu at fp64 rtol 1e-10."""
    call, ref = _functional_cases(np.random.default_rng(0), DEV)[name]
    out, d = _warm(call)
    _budget(name, d)
    with _program.eager():
        assert _equal(out, call()), name
    for got, want in zip(_tuple(out), _tuple(ref())):
        if got.dtype == torch.int64:
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        else:
            np.testing.assert_allclose(_np(got), np.asarray(want), **TOL, err_msg=name)


def test_functional_host_lam_and_grad_run_outside_programs(recording):
    """A host ``lam`` is copied to the device before the step's program (the
    program is keyed by a tensor λ); a call with grad-requiring operands
    runs eagerly and keeps its implicit-function-theorem backward."""
    rng = np.random.default_rng(1)
    left, right, res = (torch.as_tensor(rng.normal(size=s)) for s in ((2, 40), (2, 5, 40), (2, 40)))
    for _ in range(3):
        x = functional.lm_damped_step_blockdiag1(left, right, res, 0.37)
    (slot, _), = functional._STEP1_PROGRAMS.programs().items()
    assert slot[2][3][0] == () and slot[2][3][2] == torch.float64  # λ: a 0-d tensor
    with _program.eager():
        assert torch.equal(x, functional.lm_damped_step_blockdiag1(left, right, res, 0.37))
    blocks = torch.tensor(rng.uniform(0.5, 5.0, size=(8, 3, 2)), requires_grad=True)
    a2 = torch.tensor(rng.normal(size=(24, 3)), requires_grad=True)
    b = torch.tensor(rng.normal(size=24), requires_grad=True)
    before = len(functional._ANGULAR_PROGRAMS.programs())
    for _ in range(3):
        x = functional.block_angular_lstsq(blocks, a2, b)
        assert x.requires_grad
    assert len(functional._ANGULAR_PROGRAMS.programs()) == before
    assert all(g is not None for g in torch.autograd.grad(x.sum(), (blocks, a2, b)))


# --- the lane-major BlockAngularQR route (tests/test_block_angular_soa.py) -------
def _soa_problem(rng, device, N=60, br=2, bc=1, m2=5):
    blocks = rng.uniform(0.5, 5.0, size=(N, br, bc))
    a2 = rng.uniform(0.5, 5.0, size=(N * br, m2))
    b = rng.normal(size=N * br)
    soa = torch.as_tensor(blocks.transpose(1, 2, 0).reshape(br * bc, N), device=device)
    left = qt.BlockDiagonal.from_soa(soa, br, bc, nrows=N * br)
    mat = qt.BlockMatrix1x2(left, torch.as_tensor(np.ascontiguousarray(a2.T), device=device),
                            right_t=True)
    qr = qt.BlockAngularQR(qt.BlockDiagonalQR(qt.QFormat.FULL_Q, pivot=False), qt.DenseColPivQR())
    return dict(blocks=blocks, a2=a2, b_np=b, b=torch.as_tensor(b, device=device), mat=mat, qr=qr)


def _soa_calls(st):
    qr, mat, b = st["qr"], st["mat"], st["b"]
    return [
        ("compute", lambda: qr.compute(mat), lambda _: qr.r_diagonal()),
        ("solve", lambda: qr.solve(b), lambda x: x),
        ("compute_solve", lambda: qr.compute_solve(mat, b), lambda x: x),
    ]


def _soa_reference(st):
    import jax.numpy as jnp

    from qrkit_tpu.containers import BlockDiagonal as JBlockDiagonal
    from qrkit_tpu.containers import BlockMatrix1x2 as JBlockMatrix1x2
    from qrkit_tpu.solvers import BlockAngularQR as JBlockAngularQR
    from qrkit_tpu.solvers import BlockDiagonalQR as JBlockDiagonalQR
    from qrkit_tpu.solvers import DenseColPivQR as JColPiv
    from qrkit_tpu.solvers.block_diagonal import QFormat as JQFormat

    blocks, a2 = st["blocks"], st["a2"]
    N, br, bc = blocks.shape
    left = JBlockDiagonal.from_soa(jnp.asarray(blocks.transpose(1, 2, 0).reshape(br * bc, N)),
                                   br, bc, nrows=N * br)
    mat = JBlockMatrix1x2(left, jnp.asarray(np.ascontiguousarray(a2.T)), right_t=True)
    jq = JBlockAngularQR(JBlockDiagonalQR(JQFormat.FULL_Q, pivot=False), JColPiv())
    jq.compute(mat)
    assert jq._fused_soa
    b = jnp.asarray(st["b_np"])
    return {"compute": jq.r_diagonal(), "solve": jq.solve(b), "compute_solve": jq.solve(b)}


def test_soa_route_programs(recording):
    """The lane-major compute, solve and compute_solve: one program each
    when warm (the reference's pins), at most 3 ATen ops, no host read;
    bitwise equal to eager, and against qrkit_tpu at fp64 rtol 1e-10."""
    st = _soa_problem(np.random.default_rng(2), DEV)
    ref = _soa_reference(st)
    for label, call, read in _soa_calls(st):
        out, d = _warm(call)
        _budget(label, d)
        assert st["qr"]._fused_soa, label
        got = read(out)
        with _program.eager():
            assert torch.equal(got, read(call())), label
        np.testing.assert_allclose(_np(got), np.asarray(ref[label]), **TOL, err_msg=label)
    assert st["qr"].info() == qt.ComputationInfo.SUCCESS


def test_soa_compute_solve_returns_fresh_x_and_keeps_solve(recording):
    """compute_solve's x survives the next replay, and a warm compute keeps
    the route's solve program (only another factorization drops it)."""
    st = _soa_problem(np.random.default_rng(3), DEV)
    qr, mat, b = st["qr"], st["mat"], st["b"]
    for _ in range(3):
        x = qr.compute_solve(mat, b)
    kept = x.clone()
    qr.compute_solve(mat, b * 2.0)
    assert torch.equal(x, kept)
    for _ in range(2):
        qr.compute(mat)
    for _ in range(2):
        qr.solve(b)
    qr.compute(mat)  # a replay of the same factorize program
    names = sorted(k[0] for k in qr._programs.programs())
    assert "BlockAngularQR.soa_solve" in names and "BlockAngularQR.soa_compute" in names
    with qt.count_dispatches() as d:
        qr.solve(b)
    assert d.programs == 1


# --- the LM fits as one loop program ---------------------------------------------------
def _linear(rng, m=40, n=7):
    """tests/test_torch_lm.py's linear problem: residual A x − b (its damped
    step here in a form a capture takes)."""
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    return A, b


def _torch_linear(A, b, device):
    At, bt = torch.as_tensor(A, device=device), torch.as_tensor(b, device=device)
    n = A.shape[1]

    def residual(x, aux=None):
        return At @ x - bt

    def damped_step(x, r, lam, aux=None):
        # solve_ex: linalg.solve's LU solve without its host check of the
        # factorization's info, which a capture refuses
        H = At.T @ At + lam * torch.eye(n, dtype=At.dtype, device=At.device)
        return torch.linalg.solve_ex(H, -(At.T @ r))[0]

    return residual, damped_step


ELLIPSES = [(7.5, 2.0, 17.0, 23.0, 0.23), (5.0, 3.0, -2.0, 4.0, 0.7), (4.0, 1.5, 0.0, 0.0, 1.1)]


def _fit_cases(device):
    """name -> (fit() -> LMResult with NumPy fields, reference() -> the
    qrkit_tpu result); the reference imports JAX when called."""
    A, b = _linear(np.random.default_rng(42))  # test_torch_lm.py's (the rng fixture's seed)
    residual, damped_step = _torch_linear(A, b, device)
    x0 = torch.zeros(A.shape[1], dtype=torch.float64, device=device)
    pts = tell.ellipse_points(tell.Ellipse(), 200)
    pts_b = np.stack([tell.ellipse_points(tell.Ellipse(*e), 64) for e in ELLIPSES])

    def linear():
        return lm.levenberg_marquardt_device(residual, damped_step, x0, lm.LMConfig(max_iters=20))

    def linear_ref():
        import jax.numpy as jnp

        from qrkit_tpu import lm as jlm

        Aj, bj = jnp.asarray(A), jnp.asarray(b)
        n = A.shape[1]
        return jlm.levenberg_marquardt_device(
            lambda x, aux=None: Aj @ x - bj,
            lambda x, r, lam, aux=None: jnp.linalg.solve(
                Aj.T @ Aj + lam * jnp.eye(n, dtype=Aj.dtype), -(Aj.T @ r)),
            jnp.zeros(A.shape[1]), jlm.LMConfig(max_iters=20))

    def solo():
        return tell.fit_ellipse(pts, device=device)[0]

    def solo_ref():
        from qrkit_tpu.examples import ellipse as jell

        return jell.fit_ellipse(pts)[0]

    def batch():
        return tell.fit_ellipse_batch(pts_b, lm.LMConfig(max_iters=40), device=device)

    def batch_ref():
        from qrkit_tpu import lm as jlm
        from qrkit_tpu.examples import ellipse as jell

        return jell.fit_ellipse_batch(pts_b, jlm.LMConfig(max_iters=40))

    return {"linear": (linear, linear_ref), "fit_ellipse_200": (solo, solo_ref),
            "fit_ellipse_batch_3x64": (batch, batch_ref)}


def _fields(res):
    return [np.asarray(v) for v in (res.x, res.cost, res.lambda_final, res.iterations,
                                    res.converged)]


def _bitwise(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(_fields(a), _fields(b)))


def _reads():
    return lm.levenberg_marquardt_device.host_reads


def _k3_k4(iterations, starts):
    """The ellipse fit's K3 and K4 launches over ``iterations`` iterations
    and ``starts`` starts of the loop (K4r once each)."""
    return {"lm_step": iterations, "ellipse_residuals": 2 * iterations + starts,
            "ellipse_jacobian": iterations, "ellipse_residuals_vjp": iterations}


def _drive_fit(fit, device=DEV, steps=False):
    """The first fit of the key (iteration 1 eager, the capture, the fit as
    one launch), then a warm fit counted; checks the loop's bookkeeping
    against the eager fit and returns (eager result, warm result).
    ``steps``: the fit is the ellipse's, whose damped step K3 launches
    once an iteration on the card and whose model K4 launches K4r twice
    (the trial residual, the gradient's forward), K4j and K4g once an
    iteration, K4r once more at the loop's start (on the CPU their plain
    versions launch none)."""
    lm.clear_programs()
    with _program.eager():
        eager = fit()
    k = int(np.max(eager.iterations))
    assert k > 1, k  # a fit that its first iteration finishes is not captured
    reads = _reads()
    with qt.count_dispatches() as d:
        first = fit()
    assert _reads() - reads == 2, (k, _reads() - reads)  # iteration 1, the fetch
    k3 = steps and device.type == "cuda"
    # K3 and K4: iteration 1, the capture's warm-up body, then the loop (K4r
    # also at the eager start and the loop's)
    want = {"graph_loop_cond": k + 1, **(_k3_k4(k + 2, starts=2) if k3 else {})}
    assert {n: v for n, v in d.launches.items() if v} == want
    (prog,) = lm._LOOPS.programs().values()
    assert _bitwise(first, eager)
    prog.log.fill_(-1)
    reads = _reads()
    with qt.count_dispatches() as d:
        warm = fit()
    if device.type == "cuda":
        torch.cuda.synchronize()
    assert _reads() - reads == 1  # the fetch (on the CPU not a device-to-host copy)
    assert d.programs == 1 and d.host_reads == (device.type == "cuda"), d
    assert not any(d.host_launches.values()), d.host_launches
    want = {"graph_loop_cond": k + 1, **(_k3_k4(k, starts=1) if k3 else {})}
    assert {n: v for n, v in d.launches.items() if v} == want
    assert _bitwise(warm, eager)
    # L1 against its plain condition on every iteration: true until the
    # eager loop's last iteration, then false
    assert prog.log.cpu().tolist()[: k + 1] == [1] * k + [0]
    return eager, warm


@pytest.mark.parametrize("name", ["linear", "fit_ellipse_200", "fit_ellipse_batch_3x64"])
def test_fit_is_one_loop_program(name, recording):
    """A warm fit is one program and one host read, bitwise the eager
    loop's; iterations equal qrkit_tpu's and x agrees at fp64 rtol 1e-10."""
    fit, ref = _fit_cases(DEV)[name]
    _, warm = _drive_fit(fit)
    want = ref()
    np.testing.assert_array_equal(np.asarray(warm.iterations), np.asarray(want.iterations))
    np.testing.assert_array_equal(np.asarray(warm.converged), np.asarray(want.converged))
    np.testing.assert_allclose(np.asarray(warm.x), np.asarray(want.x), **TOL)


def test_loop_holds_what_its_graphs_read(recording):
    """A captured loop's graphs read and write its state in place, and the
    card's backend keeps no reference to the captured functions: the
    program itself holds every tensor they reach (the inputs, the state
    buffers, the counters and the functions' own tensors), so none is freed
    while the graph lives."""
    fit, _ = _fit_cases(DEV)["fit_ellipse_200"]
    lm.clear_programs()
    fit()
    (prog,) = lm._LOOPS.programs().values()
    reached = _program._held_tensors(prog._loop.parts)
    kept = {id(t) for t in (*prog.static_in, *prog.buffers, *prog.held, prog.done, prog.k,
                            prog.count, prog.out, prog.log)}
    assert reached and prog.buffers
    assert all(id(t) in kept for t in reached), [tuple(t.shape) for t in reached if id(t) not in kept]


def test_loop_keys_are_bounded_and_cleared(recording):
    """A key is the functions, the config and the operands; four keys are
    kept (the oldest closed first) and ``clear_programs`` drops them all."""
    lm.clear_programs()
    A, b = _linear(np.random.default_rng(6))
    residual, damped_step = _torch_linear(A, b, DEV)
    x0 = torch.zeros(A.shape[1], dtype=torch.float64)
    progs = []
    for iters in (20, 21, 22, 23, 24):
        cfg = lm.LMConfig(max_iters=iters, ftol=0.0, xtol=0.0)
        for _ in range(2):
            lm.levenberg_marquardt_device(residual, damped_step, x0, cfg)
        progs.append(lm._LOOPS.programs())
    assert [len(p) for p in progs] == [1, 2, 3, 4, 4]
    first = next(iter(progs[0].values()))
    assert first._loop is None  # closed when it left the cache
    assert all(p._loop is not None for p in lm._LOOPS.programs().values())
    lm.clear_programs()
    assert not lm._LOOPS.programs() and all(p._loop is None for p in progs[-1].values())


def test_eager_loop_paths(recording):
    """Fits under ``_program.eager()`` and operands that require grad run
    the eager loop: no loop program, one host read an iteration.  A
    ``reduce=`` fit is captured as a solo fit is (the mesh fits' loop):
    ``reduce`` keys the loop, the first fit reads the host after its eager
    iteration 1 and once for the launch, a warm fit once; x and the
    iterations bitwise the eager loop's."""
    lm.clear_programs()
    A, b = _linear(np.random.default_rng(7))
    residual, damped_step = _torch_linear(A, b, DEV)
    x0 = torch.zeros(A.shape[1], dtype=torch.float64)
    cfg = lm.LMConfig(max_iters=20)
    for _ in range(2):
        reads = _reads()
        got = lm.levenberg_marquardt_device(residual, damped_step, x0.clone().requires_grad_(), cfg)
        assert _reads() - reads == got.iterations
    with _program.eager():
        reads = _reads()
        want = lm.levenberg_marquardt_device(residual, damped_step, x0, cfg)
        assert _reads() - reads == want.iterations
    assert not lm._LOOPS.programs()
    total = lambda t: t  # noqa: E731  (one device: the identity)
    counts = []
    for _ in range(3):
        reads = _reads()
        got = lm.levenberg_marquardt_device(residual, damped_step, x0, cfg, reduce=total)
        counts.append(_reads() - reads)
    assert counts == [2, 1, 1] and len(lm._LOOPS.programs()) == 1
    assert np.array_equal(got.x, want.x) and got.iterations == want.iterations > 1


def test_tree_aux_is_captured(recording):
    """An ``aux`` that is a tree of tensors and other values is one loop
    program: its tensors are inputs (a warm fit from new values is bitwise
    the eager fit's), the rest keys the loop; an ``aux`` that cannot be
    captured raises with the program's name."""
    lm.clear_programs()
    A, b = _linear(np.random.default_rng(9))
    n = A.shape[1]

    def residual(x, aux):
        return aux["A"] @ x - aux["b"] * aux["scale"][0]

    def damped_step(x, r, lam, aux):
        At = aux["A"]
        H = At.T @ At + lam * torch.eye(n, dtype=At.dtype)
        return torch.linalg.solve_ex(H, -(At.T @ r))[0]

    x0 = torch.zeros(n, dtype=torch.float64)
    cfg = lm.LMConfig(max_iters=20)

    def fit(scale, bb=b):
        aux = {"A": torch.as_tensor(A), "b": torch.as_tensor(bb), "scale": (scale, "tag")}
        return lm.levenberg_marquardt_device(residual, damped_step, x0, cfg, aux=aux)

    for scale in (1.0, 2.0):
        _drive_fit(lambda: fit(scale))
    lm.clear_programs()
    fit(1.0), fit(1.0)
    with qt.count_dispatches() as d:
        warm = fit(1.0, b + 1.0)
    with _program.eager():
        eager = fit(1.0, b + 1.0)
    assert d.programs == 1 and _bitwise(warm, eager)
    fit(2.0)
    assert len(lm._LOOPS.programs()) == 2  # the scale keys the loop
    with pytest.raises(ValueError, match="levenberg_marquardt_device: aux tensors"):
        lm.levenberg_marquardt_device(residual, damped_step, x0, cfg,
                                      aux={"A": torch.empty(A.shape, device="meta")})
    with pytest.raises(TypeError, match="levenberg_marquardt_device: aux's structure"):
        fit(np.array([1.0]))


def test_loop_recaptures_when_held_tensors_change(recording):
    """The tensors a captured loop's functions hold are kept alive with it;
    a fit after a closure variable was rebound captures the loop again and
    reads the new tensor, while an in-place change is read by the same
    loop."""
    lm.clear_programs()
    A, b = _linear(np.random.default_rng(10))
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    n = A.shape[1]

    def residual(x, aux=None):
        return At @ x - bt

    def damped_step(x, r, lam, aux=None):
        H = At.T @ At + lam * torch.eye(n, dtype=At.dtype)
        return torch.linalg.solve_ex(H, -(At.T @ r))[0]

    x0 = torch.zeros(n, dtype=torch.float64)
    cfg = lm.LMConfig(max_iters=20)

    def fit():
        return lm.levenberg_marquardt_device(residual, damped_step, x0, cfg)

    fit()
    (first,) = lm._LOOPS.programs().values()
    assert any(t is At for t in first.held) and any(t is bt for t in first.held)
    At = At * 2.0  # rebinds the closure cell: the old tensor stays held
    _, warm = _drive_fit(fit)  # clears, captures from the new At, checks bitwise
    fit()
    (second,) = lm._LOOPS.programs().values()
    assert first._loop is None and any(t is At for t in second.held)
    bt.add_(1.0)  # in place: the same loop reads the new values
    with qt.count_dispatches() as d:
        got = fit()
    with _program.eager():
        eager = fit()
    assert d.programs == 1 and lm._LOOPS.programs()[next(iter(lm._LOOPS.programs()))] is second
    assert _bitwise(got, eager) and not _bitwise(got, warm)
    At = At + 0.0  # a new tensor again: the loop is captured again
    reads = _reads()
    fit()
    assert _reads() - reads == 2 and next(iter(lm._LOOPS.programs().values())) is not second


class _SilentL1(RecordingLoop):
    l1_counts = False


def test_loop_launch_checks_l1_count(recording):
    """A launch whose L1 count is not one more than its iterations (a loop
    whose condition did not run as built) raises with the program's name."""
    lm.clear_programs()
    A, b = _linear(np.random.default_rng(11))
    residual, damped_step = _torch_linear(A, b, DEV)
    x0 = torch.zeros(A.shape[1], dtype=torch.float64)
    with _program._use_loop_backend(_SilentL1):
        with pytest.raises(RuntimeError, match="levenberg_marquardt_device: L1 evaluated"):
            lm.levenberg_marquardt_device(residual, damped_step, x0, lm.LMConfig(max_iters=20))


def test_cpu_fits_run_eagerly():
    """Without a loop backend a CPU fit runs the eager loop (the caller
    asked for the CPU): no program, one host read an iteration."""
    lm.clear_programs()
    pts = tell.ellipse_points(tell.Ellipse(), 100)
    for _ in range(2):
        reads = _reads()
        result, _ = tell.fit_ellipse(pts, device=DEV)
        assert _reads() - reads == result.iterations
    assert not lm._LOOPS.programs()


def test_loop_condition_plain():
    """L1's plain version on the CPU: ``(k < max_iters) & ~done.all()``,
    no launch counted."""
    before = graph_loop.loop_condition.launches
    for done, k, want in (([False, True], 3, True), ([True, True], 3, False),
                          ([False], 9, True), ([False], 10, False), ([], 0, False)):
        got = graph_loop.loop_condition(torch.tensor(done, dtype=torch.bool),
                                        torch.tensor(k, dtype=torch.int32), 10)
        assert got.dtype == torch.bool and bool(got) == want, (done, k)
    assert graph_loop.loop_condition.launches == before
    with pytest.raises(ValueError):
        graph_loop.loop_condition(torch.zeros(3), torch.tensor(0, dtype=torch.int32), 10)


# --- on the card ------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    yield torch.device("cuda")
    functional.clear_programs()
    lm.clear_programs()


@pytest.mark.cuda
def test_cuda_loop_condition(cuda_device):
    """L1 against its plain version on the card, every case of a batch."""
    rng = np.random.default_rng(8)
    for n in (1, 3, 16, 300, 5000):
        for k in (0, 5, 9, 10, 11):
            for frac in (0.0, 0.5, 1.0):
                done = torch.as_tensor(rng.random(n) < frac, device=cuda_device)
                kk = torch.tensor(k, dtype=torch.int32, device=cuda_device)
                before = graph_loop.loop_condition.launches
                got = graph_loop.loop_condition(done, kk, 10)
                assert graph_loop.loop_condition.launches == before + 1
                assert torch.equal(got, graph_loop._loop_condition_plain(done, kk, 10)), (n, k, frac)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTIONAL)
def test_cuda_functional_program(name, cuda_device):
    """On the card: one replay, at most 3 ATen ops, no host read, bitwise
    equal to the same call under ``_program.eager()``."""
    call, _ = _functional_cases(np.random.default_rng(0), cuda_device)[name]
    out, d = _warm(call)
    torch.cuda.synchronize()
    _budget(name, d)
    with _program.eager():
        eager = call()
    assert _equal(out, eager) and _equal(call(), eager), name


@pytest.mark.cuda
def test_cuda_soa_route_programs(cuda_device):
    st = _soa_problem(np.random.default_rng(2), cuda_device)
    for label, call, read in _soa_calls(st):
        out, d = _warm(call)
        torch.cuda.synchronize()
        _budget(label, d)
        got = read(out)
        with _program.eager():
            eager = read(call())
        assert torch.equal(got, eager) and torch.equal(read(call()), eager), label


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["linear", "fit_ellipse_200", "fit_ellipse_batch_3x64"])
def test_cuda_fit_is_one_loop_program(name, cuda_device):
    """On the card: a warm fit is one graph launch, one host read, no
    host-issued launch, L1 once an iteration and once before the loop,
    the ellipse fits' step (K3) once an iteration, bitwise the eager
    loop's."""
    fit, _ = _fit_cases(cuda_device)[name]
    _drive_fit(fit, cuda_device, steps=name.startswith("fit_ellipse"))


def test_replay_clones_are_exact_copies():
    """A solve program hands out fresh copies of its outputs in one op,
    ``_foreach_mul`` by 1, which keeps every bit (signed zeros, subnormals,
    infinities, integers); bool outputs are cloned one by one."""
    outs = (torch.tensor([1.5, -0.0, float("inf"), 1e-310, -3e-320], dtype=torch.float64),
            torch.tensor([3, -4]), torch.tensor([1e-40, -0.0], dtype=torch.float32))
    with qt.count_dispatches() as d:
        fresh = _program._clones(outs + (None,))
    assert d.ops == 1 and fresh[-1] is None
    for a, b in zip(outs, fresh):
        assert a.dtype == b.dtype and a.data_ptr() != b.data_ptr()
        assert torch.equal(a.view(torch.int64) if a.dtype == torch.float64 else a,
                           b.view(torch.int64) if b.dtype == torch.float64 else b)
        assert torch.equal(torch.signbit(a), torch.signbit(b)) if a.is_floating_point() else True
    flags = _program._clones((torch.tensor([True]), torch.tensor([1.0])))
    assert flags[0].dtype == torch.bool and bool(flags[0])
