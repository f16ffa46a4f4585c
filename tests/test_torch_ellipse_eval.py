"""The ellipse model's residuals, Jacobian and gradient as kernel K4
(``ops.ellipse_eval``).

On the CPU the wrappers run their plain versions, the torch formulas K4
replaces.  Here they are held against ``qrkit_tpu.examples.ellipse``'s
``_residuals``, ``_residuals_soa`` and ``_jacobian_soa`` and the gradient
``jax.vjp`` gives (fp64, rtol 1e-12 with an absolute floor of 1e-12 times
the largest entry: one elementwise formula each, rounded differently only
in sin and cos), their gradients by ``torch.autograd.gradcheck``, the vmap
rules against a loop over the problems, ``torch.func.vjp`` under
``torch.func.vmap`` both ways round (the batch fit's pattern and its
transpose) against the plain vjp, one LM iteration's ATen ops (views left
out) against its pin, the launchers' arguments through a tensor that
reports a card (a point array's slice read through its row stride, no
copy) and the operands the wrappers refuse.

The ``cuda`` cases run on the card with ``python -m pytest --noconftest -m
cuda tests/test_torch_ellipse_eval.py`` (JAX is imported inside the
reference helpers only): K4r and K4j bitwise equal to their plain versions
on the card in fp32 and fp64 at N = 500, 500,000 and a 100 × 500 batch,
K4g's point entries bitwise equal and its five sums within rtol 1e-5
(fp32) / 1e-12 (fp64) of the plain version's, relative to the sum of
their terms' magnitudes (the sums run in another order), two calls bitwise
equal; a rank's slice read in place; a device fit whose captured loop,
replayed three times, gives the eager fit's bits, with K4's launches an
iteration counted.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qrkit_tpu_torch import _program, lm, profiling
from qrkit_tpu_torch.examples import ellipse
from qrkit_tpu_torch.ops import _build
from qrkit_tpu_torch.ops import ellipse_eval as ee

DEV = "cpu"
KERNELS = ("ellipse_residuals", "ellipse_residuals_vjp", "ellipse_jacobian")


def _problem(rng, n, lead=(), dtype=torch.float64, device=DEV):
    """Parameters near a fit's start and points near the ellipse, ``lead``
    problems: params ``[*lead, n + 5]``, pts ``[*lead, 2, n]``."""
    t = np.arange(n) * (1.3 * np.pi / max(n, 1)) + rng.normal(scale=0.05, size=(*lead, n))
    model = np.array([7.5, 2.0, 17.0, 23.0, 0.23]) + rng.normal(scale=0.1, size=(*lead, 5))
    params = np.concatenate([t, model], axis=-1)
    pts = np.stack([17.0 + 7.5 * np.cos(t), 23.0 + 2.0 * np.sin(t)], axis=-2)
    pts = pts + rng.normal(scale=0.01, size=pts.shape)
    return (torch.as_tensor(params, dtype=dtype, device=device),
            torch.as_tensor(pts, dtype=dtype, device=device))


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


@contextlib.contextmanager
def _dispatched():
    """The ATen ops a block dispatches, in order, inside
    ``profiling.count_dispatches()`` (which counts the same ops)."""
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func)
            return func(*args, **(kwargs or {}))

    with profiling.count_dispatches() as d, Record():
        yield ops
    assert d.ops == len(ops)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _k4(ops):
    """The port's custom ops among ``ops``, by name."""
    return sorted(str(op).split(".")[1] for op in ops if str(op).startswith("qrkit_tpu_torch."))


# --- against the reference ---------------------------------------------------------------

def _reference(name, params, pts):
    import jax.numpy as jnp
    from qrkit_tpu.examples import ellipse as jell

    fn = {"residuals": jell._residuals, "residuals_soa": jell._residuals_soa,
          "jacobian_soa": jell._jacobian_soa}[name]
    out = fn(jnp.asarray(params.numpy()), jnp.asarray(pts.numpy()))
    return out if isinstance(out, tuple) else (out,)


PORT = {"residuals": ellipse._residuals, "residuals_soa": ellipse._residuals_soa,
        "jacobian_soa": ellipse._jacobian_soa}


@pytest.mark.parametrize("n", [1, 7, 300])
@pytest.mark.parametrize("name", sorted(PORT))
def test_plain_versions_match_reference(name, n):
    """The port's model functions (the K4 wrappers, their plain versions on
    the CPU) against the reference's at fp64."""
    params, pts = _problem(np.random.default_rng(n), n)
    got = _as_tuple(PORT[name](params, pts))
    want = _reference(name, params, pts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


@pytest.mark.parametrize("n", [1, 300])
def test_vjp_matches_reference(n):
    """``torch.func.vjp`` of the residuals (K4g on the card) against
    ``jax.vjp`` of the reference's, and the wrapper called alone."""
    import jax
    import jax.numpy as jnp
    from qrkit_tpu.examples import ellipse as jell

    rng = np.random.default_rng(10 + n)
    params, pts = _problem(rng, n)
    rbar = torch.as_tensor(rng.normal(size=2 * n))
    got = torch.func.vjp(lambda p: ellipse._residuals(p, pts), params)[1](rbar)[0]
    jp = jnp.asarray(pts.numpy())
    want = jax.vjp(lambda p: jell._residuals(p, jp), jnp.asarray(params.numpy()))[1](
        jnp.asarray(rbar.numpy()))[0]
    _close(got, want)
    _close(ee.ellipse_residuals_vjp(params, rbar), want)


# --- gradients, vmap, the batch fit's transforms ------------------------------------------

def test_gradcheck():
    """The residuals' and the Jacobian's gradients (by the parameters and
    the points) against finite differences, fp64."""
    params, pts = _problem(np.random.default_rng(3), 6)
    ops = (params.requires_grad_(), pts.requires_grad_())
    assert torch.autograd.gradcheck(ee.ellipse_residuals, ops)
    assert torch.autograd.gradcheck(ee.ellipse_jacobian_residuals, ops)


VMAPPED = {
    "residuals": lambda p, x, rb: ee.ellipse_residuals(p, x),
    "vjp": lambda p, x, rb: ee.ellipse_residuals_vjp(p, rb),
    "jacobian": lambda p, x, rb: ee.ellipse_jacobian_residuals(p, x),
}


@pytest.mark.parametrize("name", sorted(VMAPPED))
def test_vmap_matches_loop(name):
    """Each op under ``torch.func.vmap`` over 3 problems is one call (its
    vmap rule joins the vmapped axis to its problem axis) and equals a loop
    over the problems; a point array shared by every problem (not mapped)
    too."""
    rng = np.random.default_rng(5)
    n, B = 9, 3
    params, pts = _problem(rng, n, (B,))
    rbar = torch.as_tensor(rng.normal(size=(B, 2 * n)))
    fn = VMAPPED[name]
    with _dispatched() as ops:
        got = _as_tuple(torch.func.vmap(fn)(params, pts, rbar))
    assert len(_k4(ops)) == 1
    loop = [_as_tuple(fn(params[i], pts[i], rbar[i])) for i in range(B)]
    for k, g in enumerate(got):
        _close(g, torch.stack([out[k] for out in loop]), rtol=1e-14)
    shared = _as_tuple(torch.func.vmap(fn, in_dims=(0, None, 0))(params, pts[0], rbar))
    for k, g in enumerate(shared):
        _close(g, torch.stack([_as_tuple(fn(params[i], pts[0], rbar[i]))[k] for i in range(B)]),
               rtol=1e-14)


@pytest.mark.parametrize("order", ["vjp_of_vmap", "vmap_of_vjp"])
def test_vjp_under_vmap(order):
    """``torch.func.vjp`` of the vmapped residuals (the batch driver's
    ``g = Jᵀr``) and ``vmap`` of the per-problem vjp both equal the plain
    vjp problem by problem; the first runs K4r and K4g once each for the
    batch."""
    rng = np.random.default_rng(8)
    n, B = 11, 3
    params, pts = _problem(rng, n, (B,))
    rbar = torch.as_tensor(rng.normal(size=(B, 2 * n)))
    with _dispatched() as ops:
        if order == "vjp_of_vmap":
            rf = torch.func.vmap(ellipse._residuals, in_dims=(0, 0))
            got = torch.func.vjp(lambda p: rf(p, pts), params)[1](rbar)[0]
        else:
            got = torch.func.vmap(lambda p, x, rb: torch.func.vjp(
                lambda q: ellipse._residuals(q, x), p)[1](rb)[0])(params, pts, rbar)
    assert _k4(ops) == ["ellipse_residuals", "ellipse_residuals_vjp"]
    want = torch.stack([ee._residuals_vjp_plain(params[i], rbar[i]) for i in range(B)])
    _close(got, want, rtol=1e-14)


def test_lm_iteration_dispatches():
    """One iteration of the solo ellipse fit's device loop (``lm._step``)
    dispatches at most 70 ATen ops, views left out (215 before K4): K4j
    once (the step's operands), K4r twice (the trial residual and the
    gradient's forward), K4g once, K3 once."""
    n = 500
    pts = torch.as_tensor(ellipse.ellipse_points(ellipse.Ellipse(), n))
    x0 = torch.as_tensor(ellipse.initial_params_np(pts.numpy()))[None]
    cfg = lm.LMConfig()

    def residual(x, aux):
        return ellipse._residuals_aux(x[0], aux)[None]

    def step(x, r, lam, aux):
        return ellipse._damped_step_aux(x[0], r[0], lam[0], aux)[None]

    state = lm._start(residual, x0, pts, cfg, lm._identity)
    with _dispatched() as ops:
        lm._step(residual, step, state, pts, cfg, lm._identity)
    assert _k4(ops) == ["ellipse_jacobian", "ellipse_residuals", "ellipse_residuals",
                        "ellipse_residuals_vjp", "lm_damped_step"]
    computed = [op for op in ops if not op.is_view]
    assert len(computed) <= 70, len(computed)


# --- the routes ----------------------------------------------------------------------------

class _OnCuda1(torch.Tensor):
    """A CPU tensor that reports cuda:1, so the wrapper takes its kernel path."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.fixture
def launch_recorder(monkeypatch):
    """The K4 library swapped for a recorder of (name, args); the stream of
    cuda:N reads as 1000 + N.  The launch counters are restored after."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def record(*args):
                calls.append((name, args))
                return 0

            record.__name__ = name
            return record

    monkeypatch.setattr(_build, "load_ellipse_eval", lambda: Library())
    monkeypatch.setattr(_build, "current_stream", lambda device: 1000 + device)
    for fn in profiling._KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    _build.ellipse_launcher.cache_clear()
    yield calls
    _build.ellipse_launcher.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_path_reaches_its_launchers(launch_recorder, dtype):
    """Operands on cuda:1 reach each launcher with ordinal 1, cuda:1's
    stream, the operands and their strides, the outputs, N and the
    problems; a rank's slice of a wider point array goes in place (its row
    stride, no copy); one launch counted each."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    n, wide, P = 300, 1000, 3
    params, pts = _problem(np.random.default_rng(2), n, (P,), dtype)
    params = params.as_subclass(_OnCuda1)
    whole = torch.zeros((2, wide), dtype=dtype)
    view = whole[:, 100:100 + n].as_subclass(_OnCuda1)
    for fn, name in ((ee._residuals_kernel, "residuals"), (ee._jacobian_kernel, "jacobian")):
        out = fn(params[:1], view[None])
        ((got, args),) = launch_recorder
        assert got == f"qrk_ellipse_{name}_{sfx}" and args[0] == 1 and args[-1] == 1001
        assert args[1:6] == (params.data_ptr(), n + 5, view.data_ptr(), 2 * wide, wide)
        outs = out if isinstance(out, tuple) else (out,)
        assert args[6:-3] == tuple(t.data_ptr() for t in outs) and args[-3:-1] == (n, 1)
        launch_recorder.clear()
    rbar = torch.zeros((P, 2 * n), dtype=dtype).as_subclass(_OnCuda1)
    g = ee._vjp_kernel(params, rbar)
    ((got, args),) = launch_recorder
    assert got == f"qrk_ellipse_vjp_{sfx}" and g.shape == (P, n + 5)
    assert args[1:5] == (params.data_ptr(), n + 5, rbar.data_ptr(), g.data_ptr())
    assert args[-3:-1] == (n, P)
    counts = profiling.launch_counts()
    assert {k: counts[k] for k in KERNELS} == dict.fromkeys(KERNELS, 1)


def test_cpu_never_builds(monkeypatch):
    """A CPU tensor runs the plain versions: nothing is built or counted."""
    monkeypatch.setattr(_build, "load_ellipse_eval", lambda: pytest.fail("built on the CPU"))
    before = profiling.launch_counts()
    params, pts = _problem(np.random.default_rng(1), 5)
    ee.ellipse_residuals(params, pts)
    ee.ellipse_jacobian_residuals(params, pts)
    ee.ellipse_residuals_vjp(params, torch.zeros(10, dtype=torch.float64))
    assert profiling.launch_counts() == before


BAD = {
    "int params": (lambda p, x: (p.long(), x), TypeError),
    "half": (lambda p, x: (p.half(), x.half()), TypeError),
    "mixed dtypes": (lambda p, x: (p, x.float()), TypeError),
    "two devices": (lambda p, x: (p, x.to("meta")), TypeError),
    "three rows": (lambda p, x: (p, torch.cat([x, x[:1]])), ValueError),
    "too few points": (lambda p, x: (p, x[:, :-1]), ValueError),
    "no model": (lambda p, x: (p[:4], x[:, :0]), ValueError),
    "leading axes differ": (lambda p, x: (p[None].expand(2, -1), x), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
@pytest.mark.parametrize("wrapper", ["residuals", "jacobian", "vjp"])
def test_refuses_bad_operands(case, wrapper):
    params, pts = _problem(np.random.default_rng(0), 4)
    make, err = BAD[case]
    p, x = make(params, pts)
    with pytest.raises(err):
        if wrapper == "residuals":
            ee.ellipse_residuals(p, x)
        elif wrapper == "jacobian":
            ee.ellipse_jacobian_residuals(p, x)
        else:  # r̄ in place of the points, [..., 2N] as they are [..., 2, N]
            ee.ellipse_residuals_vjp(p, x.reshape(*x.shape[:-2], -1))


# --- on the card --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CUDA_CASES = [(500, ()), (500_000, ()), (500, (100,))]  # N, problems


def _ids(case):
    n, lead = case
    return f"{'x'.join(map(str, lead))}{'x' if lead else ''}{n}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernels_match_plain(cuda_device, case, dtype):
    """K4r and K4j bitwise equal to their plain versions on the card; K4g's
    point entries bitwise, its five sums within rtol of Σ|terms|; two calls
    of each bitwise equal; one launch each."""
    n, lead = case
    rng = np.random.default_rng(n + len(lead))
    params, pts = _problem(rng, n, lead, dtype, cuda_device)
    rbar = torch.as_tensor(rng.normal(size=(*lead, 2 * n)), dtype=dtype, device=cuda_device)
    before = profiling.launch_counts()
    r = ee.ellipse_residuals(params, pts)
    jac = ee.ellipse_jacobian_residuals(params, pts)
    g = ee.ellipse_residuals_vjp(params, rbar)
    again = (ee.ellipse_residuals(params, pts), ee.ellipse_jacobian_residuals(params, pts),
             ee.ellipse_residuals_vjp(params, rbar))
    torch.cuda.synchronize()
    counts = profiling.launch_counts()
    assert {k: counts[k] - before[k] for k in KERNELS} == dict.fromkeys(KERNELS, 2)
    assert torch.equal(r, ee._residuals_plain(params, pts))
    for got, want in zip(jac, ee._jacobian_residuals_plain(params, pts)):
        assert torch.equal(got, want)
    want = ee._residuals_vjp_plain(params, rbar)
    assert torch.equal(g[..., :n], want[..., :n])
    left, right = ee._jacobian_plain(params, n)
    rb = rbar.reshape(*lead, n, 2)
    scale = (right[..., 0, :, :] * rb[..., None, :, 0]).abs().sum(-1) \
        + (right[..., 1, :, :] * rb[..., None, :, 1]).abs().sum(-1)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    assert ((g[..., n:] - want[..., n:]).abs() <= rtol * scale).all()
    assert torch.equal(r, again[0]) and all(torch.equal(a, b) for a, b in zip(jac, again[1]))
    assert torch.equal(g, again[2])


@pytest.mark.cuda
def test_cuda_rank_slice_in_place(cuda_device):
    """A rank's slice of a wider point array (the mesh step's view) gives
    the bits of the same points made contiguous."""
    params, pts = _problem(np.random.default_rng(4), 3000, (), torch.float32, cuda_device)
    lo, hi = 1000, 2000
    sub = torch.cat([params[lo:hi], params[3000:]])
    view = pts[:, lo:hi]
    for a, b in zip(ee.ellipse_jacobian_residuals(sub, view),
                    ee.ellipse_jacobian_residuals(sub, view.contiguous())):
        assert torch.equal(a, b)
    assert torch.equal(ee.ellipse_residuals(sub, view), ee.ellipse_residuals(sub, view.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [False, True], ids=["solo", "batch"])
def test_cuda_fit_replays_bitwise(cuda_device, batch):
    """A device fit's captured loop replayed three times gives the eager
    fit's bits; a warm fit runs K4r 2k + 1 times (the start, then the
    trial residual and the gradient's forward an iteration), K4j and K4g k
    times, K3 k times."""
    cfg = lm.LMConfig(max_iters=40, ftol=1e-8, xtol=1e-8)
    n = 500
    if batch:
        pts = np.stack([ellipse.ellipse_points(ellipse.Ellipse(r=0.2 + 0.01 * i), n) for i in range(4)])

        def fit():
            return ellipse.fit_ellipse_batch(pts, cfg, dtype=torch.float32, device=cuda_device)
    else:
        pts = ellipse.ellipse_points(ellipse.Ellipse(), n)

        def fit():
            return ellipse.fit_ellipse(pts, cfg, dtype=torch.float32, device=cuda_device)[0]

    lm.clear_programs()
    with _program.eager():
        eager = fit()
    fit()  # the capture
    k = int(np.max(eager.iterations))
    for _ in range(3):
        with profiling.count_dispatches() as d:
            warm = fit()
        torch.cuda.synchronize()
        assert d.programs == 1
        assert {n_: v for n_, v in d.launches.items() if v} == {
            "graph_loop_cond": k + 1, "lm_step": k, "ellipse_residuals": 2 * k + 1,
            "ellipse_jacobian": k, "ellipse_residuals_vjp": k}
        for a, b in zip(warm, eager):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    lm.clear_programs()
