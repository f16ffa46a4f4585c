"""The port's LM stack against qrkit_tpu, fp64: ``block_angular_lstsq`` and
its implicit-diff gradient, the lane-major damped steps, the three LM
drivers and the ellipse application.

Tolerances: solutions and gradients rtol 1e-10 (atol 1e-10); whole LM fits
the same iteration count and the final x within 1e-8; a batched fit equals
the solo fits to 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrkit_tpu import functional as jf
from qrkit_tpu import lm as jlm
from qrkit_tpu.examples import ellipse as jell

from qrkit_tpu_torch import functional as tf
from qrkit_tpu_torch import lm as tlm
from qrkit_tpu_torch.examples import ellipse as tell

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA

TOL = dict(rtol=1e-10, atol=1e-10)


def close(got, want, **tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _angular(rng, nb=24, br=3, bc=2, m2=5, tail=0):
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    right = rng.normal(size=(nb * br + tail, m2))
    b = rng.normal(size=nb * br + tail)
    return blocks, right, b


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("tail", [0, 5])
def test_block_angular_lstsq_matches(rng, n_shards, tail):
    blocks, right, b = _angular(rng, tail=tail)
    x = tf.block_angular_lstsq(
        torch.as_tensor(blocks), torch.as_tensor(right), torch.as_tensor(b), n_shards, tail
    )
    want = jf.block_angular_lstsq(
        jnp.asarray(blocks), jnp.asarray(right), jnp.asarray(b), n_shards=n_shards, tail=tail
    )
    close(x, want)


@pytest.mark.parametrize("tail", [0, 5])
def test_block_angular_lstsq_n_shards_bitwise(rng, tail):
    """On one device ``n_shards`` does not change the arithmetic: the bottom
    is one R-only QR (``ops.tall_qr.r_and_qtb``) whatever the shard count."""
    args = tuple(torch.as_tensor(t) for t in _angular(rng, nb=50, tail=tail))
    xs = [tf.block_angular_lstsq(*args, n_shards, tail) for n_shards in (1, 2, 4)]
    assert all(torch.equal(xs[0], x) for x in xs[1:])


@pytest.mark.parametrize("n_shards,tail", [(1, 5), (2, 0)])
def test_block_angular_lstsq_gradient_matches_jax(rng, n_shards, tail):
    blocks, right, b = _angular(rng, tail=tail)
    g = rng.normal(size=blocks.shape[0] * blocks.shape[2] + right.shape[1])
    A, R, v = (torch.tensor(t, requires_grad=True) for t in (blocks, right, b))
    x = tf.block_angular_lstsq(A, R, v, n_shards, tail)
    grads = torch.autograd.grad(x, (A, R, v), torch.as_tensor(g))
    _, vjp = jax.vjp(
        lambda a, r, c: jf.block_angular_lstsq(a, r, c, n_shards=n_shards, tail=tail),
        jnp.asarray(blocks), jnp.asarray(right), jnp.asarray(b),
    )
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        close(got, want, rtol=1e-9, atol=1e-9)


def test_block_angular_lstsq_gradcheck(rng):
    blocks, right, b = _angular(rng, nb=4, tail=2, m2=3)
    args = tuple(torch.tensor(t, requires_grad=True) for t in (blocks, right, b))
    assert torch.autograd.gradcheck(lambda a, r, c: tf.block_angular_lstsq(a, r, c, 1, 2), args)


@pytest.mark.parametrize("bc", [1, 2])
def test_lm_damped_step_matches(rng, bc):
    bl, m2, nb = 2, 5, 40
    left = rng.normal(size=(bl, bc, nb))
    right = rng.normal(size=(bl, m2, nb))
    res = rng.normal(size=(bl, nb))
    lam = 0.37
    x1, x2 = tf.lm_damped_step_blockdiag(
        torch.as_tensor(left), torch.as_tensor(right), torch.as_tensor(res),
        torch.tensor(lam, dtype=torch.float64),
    )
    jx1, jx2 = jf.lm_damped_step_blockdiag(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(res), jnp.asarray(lam)
    )
    close(x1, jx1)
    close(x2, jx2)
    if bc == 1:
        close(
            tf.lm_damped_step_blockdiag1(
                torch.as_tensor(left[:, 0]), torch.as_tensor(right), torch.as_tensor(res), lam
            ),
            jf.lm_damped_step_blockdiag1(
                jnp.asarray(left[:, 0]), jnp.asarray(right), jnp.asarray(res), jnp.asarray(lam)
            ),
        )


def test_lm_damped_step_solves_damped_system(rng):
    """Independent of JAX: the step is the damped least-squares minimizer."""
    bl, bc, m2, nb = 2, 2, 3, 7
    left = rng.normal(size=(bl, bc, nb))
    right = rng.normal(size=(bl, m2, nb))
    res = rng.normal(size=(bl, nb))
    lam = 0.5
    x1, x2 = tf.lm_damped_step_blockdiag(
        torch.as_tensor(left), torch.as_tensor(right), torch.as_tensor(res), lam
    )
    J = np.zeros((bl * nb, bc * nb + m2))
    for i in range(nb):
        J[i * bl : (i + 1) * bl, i * bc : (i + 1) * bc] = left[:, :, i]
        J[i * bl : (i + 1) * bl, bc * nb :] = right[:, :, i]
    r = res.T.reshape(-1)
    delta = np.linalg.solve(J.T @ J + lam * np.eye(J.shape[1]), -J.T @ r)
    close(torch.cat([x1.T.reshape(-1), x2]), delta, rtol=1e-9, atol=1e-10)


# --- LM drivers on the reference's linear problem (tests/test_lm.py) ----------------
def _linear(rng, m=40, n=7):
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    return A, b


def _torch_linear(A, b):
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    n = A.shape[1]

    def residual(x, aux=None):
        return At @ x - bt

    def damped_step(x, r, lam, aux=None):
        H = At.T @ At + lam * torch.eye(n, dtype=At.dtype)
        return torch.linalg.solve(H, -(At.T @ r))

    return residual, damped_step


def _jax_linear(A, b):
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    n = A.shape[1]

    def residual(x, aux=None):
        return Aj @ x - bj

    def damped_step(x, r, lam, aux=None):
        return jnp.linalg.solve(Aj.T @ Aj + lam * jnp.eye(n, dtype=Aj.dtype), -(Aj.T @ r))

    return residual, damped_step


def test_gain_ratio_is_one_and_matches_gauss_newton(rng):
    A, b = _linear(rng)
    residual, damped_step = _torch_linear(A, b)
    x = torch.as_tensor(rng.normal(size=A.shape[1]))
    r = residual(x)
    for lam in (1e-6, 1e-3, 1.0, 1e3):
        delta = damped_step(x, r, lam)
        r_new = residual(x + delta)
        g = torch.func.vjp(residual, x)[1](r)[0]
        pred = float(tlm.predicted_reduction(delta, g, lam))
        rho = (0.5 * float(r @ r) - 0.5 * float(r_new @ r_new)) / pred
        assert abs(rho - 1.0) < 1e-8, (lam, rho)
        jpred = float(jlm.predicted_reduction(jnp.asarray(delta.numpy()), jnp.asarray(g.numpy()), lam))
        assert abs(pred - jpred) <= 1e-12 * abs(jpred)


@pytest.mark.parametrize("driver", ["host", "device", "device_batch"])
def test_lm_drivers_match_on_linear_problem(rng, driver):
    A, b = _linear(rng)
    cfg_t, cfg_j = tlm.LMConfig(max_iters=20), jlm.LMConfig(max_iters=20)
    tr, ts = _torch_linear(A, b)
    jr, js = _jax_linear(A, b)
    x0 = np.zeros(A.shape[1])
    x_star, *_ = np.linalg.lstsq(A, b, rcond=None)
    if driver == "host":
        got = tlm.levenberg_marquardt(tr, ts, torch.as_tensor(x0), cfg_t)
        want = jlm.levenberg_marquardt(lambda x: jr(x), lambda x, r, lam: js(x, r, lam),
                                       jnp.asarray(x0), cfg_j)
        xs = (got.x, want.x)
    elif driver == "device":
        reads = tlm.levenberg_marquardt_device.host_reads
        got = tlm.levenberg_marquardt_device(tr, ts, torch.as_tensor(x0), cfg_t)
        assert tlm.levenberg_marquardt_device.host_reads - reads == got.iterations
        want = jlm.levenberg_marquardt_device(jr, js, jnp.asarray(x0), cfg_j)
        xs = (got.x, want.x)
    else:
        x0b = np.stack([x0, rng.normal(size=A.shape[1])])
        got = tlm.levenberg_marquardt_device_batch(tr, ts, torch.as_tensor(x0b), cfg_t)
        want = jlm.levenberg_marquardt_device_batch(jr, js, jnp.asarray(x0b), cfg_j)
        close(got.x, want.x, rtol=0, atol=1e-8)
        # the iteration counts are not compared here: once a linear problem
        # has converged, accepting a step turns on cost differences at
        # roundoff, which a batched solve rounds differently (the ellipse
        # test below holds the trajectories equal)
        assert got.converged.all()
        for i in range(2):
            solo = tlm.levenberg_marquardt_device(tr, ts, torch.as_tensor(x0b[i]), cfg_t)
            close(got.x[i], solo.x, rtol=0, atol=1e-10)
            close(got.x[i], x_star, rtol=0, atol=1e-8)
        return
    assert got.iterations == want.iterations and got.converged == want.converged
    assert got.iterations <= 6
    close(xs[0], xs[1], rtol=0, atol=1e-8)
    close(xs[0], x_star, rtol=0, atol=1e-8)


# --- the ellipse application (tests/test_lm_ellipse.py) -----------------------------
ELLIPSE = tell.Ellipse(7.5, 2.0, 17.0, 23.0, 0.23)


@pytest.mark.parametrize("loop", ["device", "host"])
def test_fit_ellipse_matches_jax(loop):
    pts = tell.ellipse_points(ELLIPSE, 200)
    np.testing.assert_array_equal(pts, jell.ellipse_points(jell.Ellipse(), 200))
    result, params = tell.fit_ellipse(pts, loop=loop, device=DEV)
    jresult, jparams = jell.fit_ellipse(pts, loop=loop)
    n = pts.shape[1]
    assert result.iterations == jresult.iterations
    assert result.cost < 1e-12
    x = result.x.numpy() if isinstance(result.x, torch.Tensor) else result.x
    close(x, jresult.x, rtol=0, atol=1e-8)
    truth = [ELLIPSE.a, ELLIPSE.b, ELLIPSE.x0, ELLIPSE.y0, ELLIPSE.r]
    close(params[n:], truth, rtol=0, atol=1e-6)
    close(params, jparams, rtol=0, atol=1e-8)


def test_fit_ellipse_class_based_step_matches():
    """fused=False: the host loop through BlockAngularQR (the fused dense
    path) instead of block_angular_lstsq."""
    pts = tell.ellipse_points(ELLIPSE, 120)
    result, params = tell.fit_ellipse(pts, loop="host", fused=False, device=DEV)
    jresult, _ = jell.fit_ellipse(pts, loop="host", fused=False)
    assert result.iterations == jresult.iterations
    close(result.x, jresult.x, rtol=0, atol=1e-8)


def test_fit_ellipse_batch_matches_solo():
    els = [
        tell.Ellipse(7.5, 2.0, 17.0, 23.0, 0.23),
        tell.Ellipse(5.0, 3.0, -2.0, 4.0, 0.7),
        tell.Ellipse(4.0, 1.5, 0.0, 0.0, 1.1),
    ]
    n = 64
    pts_batch = np.stack([tell.ellipse_points(el, n) for el in els])
    cfg = tlm.LMConfig(max_iters=40)
    batched = tell.fit_ellipse_batch(pts_batch, cfg, device=DEV)
    assert batched.x.shape == (3, n + 5)
    jbatched = jell.fit_ellipse_batch(pts_batch, jlm.LMConfig(max_iters=40))
    np.testing.assert_array_equal(batched.iterations, np.asarray(jbatched.iterations))
    for i in range(3):
        solo, _ = tell.fit_ellipse(pts_batch[i], cfg, loop="device", device=DEV)
        close(batched.x[i], solo.x, rtol=0, atol=1e-9)
        assert batched.iterations[i] == solo.iterations
        assert float(batched.cost[i]) < 1e-10


def test_damped_steps_match():
    """One damped step through the three stacks (block_angular_lstsq, the
    class-based composition, the banded left with its chain kernel's plain
    version) against each other and against the reference's."""
    pts = tell.ellipse_points(ELLIPSE, 80)
    lam = 1e-3
    fused = tell.EllipseFitting(pts, device=DEV)
    x0 = fused.initial_params()
    r0 = fused.residuals(x0)
    d_fused = fused.damped_step(x0, r0, lam)
    d_class = tell.EllipseFitting(pts, fused=False, device=DEV).damped_step(x0, r0, lam)
    d_banded = fused.damped_step_banded(x0, r0, lam)
    close(d_class, d_fused, rtol=0, atol=1e-8)
    close(d_banded, d_fused, rtol=0, atol=1e-8)
    jfun = jell.EllipseFitting(pts)
    jx0 = jfun.initial_params()
    jr0 = jfun.residuals(jx0)
    close(r0, jr0)
    close(d_fused, jfun.damped_step(jx0, jr0, lam))
    close(d_banded, jfun.damped_step_banded(jx0, jr0, lam))
    # the device loop's lane-major step agrees with the fused AoS step
    close(tell._damped_step_aux(x0, r0, torch.tensor(lam, dtype=torch.float64), fused.pts),
          d_fused, rtol=0, atol=1e-10)


def test_banded_step_runs_the_chain_kernel_path(monkeypatch):
    """On the CPU the banded left takes B5's plain version exactly once per
    step when the kernel tier is demanded (on a CUDA device "auto" takes the
    kernel)."""
    from qrkit_tpu_torch.ops import banded as bk
    from qrkit_tpu_torch.solvers import banded_blocked

    calls = []
    plain = bk._chain_qr_plain
    monkeypatch.setattr(bk, "_chain_qr_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    real = banded_blocked.BandedBlockedQR.__init__

    def demand_kernel(self, *args, **kw):
        kw["use_kernel"] = True
        real(self, *args, **kw)

    monkeypatch.setattr(banded_blocked.BandedBlockedQR, "__init__", demand_kernel)
    f = tell.EllipseFitting(tell.ellipse_points(ELLIPSE, 40), device=DEV)
    x0 = f.initial_params()
    f.damped_step_banded(x0, f.residuals(x0), 1e-3)
    assert calls == [1]
