"""The port's bundle-adjustment example against qrkit_tpu's, fp64, on the CPU.

Scene, residuals and the vmap + jacfwd Jacobian blocks equal the
reference's; one damped ``_BundleStep`` agrees with the reference's to rtol
1e-8 (the point blocks through B2's plain version, as the card runs B2); a
clean 3-camera, 16-point fit reaches cost < 1e-16 in the reference's
iteration count on both LM loops.  Oracle: tests/test_bundle.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrkit_tpu.examples import bundle as jb
from qrkit_tpu.lm import LMConfig as JLMConfig

import qrkit_tpu_torch as qt
from qrkit_tpu_torch.examples import bundle as tb

DEV = torch.device("cpu")  # the CPU tests name the device: entry points default to CUDA


def _perturbed(seed_scene, n_cams, n_pts, noise, dp=0.05):
    cams, pts, uv = tb.make_scene(n_cams=n_cams, n_pts=n_pts, noise=noise, seed=seed_scene)
    rng = np.random.default_rng(7)
    return cams + 0.02 * rng.normal(size=cams.shape), pts + dp * rng.normal(size=pts.shape), uv


def test_scene_residuals_and_jacobian_match():
    for args in ((3, 16, 0.01, 1), (4, 20, 1e-3, 5)):
        got, want = tb.make_scene(*args), jb.make_scene(*args)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-14, atol=1e-15)
    cams0, pts0, uv = _perturbed(1, 3, 16, 0.01)
    x = np.concatenate([pts0.ravel(), cams0.ravel()])
    np.testing.assert_allclose(tb.residuals(torch.as_tensor(x), torch.as_tensor(uv)).numpy(),
                               np.asarray(jb.residuals(jnp.asarray(x), jnp.asarray(uv))),
                               rtol=1e-12, atol=1e-14)
    for g, w in zip(tb._jacobian_blocks(torch.as_tensor(x), torch.as_tensor(uv)),
                    jb._jacobian_blocks(jnp.asarray(x), jnp.asarray(uv))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)
    # the tangent through _rodrigues' small-angle branch stays finite
    z = torch.zeros(6, dtype=torch.float64)
    z[3:] = torch.tensor([0.1, -0.2, 6.0], dtype=torch.float64)
    jac = torch.func.jacfwd(tb._project, argnums=0)(z, torch.ones(3, dtype=torch.float64))
    assert torch.isfinite(jac).all()


@pytest.mark.parametrize("use_kernel", [True, False], ids=["b2-plain", "batched"])
def test_bundle_step_matches(use_kernel):
    cams0, pts0, uv = _perturbed(1, 3, 16, 0.01)
    x = np.concatenate([pts0.ravel(), cams0.ravel()])
    r = tb.residuals(torch.as_tensor(x), torch.as_tensor(uv))
    step = tb._BundleStep(uv, device=DEV)
    step._qr.left.use_kernel = use_kernel  # True: B2's plain version on the CPU
    delta = step(torch.as_tensor(x), r, 1e-3)
    want = np.asarray(jb._BundleStep(uv)(jnp.asarray(x), jnp.asarray(r.numpy()), 1e-3))
    np.testing.assert_allclose(delta.numpy(), want, rtol=1e-8, atol=1e-8 * np.abs(want).max())
    qr = step.last_qr
    assert qr.info() == qt.ComputationInfo.SUCCESS
    assert qr._r12_coo is not None  # the camera block stayed sparse
    assert qr.left._kernel_mode == use_kernel
    # a second step on the same solver reuses its sparse-A2 plan; the fused
    # device step gives the same minimizer
    plan = qr._plan_cache["blockdiag_a2"]
    delta2 = step(torch.as_tensor(x), r, 1e-2)
    assert step.last_qr._plan_cache["blockdiag_a2"] is plan
    dev = tb._damped_step_device(torch.as_tensor(x), r, torch.tensor(1e-2, dtype=torch.float64),
                                 torch.as_tensor(uv))
    np.testing.assert_allclose(dev.numpy(), delta2.numpy(), rtol=1e-8, atol=1e-10)
    two = tb._make_damped_step(2)(torch.as_tensor(x), r, torch.tensor(1e-2, dtype=torch.float64),
                                  torch.as_tensor(uv))
    np.testing.assert_allclose(two.numpy(), dev.numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_clean_fit_matches_reference(loop):
    cams0, pts0, uv = _perturbed(3, 3, 16, 0.0)
    if loop == "host":
        res = tb.fit_bundle(cams0, pts0, uv, qt.LMConfig(max_iters=60), device=DEV)
        ref = jb.fit_bundle(cams0, pts0, uv, JLMConfig(max_iters=60))
    else:
        res = tb.fit_bundle_device(cams0, pts0, uv, qt.LMConfig(max_iters=60), device=DEV)
        ref = jb.fit_bundle_device(cams0, pts0, uv, JLMConfig(max_iters=60))
    assert res.cost < 1e-16, res.cost
    assert int(res.iterations) == int(ref.iterations)
    x = torch.as_tensor(np.asarray(res.x))
    assert float(tb.residuals(x, torch.as_tensor(uv)).abs().max()) < 1e-7


def test_noisy_device_fit_and_mesh_raises(tmp_path):
    """A noisy device fit gets down to the noise level; on a one-rank gloo
    mesh in this process the point-sharded fit gives the same result (the
    two-rank runs are in tests/test_torch_parallel.py)."""
    import torch.distributed as dist

    from qrkit_tpu_torch import dryrun

    cams0, pts0, uv = _perturbed(5, 3, 24, 1e-3, dp=0.02)
    cfg = qt.LMConfig(max_iters=60)
    res = tb.fit_bundle_device(cams0, pts0, uv, cfg, device=DEV)
    assert np.sqrt(2.0 * res.cost / uv.size) < 5e-3  # down at the noise level
    mesh = dryrun.init_rank(0, 1, "cpu", str(tmp_path / "store"))
    try:
        sharded = tb.fit_bundle_device(cams0, pts0, uv, cfg, mesh=mesh, device=DEV)
    finally:
        dist.destroy_process_group()
    assert sharded.iterations == res.iterations
    np.testing.assert_allclose(sharded.x, res.x, rtol=0, atol=1e-9)
