"""Port functional.block_diagonal_* against qrkit_tpu.functional, fp64.

Forward solutions and factors, and the implicit-diff backward against
``jax.vjp`` with the same cotangent (1e-9), plus ``torch.autograd.gradcheck``
of the backward on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrkit_tpu import functional as jf
from qrkit_tpu_torch import functional as tf

TOL = dict(rtol=1e-9, atol=1e-9)


def _system(seed, nb=12, br=7, bc=2):
    rng = np.random.default_rng(seed)
    blocks = rng.uniform(0.5, 5.0, size=(nb, br, bc))
    b = rng.normal(size=nb * br + 3)  # 3 ignored tail rows
    g = rng.normal(size=nb * bc)
    return blocks, b, g


@pytest.mark.parametrize("pivot", [False, True], ids=["nopivot", "pivot"])
def test_lstsq_forward_matches(pivot):
    blocks, b, _ = _system(0)
    x = tf.block_diagonal_lstsq(torch.as_tensor(blocks), torch.as_tensor(b), pivot=pivot)
    want = jf.block_diagonal_lstsq(jnp.asarray(blocks), jnp.asarray(b), pivot=pivot)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pivot", [False, True], ids=["nopivot", "pivot"])
def test_lstsq_backward_matches_jax_vjp(pivot):
    blocks, b, g = _system(1)
    A = torch.tensor(blocks, requires_grad=True)
    v = torch.tensor(b, requires_grad=True)
    x = tf.block_diagonal_lstsq(A, v, pivot=pivot)
    gA, gb = torch.autograd.grad(x, (A, v), torch.as_tensor(g))
    _, vjp = jax.vjp(
        lambda a, c: jf.block_diagonal_lstsq(a, c, pivot=pivot),
        jnp.asarray(blocks), jnp.asarray(b),
    )
    jgA, jgb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(gA.numpy(), np.asarray(jgA), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), **TOL)


@pytest.mark.parametrize("pivot", [False, True], ids=["nopivot", "pivot"])
def test_lstsq_gradcheck(pivot):
    blocks, b, _ = _system(2, nb=4)
    A = torch.tensor(blocks, requires_grad=True)
    v = torch.tensor(b, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, c: tf.block_diagonal_lstsq(a, c, pivot=pivot), (A, v)
    )


@pytest.mark.parametrize("pivot", [False, True], ids=["nopivot", "pivot"])
def test_factorize_matches(pivot):
    blocks, _, _ = _system(3)
    Q, R, perm = tf.block_diagonal_factorize(torch.as_tensor(blocks), pivot=pivot)
    jQ, jR, jperm = jf.block_diagonal_factorize(jnp.asarray(blocks), pivot=pivot)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=1e-10, atol=1e-12)
