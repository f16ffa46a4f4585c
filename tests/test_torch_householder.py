"""Port ops/householder.py against qrkit_tpu.ops.householder, fp64.

Both sides run the same recurrence in fp64, so factors agree to rtol 1e-10;
the atol of 1e-12 covers entries that are zero up to rounding (the reduced
matrix below R's diagonal).  The port runs batched; the JAX side runs one
block at a time.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrkit_tpu.ops import householder as jh
from qrkit_tpu_torch.ops import householder as th

TOL = dict(rtol=1e-10, atol=1e-12)

# the reference functions, compiled once per shape (eager dispatch of their
# unrolled loops costs seconds per call)
_j_panel = jax.jit(jax.vmap(jh.panel_qr_yt))
_j_colpiv = jax.jit(jh.colpiv_householder_qr)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "shape", [(7, 2), (9, 4), (6, 6), (20, 17), (3, 5)],
    ids=["7x2", "9x4", "square", "recursive", "landscape"],
)
def test_panel_qr_yt_matches(rng, shape):
    batch = rng.uniform(0.5, 5.0, size=(2,) + shape)
    Y, T, R = th.panel_qr_yt(torch.as_tensor(batch))
    jY, jT, jR = _j_panel(jnp.asarray(batch))
    _close(Y, jY)
    _close(T, jT)
    _close(R, jR)
    _close(th.form_q(Y[0], T[0]), jh.form_q(jY[0], jT[0]))


@pytest.mark.parametrize("offset", [0, 2])
def test_unblocked_and_t_factor_match(rng, offset):
    A = rng.normal(size=(8, 3))
    Y, taus, Ared = th.householder_qr_unblocked(torch.as_tensor(A), offset)
    jY, jtaus, jAred = jax.jit(
        functools.partial(jh.householder_qr_unblocked, offset=offset)
    )(jnp.asarray(A))
    _close(Y, jY)
    _close(taus, jtaus)
    _close(Ared, jAred)
    _close(th.build_t_factor(Y, taus), jh.build_t_factor(jY, jtaus))


@pytest.mark.parametrize(
    "shape", [(7, 2), (6, 6), (4, 7), (10, 5)],
    ids=["7x2", "square", "landscape", "rank_deficient"],
)
def test_colpiv_matches(rng, shape):
    A = rng.normal(size=shape)
    if shape == (10, 5):
        A[:, 3] = A[:, 0] + 2.0 * A[:, 1]  # rank 4
    Y, taus, R, perm = th.colpiv_householder_qr(torch.as_tensor(A[None]))
    jY, jtaus, jR, jperm = _j_colpiv(jnp.asarray(A))
    # past the numerical rank the remaining columns are rounding noise and
    # the reflectors built from them are arbitrary: compare up to the rank
    k = min(shape)
    live = 4 if shape == (10, 5) else k
    np.testing.assert_array_equal(perm[0].numpy()[:live], np.asarray(jperm)[:live])
    _close(Y[0][:, :live], jY[:, :live])
    _close(taus[0][:live], jtaus[:live])
    _close(R[0][:live], jR[:live])
    d = torch.diagonal(R[0][:k], dim1=-2, dim2=-1)
    jd = jnp.diagonal(jR[:k])
    assert int(th.rank_from_diag(d, *shape)) == int(jh.rank_from_diag(jd, *shape))


def test_apply_wy_matches(rng):
    A = rng.normal(size=(9, 4))
    M = rng.normal(size=(9, 3))
    Y, T, _ = th.panel_qr_yt(torch.as_tensor(A))
    jY, jT, _ = (t[0] for t in _j_panel(jnp.asarray(A[None])))
    for transpose in (False, True):
        _close(
            th.apply_wy(Y, T, torch.as_tensor(M), transpose=transpose),
            jh.apply_wy(jY, jT, jnp.asarray(M), transpose=transpose),
        )


@pytest.mark.parametrize("k", [0, 2, 4])
def test_rank_masked_triangular_solve_matches(rng, k):
    R = np.triu(rng.uniform(0.5, 2.0, size=(4, 4)))
    y = rng.normal(size=4)
    got = th.rank_masked_triangular_solve(torch.as_tensor(R), torch.as_tensor(y), torch.tensor(k))
    _close(got, jh.rank_masked_triangular_solve(jnp.asarray(R), jnp.asarray(y), jnp.asarray(k)))


def test_rank_from_diag_batched_matches(rng):
    d = rng.normal(size=(5, 3))
    d[1, 2] = 1e-18
    d[3, 1:] = 0.0
    got = th.rank_from_diag(torch.as_tensor(d), 7, 3).numpy()
    want = [int(jh.rank_from_diag(jnp.asarray(row), 7, 3)) for row in d]
    np.testing.assert_array_equal(got, want)


def test_highest_precision_restores_flags():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with th.highest_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            with th.highest_precision():
                pass
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize(
    "shape,panel_width", [((7, 2), 16), ((20, 17), 16), ((20, 17), 4), ((40, 36), 16)],
    ids=["7x2", "recursive", "narrow_panels", "library_qr"],
)
def test_batched_panel_qr_yt_matches(rng, shape, panel_width):
    """``batched_panel_qr_yt`` against the reference's vmap of ``panel_qr_yt``."""
    batch = rng.uniform(0.5, 5.0, size=(3,) + shape)
    got = th.batched_panel_qr_yt(torch.as_tensor(batch), panel_width)
    want = jax.jit(jh.batched_panel_qr_yt, static_argnames="panel_width")(
        jnp.asarray(batch), panel_width=panel_width)
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(ValueError):
        th.batched_panel_qr_yt(torch.as_tensor(batch[0]))


def _ops_case(name, rng):
    """(port call, reference call) of one name of ``ops``, on one input."""
    import qrkit_tpu.ops as jops
    import qrkit_tpu_torch.ops as tops

    A = rng.uniform(0.5, 5.0, size=(9, 4))
    M = rng.normal(size=(9, 3))
    Y, T, _ = th.panel_qr_yt(torch.as_tensor(A))
    jY, jT, _ = jh.panel_qr_yt(jnp.asarray(A))
    Y2, T2, _ = th.panel_qr_yt(torch.as_tensor(rng.uniform(0.5, 5.0, size=(2, 6, 2))))
    t, j = getattr(tops, name), getattr(jops, name)
    return {
        "apply_wy": (lambda: t(Y, T, torch.as_tensor(M), transpose=True),
                     lambda: j(jY, jT, jnp.asarray(M), transpose=True)),
        "batched_panel_qr_yt": (lambda: t(torch.as_tensor(A[None])), lambda: j(jnp.asarray(A[None]))),
        "build_t_factor": (lambda: t(*th.householder_qr_unblocked(torch.as_tensor(A))[:2]),
                           lambda: j(*jh.householder_qr_unblocked(jnp.asarray(A))[:2])),
        "colpiv_householder_qr": (lambda: t(torch.as_tensor(A)), lambda: j(jnp.asarray(A))),
        "form_q": (lambda: t(Y, T), lambda: j(jY, jT)),
        "householder_qr_unblocked": (lambda: t(torch.as_tensor(A), 1),
                                     lambda: j(jnp.asarray(A), 1)),
        "panel_qr_yt": (lambda: t(torch.as_tensor(A), 0, 2), lambda: j(jnp.asarray(A), 0, 2)),
        "CompactWYSeq": (  # two 6×2 blocks at rows 0 and 3 of a 9-row operand, Qᵀ then Q
            lambda: [(s := t(Y2, T2, [0, 3], 9)).apply_qt(torch.as_tensor(M)),
                     s.apply_q(torch.as_tensor(M))],
            lambda: [(s := j(jnp.asarray(Y2.numpy()), jnp.asarray(T2.numpy()), jnp.asarray([0, 3]),
                             9)).apply_qt(jnp.asarray(M)), s.apply_q(jnp.asarray(M))]),
    }[name]


@pytest.mark.parametrize("name", ["apply_wy", "batched_panel_qr_yt", "build_t_factor",
                                  "colpiv_householder_qr", "form_q", "householder_qr_unblocked",
                                  "panel_qr_yt", "CompactWYSeq"])
def test_ops_exports_match_reference(rng, name):
    """``qrkit_tpu_torch.ops`` exports the reference's names, each agreeing
    with ``qrkit_tpu.ops``'s in fp64."""
    import qrkit_tpu.ops as jops
    import qrkit_tpu_torch.ops as tops

    assert name in tops.__all__ and set(tops.__all__) == set(jops.__all__)
    got, want = (f() for f in _ops_case(name, rng))
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == torch.int64:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)
