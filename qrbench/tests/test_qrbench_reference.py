"""The plain references against dense solutions at small sizes."""
import numpy as np
import pytest
import torch

from qrbench import generate
from qrbench.reference import banded_lstsq, ellipse_lm

BANDED = {"blocks": 30, "block_rows": 12, "block_cols": 8, "overlap": 4, "values": [0.5, 5.0]}


def dense(rows, cols, shape, vals):
    a = np.zeros(shape)
    a[rows, cols] = vals
    return a


@pytest.mark.parametrize("columns", [1, 3])
def test_banded_reference_matches_dense_lstsq(columns):
    rows, cols, shape = generate.banded_pattern(BANDED)
    vals = generate.banded_values(BANDED, 5, 1, rows.size, "cpu")[0]
    b = generate.banded_rhs(5, 1, shape[0], columns, "cpu")[0]
    ne = banded_lstsq.NormalEquations(rows, cols, shape, vals)
    want = np.linalg.lstsq(dense(rows, cols, shape, vals.double().numpy()), b.double().numpy(),
                           rcond=None)[0]
    np.testing.assert_allclose(ne.solve(b).numpy(), want, rtol=1e-10, atol=1e-12)


def test_banded_control_is_tf32():
    rows, cols, shape = generate.banded_pattern(BANDED)
    vals = generate.banded_values(BANDED, 6, 1, rows.size, "cpu")[0]
    b = generate.banded_rhs(6, 1, shape[0], 1, "cpu")[0]
    want = banded_lstsq.NormalEquations(rows, cols, shape, vals).solve(b).numpy()
    got = banded_lstsq.NormalEquations(rows, cols, shape, vals, "tf32").solve(b).numpy()
    gap = np.abs(got - want).max() / np.abs(want).max()
    assert 1e-5 < gap < 1e-1


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.0])
    assert banded_lstsq.tf32_round(x).tolist() == [1.0 + 2.0 ** -10, 1.0, 3.0]


def test_ellipse_reference_recovers_the_truth():
    truth = (7.1, 1.8, 16.5, 23.4, 0.27)
    pts = generate.ellipse_points(truth, 800, ellipse_lm.ARC)
    x, iters, converged = ellipse_lm.fit(pts)
    assert converged and iters <= 40
    np.testing.assert_allclose(x[800:], truth, rtol=1e-9)
    t = np.arange(800) * (ellipse_lm.ARC / 800)
    np.testing.assert_allclose(x[:800], t, atol=1e-9)


def test_ellipse_step_matches_dense_damped_lstsq():
    """The Schur-complement step is the damped least-squares step of the
    dense Jacobian."""
    n = 40
    pts = torch.as_tensor(generate.ellipse_points((7.5, 2, 17, 23, 0.23), n, ellipse_lm.ARC))
    x = torch.as_tensor(ellipse_lm.initial_guess(pts.numpy()))
    r = ellipse_lm.residuals(x, pts)
    d, e = ellipse_lm.jacobian(x, pts)
    jac = torch.zeros(2 * n, n + 5, dtype=torch.float64)
    for i in range(n):
        jac[2 * i:2 * i + 2, i] = d[:, i]
        jac[2 * i:2 * i + 2, n:] = e[:, :, i]
    lam = 0.01
    aug = torch.cat([jac, lam ** 0.5 * torch.eye(n + 5, dtype=torch.float64)])
    rhs = torch.cat([-r.T.reshape(-1), torch.zeros(n + 5, dtype=torch.float64)])
    want = torch.linalg.lstsq(aug, rhs[:, None]).solution[:, 0]
    got, g = ellipse_lm.damped_step(x, pts, r, torch.tensor(lam, dtype=torch.float64))
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-11)
    torch.testing.assert_close(g, jac.T @ r.T.reshape(-1), rtol=1e-12, atol=1e-12)


def test_canonical_resolves_the_ambiguities():
    swapped = np.array([0.0, -2.0, 7.5, 17.0, 23.0, 0.23 + 0.5 * np.pi])
    np.testing.assert_allclose(ellipse_lm.canonical(swapped, 1)[1:], [7.5, -2.0, 17.0, 23.0, 0.23])
    negative = np.array([0.0, -7.5, -2.0, 17.0, 23.0, 0.23 - np.pi])
    np.testing.assert_allclose(ellipse_lm.canonical(negative, 1)[1:], [7.5, 2.0, 17.0, 23.0, 0.23])
