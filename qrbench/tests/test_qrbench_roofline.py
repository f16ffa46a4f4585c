"""The roofline counts give the kernel table's bytes at its shapes
(PERF.md §6: K3 6.0 / 30 MB at 100k / 500k points, K1 5.3 MB and K2 0.78 MB
on config 3's vector)."""
import pytest

from qrbench.roofline import bound_s, k1, k2, k3, share_pct

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("points,mb", [(100_000, 6.0), (500_000, 30.0)])
def test_k3_bytes(points, mb):
    nbytes, flops = k3.cost(points)
    assert round(nbytes / 1e6, 1) == mb and flops > 0


def test_k3_batch_counts_each_problem():
    assert k3.cost(10_000, 16)[0] == 16 * k3.cost(10_000)[0]


def test_k1_bytes_on_config3_vector():
    assert round(k1.cost(2499, 40, 8, 99_960, 1)[0] / 1e6, 1) == 5.3


def test_k2_bytes_on_config3_vector():
    assert round(k2.cost(2499, 8, 10_000, 1)[0] / 1e6, 2) == 0.78


def test_share_against_the_byte_bound():
    nbytes, flops = k3.cost(500_000)
    assert bound_s(nbytes, flops, H100) == pytest.approx(nbytes / 3.35e12)
    assert share_pct(nbytes, flops, H100, 2 * nbytes / 3.35e12) == pytest.approx(50.0)
    assert share_pct(nbytes, flops, "some other card", 1.0) is None
