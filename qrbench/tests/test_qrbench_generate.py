"""Every traffic's generator is repeatable from ``--seed``."""
import numpy as np
import pytest
import torch

from qrbench import generate
from qrbench.callers import Order, Sample

from .cells import small_cell

BIG = 2**31 + 12345  # seeds may pass 32 signed bits


@pytest.mark.parametrize("workload", ["ellipse-n500k", "ellipse-b100-n500"])
def test_ellipse_catalog_is_fixed_by_the_traffic_file(workload):
    _, config, mix = small_cell(workload)
    t1, p1 = generate.ellipse_catalog(config, mix)
    t2, p2 = generate.ellipse_catalog(config, mix)
    assert np.array_equal(t1, t2) and all(np.array_equal(a, b) for a, b in zip(p1, p2))
    assert t1.shape == (mix["catalog_calls"], mix["problems_per_call"], 5)
    for k, key in enumerate(generate.TRUTH_KEYS):
        lo, hi = config["truth_ranges"][key]
        assert lo <= t1[..., k].min() and t1[..., k].max() <= hi
    want = (2, mix["points"]) if mix["problems_per_call"] == 1 else (
        mix["problems_per_call"], 2, mix["points"])
    assert p1[0].shape == want


def test_call_order_is_seeded_and_covers_the_catalog():
    a = [Order(5, BIG).next() for _ in range(1)]
    o1, o2, o3 = Order(5, BIG), Order(5, BIG), Order(5, BIG + 1)
    s1 = [o1.next() for _ in range(20)]
    assert s1 == [o2.next() for _ in range(20)] and a[0] == s1[0]
    assert s1 != [o3.next() for _ in range(20)]
    for k in range(4):
        assert sorted(s1[5 * k:5 * k + 5]) == list(range(5))


@pytest.mark.parametrize("workload", ["banded-c3-refactor"])
def test_banded_inputs_are_seeded(workload):
    _, config, mix = small_cell(workload)
    rows, cols, shape = generate.banded_pattern(config)
    assert shape == (config["blocks"] * config["block_rows"],
                     (config["block_cols"] - config["overlap"]) * config["blocks"]
                     + config["overlap"])
    assert rows.size == config["blocks"] * config["block_rows"] * config["block_cols"]
    v1 = generate.banded_values(config, BIG, mix["value_sets"], rows.size, "cpu")
    v2 = generate.banded_values(config, BIG, mix["value_sets"], rows.size, "cpu")
    v3 = generate.banded_values(config, BIG + 1, mix["value_sets"], rows.size, "cpu")
    assert torch.equal(v1, v2) and not torch.equal(v1, v3)
    assert 0.5 <= float(v1.min()) and float(v1.max()) <= 5.0
    b1 = generate.banded_rhs(BIG, mix["rhs_pool"], shape[0], mix["rhs_columns"], "cpu")
    b2 = generate.banded_rhs(BIG, mix["rhs_pool"], shape[0], mix["rhs_columns"], "cpu")
    assert torch.equal(b1, b2) and b1.shape[:2] == (mix["rhs_pool"], shape[0])


def test_sample_is_seeded_and_bounded():
    def draw(seed):
        s = Sample(3, seed)
        for i in range(50):
            s.offer(i)
        return s.items

    assert draw(BIG) == draw(BIG) and len(draw(BIG)) == 3 and draw(BIG) != draw(BIG + 1)
