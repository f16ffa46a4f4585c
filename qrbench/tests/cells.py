"""The cells at sizes the CPU runs in a second or two, for the
benchmark's own tests (run them with ``python -m pytest qrbench/tests``;
the card's with ``-m cuda``)."""
from qrbench import registry


SMALL = {
    "ellipse-n500k": ({}, {"points": 1500, "catalog_calls": 3}),
    "ellipse-b100-n500": ({}, {"points": 300, "catalog_calls": 2, "problems_per_call": 3}),
    "banded-c3-refactor": ({"blocks": 70}, {"value_sets": 2, "rhs_pool": 2}),
}


def small_cell(workload):
    """(bench, config, mix) of ``workload`` at a size the CPU runs in a
    second or two: its widths as the files say, its scale cut."""
    bench = registry.benchmark()
    _, config, mix = registry.cell(bench, workload)
    co, mo = SMALL[workload]
    return bench, {**config, **co}, {**mix, **mo}
