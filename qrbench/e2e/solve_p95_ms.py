"""95th percentile of the wall time of every call in the window."""
from . import p95_ms


def compute(ctx):
    return p95_ms(ctx.records)
