"""95th percentile of the wall time of every fit call in the window: from
the call with host points to the host holding the canonical parameters."""
from . import p95_ms


def compute(ctx):
    return p95_ms(ctx.records)
