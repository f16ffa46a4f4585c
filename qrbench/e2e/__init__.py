"""End-to-end metrics, each ``compute(ctx)`` over the timed window's calls
(``ctx.records``, ``ctx.window_s``) or the set-up (``ctx.setup_s``)."""
import numpy as np


def p95_ms(records) -> float:
    """The 95th percentile of every call's wall time, in ms."""
    return float(np.percentile([r["end"] - r["start"] for r in records], 95)) * 1e3
