"""K1's share of its roofline in a solve: the bound of the problem's Qᵀ
(``roofline/k1.py``) over the device time of K1's kernel records
(``kernels/k1.json``) inside ``qrbench.solve`` a call (the segmented
solver applies its segments' and its boundary chain's Qᵀ, one record
each)."""
from ..registry import kernels
from ..roofline import k1, share_pct
from . import per_call_seconds


def read(ctx):
    chain = getattr(ctx.caller, "chain", None)
    t = per_call_seconds(ctx, "qrbench.solve", kernels()["k1"]["records"])
    if chain is None or t is None:
        return None
    steps, br, bc, rows, _, cols = chain()
    return share_pct(*k1.cost(steps, br, bc, rows, cols), ctx.kind, t)
