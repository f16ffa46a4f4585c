"""K2's share of its roofline in a solve: the bound of the problem's
back-substitution (``roofline/k2.py``) over the device time of K2's
kernel records (``kernels/k2.json``) inside ``qrbench.solve`` a call."""
from ..registry import kernels
from ..roofline import k2, share_pct
from . import per_call_seconds


def read(ctx):
    chain = getattr(ctx.caller, "chain", None)
    t = per_call_seconds(ctx, "qrbench.solve", kernels()["k2"]["records"])
    if chain is None or t is None:
        return None
    steps, _, bc, _, unknowns, cols = chain()
    return share_pct(*k2.cost(steps, bc, unknowns, cols), ctx.kind, t)
