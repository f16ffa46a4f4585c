"""K3's share of its roofline: the bound of one step (bytes from the
problem's shapes, ``roofline/k3.py``) over the mean time of one of K3's
kernel records (``kernels/k3.json``) in the traced window."""
from ..registry import kernels
from ..roofline import share_pct
from . import mean


def read(ctx):
    cost = getattr(ctx.caller, "k3_cost", None)
    names = kernels()["k3"]["records"]
    t = mean(t - s for name, _, s, t, _ in ctx.trace.kernels()
             if any(part in name for part in names))
    if cost is None or t is None:
        return None
    return share_pct(*cost(), ctx.kind, t / 1e6)
