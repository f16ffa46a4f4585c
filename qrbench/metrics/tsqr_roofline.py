"""The TSQR's share of its roofline in the block-angular step: the bound
of the bottom's factorization and Qᵀ on its rhs (operations from the
step's shapes, ``roofline/tsqr.py``) over ``angular_right_us``."""
from ..roofline import share_pct, tsqr
from ..step_marks import part_us


def read(ctx):
    shape = getattr(ctx.caller, "tsqr_shape", None)
    t = part_us("bottom", "tsqr")
    if shape is None or t is None:
        return None
    return share_pct(*tsqr.cost(*shape()), ctx.kind, t / 1e6)
