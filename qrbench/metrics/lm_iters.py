"""LM iterations a problem (``LMResult.iterations``), over the window."""
from . import mean


def read(ctx):
    return mean(i for r in ctx.records for i in r.get("iterations", ()))
