"""Problems fitted to convergence in the window over the window's seconds
(a batch call counts each of its problems)."""


def compute(ctx):
    return sum(r["converged"] for r in ctx.records) / ctx.window_s
