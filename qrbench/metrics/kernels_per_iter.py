"""Device operations of one LM iteration as the captured loop runs it:
the kernel, memset and copy nodes of the loop's captured body graph
(``ctx.census``, read from the graph by the caller), plus L1's evaluations
of the loop condition a loop iteration (the program's ``graph_loop_cond``
counter over the traced window)."""


def read(ctx):
    iters = sum(r.get("loop_iters", 0) for r in ctx.traced)
    if ctx.census is None or not iters:
        return None
    return ctx.census + ctx.launched.get("graph_loop_cond", 0) / iters
