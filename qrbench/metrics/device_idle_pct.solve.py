"""The share of the untraced window, in percent, in which the device ran
nothing: one less the device time a call (the union of the kernel, memset
and copy intervals of the traced window, over its calls) over the
untraced window's time a call.  The traced window's own idle share would
count the profiler's cost on the host (``cudaGraphLaunch`` takes several
times as long under it)."""


def read(ctx):
    if not ctx.traced or not ctx.records:
        return None
    busy_per_call = ctx.trace.busy_s() / len(ctx.traced)
    return 100.0 * (1.0 - busy_per_call / (ctx.window_s / len(ctx.records)))
