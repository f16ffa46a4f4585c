"""The share of the untraced window, in percent, in which the device ran
nothing, in the fit cells: one less the device time a call over the
untraced window's time a call, as ``device_idle_pct.solve``.  The device
time is the union of the traced window's kernel, memset and copy records
and each captured loop launch's interval (``program_trace.launches``: the
loop's iterations run inside a WHILE node, where the profiler may keep no
record), over the traced calls."""
from ..program_trace import launches, union_s


def read(ctx):
    loops = launches(ctx.trace)
    if loops is None or not ctx.traced or not ctx.records:
        return None
    lo, hi = ctx.trace.window
    spans = [(max(s, lo), min(t, hi)) for s, t in ctx.trace.busy_intervals()]
    spans += [(max(x.lo, lo), min(x.hi, hi)) for x in loops]
    busy_per_call = union_s(spans) / len(ctx.traced)
    return 100.0 * (1.0 - busy_per_call / (ctx.window_s / len(ctx.records)))
