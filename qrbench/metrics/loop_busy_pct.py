"""The share, in percent, of the captured loop's iterations on the device
that the profiler's kernel, memset and copy records cover, overlaps once,
over the iterations whose records it kept.  An iteration runs from one
stamp of kernel L1 to the next, placed on the trace's clock
(``program_trace.launches``): the body's nodes and L1.  Inside the WHILE
node the profiler keeps few iterations' records a launch (the last, where
the profiler started after the loop's capture), so the iterations counted
are those in which a record other than L1's starts.  The rest of an
iteration is the scheduling of its graph nodes."""
import bisect

from ..program_trace import l1_names, launches, union_s


def read(ctx):
    loops = [x for x in launches(ctx.trace) or () if x.at is not None]
    if not loops:
        return None
    names = l1_names()
    ops = sorted((s, t, not any(p in name for p in names)) for name, _, s, t, _ in ctx.trace.ops)
    begins = [s for s, _, _ in ops]
    longest = max((t - s for s, t, _ in ops), default=0.0)
    covered = total = 0.0
    for x in loops:
        for a, b in zip(x.at, x.at[1:]):
            near = ops[bisect.bisect_left(begins, a - longest):bisect.bisect_left(begins, b)]
            if any(a <= s < b and other for s, _, other in near):
                covered += union_s((max(s, a), min(t, b)) for s, t, _ in near if t > a)
                total += (b - a) / 1e6
    return 100.0 * covered / total if total else None
