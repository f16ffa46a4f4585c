"""Host microseconds from a call to its return, before the synchronize:
what the captured programs' replays cost the host."""
from . import mean


def read(ctx):
    m = mean(r["host_end"] - r["start"] for r in ctx.records if "host_end" in r)
    return None if m is None else m * 1e6
