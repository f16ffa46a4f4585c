"""Seconds of set-up spent making the captured programs and loops: each
key's eager first call (a fit's eager first iteration) and each warm-up,
capture and instantiate (``profiling.setup_seconds()``: ``first_call`` +
``capture``; the builds inside them counted apart)."""
from ..program_trace import setup_sum


def read(ctx):
    return setup_sum("first_call", "capture")
