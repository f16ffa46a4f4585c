"""Seconds of set-up spent on the kernels' libraries: nvcc's builds (none
on a checkout that built them before) and their loads
(``profiling.setup_seconds()``: ``build`` + ``load``)."""
from ..program_trace import setup_sum


def read(ctx):
    return setup_sum("build", "load")
