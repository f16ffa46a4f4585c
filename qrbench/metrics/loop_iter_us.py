"""Microseconds of one iteration of the captured LM loop on the device:
the mean gap between consecutive stamps of kernel L1's evaluations of the
loop's condition (``profiling.loop_records()``), stamp 1 onward, over
every iteration of the traced launches.  A gap holds the body's nodes, L1
and their scheduling inside the WHILE node; the first (stamp 0 to 1) also
holds the node's entry and is left out."""
from ..program_trace import loop_records


def read(ctx):
    gaps = [b - a for r in loop_records() or () for a, b in zip(r["stamps"][1:], r["stamps"][2:])]
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
