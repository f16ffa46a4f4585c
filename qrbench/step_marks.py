"""The marks a step leaves inside the captured LM loop's body: kernel L2
stamps the device's ``%globaltimer`` at named points of each iteration
(``qrkit_tpu_torch.profiling.loop_records()``: a record's ``marks``, a dict
of ns by point an iteration).  The block-angular step marks its entry
(``"step"``), its bottom assembled (``"bottom"``) and its TSQR with Qᵀ on
the rhs done (``"tsqr"``).  A program that leaves no marks (an older
commit) gives None."""
from __future__ import annotations

from typing import Optional

from .program_trace import loop_records


def part_us(first: str, last: str) -> Optional[float]:
    """The mean over every marked iteration of the traced launches of the
    time from mark ``first`` to mark ``last``, in µs."""
    gaps = [(row[last] - row[first]) / 1e3 for r in loop_records() or () for row in r.get("marks", ())
            if row.get(first) and row.get(last)]
    return sum(gaps) / len(gaps) if gaps else None
