"""Each kernel's bytes and fp32 operations from the problem's shapes, and
the share of its roofline a measured time reaches.

Each input is counted as read once and each output as written once,
whatever the kernel reads again, so a later kernel that reads differently
is held to the same count.  The formulas are those of the port's smoke
gate (``chip_smoke.py``: ``lm_step_cost``, ``two_seg_cost``,
``solve_chunk_cost``), restated over shapes.
"""
from __future__ import annotations

import functools
from typing import Optional

from ..registry import HERE, load_json


@functools.lru_cache(maxsize=None)
def peaks() -> dict:
    """The cards' published peaks (``qrbench/peaks.json``), by the name
    ``torch.cuda.get_device_name`` gives."""
    return load_json(HERE / "peaks.json")


def bound_s(nbytes: float, flops: float, kind: str) -> Optional[float]:
    """The least time the card ``kind`` could take: the larger of the bytes
    over its HBM rate and the operations over its fp32 rate (None for a
    card the table does not hold)."""
    peak = peaks().get(kind)
    if peak is None:
        return None
    return max(nbytes / peak["hbm_bytes_per_s"], flops / peak["fp32_flops_per_s"])


def share_pct(nbytes: float, flops: float, kind: str, seconds: float) -> Optional[float]:
    """The bound's share of a measured ``seconds``, in percent."""
    b = bound_s(nbytes, flops, kind)
    if b is None or not seconds > 0:
        return None
    return 100.0 * b / seconds
