"""Timing helpers and the kernel launch counters.

Counterpart of ``qrkit_tpu/profiling.py`` (``timed``, ``Timer``).  On a CUDA
device, work is enqueued asynchronously, so every timer here ends in a real
``torch.cuda.synchronize()``; :func:`cuda_time_ms` times device work with
CUDA events.  :func:`launch_counts` / :func:`reset_launch_counts` read and
clear the per-kernel launch counters that the kernel wrappers in
:mod:`qrkit_tpu_torch.ops.blockdiag` and :mod:`qrkit_tpu_torch.ops.banded`
keep.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Tuple

import torch

from .ops import banded, blockdiag

__all__ = ["Timer", "cuda_time_ms", "launch_counts", "reset_launch_counts", "timed"]

# kernel name -> the wrapper that launches it and counts its launches
_KERNEL_WRAPPERS = {
    "blockdiag_lstsq": blockdiag.block_diagonal_lstsq_soa,
    "blockdiag_qr_r": blockdiag.block_diagonal_qr_r_soa,
    "banded_segment_chains": banded.segment_chains,
    "banded_apply_w": banded.segment_apply_w,
    "banded_chain_qr": banded.chain_qr,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNEL_WRAPPERS.values():
        fn.launches = 0


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """(result, wall seconds), with the device drained before and after."""
    _sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync()
    return out, time.perf_counter() - t0


def cuda_time_ms(fn: Callable, *args, warmup: int = 10, reps: int = 50) -> float:
    """Median device time of ``fn(*args)`` in ms: CUDA events around each of
    ``reps`` calls after ``warmup`` calls, one synchronize before reading."""
    for _ in range(warmup):
        fn(*args)
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


class Timer:
    """Accumulating section timer: ``with timer("factorize"): ...``; each
    section drains the device on exit."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(
                f"{name:30s} {t * 1e3:10.2f} ms total  {c:6d} calls  {t / c * 1e3:8.3f} ms/call"
            )
        return "\n".join(lines)
