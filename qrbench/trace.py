"""The traced window: ``torch.profiler`` over the cell's calls, and the
reading of its trace.

The harness marks the window and each call with ``record_function``
ranges (``qrbench.window``, ``qrbench.call`` and the caller's own, such as
``qrbench.factorize``).  The trace is exported as Chrome JSON to the run's
``TMPDIR`` and read back:

* device operations: kernels, memsets and copies, each an interval on the
  card's clock (the profiler puts them on the host's time base);
* the host range that launched each one, by its correlation id: the
  runtime or driver call (``cudaGraphLaunch`` for a replay) and the
  innermost ``qrbench.*`` range around that call;
* busy time: the union of the device intervals inside the window, so
  overlapping operations count once.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """What the metric readers see of a traced window.

    ``all_ops``: ``(name, cat, start_us, end_us, annotation)`` of every
    device operation, ``annotation`` the innermost ``qrbench.*`` range whose
    host call launched it (None where none did); ``ops``: those inside the
    window.
    ``window``: ``(start_us, end_us)`` of ``qrbench.window``.
    ``host``: ``(name, start_us, end_us)`` of the host events on the
    window's thread, for naming idle gaps."""

    def __init__(self, events: List[Dict]):
        ann = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        win = [e for e in ann if e["name"] == "qrbench.window"]
        if not win:
            raise RuntimeError("the trace holds no qrbench.window range")
        w = win[0]
        self.window = (float(w["ts"]), float(w["ts"]) + float(w["dur"]))
        tid = w.get("tid")
        marks = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in ann if e["name"].startswith("qrbench.") and e["name"] != "qrbench.window"),
            key=lambda m: (m[0], -m[1]),
        )
        launch_at = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch_at[e["args"]["correlation"]] = float(e["ts"])
        lo, hi = self.window
        self.all_ops: List[Tuple[str, str, float, float, Optional[str]]] = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            at = launch_at.get(e.get("args", {}).get("correlation"))
            self.all_ops.append((e["name"], e["cat"], s, t, _innermost(marks, at)))
        self.ops = [op for op in self.all_ops if op[3] > lo and op[2] < hi]
        self.host = sorted(
            ((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("ph") == "X" and e.get("tid") == tid and e.get("cat") not in DEVICE_CATS
             and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo),
            key=lambda h: (h[1], -h[2]),
        )

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self, annotation: Optional[str] = None, name_part: str = "") -> List[Tuple]:
        """Kernel records launched inside ``annotation`` (wherever they ran),
        or inside the window where ``annotation`` is None."""
        ops = self.ops if annotation is None else self.all_ops
        return [op for op in ops if op[1] == "kernel" and name_part in op[0]
                and (annotation is None or op[4] == annotation)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint intervals."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for _, _, s, t, _ in sorted(self.ops, key=lambda op: op[2]):
            s, t = max(s, lo), min(t, hi)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, by name, and the idle
        time by what the host was doing (its innermost event at the middle
        of each gap), each with its seconds."""
        by_op: Dict[str, float] = defaultdict(float)
        for name, _, s, t, _ in self.ops:
            by_op[name] += (t - s) / 1e6
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        by_gap: Dict[str, float] = defaultdict(float)
        starts = [h[1] for h in self.host]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                by_gap[self._host_at(0.5 * (a + b), starts)] += (b - a) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}

    def _host_at(self, t: float, starts: List[float]) -> str:
        i = _containing(self.host, bisect.bisect_right(starts, t), t, start=1)
        return self.host[i][0] if i is not None else "host: outside any traced event"


# Ranges on one host thread nest, so the range that contains a time and
# starts last is the innermost; the search walks back a bounded way.
_NEST = 64


def _containing(ranges, upto: int, t: float, start: int) -> Optional[int]:
    for i in range(upto - 1, max(upto - _NEST, 0) - 1, -1):
        if ranges[i][start] <= t < ranges[i][start + 1]:
            return i
    return None


def _innermost(marks, at: Optional[float]) -> Optional[str]:
    if at is None:
        return None
    i = _containing(marks, bisect.bisect_right(marks, (at, float("inf"), "")), at, start=0)
    return marks[i][2] if i is not None else None


def profile(fn):
    """Run ``fn()`` under ``torch.profiler`` (host and CUDA activity) and
    return ``(fn's result, Trace)``.  The Chrome trace goes to a temporary
    file in ``TMPDIR``, removed once read."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, Trace(events)
