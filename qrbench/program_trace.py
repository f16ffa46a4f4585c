"""What the program records about itself, for the per-layer readers: its
set-up by part, its host spans, and its captured loops' launches placed on
the traced window's clock.

* Set-up: ``qrkit_tpu_torch.profiling.setup_seconds()``, ``{part:
  (seconds, count)}``, each part's seconds without the parts inside it.
* Host spans: the program's ``qrk.<layer>.<part>`` ranges, host events of
  the traced window (``Trace.host``).
* Loops: ``profiling.loop_records()`` holds, for each launch of a captured
  loop made under the profiler, kernel L1's stamp of each of its
  evaluations of the loop's condition (ns on the device's
  ``%globaltimer``): stamp 0 before the first iteration, stamp k after
  iteration k.  Each launch's records are found on the device's timeline
  and its stamps placed by the L1 records the profiler kept of it
  (:func:`graphs`, :func:`launches`, :func:`place`).

A program that records none of these (an older commit) gives None
everywhere.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Tuple

from .registry import kernels


def setup_seconds() -> Optional[Dict[str, Tuple[float, int]]]:
    """The program's set-up by part, or None where it keeps none."""
    from qrkit_tpu_torch import profiling

    read = getattr(profiling, "setup_seconds", None)
    return None if read is None else read()


def setup_sum(*parts: str) -> Optional[float]:
    """The seconds of ``parts`` summed (a part the run never entered counts
    0), or None where the program keeps no set-up record."""
    got = setup_seconds()
    if got is None:
        return None
    return sum(got.get(p, (0.0, 0))[0] for p in parts)


def host_spans(tr, prefix: str) -> List[Tuple[str, float, float]]:
    """The program's host ranges of the traced window whose name starts
    with ``prefix``: ``(name, start_us, end_us)``, in time order."""
    return [h for h in tr.host if h[0].startswith(prefix)]


class Launch(NamedTuple):
    """One traced launch of a captured loop on the trace's clock (µs):
    ``lo``/``hi`` its interval on the device (its graph's records, from the
    init's first to the tail's last); ``at`` its stamps placed on the
    trace's clock, or None where its L1 records could not place them."""

    name: str
    iterations: int
    lo: float
    hi: float
    at: Optional[List[float]]


MATCH_US = 1.0  # a placed stamp lies this close to the start of its L1 record
RATE = 2e-3  # the stamps' clock and the trace's device clock run at rates this close
INIT_GAP_US = 20.0  # the graph's nodes run closer than this; its launch, after the copy-in, not


def loop_records() -> Optional[List[dict]]:
    from qrkit_tpu_torch import profiling

    read = getattr(profiling, "loop_records", None)
    return None if read is None else read()


def l1_names() -> List[str]:
    return kernels()["l1"]["records"]


def place(l1: List[float], stamps: List[float], lo: float, hi: float) -> Optional[List[float]]:
    """A launch's stamps (µs, increasing) on the trace's clock, or None.  The
    two clocks differ by an offset and by a rate within :data:`RATE`: the
    map puts the launch's first L1 record start ``l1[0]`` on one stamp and
    its last on a later one, every stamp inside its graph's records ``[lo,
    hi]``, and the most L1 records within :data:`MATCH_US` of a stamp (a
    tie: the earliest pair).  One L1 record could be any evaluation's: it
    places the stamps only of a loop that ran no iteration."""
    if len(l1) < 2:
        return [l1[0] + t - stamps[0] for t in stamps] if l1 and len(stamps) == 1 else None
    best, out = 0, None
    for i in range(len(stamps)):
        for j in range(len(stamps) - 1, i, -1):
            c = (l1[-1] - l1[0]) / (stamps[j] - stamps[i])
            if abs(c - 1.0) > RATE:
                continue
            at = [l1[0] + (t - stamps[i]) * c for t in stamps]
            if at[0] < lo - MATCH_US or at[-1] > hi + MATCH_US:
                continue  # the loop's evaluations lie inside its graph's records
            n = 0
            for q in l1:
                k = bisect.bisect_left(at, q - MATCH_US)
                n += k < len(at) and at[k] <= q + MATCH_US
            if n > best:
                best, out = n, at
    return out


def _copy(op, way: str) -> bool:
    return op[1] == "gpu_memcpy" and way in op[0]


def graphs(tr) -> List[List[tuple]]:
    """The device records of each loop launch of the traced window, in
    order, found on the device's timeline alone (the trace's host and
    device timelines can drift apart by milliseconds): a fit call uploads
    its inputs (copies to the device), runs the loop's graph, and fetches
    its result (a copy to the host).  A launch's graph records are those
    after a call's last upload and before its first fetch, among them an L1
    record (the init and the tail, and evaluation 0, run outside the WHILE
    node, so the profiler keeps their records); the copy of the inputs
    into the loop's static buffers comes first among them."""
    names = l1_names()
    out, body = [], None  # body: the records since the last upload (None: none since a fetch)
    for op in sorted(tr.ops, key=lambda op: op[2]):
        if _copy(op, "HtoD"):
            body = []
        elif _copy(op, "DtoH"):
            if body and any(any(p in r[0] for p in names) for r in body):
                out.append(body)
            body = None
        elif body is not None:
            body.append(op)
    return out


def launches(tr) -> Optional[List[Launch]]:
    """The traced window's loop launches, or None where the program keeps
    no loop records or the trace holds none of its loop graphs.  The
    window's graphs (:func:`graphs`) and the program's newest loop records
    are the same launches, in order.  A launch's interval runs from its
    init's first record (the records before its first L1 record, back to
    the first gap longer than :data:`INIT_GAP_US`: the copy of the inputs
    came before the graph's launch) to its tail's last; its stamps are
    placed by the L1 records among its graph's (:func:`place`)."""
    records, found = loop_records(), graphs(tr)
    if not records or not found or len(records) < len(found):
        return None
    names = l1_names()
    out = []
    for rec, graph in zip(records[-len(found):], found):
        begins = [op[2] for op in graph]
        l1 = [begins[i] for i, op in enumerate(graph) if any(p in op[0] for p in names)]
        stamps = [(t - rec["stamps"][0]) / 1e3 for t in rec["stamps"]]  # µs after stamp 0
        hi = max(op[3] for op in graph)
        at = place(l1, stamps, begins[0], hi)
        # evaluation 0's record (where the stamps are placed), else the first L1 record
        i = begins.index(l1[0]) if at is None else bisect.bisect_left(begins, at[0] - MATCH_US)
        while i > 0 and begins[i] - graph[i - 1][3] <= INIT_GAP_US:
            i -= 1  # the init runs back to back before evaluation 0
        lo = begins[i] if at is None else min(begins[i], at[0])
        out.append(Launch(rec["name"], rec["iterations"], lo, hi, at))
    return out


def union_s(intervals) -> float:
    """Seconds covered by ``intervals`` (µs pairs), overlaps once."""
    busy, end = 0.0, float("-inf")
    for s, t in sorted(intervals):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy / 1e6
