"""Timing helpers and the kernel launch counters.

Counterpart of ``qrkit_tpu/profiling.py`` (``timed``, ``Timer``,
``count_dispatches``, ``trace``).  On a CUDA device, work is enqueued
asynchronously, so every timer here ends in a real
``torch.cuda.synchronize()``; :func:`cuda_time_ms` times device work with
CUDA events.  :func:`launch_counts` / :func:`reset_launch_counts` read and
clear the per-kernel launch counters that the kernel wrappers in
:mod:`qrkit_tpu_torch.ops.blockdiag`, :mod:`qrkit_tpu_torch.ops.banded`,
:mod:`qrkit_tpu_torch.ops.compact_wy`, :mod:`qrkit_tpu_torch.ops.graph_loop`,
:mod:`qrkit_tpu_torch.ops.lm_step`, :mod:`qrkit_tpu_torch.ops.ellipse_eval` and
:mod:`qrkit_tpu_torch.ops.tall_qr` keep; a replay of a captured program
(:mod:`qrkit_tpu_torch._program`) adds the launches its graph holds (a
captured loop: per iteration, from its fetched loop counter), and the
collectives it holds to :func:`collective_counts`.  :func:`count_dispatches` counts the
ATen ops a block dispatches (the port's eager paths run many, one host
round of launch work each), the program replays, the kernel launches, and
the reads that make the host wait for the device; :func:`trace` writes a
``torch.profiler`` trace.  :func:`graph_nodes` lists the nodes of one call
captured into a CUDA graph: its kernel launches, with their grid and
cooperative attribute, and its memsets.

Spans and set-up: :func:`span` names a part of the program's host work on
a ``torch.profiler`` trace (``qrk.<layer>.<part>``, nested under the
caller's range) and costs one check of the profiler's state without one;
with ``setup=True`` it also adds the part's seconds to
:func:`setup_seconds`, always.  Captured loops: while a profiler runs,
each launch of a captured LM loop leaves its iterations' device
timestamps in :func:`loop_records` (kernel L1 stamps each evaluation of
the loop's condition); :func:`trace` writes them into its trace as the
loop's interval and iterations, and :func:`loop_body_nodes` reads each
cached loop's body graph.
"""
from __future__ import annotations

import bisect
import contextlib
import ctypes
import json
import os
import statistics
import struct
import threading
import time
from collections import Counter, defaultdict, deque
from typing import Any, Callable, Dict, List, Tuple

import torch

from .ops import banded, blockdiag, compact_wy, ellipse_eval, graph_loop, lm_step, tall_qr

__all__ = [
    "DispatchCount",
    "Timer",
    "collective_counts",
    "count_dispatches",
    "cuda_time_ms",
    "graph_nodes",
    "launch_counts",
    "loop_body_nodes",
    "loop_records",
    "reset_launch_counts",
    "setup_seconds",
    "span",
    "timed",
    "trace",
]

# kernel name -> the wrapper that launches it and counts its launches
_KERNEL_WRAPPERS = {
    "blockdiag_lstsq": blockdiag.block_diagonal_lstsq_soa,
    "blockdiag_qr_r": blockdiag.block_diagonal_qr_r_soa,
    "banded_segment_chains": banded.segment_chains,
    "banded_apply_w": banded.segment_apply_w,
    "banded_chain_qr": banded.chain_qr,
    "graph_loop_cond": graph_loop.loop_condition,
    "loop_mark": graph_loop.mark,
    "chain_two_seg": compact_wy.two_segment_apply,
    "chain_solve": banded.banded_solve_chunk,
    "lm_step": lm_step.damped_step_lane_major,
    "ellipse_residuals": ellipse_eval.ellipse_residuals,
    "ellipse_residuals_vjp": ellipse_eval.ellipse_residuals_vjp,
    "ellipse_jacobian": ellipse_eval.ellipse_jacobian_residuals,
    "tall_qr": tall_qr.r_and_qtb,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in _KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    _set_launch_counts({name: 0 for name in _KERNEL_WRAPPERS})


def _set_launch_counts(counts: Dict[str, int]) -> None:
    for name, fn in _KERNEL_WRAPPERS.items():
        fn.launches = counts[name]


class _Replays:
    """Program replays since import, and the kernel launches they added to
    the wrappers' counters (by kernel name)."""

    count = 0
    launches: Dict[str, int] = defaultdict(int)


# collectives issued through qrkit_tpu_torch.parallel.mesh since import, by
# torch.distributed name (a replay adds those its graph holds)
_COLLECTIVES: Dict[str, int] = defaultdict(int)


def collective_counts() -> Dict[str, int]:
    """The collectives the port issued since import, by
    ``torch.distributed`` name (those inside a replayed graph included)."""
    return {k: v for k, v in _COLLECTIVES.items() if v}


def _set_collective_counts(counts: Dict[str, int]) -> None:
    _COLLECTIVES.clear()
    _COLLECTIVES.update(counts)


def _note_collective(name: str) -> None:
    """One collective issued by the host (:mod:`qrkit_tpu_torch.parallel.mesh`)."""
    _COLLECTIVES[name] += 1


def _note_replay(launches: Dict[str, int], collectives: Dict[str, int] = None,
                 replays: int = 1) -> None:
    """``replays`` graph launches (one replay of a captured program, the
    chunks of a chunked loop) holding ``launches`` and ``collectives``."""
    _Replays.count += replays
    for name, n in launches.items():
        _KERNEL_WRAPPERS[name].launches += n
        _Replays.launches[name] += n
    for name, n in (collectives or {}).items():
        _COLLECTIVES[name] += n


_profiler_enabled = torch._C._autograd._profiler_enabled
_INERT = contextlib.nullcontext()

# set-up part -> [seconds, spans], and each thread's open set-up spans (the
# seconds their inner set-up spans took)
_SETUP: Dict[str, List] = {}
_OPEN = threading.local()


def span(name: str, setup: bool = False):
    """A context manager naming a part of the program's host work
    ``name`` (``qrk.<layer>.<part>``).  While a ``torch.profiler`` is
    active it is a ``torch.profiler.record_function(name)`` range, nested
    under the caller's; otherwise it does nothing beyond one check of the
    profiler's state.

    ``setup=True`` (``qrk.setup.<part>``, one-off paths only) also times
    the block, always, and adds its seconds to the part's
    :func:`setup_seconds`, less those of the set-up spans inside it: a
    kernel build inside a first call counts as ``build`` alone.  The
    context's ``seconds`` holds them after the block."""
    if setup:
        return _SetupSpan(name)
    if not _profiler_enabled():
        return _INERT
    return torch.profiler.record_function(name)


class _SetupSpan:
    __slots__ = ("name", "seconds", "_mark", "_t0")

    def __init__(self, name: str):
        self.name, self.seconds = name, 0.0

    def __enter__(self):
        if not hasattr(_OPEN, "inner"):
            _OPEN.inner = []
        _OPEN.inner.append(0.0)
        self._mark = span(self.name)
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._t0
        self._mark.__exit__(*exc)
        self.seconds = elapsed - _OPEN.inner.pop()
        if _OPEN.inner:
            _OPEN.inner[-1] += elapsed
        _note_setup(self.name.rsplit(".", 1)[-1], self.seconds)
        return False


def _note_setup(part: str, seconds: float) -> None:
    entry = _SETUP.setdefault(part, [0.0, 0])
    entry[0] += seconds
    entry[1] += 1


def setup_seconds() -> Dict[str, Tuple[float, int]]:
    """The port's set-up since import, by part: ``(seconds, count)``.
    Parts: ``import`` (the package's own), ``build`` (an nvcc run),
    ``load`` (a library's ``ctypes.CDLL``), ``analysis`` (``auto_qr``'s
    structure analysis and route choice), ``first_call`` (a program key's
    eager first call, a device fit's eager first iteration) and
    ``capture`` (a program's or a loop's warm-up, capture and
    instantiate).  Each part's seconds leave out the parts inside it, so
    they add up to no more than the wall time they cover."""
    return {part: (seconds, count) for part, (seconds, count) in _SETUP.items()}


# the captured loops' launches traced since import (the newest kept), and
# how many were traced in all
_LOOP_RECORDS: deque = deque(maxlen=4096)
_LOOPS_TRACED = [0]


def _note_loop(name: str, iterations: int, stamps, marks=None) -> None:
    """One traced launch of a captured loop: its ``iterations``, the
    stamps of L1's evaluations (ns, ``iterations + 1``) and, where its body
    marked points, each iteration's marks (ns, a row of
    ``graph_loop.MARKS``'s slots an iteration)."""
    record = {"name": name, "iterations": int(iterations), "stamps": [int(t) for t in stamps]}
    if marks is not None:
        record["marks"] = [{n: int(t) for n, t in zip(graph_loop.MARKS, row) if t}
                           for row in marks]
    _LOOP_RECORDS.append(record)
    _LOOPS_TRACED[0] += 1


def loop_records() -> List[dict]:
    """Each launch of a captured loop made while a ``torch.profiler`` was
    active, oldest first (the newest 4,096): ``name`` (the loop's),
    ``iterations`` and ``stamps``, the time of each evaluation of the
    loop's condition in ns (``iterations + 1`` of them; stamp 0 before the
    first iteration, stamp k after iteration k), and ``marks`` where the
    loop's body marked points of its iterations
    (:func:`~qrkit_tpu_torch.ops.graph_loop.mark`, kernel L2): a dict an
    iteration, ns at each point's name (a point the body left unmarked
    absent).  On
    the card a stamp or mark is the device's ``%globaltimer``; under a test
    backend, the host's clock.  The records outlive the loops
    (``lm.clear_programs()``)."""
    return [{**r, "stamps": list(r["stamps"]),
             **({"marks": [dict(m) for m in r["marks"]]} if "marks" in r else {})}
            for r in _LOOP_RECORDS]


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


def _replay_state():
    return _Replays.count, dict(_Replays.launches)


class DispatchCount:
    """Counter handed out by :func:`count_dispatches`: ``ops`` ATen ops,
    ``programs`` replays of captured programs, ``launches`` kernel
    executions by the port's wrappers (by kernel; a replay's count as its
    graph's), ``host_launches`` those the host issued outside a replay, and
    ``host_reads`` reads of device data by the host (``.item()``, ``bool()``
    and copies from a device to the CPU), all since the block was entered.
    ``count`` is ``ops`` plus the replays plus the host-issued launches."""

    def __init__(self):
        self.ops = 0
        self.host_reads = 0
        self._start = launch_counts(), _replay_state()
        self._end = None

    def _now(self):
        return self._end if self._end is not None else (launch_counts(), _replay_state())

    @property
    def launches(self) -> Dict[str, int]:
        now, start = self._now()[0], self._start[0]
        return {k: now[k] - start[k] for k in now}

    @property
    def programs(self) -> int:
        return self._now()[1][0] - self._start[1][0]

    @property
    def host_launches(self) -> Dict[str, int]:
        now, start = self._now()[1][1], self._start[1][1]
        return {k: n - now.get(k, 0) + start.get(k, 0) for k, n in self.launches.items()}

    @property
    def count(self) -> int:
        return self.ops + self.programs + sum(self.host_launches.values())

    def __int__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"DispatchCount({self.count}, ops={self.ops}, programs={self.programs}, "
                f"host_reads={self.host_reads})")


def _counting_mode(counter: DispatchCount):
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    copies = {aten._to_copy.default, aten.copy_.default}

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            counter.ops += 1
            if func is aten._local_scalar_dense.default:
                counter.host_reads += 1
            elif func in copies:
                src = args[1] if func is aten.copy_.default else args[0]
                dst = (args[0].device if func is aten.copy_.default
                       else kwargs.get("device") or getattr(src, "device", None))
                if (isinstance(src, torch.Tensor) and src.device.type != "cpu"
                        and dst is not None and torch.device(dst).type == "cpu"):
                    counter.host_reads += 1
            return func(*args, **kwargs)

    return _Count()


@contextlib.contextmanager
def count_dispatches():
    """Count what a block sends to the device::

        with count_dispatches() as d:
            qr.compute(mat)
        print(d.count, d.launches, d.host_reads)

    Every ATen op dispatched in the block counts once (a
    ``TorchDispatchMode``, so CPU tensors count too and the CPU tests can
    pin a path), and so do every replay of a captured program and every
    launch the port's kernel wrappers issue outside a replay (ctypes calls
    that bypass ATen).  ``launches`` counts every kernel execution, a
    replay's included.  Counters nest.  The mode adds Python
    work to every op: time a path outside the block."""
    counter = DispatchCount()
    try:
        with _counting_mode(counter):
            yield counter
    finally:
        counter._end = launch_counts(), _replay_state()


# CUgraphNodeType, in the driver's order
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event", "event_record",
               "ext_semas_signal", "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op", "conditional")
_COOPERATIVE = 2  # CU_LAUNCH_ATTRIBUTE_COOPERATIVE


class _Driver:
    """The CUDA driver API (``libcuda``, by ctypes) for reading a graph's
    nodes; a call that fails raises."""

    def __init__(self):
        self.cu = ctypes.CDLL("libcuda.so.1")

    def check(self, err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA driver error {err}")

    def nodes(self, graph) -> list:
        """``(node, type name)`` of each node of the ``cudaGraph_t``
        ``graph`` (an int or a ``c_void_p``)."""
        cu, count = self.cu, ctypes.c_size_t(0)
        graph = ctypes.c_void_p(graph) if isinstance(graph, int) else graph
        self.check(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
        handles = (ctypes.c_void_p * count.value)()
        self.check(cu.cuGraphGetNodes(graph, handles, ctypes.byref(count)), "cuGraphGetNodes")
        out = []
        for node in map(ctypes.c_void_p, handles):
            kind = ctypes.c_int(-1)
            self.check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
            out.append((node, _NODE_TYPES[kind.value] if 0 <= kind.value < len(_NODE_TYPES)
                        else kind.value))
        return out

    def node_types(self, graph) -> Counter:
        """The nodes of ``graph`` by type, a child graph's counted in its
        place."""
        out: Counter = Counter()
        for node, kind in self.nodes(graph):
            if kind == "graph":
                child = ctypes.c_void_p()
                self.check(self.cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                           "cuGraphChildGraphNodeGetGraph")
                out.update(self.node_types(child))
            else:
                out[kind] += 1
        return out


def graph_nodes(fn: Callable) -> list:
    """The nodes of one call of ``fn`` captured into a CUDA graph, which is
    never launched: a dict a node with its ``type`` (``"kernel"``,
    ``"memset"``, …) and, for a kernel node, its ``name`` (the kernel's
    mangled name), ``grid``, ``block`` and ``cooperative`` (its launch
    attribute).  ``fn`` runs once first on a side stream (its kernels built,
    its allocations warm).  Reads the graph through the CUDA driver API
    (``libcuda``, by ctypes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    drv = _Driver()
    cu, check = drv.cu, drv.check
    out = []
    for node, kind in drv.nodes(graph.raw_cuda_graph()):
        rec = {"type": kind}
        if kind == "kernel":
            params = (ctypes.c_uint8 * 72)()  # CUDA_KERNEL_NODE_PARAMS_v2
            check(cu.cuGraphKernelNodeGetParams_v2(node, params), "cuGraphKernelNodeGetParams_v2")
            func, kern = (ctypes.c_void_p.from_buffer(params, off).value for off in (0, 56))
            name = ctypes.c_char_p()
            if func:
                check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)), "cuFuncGetName")
            else:
                check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern)), "cuKernelGetName")
            attr = (ctypes.c_uint8 * 64)()  # CUlaunchAttributeValue
            check(cu.cuGraphKernelNodeGetAttribute(node, _COOPERATIVE, attr), "cuGraphKernelNodeGetAttribute")
            dims = struct.unpack_from("6I", params, 8)
            rec.update(name=name.value.decode(), grid=list(dims[:3]), block=list(dims[3:]),
                       cooperative=bool(ctypes.c_int.from_buffer(attr, 0).value))
        out.append(rec)
    del graph
    return out


def loop_body_nodes() -> List[dict]:
    """The body graph of each captured loop that :mod:`qrkit_tpu_torch.lm`
    holds (its device fits), oldest first: ``name`` (the loop's) and
    ``nodes``, the body's nodes by type (``"kernel"``, ``"memset"``, …; a
    child graph's counted in its place), read through the CUDA driver API;
    ``nodes`` is None for a loop that holds no body graph (a chunked loop,
    a test backend's).  An iteration runs the body's nodes and one L1."""
    from . import _program, lm

    out, drv = [], None
    for prog in lm._LOOPS.programs().values():
        loop, nodes = prog._loop, None
        if isinstance(loop, _program._CudaLoop) and loop.graphs:
            drv = drv or _Driver()
            nodes = dict(drv.node_types(loop.graphs[0].raw_cuda_graph()))
        out.append({"name": prog.name, "nodes": nodes})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU ops and, where a card is
    present, its kernels) written to ``log_dir/trace.json`` (Chrome trace
    format, Perfetto reads it).

    Each launch of a captured loop in the block (:func:`loop_records`) is
    written into it as well, on a row of its own under the device: the
    loop's interval (``qrk.loop <name>``, from its first device record to
    its last) and each iteration's period between two evaluations of its
    condition (``qrk.loop.iteration``), where the profiler itself keeps
    only one iteration's records.  Each launch's stamps are put on the
    trace's clock by its own L1 records (:func:`_place_loops`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = _LOOPS_TRACED[0]
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    n = min(_LOOPS_TRACED[0] - first, len(_LOOP_RECORDS))
    if n:
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] += _place_loops(doc["traceEvents"], list(_LOOP_RECORDS)[-n:])
        with open(path, "w") as f:
            json.dump(doc, f)


L1_RECORD = "loop_cond_kernel"  # the profiler's name of L1's records holds this
_LOOP_ROW = 1 << 20  # the loop rows' thread ids: this plus the stream's
_MATCH_US = 1.0  # a placed stamp lies this close to the start of its L1 record
_RATE = 2e-3  # the stamps' clock and the trace's device clock run at rates this close


def _place_loops(events: List[dict], records: List[dict]) -> List[dict]:
    """The trace events of ``records`` (the block's loop launches, in order)
    for a Chrome trace whose events are ``events``.  A launch's graph
    records share its launch's correlation id, and the graphs holding L1
    records are the same launches, in order (the init, the tail and
    evaluation 0 run outside the WHILE node, so the profiler keeps their
    records); none is placed where the counts differ.  A launch's interval
    runs from its first record to its last, and its stamps are placed by
    its L1 records (:func:`_place`)."""
    by_launch: Dict[Any, List[dict]] = defaultdict(list)
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") and corr:
            by_launch[corr].append(e)
    loops = sorted((g for g in by_launch.values()
                    if any(e["cat"] == "kernel" and L1_RECORD in e["name"] for e in g)),
                   key=lambda g: min(float(e["ts"]) for e in g))
    if not loops or len(loops) != len(records):
        return []
    out, rows = [], set()
    for rec, graph in zip(records, loops):
        l1 = sorted((e for e in graph if e["cat"] == "kernel" and L1_RECORD in e["name"]),
                    key=lambda e: float(e["ts"]))
        stamps = [(t - rec["stamps"][0]) / 1e3 for t in rec["stamps"]]  # µs after stamp 0
        lo = min(float(e["ts"]) for e in graph)
        hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in graph)
        at = _place([float(e["ts"]) for e in l1], stamps, lo, hi)
        if at is None:
            continue
        pid, tid = l1[0]["pid"], _LOOP_ROW + int(l1[0]["tid"])
        rows.add((pid, tid, l1[0]["tid"]))
        out.append({"ph": "X", "cat": "qrk_loop", "name": f"qrk.loop {rec['name']}", "pid": pid,
                    "tid": tid, "ts": lo, "dur": hi - lo,
                    "args": {"iterations": rec["iterations"]}})
        out += [{"ph": "X", "cat": "qrk_loop", "name": "qrk.loop.iteration", "pid": pid,
                 "tid": tid, "ts": a, "dur": b - a, "args": {"iteration": i + 1}}
                for i, (a, b) in enumerate(zip(at, at[1:]))]
    out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": f"qrk loops (stream {stream})"}} for pid, tid, stream in rows]
    return out


def _place(l1: List[float], stamps: List[float], lo: float, hi: float):
    """A launch's stamps (µs, increasing) on the trace's clock, or None.  The
    two clocks differ by an offset and by a rate within ``_RATE``: the map
    puts the launch's first L1 record start on one stamp and its last on a
    later one, every stamp inside its graph's records ``[lo, hi]``, and the
    most L1 records within ``_MATCH_US`` of a stamp (a tie: the earliest
    pair).  One L1 record could be any evaluation's: it places the stamps
    only of a loop that ran no iteration."""
    if len(l1) < 2:
        return [l1[0] + t - stamps[0] for t in stamps] if l1 and len(stamps) == 1 else None
    best, out = 0, None
    for i in range(len(stamps)):
        for j in range(len(stamps) - 1, i, -1):
            c = (l1[-1] - l1[0]) / (stamps[j] - stamps[i])
            if abs(c - 1.0) > _RATE:
                continue
            at = [l1[0] + (t - stamps[i]) * c for t in stamps]
            if at[0] < lo - _MATCH_US or at[-1] > hi + _MATCH_US:
                continue  # the loop's evaluations lie inside its graph's records
            n = 0
            for q in l1:
                k = bisect.bisect_left(at, q - _MATCH_US)
                n += k < len(at) and at[k] <= q + _MATCH_US
            if n > best:
                best, out = n, at
    return out
