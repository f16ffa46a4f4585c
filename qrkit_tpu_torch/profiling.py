"""Timing helpers and the kernel launch counters.

Counterpart of ``qrkit_tpu/profiling.py`` (``timed``, ``Timer``,
``count_dispatches``, ``trace``).  On a CUDA device, work is enqueued
asynchronously, so every timer here ends in a real
``torch.cuda.synchronize()``; :func:`cuda_time_ms` times device work with
CUDA events.  :func:`launch_counts` / :func:`reset_launch_counts` read and
clear the per-kernel launch counters that the kernel wrappers in
:mod:`qrkit_tpu_torch.ops.blockdiag`, :mod:`qrkit_tpu_torch.ops.banded`,
:mod:`qrkit_tpu_torch.ops.compact_wy`, :mod:`qrkit_tpu_torch.ops.graph_loop`
and :mod:`qrkit_tpu_torch.ops.lm_step` keep; a replay of a captured program
(:mod:`qrkit_tpu_torch._program`) adds the launches its graph holds (a
captured loop: per iteration, from its fetched loop counter), and the
collectives it holds to :func:`collective_counts`.  :func:`count_dispatches` counts the
ATen ops a block dispatches (the port's eager paths run many, one host
round of launch work each), the program replays, the kernel launches, and
the reads that make the host wait for the device; :func:`trace` writes a
``torch.profiler`` trace.  :func:`graph_nodes` lists the nodes of one call
captured into a CUDA graph: its kernel launches, with their grid and
cooperative attribute, and its memsets.
"""
from __future__ import annotations

import contextlib
import ctypes
import statistics
import struct
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Tuple

import torch

from .ops import banded, blockdiag, compact_wy, graph_loop, lm_step

__all__ = [
    "DispatchCount",
    "Timer",
    "collective_counts",
    "count_dispatches",
    "cuda_time_ms",
    "graph_nodes",
    "launch_counts",
    "reset_launch_counts",
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
    "chain_two_seg": compact_wy.two_segment_apply,
    "chain_solve": banded.banded_solve_chunk,
    "lm_step": lm_step.damped_step_lane_major,
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
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA driver error {err}")

    raw, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    out = []
    for node in map(ctypes.c_void_p, nodes):
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        rec = {"type": _NODE_TYPES[kind.value] if 0 <= kind.value < len(_NODE_TYPES) else kind.value}
        if kind.value == 0:
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


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU ops and, where a card is
    present, its kernels) written to ``log_dir/trace.json`` (Chrome trace
    format, Perfetto reads it)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
