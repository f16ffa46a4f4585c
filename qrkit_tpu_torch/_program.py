"""Captured programs: a refactorize or a solve as one CUDA graph replay.

Counterpart of the reference's ``jax.jit`` program caches
(``solvers/banded_blocked.py``, ``segmented_banded.py``, ``dense.py``,
``block_diagonal.py``, ``block_angular_fused.py`` and
``functional.block_diagonal_lstsq``): where the reference runs a
refactorize or a solve as ONE compiled program, the port captures the same
torch code, kernel launches (B1–B5) included, into one
``torch.cuda.CUDAGraph`` and replays it.

:class:`Programs` is one solver's cache (or a module's, for a function).
A :class:`Program` is keyed by its name, the caller's key (the state the
captured function reads: pattern layout, route), the factor state a solve
reads, the inputs' shapes, strides, dtypes and devices, and the addresses
of the inputs it reads in place (``resident``: the block-diagonal operand,
which the solver keeps anyway).  The first call of a key runs eagerly, as
an uncaptured call would: a solver or a shape used once pays no capture.
The second call in a row of the same key runs the function once on a side
stream (the warm-up: cuBLAS workspaces, the kernels' one-time module
loads, this call's result) and captures it; every later call is one copy
of each non-resident input into the program's static buffer, one
``graph.replay()`` and, for a solve, one clone of each output.  All of a
solver's graphs share one memory pool (``torch.cuda.graph_pool_handle()``),
held, with the static buffers, for as long as the solver holds its programs
(:meth:`Programs.clear` frees them).

Factorize programs keep their outputs: the solver's factors ARE the static
outputs, overwritten in place by the next replay of the same program, so
that the solve programs captured against them read the new factors at the
addresses they saw; a caller who keeps a factor across computes takes a
copy (the solvers' export methods return copies).  A factorization that binds other tensors (another
program, an eager call) drops the solver's solve programs.  The captured
function receives a shallow copy of the solver taken at capture, so a
graph reads the tensors it was captured with, and lazy state the function
materializes stays out of the solver.

Calls run eagerly, with no capture, when an input lies on the CPU (the
caller asked for the CPU), when an input or an output requires grad
(autograd must see the ops: a solve against factors that require grad is
never captured), inside another capture, under :func:`eager`, or when the caller
says so (the ``mesh=`` paths).  On the card a capture or replay that fails
raises with the program's name; nothing falls back to eager.

The kernel wrappers' launch counters tick in Python, when a launch is
issued, so a capture would count launches that never ran: a program
records the launches its capture issued, sets the counters back, and adds
them on each replay (:func:`qrkit_tpu_torch.profiling.count_dispatches`
counts the replays as ``programs``).
"""
from __future__ import annotations

import contextlib
import copy
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from . import profiling

__all__ = ["Program", "Programs", "eager"]

_EAGER = False
_BACKEND = None  # a test's stand-in for _CudaGraph; None: CUDA graphs on CUDA tensors
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}  # warm-up and capture stream per card


@contextlib.contextmanager
def eager():
    """Run every program's function eagerly, with no capture and no
    replay, for the block (tests and ``chip_smoke.py`` compare a replay
    with the same call made this way)."""
    global _EAGER
    saved, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = saved


@contextlib.contextmanager
def _use_backend(backend):
    """Capture with ``backend`` (a class taking ``(fn, static_inputs, pool,
    stream)`` with ``.out`` and ``.replay()``) on any device for the block:
    the hook through which the CPU tests drive the bookkeeping."""
    global _BACKEND
    saved, _BACKEND = _BACKEND, backend
    try:
        yield
    finally:
        _BACKEND = saved


def _capturable(inputs) -> bool:
    if _EAGER:
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return False
    if _BACKEND is not None:
        return True
    if not all(t.is_cuda for t in inputs):
        return False
    return not torch.cuda.is_current_stream_capturing()


def _signature(inputs):
    return tuple((tuple(t.shape), t.stride(), t.dtype, t.device) for t in inputs)


def _side_stream(device: torch.device):
    if device.type != "cuda":
        return None
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _STREAMS:
        _STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _STREAMS[idx]


@contextlib.contextmanager
def _on(stream):
    """Make ``stream`` current for the block, ordered after the caller's
    current stream and before what the caller enqueues next."""
    if stream is None:
        yield
        return
    caller = torch.cuda.current_stream(stream.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        yield
    caller.wait_stream(stream)


def _as_tuple(out) -> Tuple[Optional[torch.Tensor], ...]:
    return out if isinstance(out, tuple) else (out,)


class _CudaGraph:
    """The capture backend on the card: ``torch.cuda.graph`` into the
    solver's pool, on the program's side stream (the one the warm-up ran
    on, so cuBLAS's workspace for it exists)."""

    def __init__(self, fn, static_in, pool, stream):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = fn(*static_in)

    def replay(self) -> None:
        self.graph.replay()


class Program:
    """One captured call: static inputs, the graph, its static outputs and
    the kernel launches its capture issued (by kernel name).

    The first ``resident`` inputs are read where they lie: the graph holds
    their addresses (``addrs``), no static copy.  ``persistent`` (a
    factorize): the outputs are returned as they are and stay the caller's
    state.  Otherwise (a solve) each call returns clones.
    ``capture_seconds`` is the warm-up excluded: capture and instantiate."""

    def __init__(self, name: str, fn: Callable, static_in, first, *, resident: int,
                 persistent: bool, pool, stream):
        self.name, self.persistent = name, persistent
        self.addrs = tuple(t.data_ptr() for t in static_in[:resident])
        before = profiling.launch_counts()
        t0 = time.perf_counter()
        try:
            self._graph = (_BACKEND or _CudaGraph)(fn, static_in, pool, stream)
        except RuntimeError as e:
            raise RuntimeError(f"{name}: capture failed: {e}") from e
        finally:
            after = profiling.launch_counts()
            profiling._set_launch_counts(before)  # a capture runs nothing
        self.capture_seconds = time.perf_counter() - t0
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.static_in = (None,) * resident + tuple(static_in[resident:])
        self.out = _as_tuple(self._graph.out)
        self._single = not isinstance(self._graph.out, tuple)
        if persistent:  # the capture computed nothing: the warm-up's values
            for s, w in zip(self.out, first):
                if s is not None and s is not w:
                    s.copy_(w)

    def _result(self, out):
        return out[0] if self._single else out

    def replay(self, inputs):
        for s, x in zip(self.static_in, inputs):
            if s is not None and s is not x:
                s.copy_(x)
        try:
            self._graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: replay failed: {e}") from e
        profiling._note_replay(self.launches)
        if self.persistent:
            return self._result(self.out)
        return self._result(tuple(o.clone() if o is not None else None for o in self.out))


def _requires_grad(out) -> bool:
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in _as_tuple(out))


class Programs:
    """One solver's captured programs and their shared memory pool.

    :meth:`factorize` runs a call whose outputs become the solver's factors;
    :meth:`solve` a call that reads them.  A call is captured on the second
    call in a row of its slot (name, key, input signature) with the same
    resident addresses; the first runs eagerly, so a solver called once
    (``auto_qr``, the CLI, one LM iteration's solver) pays no capture.  A
    slot holds one program: a capture against other resident addresses
    replaces it, and ``limit`` bounds the slots (the oldest go).  A solve
    program is keyed by the factor state it was captured against and is
    dropped when the solver's factors are bound to other tensors
    (:meth:`bind_eager` or another factorize program).  A call whose
    outputs require grad (factors that do, with grad enabled) is never
    captured.  :meth:`clear` drops every program and frees the pool."""

    _LAST_LIMIT = 64  # slots whose last call ran eagerly, remembered

    def __init__(self, limit: Optional[int] = None):
        self._cache: Dict[tuple, Program] = {}
        self._last: Dict[tuple, Tuple[tuple, bool]] = {}  # slot → (addresses, persistent)
        self._limit = limit
        self._pool = None
        self._state: Optional[Program] = None  # the program whose outputs are the factors
        self._token = 0  # bumped whenever the factors are bound to other tensors

    def _run(self, owner, name, key, fn, inputs, persistent: bool, capture: bool,
             resident: int):
        if not (capture and _capturable(inputs)):
            return fn(owner, *inputs), None
        slot = (name, key, _signature(inputs))
        addrs = tuple(t.data_ptr() for t in inputs[:resident])
        prog = self._cache.get(slot)
        last = self._last.pop(slot, (None,))[0]  # the slot's previous call, if it ran eagerly
        if prog is not None and prog.addrs == addrs:
            return prog.replay(inputs), prog
        if last != addrs:  # the first call in a row with these addresses: eager
            out = fn(owner, *inputs)
            if not _requires_grad(out):
                self._last[slot] = (addrs, persistent)
                if len(self._last) > self._LAST_LIMIT:
                    del self._last[next(iter(self._last))]
            return out, None
        static_in = tuple(t if i < resident else t.clone() for i, t in enumerate(inputs))
        stream = _side_stream(inputs[0].device) if _BACKEND is None else None
        snap = copy.copy(owner)

        def bound(*xs):
            return fn(snap, *xs)

        with _on(stream):  # the warm-up, and this call's result
            first = bound(*static_in)
        if _requires_grad(first):  # autograd recorded the warm-up: nothing is captured
            return first, None
        if self._pool is None and _BACKEND is None:
            self._pool = torch.cuda.graph_pool_handle()
        prog = Program(name, bound, static_in, _as_tuple(first), resident=resident,
                       persistent=persistent, pool=self._pool, stream=stream)
        self._cache.pop(slot, None)
        self._cache[slot] = prog
        if self._limit is not None and len(self._cache) > self._limit:
            del self._cache[next(iter(self._cache))]
        return (prog._result(prog.out) if persistent else first), prog

    def factorize(self, owner, name: str, key, fn: Callable, *inputs, capture: bool = True,
                  resident: int = 0):
        """``fn(owner, *inputs)`` → the factor tensors (a tuple), captured
        once per key; the factors are the program's static outputs.  The
        first ``resident`` inputs are read where they lie (keyed by their
        addresses, no copy in)."""
        out, prog = self._run(owner, name, key, fn, inputs, True, capture, resident)
        self._bind(prog)
        return out

    def solve(self, owner, name: str, key, fn: Callable, *inputs, capture: bool = True):
        """``fn(owner, *inputs)`` → fresh tensors, captured once per key and
        factor state."""
        return self._run(owner, name, (key, self._token), fn, inputs, False, capture, 0)[0]

    def bind_eager(self) -> None:
        """The solver's factors were bound to tensors no program owns."""
        self._bind(None)

    def _bind(self, prog: Optional[Program]) -> None:
        if prog is None or prog is not self._state:
            self._token += 1
            self._cache = {k: p for k, p in self._cache.items() if p.persistent}
            self._last = {k: v for k, v in self._last.items() if v[1]}
        self._state = prog

    def clear(self) -> None:
        """Drop every program; the pool's memory is freed once the tensors
        handed out of it (a solver's factors) are."""
        self._cache, self._last, self._pool = {}, {}, None
        self._bind(None)

    def programs(self) -> Dict[tuple, Program]:
        """The cached programs by slot."""
        return dict(self._cache)

    def pool_bytes(self) -> Optional[int]:
        """Bytes of device memory reserved in this cache's graph pool
        (``torch.cuda.memory_snapshot``'s segments of the pool); None before
        any capture on the card or where the snapshot names no pool."""
        if self._pool is None:
            return None
        segs = torch.cuda.memory_snapshot()
        if not segs or "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == tuple(self._pool))
