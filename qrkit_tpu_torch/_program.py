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
loads, this call's result) and captures it; every later call copies the
non-resident inputs into the program's static buffers (one
``_foreach_copy_``), runs one ``graph.replay()`` and, for a solve, hands out
fresh copies of the outputs (one op, :func:`_clones`).  All of a
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
never captured), inside another program's function, under :func:`eager`,
or when the caller says so.  A program whose function
calls another solver's captured call (``BlockAngularQR``'s sparse-A2
recompute calls its right solver's ``compute``) runs that call inline, in
its own first call, warm-up and capture alike, so the inner ops become part
of the outer graph; the caller binds the inner solver's factors to the
outer program's outputs.  On the card a capture or replay that fails raises
with the program's name; nothing falls back to eager.

Programs over a mesh (the ``mesh=`` paths, the reference's jitted SPMD
programs) record their ``torch.distributed`` collectives inside the graph.
A recorded collective runs only when every rank replays its graph, so
every rank must take the same path at the same call: such a program is
keyed by the mesh axis's group and size as well (``mesh=``), reads no
input at its address (addresses differ between ranks; its inputs are
copied in), and every decision (eager, capture, replay, eviction) follows
from the call sequence, which SPMD makes the same on every rank.  The
first call of a key runs eagerly, which creates the communicator before
any capture, and the warm-up runs the collectives on every rank together.
A program whose warm-up issued a collective is captured with
``capture_error_mode="thread_local"`` (the process group's watchdog thread
queries events while a capture runs, which the default mode refuses); the
others keep the default.  Collectives are counted as the kernel launches
are (:func:`qrkit_tpu_torch.profiling.collective_counts`): a capture
records those it issued, sets the counters back and adds them at each
replay.

Host values (a NumPy array where the function takes a tensor: the values
of a host ``SparseCSR``) are uploads: the program keeps a static input of
the solver's device and dtype, and each call writes the values into a host
staging buffer (pinned on the card; the next call waits for the last copy
out of it) and copies that into the static input in one asynchronous copy.
A ``fetch`` call returns its outputs on the host (NumPy arrays): a replay
copies each output into a pinned host buffer kept with the program (one
copy each, the call's host read) and hands out a NumPy copy of it.

The kernel wrappers' launch counters tick in Python, when a launch is
issued, so a capture would count launches that never ran: a program
records the launches its capture issued, sets the counters back, and adds
them on each replay (:func:`qrkit_tpu_torch.profiling.count_dispatches`
counts the replays as ``programs``).

A :class:`LoopProgram` is the counterpart of ``lax.while_loop`` (the LM
device fits, :mod:`qrkit_tpu_torch.lm`): an ``init``, a loop ``body`` and a
``tail`` that update static state buffers in place, each captured with
``torch.cuda.CUDAGraph(keep_graph=True)`` into its cache's pool after one
warm-up of the body on the side stream (an iteration of the caller's loop),
and built by :class:`qrkit_tpu_torch.ops.graph_loop.LoopGraph` into a graph
whose conditional WHILE node replays the body while kernel L1 finds the
condition ``(k < max_iters) & ~done.all()`` true.  A fit is then one graph
launch and one fetch of the tail's output, which carries the loop counter
and L1's own count of its evaluations: the body's launches are counted per
iteration from the first, L1's from the second.  A loop also reads the
tensors its functions hold (closure cells, a bound method's object): the
program keeps them alive and is captured again when the functions hold
others (:meth:`Loops.get`).  A loop whose iteration issues collectives
(an LM fit over a mesh, ``reduce=``) cannot hold them in a WHILE node's
body: it runs as chunks of gated iterations in plain graphs
(:class:`_ChunkedLoop`, one launch and one fetch a chunk), captured in
``"thread_local"`` mode, its collectives counted per iteration run.
:class:`Loops` caches the loops by key
(``limit`` keys, the oldest destroyed first: its graph before the pool).
"""
from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import types
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import profiling
from .ops import graph_loop

__all__ = ["LOOP_CHUNK", "LoopProgram", "Loops", "Program", "Programs", "eager", "loop_chunks"]

LOOP_CHUNK = 8  # gated iterations a chunk graph runs (a loop that holds collectives)

_EAGER = False
_INLINE = 0  # depth of program functions running (first call, warm-up, capture, test replay)
_BACKEND = None  # a test's stand-in for _CudaGraph; None: CUDA graphs on CUDA tensors
_LOOP_BACKEND = None  # a test's stand-in for _CudaLoop
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}  # warm-up and capture stream per card
_SERIAL = itertools.count()  # names each program for what reads its outputs


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


@contextlib.contextmanager
def _use_loop_backend(backend):
    """The loop counterpart of :func:`_use_backend`: loop programs are
    captured with ``backend`` (a class taking ``(init, body, tail, prog,
    pool, stream)`` with ``.launch()`` and ``.close()``) on any device for
    the block."""
    global _LOOP_BACKEND
    saved, _LOOP_BACKEND = _LOOP_BACKEND, backend
    try:
        yield
    finally:
        _LOOP_BACKEND = saved


def _capturable(inputs, stand_in, upload=None) -> bool:
    """Whether a call on ``inputs`` is captured (``stand_in``: the test
    backend in use, or None; ``upload``: the (device, dtype) of the host
    arrays among the inputs)."""
    if _EAGER or _INLINE:
        return False
    tensors = [t for t in inputs if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    if stand_in is not None:
        return True
    devices = [t.device for t in tensors] + ([upload[0]] if len(tensors) < len(inputs) else [])
    if not all(d.type == "cuda" for d in devices):
        return False
    return not torch.cuda.is_current_stream_capturing()


def _signature(inputs, upload=None):
    """Shapes, strides, dtypes and devices of the inputs; a host array as
    the static input it is uploaded into (so host values and a device
    vector of the same shape share a program)."""
    return tuple((tuple(t.shape), t.stride(), t.dtype, t.device) if isinstance(t, torch.Tensor)
                 else _upload_signature(t.shape, upload) for t in inputs)


def _upload_signature(shape, upload):
    device, dtype = upload
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= max(d, 1)
    return tuple(shape), tuple(reversed(strides)), dtype, device


@contextlib.contextmanager
def _inline():
    """The block runs a program's function: the programs it calls run
    inline (eagerly, into the caller's capture)."""
    global _INLINE
    _INLINE += 1
    try:
        yield
    finally:
        _INLINE -= 1


def _upload(a, upload) -> torch.Tensor:
    """A host array on ``upload = (device, dtype)`` for an eager call:
    pinned and asynchronous on the card, so the call does not wait for the
    device."""
    device, dtype = upload
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _on_device(inputs, upload):
    """The inputs with each host array uploaded (an eager call)."""
    return tuple(t if isinstance(t, torch.Tensor) else _upload(t, upload) for t in inputs)


class _Staging:
    """A host input's staging buffer: each call writes the values into it
    on the host (no ATen op) and copies it into the static input in one
    asynchronous copy; on the card the buffer is pinned and an event keeps
    the next write behind the last copy out of it."""

    def __init__(self, static: torch.Tensor):
        pinned = static.is_cuda
        self.host = torch.empty(static.shape, dtype=static.dtype, pin_memory=pinned)
        self.view = self.host.numpy()
        self.event = torch.cuda.Event() if pinned else None

    def copy(self, static: torch.Tensor, a) -> None:
        if self.event is not None:
            self.event.synchronize()
        np.copyto(self.view, a, casting="same_kind")
        static.copy_(self.host, non_blocking=True)
        if self.event is not None:
            self.event.record()


class _HostOut:
    """A fetched output's host buffer (pinned on the card) and its NumPy
    view, both made once: a fetch is one copy into it (the host read) and
    a NumPy copy out of it; an output on the CPU is read through its own
    view, no ATen op."""

    def __init__(self, out: torch.Tensor):
        self.host = None if out.device.type == "cpu" else torch.empty(
            out.shape, dtype=out.dtype, pin_memory=True)
        self.view = (out if self.host is None else self.host).numpy()

    def read(self, out: torch.Tensor):
        if self.host is not None:
            self.host.copy_(out)
        return self.view.copy()


def _fetch(out):
    """``out`` (a tensor or a tuple) on the host: each tensor a fresh NumPy
    array (one copy from the device each; on the CPU a NumPy copy, no ATen
    op)."""
    host = tuple(None if t is None else t.numpy().copy() if t.device.type == "cpu"
                 else t.cpu().numpy() for t in _as_tuple(out))
    return host if isinstance(out, tuple) else host[0]


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


def _copy_in(static, inputs, staging=None) -> None:
    """Copy each input into its static buffer (None: read in place), as one
    ``_foreach_copy_``; a host array through its staging buffer (``staging``
    by input index, made at its first use), one copy each."""
    for i, x in enumerate(inputs):
        if not isinstance(x, torch.Tensor):
            if i not in staging:
                staging[i] = _Staging(static[i])
            staging[i].copy(static[i], x)
    pairs = [(s, x) for s, x in zip(static, inputs)
             if s is not None and s is not x and isinstance(x, torch.Tensor)]
    if len(pairs) == 1:
        pairs[0][0].copy_(pairs[0][1])
    elif pairs:
        torch._foreach_copy_([s for s, _ in pairs], [x for _, x in pairs])


def _clones(outs) -> Tuple[Optional[torch.Tensor], ...]:
    """A fresh copy of each output (None stays None) in one op,
    ``_foreach_mul`` by 1 (exact: x · 1 is x in every IEEE format, and in
    integers); bool or complex outputs are cloned one by one."""
    ts = [o for o in outs if o is not None]
    if len(ts) > 1 and not any(t.dtype == torch.bool or t.is_complex() for t in ts):
        fresh = torch._foreach_mul(ts, 1)
    else:
        fresh = [t.clone() for t in ts]
    fresh = iter(fresh)
    return tuple(next(fresh) if o is not None else None for o in outs)


class _CudaGraph:
    """The capture backend on the card: ``torch.cuda.graph`` into the
    solver's pool, on the program's side stream (the one the warm-up ran
    on, so cuBLAS's workspace for it exists), in the program's
    ``capture_error_mode``."""

    def __init__(self, fn, static_in, pool, stream, capture_error_mode: str = "global"):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode=capture_error_mode):
            self.out = fn(*static_in)

    def replay(self) -> None:
        self.graph.replay()


def _capture_mode(collective: bool) -> str:
    """``torch.cuda.graph``'s ``capture_error_mode`` for a capture that
    issues collectives or none: ``"thread_local"`` where it does (the
    process group's watchdog thread queries CUDA events while a capture
    runs, which the default ``"global"`` mode refuses), else the default."""
    return "thread_local" if collective else "global"


def _mesh_key(mesh, axis: str):
    """What keys a program over ``mesh``: the axis's process group and its
    size (None without a mesh).  Every rank computes the same key, so every
    rank captures at the same call."""
    if mesh is None:
        return None
    import torch.distributed as dist

    group = mesh.get_group(axis)
    return group.group_name, dist.get_world_size(group)


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


class Program:
    """One captured call: static inputs, the graph, its static outputs and
    the kernel launches and collectives its capture issued (by name).

    The first ``resident`` inputs are read where they lie: the graph holds
    their addresses (``addrs``), no static copy.  ``persistent`` (a
    factorize): the outputs are returned as they are and stay the caller's
    state.  Otherwise (a solve) each call returns clones.
    ``capture_seconds``: its set-up's ``capture`` part (the warm-up, the
    capture and the instantiate; :func:`qrkit_tpu_torch.profiling.setup_seconds`).
    ``collective``: the warm-up issued collectives (a mesh program), which
    the graph then holds; it is captured in ``"thread_local"`` mode."""

    def __init__(self, name: str, fn: Callable, static_in, first, *, resident: int,
                 persistent: bool, pool, stream, hosts=(), fetch: bool = False,
                 collective: bool = False):
        self.name, self.persistent = name, persistent
        self.serial = next(_SERIAL)
        self.addrs = tuple(t.data_ptr() for t in static_in[:resident])
        self.capture_error_mode = _capture_mode(collective)
        self.capture_seconds = 0.0  # set by the cache, which times the set-up
        before, cbefore = profiling.launch_counts(), profiling.collective_counts()
        try:
            with _inline():
                if _BACKEND is not None:
                    self._graph = _BACKEND(fn, static_in, pool, stream)
                else:
                    self._graph = _CudaGraph(fn, static_in, pool, stream, self.capture_error_mode)
        except RuntimeError as e:
            raise RuntimeError(f"{name}: capture failed: {e}") from e
        finally:
            after, cafter = profiling.launch_counts(), profiling.collective_counts()
            profiling._set_launch_counts(before)  # a capture runs nothing
            profiling._set_collective_counts(cbefore)
        self.launches = _delta(after, before)
        self.collectives = _delta(cafter, cbefore)
        self.static_in = (None,) * resident + tuple(static_in[resident:])
        # host inputs' staging buffers by index, made now (a later call that
        # passes host values where this one passed a tensor makes its own)
        self.staging = {i: _Staging(static_in[i]) for i in hosts}
        self.out = _as_tuple(self._graph.out)
        self.fetched = tuple(None if t is None else _HostOut(t) for t in self.out) if fetch else None
        self._single = not isinstance(self._graph.out, tuple)
        if persistent:  # the capture computed nothing: the warm-up's values
            for s, w in zip(self.out, first):
                if s is not None and s is not w:
                    s.copy_(w)

    def _result(self, out):
        return out[0] if self._single else out

    def replay(self, inputs, fetch: bool = False):
        _copy_in(self.static_in, inputs, self.staging)
        try:
            with _inline():  # a test backend's replay runs the function again
                self._graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: replay failed: {e}") from e
        profiling._note_replay(self.launches, self.collectives)
        if fetch:
            return self._result(tuple(None if h is None else h.read(t)
                                      for h, t in zip(self.fetched, self.out)))
        if self.persistent:
            return self._result(self.out)
        return self._result(_clones(self.out))


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
             resident: int, upload=None, fetch: bool = False, mesh=None, axis: str = "dp"):
        if upload is None and not all(isinstance(t, torch.Tensor) for t in inputs):
            raise TypeError(f"{name}: a host input needs upload=(device, dtype)")
        if not (capture and _capturable(inputs, _BACKEND, upload)):
            out = fn(owner, *_on_device(inputs, upload))
            return (_fetch(out) if fetch else out), None
        if mesh is not None and resident:
            raise ValueError(f"{name}: a mesh program reads no input at its address (the "
                             "addresses differ between ranks, the capture decision must not)")
        slot = (name, key, _signature(inputs, upload))
        if mesh is not None:
            slot += (_mesh_key(mesh, axis),)
        addrs = tuple(t.data_ptr() for t in inputs[:resident])
        prog = self._cache.get(slot)
        last = self._last.pop(slot, (None,))[0]  # the slot's previous call, if it ran eagerly
        if prog is not None and prog.addrs == addrs:
            with profiling.span("qrk.program.replay"):
                return prog.replay(inputs, fetch), prog
        if last != addrs:  # the first call in a row with these addresses: eager
            with profiling.span("qrk.setup.first_call", setup=True), _inline():
                out = fn(owner, *_on_device(inputs, upload))
            if not _requires_grad(out):
                self._last[slot] = (addrs, persistent)
                if len(self._last) > self._LAST_LIMIT:
                    del self._last[next(iter(self._last))]
            return (_fetch(out) if fetch else out), None
        static_in = tuple(t if i < resident else t.clone()
                          for i, t in enumerate(_on_device(inputs, upload)))
        stream = _side_stream(static_in[0].device) if _BACKEND is None else None
        snap = copy.copy(owner)

        def bound(*xs):
            return fn(snap, *xs)

        with profiling.span("qrk.setup.capture", setup=True) as setup:
            issued = profiling.collective_counts()
            with _on(stream), _inline():  # the warm-up, and this call's result
                first = bound(*static_in)
            collective = profiling.collective_counts() != issued
            if _requires_grad(first):  # autograd recorded the warm-up: nothing is captured
                return first, None
            if self._pool is None and _BACKEND is None:
                self._pool = torch.cuda.graph_pool_handle()
            prog = Program(name, bound, static_in, _as_tuple(first), resident=resident,
                           persistent=persistent, pool=self._pool, stream=stream, fetch=fetch,
                           hosts=[i for i, t in enumerate(inputs)
                                  if not isinstance(t, torch.Tensor)],
                           collective=collective)
        prog.capture_seconds = setup.seconds
        self._cache.pop(slot, None)
        self._cache[slot] = prog
        if self._limit is not None and len(self._cache) > self._limit:
            del self._cache[next(iter(self._cache))]
        if fetch:
            return _fetch(first), prog
        return (prog._result(prog.out) if persistent else first), prog

    def factorize(self, owner, name: str, key, fn: Callable, *inputs, capture: bool = True,
                  resident: int = 0, upload=None, mesh=None, axis: str = "dp"):
        """``fn(owner, *inputs)`` → the factor tensors (a tuple), captured
        once per key; the factors are the program's static outputs.  The
        first ``resident`` inputs are read where they lie (keyed by their
        addresses, no copy in); a host array among the inputs is uploaded to
        ``upload = (device, dtype)``.  ``mesh``/``axis``: the function
        issues collectives over that mesh axis (on every rank: the program
        is keyed by the axis's group, and reads no resident input)."""
        out, prog = self._run(owner, name, key, fn, inputs, True, capture, resident, upload,
                              mesh=mesh, axis=axis)
        self._bind(prog)
        return out

    def solve(self, owner, name: str, key, fn: Callable, *inputs, capture: bool = True,
              upload=None, fetch: bool = False, mesh=None, axis: str = "dp"):
        """``fn(owner, *inputs)`` → fresh tensors, captured once per key and
        factor state; with ``fetch``, the outputs on the host (NumPy);
        ``mesh``/``axis`` as for :meth:`factorize`."""
        return self._run(owner, name, (key, self._token), fn, inputs, False, capture, 0,
                         upload, fetch, mesh=mesh, axis=axis)[0]

    def drop(self, name: str) -> None:
        """Forget every program named ``name`` (its key's maps went)."""
        self._cache = {k: p for k, p in self._cache.items() if k[0] != name}
        self._last = {k: v for k, v in self._last.items() if k[0] != name}

    def state(self) -> Optional[int]:
        """The serial number of the program whose outputs are the factors,
        or None when they are tensors no program owns: a program of another
        solver that reads the factors is keyed by it, and captured only
        when it is not None (eager factors move at every call)."""
        return None if self._state is None else self._state.serial

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
        return _pool_bytes(self._pool)


def _pool_bytes(pool) -> Optional[int]:
    if pool is None:
        return None
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == tuple(pool))


class _CudaLoop:
    """The loop backend on the card: the body, init and tail captured with
    ``torch.cuda.CUDAGraph(keep_graph=True)`` into the cache's pool on the
    side stream, and the graph of :class:`~qrkit_tpu_torch.ops.graph_loop.LoopGraph`
    built around them.  PyTorch's graphs are kept: they hold the pool."""

    def __init__(self, init, body, tail, prog, pool, stream):
        from .ops.graph_loop import LoopGraph

        self.graphs = []
        for fn in (body, init, tail):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode=prog.capture_error_mode):
                fn()
            self.graphs.append(graph)
        body_g, init_g, tail_g = (g.raw_cuda_graph() for g in self.graphs)
        self.loop = LoopGraph(init_g, body_g, tail_g, prog.done, prog.k, prog.max_iters,
                              prog.count, prog.log, prog.stamps)

    def launch(self) -> None:
        self.loop.launch()

    def close(self) -> None:
        self.loop.close()  # the instantiated graph before the pool
        self.graphs = []


class _ChunkedLoop:
    """The loop design for an iteration that holds collectives.  NCCL's
    captured collectives are refused inside a conditional WHILE body (on 4
    cards the build of that graph fails with "invalid argument":
    ``dryrun.probe_graph_collectives``), so such a loop is two plain
    graphs captured with the program backend (:class:`_CudaGraph` on the
    card, in the loop's capture mode): the first chunk (``init``, then
    :data:`LOOP_CHUNK` gated iterations, then ``tail``) and the next chunk
    (the same without ``init``).  A gated iteration evaluates L1's
    condition, runs ``body`` and keeps the new state (``buffers`` and
    ``k``) only where the condition holds, so once the loop is finished an
    iteration changes nothing, bitwise.  :meth:`LoopProgram.run` launches
    the first chunk, fetches ``out``, and launches the next chunk until one
    ran fewer than :data:`LOOP_CHUNK` iterations or ``k`` reached
    ``max_iters`` (:func:`loop_chunks`): one launch and one fetch a chunk."""

    def __init__(self, init, body, tail, prog, pool, stream):
        from .ops.graph_loop import loop_condition

        state = tuple(prog.buffers) + (prog.k,)

        def gated():
            cond = loop_condition(prog.done, prog.k, prog.max_iters)
            prog.count.add_(1)
            old = [t.clone() for t in state]
            body()
            torch._foreach_copy_(list(state), [torch.where(cond, t, o) for t, o in zip(state, old)])

        def chunk(first):
            def run():
                if first:
                    init()
                for _ in range(LOOP_CHUNK):
                    gated()
                tail()
                return prog.out
            return run

        before, issued = profiling.launch_counts(), profiling.collective_counts()
        try:
            with _inline():
                self.graphs = [
                    _BACKEND(chunk(first), (), pool, stream) if _BACKEND is not None
                    else _CudaGraph(chunk(first), (), pool, stream, prog.capture_error_mode)
                    for first in (True, False)
                ]
        finally:  # L1's launches outside the parts' counts: a capture runs nothing
            profiling._set_launch_counts(before)
            profiling._set_collective_counts(issued)

    def replay(self, first: bool) -> None:
        with _inline():  # a test backend's replay runs the functions again
            self.graphs[0 if first else 1].replay()

    def close(self) -> None:
        self.graphs = []


def loop_chunks(iterations: int, max_iters: int) -> int:
    """The chunks a chunked loop (:class:`_ChunkedLoop`) launches for a run
    of ``iterations``: until a chunk runs fewer than :data:`LOOP_CHUNK`
    iterations or the loop reaches ``max_iters``."""
    return min(iterations // LOOP_CHUNK + 1, -(-max_iters // LOOP_CHUNK))


def _held_tensors(fns) -> Tuple[torch.Tensor, ...]:
    """The tensors that ``fns`` read besides their arguments, in order,
    each once: found through closure cells and defaults, bound methods and
    their objects' attributes, callable objects' attributes, partials, and
    the tuples, lists and dicts among them (not through module globals)."""
    found, seen, stack = [], set(), list(reversed(fns))
    while stack:
        o = stack.pop()
        if id(o) in seen or isinstance(o, (type, types.ModuleType)):
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            found.append(o)
            continue
        if isinstance(o, types.FunctionType):
            cells = []
            for c in o.__closure__ or ():
                try:
                    cells.append(c.cell_contents)
                except ValueError:  # a cell not yet bound
                    pass
            kids = cells + list(o.__defaults__ or ()) + list((o.__kwdefaults__ or {}).values())
        elif isinstance(o, types.MethodType):
            kids = [o.__func__, *vars(o.__self__).values()] if hasattr(o.__self__, "__dict__") \
                else [o.__func__]
        elif isinstance(o, functools.partial):
            kids = [o.func, *o.args, *o.keywords.values()]
        elif isinstance(o, (tuple, list)):
            kids = list(o)
        elif isinstance(o, dict):
            kids = list(o.values())
        elif callable(o) and hasattr(o, "__dict__"):
            kids = list(vars(o).values())
        else:
            continue
        stack.extend(reversed(kids))
    return tuple(found)


def _held_signature(held):
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device) for t in held)


class LoopProgram:
    """One captured loop: ``init()`` sets the state from the static inputs
    and zeroes ``k`` and ``count``, ``body()`` is one iteration (it ends by
    adding one to the loop counter ``k``), ``tail()`` writes the result into
    ``out``, whose last two entries are ``k`` and ``count``; all three
    update static buffers in place.  ``done`` (bool ``[B]``) and ``k``
    (int32) are the state the condition reads; each evaluation adds one to
    ``count`` (int32), writes the condition into ``log`` at index k
    (int32, ``max_iters + 1``, -1 where none ran) and its time into
    ``stamps`` at index k (int64 ns, as long as ``log``: on the card the
    device's ``%globaltimer``; a chunked loop writes none).  The body may
    mark points inside an iteration (:func:`~qrkit_tpu_torch.ops.graph_loop.mark`,
    kernel L2): its marks go to ``marks[k, slot]`` (int64 ns, ``[max_iters +
    1, len(graph_loop.MARKS)]``, k the iteration's index from 0; a chunked
    loop takes none).  ``held``: the tensors
    the captured functions read besides the inputs, kept alive for as long
    as the graph reads their addresses; ``buffers``: the loop's state
    tensors that the graphs read and write (allocated before the capture,
    outside its pool), kept alive likewise.

    :meth:`run` is a whole loop from new inputs: one launch followed by one
    fetch of ``out``; while a ``torch.profiler`` runs it adds the launch's
    stamps (and marks, where the body made any) to
    :func:`qrkit_tpu_torch.profiling.loop_records`.
    ``capture_seconds``: its set-up's ``capture`` part (the warm-up, the
    three captures and the build).  ``collective``: the warm-up issued
    collectives (a ``reduce=`` fit over a mesh), which the graphs then hold:
    captured in ``"thread_local"`` mode, counted per part as the launches
    are, and run as chunks (:class:`_ChunkedLoop`: a launch and a fetch a
    chunk); ``reads`` is the last run's fetches."""

    def __init__(self, name: str, init: Callable, body: Callable, tail: Callable, static_in,
                 done: torch.Tensor, k: torch.Tensor, count: torch.Tensor, out: torch.Tensor,
                 max_iters: int, held, pool, stream, buffers=(), collective: bool = False):
        self.name, self.static_in, self.max_iters = name, tuple(static_in), int(max_iters)
        self.buffers = tuple(buffers)
        self.done, self.k, self.count, self.out = done, k, count, out
        self.held, self.held_signature = tuple(held), _held_signature(held)
        self.log = torch.full((self.max_iters + 1,), -1, dtype=torch.int32, device=done.device)
        self.stamps = torch.zeros(self.max_iters + 1, dtype=torch.int64, device=done.device)
        self.marks = torch.zeros((self.max_iters + 1, len(graph_loop.MARKS)),
                                 dtype=torch.int64, device=done.device)
        self.marked = False  # the body marked points of its iterations
        self.capture_seconds = 0.0  # set by the cache, which times the set-up
        self.capture_error_mode = _capture_mode(collective)
        self.chunked, self.reads = collective, 0
        self.launches: Dict[str, Dict[str, int]] = {}
        self.collectives: Dict[str, Dict[str, int]] = {}

        def counted(part, fn):
            def run():
                before, cbefore = profiling.launch_counts(), profiling.collective_counts()
                try:
                    fn()
                finally:
                    after, cafter = profiling.launch_counts(), profiling.collective_counts()
                    profiling._set_launch_counts(before)  # a capture runs nothing
                    profiling._set_collective_counts(cbefore)
                self.launches[part] = _delta(after, before)
                self.collectives[part] = _delta(cafter, cbefore)
            return run

        def marked(fn):
            def run():
                with graph_loop.marking(self.marks, self.k) as sink:
                    fn()
                self.marked = self.marked or sink.used
            return run

        design = _ChunkedLoop if collective else (_LOOP_BACKEND or _CudaLoop)
        body = counted("body", body if collective else marked(body))
        try:
            self._loop = design(counted("init", init), body, counted("tail", tail), self, pool,
                                stream)
        except RuntimeError as e:
            raise RuntimeError(f"{name}: capture failed: {e}") from e

    def run(self, inputs):
        """The loop from ``inputs`` (copied into the static inputs) to its
        end: one launch, one fetch (a chunked loop: one of each a chunk);
        returns ``out`` on the host (NumPy).  Raises if L1's count of its
        evaluations is not one more than the iterations (chunked: one a
        gated iteration), a loop whose condition did not run as built."""
        with profiling.span("qrk.loop.copy_in"):
            _copy_in(self.static_in, inputs)
        chunks = 0
        try:
            while True:
                with profiling.span("qrk.loop.launch"):
                    if self.chunked:
                        self._loop.replay(first=chunks == 0)
                    else:
                        self._loop.launch()
                chunks += 1
                with profiling.span("qrk.loop.fetch"):
                    host = self.out.cpu().numpy()  # waits on the loop
                iterations = int(host[-2])
                if not self.chunked or loop_chunks(iterations, self.max_iters) <= chunks:
                    break
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: launch failed: {e}") from e
        self.reads = chunks
        evaluations = int(host[-1])
        want = chunks * LOOP_CHUNK if self.chunked else iterations + 1
        if evaluations != want:
            raise RuntimeError(f"{self.name}: L1 evaluated the loop condition {evaluations} times "
                               f"in {iterations} iterations (want {want})")
        body = evaluations if self.chunked else iterations
        launches: Dict[str, int] = {"graph_loop_cond": evaluations}
        collectives: Dict[str, int] = {}
        for part, times in (("init", 1), ("body", body), ("tail", chunks)):
            for counts, held in ((launches, self.launches), (collectives, self.collectives)):
                for name, n in held.get(part, {}).items():
                    counts[name] = counts.get(name, 0) + n * times
        profiling._note_replay(launches, collectives, replays=chunks)
        if not self.chunked and profiling._profiler_enabled():
            marks = self.marks[:iterations].tolist() if self.marked else None
            profiling._note_loop(self.name, iterations, self.stamps[: iterations + 1].tolist(),
                                 marks)
        return host

    def close(self) -> None:
        """Destroy the graph; the pool's memory goes once no graph holds it."""
        if self._loop is not None:
            self._loop.close()
            self._loop = None


class Loops:
    """A module's captured loops by key and their shared memory pool.

    :meth:`capture` runs the body once on the side stream (the warm-up: an
    iteration of the caller's loop), then captures the loop; a key holds
    one loop, ``limit`` keys are kept (the oldest closed first).  Loops of
    one cache share a pool: they must not run concurrently (the LM fits run
    one after another on the caller's stream).  :meth:`clear` closes every
    loop and lets the pool go."""

    def __init__(self, limit: int):
        self._cache: Dict[tuple, LoopProgram] = {}
        self._limit = limit
        self._pool = None

    def capturable(self, inputs) -> bool:
        """Whether a loop over ``inputs`` is captured: CUDA tensors that do
        not require grad, outside a capture and outside :func:`eager` (or
        any device under a test backend)."""
        return _capturable(inputs, _LOOP_BACKEND)

    def get(self, key, reads=()) -> Optional[LoopProgram]:
        """The key's loop, or None: none was captured, or the functions
        ``reads`` now hold other tensors (:func:`_held_tensors`) than the
        loop reads, which then goes (the caller captures again)."""
        prog = self._cache.get(key)
        if prog is not None and _held_signature(_held_tensors(reads)) != prog.held_signature:
            self._cache.pop(key).close()
            return None
        return prog

    def capture(self, key, name: str, init: Callable, body: Callable, tail: Callable, static_in,
                done: torch.Tensor, k: torch.Tensor, count: torch.Tensor, out: torch.Tensor,
                max_iters: int, reads=(), buffers=()) -> LoopProgram:
        """Warm up (one ``body()`` on the side stream) and capture; the
        program replaces the key's and is returned.  ``reads``: the
        functions whose held tensors the loop reads; ``buffers``: the state
        tensors the loop updates in place (both kept alive with it)."""
        stream = _side_stream(done.device) if _LOOP_BACKEND is None else None
        with profiling.span("qrk.setup.capture", setup=True) as setup:
            issued = profiling.collective_counts()
            with _on(stream):
                body()
            collective = profiling.collective_counts() != issued
            if self._pool is None and _LOOP_BACKEND is None:
                self._pool = torch.cuda.graph_pool_handle()
            prog = LoopProgram(name, init, body, tail, static_in, done, k, count, out, max_iters,
                               _held_tensors(reads), self._pool, stream, buffers, collective)
        prog.capture_seconds = setup.seconds
        old = self._cache.pop(key, None)
        if old is not None:
            old.close()
        self._cache[key] = prog
        while len(self._cache) > self._limit:
            self._cache.pop(next(iter(self._cache))).close()
        return prog

    def programs(self) -> Dict[tuple, LoopProgram]:
        return dict(self._cache)

    def clear(self) -> None:
        """Close every loop (its graph first) and let the pool go."""
        for prog in self._cache.values():
            prog.close()
        self._cache, self._pool = {}, None

    def pool_bytes(self) -> Optional[int]:
        """Bytes reserved in this cache's graph pool (see
        :meth:`Programs.pool_bytes`)."""
        return _pool_bytes(self._pool)
