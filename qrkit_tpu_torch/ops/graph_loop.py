"""L1, the LM device loop's condition, and the CUDA graph that runs the loop
as one launch.

No TPU kernel is replaced: XLA evaluates the predicate of
``lax.while_loop`` itself (``qrkit_tpu/lm.py:149-151``).  On the card the
port's loop is a CUDA conditional WHILE node (``csrc/graph_loop.cu``), and
its condition ``(k < max_iters) & ~done.all()`` is set by a kernel from the
device state:

* :func:`loop_condition` launches that kernel once on a CUDA tensor (out: a
  0-d bool) and counts the launch in ``loop_condition.launches``; on a CPU
  tensor it runs the plain expression :func:`_loop_condition_plain`.
* :class:`LoopGraph` builds the instantiated graph of a captured loop
  around the graphs PyTorch captured for its init, body and tail (init,
  then the loop, then the tail) and launches it on the current stream.
  Each evaluation of the condition is one L1 launch inside the graph, which
  adds one to a device counter that the loop's tail fetches with its
  result: the loop program adds that count to ``loop_condition.launches``
  (:class:`qrkit_tpu_torch._program.LoopProgram`).  Each evaluation also
  stamps the device's clock (``%globaltimer``, ns) at index k, so the
  stamps bound the loop's iterations on the device.
* :func:`mark` (kernel L2) stamps the device's clock at a named point
  (:data:`MARKS`) inside a captured loop's body, into the loop's
  ``marks[k, slot]``: a step marks the ends of its parts, so the marks
  time them on the clock of L1's stamps.  It does something only while
  the loop program captures its body (:func:`marking`); elsewhere it is
  free.
* :func:`versions` reads the driver's and the toolkit's CUDA versions
  (conditional WHILE nodes need 12.3 in both).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from typing import Tuple

import torch

from . import _build

__all__ = ["LoopGraph", "MARKS", "loop_condition", "mark", "marking", "versions"]

# the points a loop's body may mark in each iteration, in the order of their
# slots in the loop's ``marks``: a step's entry, its bottom assembled and its
# bottom factored with Qᵀ on the rhs (the block-angular step's two parts)
MARKS = ("step", "bottom", "tsqr")


def _loop_condition_plain(done: torch.Tensor, k: torch.Tensor, max_iters: int) -> torch.Tensor:
    """The plain version: ``(k < max_iters) & ~done.all()``, a 0-d bool."""
    return (k < max_iters) & ~done.all()


def _check(done: torch.Tensor, k: torch.Tensor) -> None:
    if done.dtype != torch.bool or done.dim() != 1:
        raise ValueError(f"done must be a 1-d bool tensor, got {tuple(done.shape)} {done.dtype}")
    if k.dtype != torch.int32 or k.numel() != 1 or k.device != done.device:
        raise ValueError(f"k must be one int32 value on {done.device}, got "
                         f"{tuple(k.shape)} {k.dtype} {k.device}")


def loop_condition(done: torch.Tensor, k: torch.Tensor, max_iters: int) -> torch.Tensor:
    """``(k < max_iters) & ~done.all()`` for ``done [B]`` (bool) and the loop
    counter ``k`` (one int32), as a 0-d bool on their device: the L1 kernel
    on a CUDA tensor, the plain expression on a CPU tensor."""
    _check(done, k)
    if done.device.type == "cpu":
        return _loop_condition_plain(done, k, max_iters)
    if not done.is_contiguous():
        raise ValueError("done must be contiguous")
    out = torch.empty((), dtype=torch.bool, device=done.device)
    _launcher()(done.device.index, done.data_ptr(), done.numel(), k.data_ptr(), int(max_iters),
                out.data_ptr())
    loop_condition.launches += 1
    return out


loop_condition.launches = 0


@functools.lru_cache(maxsize=None)
def _launcher() -> _build.Launcher:
    """The standalone L1 launcher, built and bound at first use."""
    return _build.Launcher(_build.load_graph_loop(), "qrk_loop_cond")


class _Marks:
    """Where :func:`mark` writes while a loop's body is captured: the
    loop's ``marks [max_iters + 1, slots]`` (int64) and its counter ``k``;
    ``used`` turns true at the first mark."""

    __slots__ = ("marks", "k", "used")

    def __init__(self, marks: torch.Tensor, k: torch.Tensor):
        self.marks, self.k, self.used = marks, k, False


_SINK = [None]


@contextlib.contextmanager
def marking(marks: torch.Tensor, k: torch.Tensor):
    """Route :func:`mark` into ``marks`` at row ``k`` for the block (the
    loop program wraps its body's capture in it); yields the sink, whose
    ``used`` says whether the body marked anything."""
    saved, _SINK[0] = _SINK[0], _Marks(marks, k)
    try:
        yield _SINK[0]
    finally:
        _SINK[0] = saved


def mark(name: str) -> None:
    """Stamp the clock into the capturing loop's ``marks[k, slot]``, the
    slot of ``name`` in :data:`MARKS`: on the card kernel L2 (one thread,
    the device's ``%globaltimer`` in ns, one launch counted in
    ``mark.launches``), on a CPU loop the host's clock (no host read of
    ``k``).  Outside :func:`marking`, nothing."""
    if name not in MARKS:
        raise ValueError(f"mark {name!r} is none of {MARKS}")
    sink = _SINK[0]
    if sink is None:
        return
    marks, k, slot = sink.marks, sink.k, MARKS.index(name)
    sink.used = True
    if marks.device.type == "cpu":
        row = k.to(torch.int64).reshape(1)
        marks.index_put_((row, torch.tensor([slot])), torch.tensor([time.perf_counter_ns()]))
        return
    _mark_launcher()(marks.device.index, marks.data_ptr(), k.data_ptr(), marks.shape[1], int(slot),
                     marks.shape[0])
    mark.launches += 1


mark.launches = 0


@functools.lru_cache(maxsize=None)
def _mark_launcher() -> _build.Launcher:
    """The L2 launcher, built and bound at first use."""
    return _build.Launcher(_build.load_graph_loop(), "qrk_loop_mark")


def _raise(lib, what: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.qrk_error_string(err).decode()})")


def versions() -> Tuple[int, int]:
    """(driver, runtime): the CUDA versions of the driver and of the toolkit
    the graph-loop library was built with, as ``cuDriverGetVersion`` gives
    them (12080 for 12.8)."""
    lib = _build.load_graph_loop()
    drv, rt = ctypes.c_int(), ctypes.c_int()
    _raise(lib, "qrk_versions", lib.qrk_versions(ctypes.byref(drv), ctypes.byref(rt)))
    return drv.value, rt.value


class LoopGraph:
    """The instantiated graph of one captured loop.

    ``init``, ``body`` and ``tail`` are ``cudaGraph_t`` handles (PyTorch's
    ``CUDAGraph.raw_cuda_graph()``, captured with ``keep_graph=True``); they
    are cloned, so PyTorch's graphs may go, but the memory pool their
    addresses lie in must outlive this object.  ``done`` and ``k`` are the
    loop state the condition reads; each evaluation adds one to ``count``
    (one int32, which ``init`` zeroes), writes the condition into ``log``
    (int32, ``max_iters + 1``) at index k and the device's
    ``%globaltimer`` on its entry into ``stamps`` (int64, as long as
    ``log``) at index k.  A failure to build, instantiate or launch
    raises."""

    def __init__(self, init: int, body: int, tail: int, done: torch.Tensor,
                 k: torch.Tensor, max_iters: int, count: torch.Tensor, log: torch.Tensor,
                 stamps: torch.Tensor):
        _check(done, k)
        for name, t, dtype in (("count", count, torch.int32), ("log", log, torch.int32),
                               ("stamps", stamps, torch.int64)):
            if t.dtype != dtype or t.device != done.device or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {dtype} tensor on the state's device")
        if stamps.numel() != log.numel():
            raise ValueError(f"stamps must hold as many entries as log ({log.numel()}), "
                             f"got {stamps.numel()}")
        self._lib = _build.load_graph_loop()
        self.device = done.device.index if done.device.index is not None else torch.cuda.current_device()
        self._handle = ctypes.c_void_p()
        _raise(self._lib, "qrk_loop_build", self._lib.qrk_loop_build(
            self.device, init, body, tail, done.data_ptr(), done.numel(), k.data_ptr(),
            int(max_iters), count.data_ptr(), log.data_ptr(), stamps.data_ptr(), log.numel(),
            ctypes.byref(self._handle)))

    def launch(self) -> None:
        """Launch the graph on the current stream of the state's card."""
        if self._handle is None:
            raise RuntimeError("the loop graph was destroyed")
        _raise(self._lib, "qrk_loop_launch", self._lib.qrk_loop_launch(
            self._handle, _build.current_stream(self.device)))

    def close(self) -> None:
        """Destroy the instantiated graph (before the memory pool goes)."""
        if self._handle is not None:
            self._lib.qrk_loop_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
