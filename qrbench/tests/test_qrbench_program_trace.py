"""The readers of what the program records about itself (its set-up by
part, its host spans, its captured loops' stamps) on a hand-made trace and
hand-made records; and None from each where a program records none."""
from types import SimpleNamespace

import pytest

from qrbench import program_trace, registry
from qrbench.trace import Trace
from qrkit_tpu_torch import profiling

NEW = ("device_idle_pct.fit", "loop_iter_us", "loop_busy_pct", "fit_host_ms", "setup_build_s",
       "setup_capture_s")
DEVICE_AHEAD_US = 5000.0  # the stamps' clock runs this far ahead of the trace's


def X(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def K(name, ts, dur, cat="kernel"):
    return X(name, cat, ts, dur, tid=7, correlation=1)


# one fit call: the host's parts, the upload and the copy-in, then the
# loop's graph, launched 32 µs later (init, evaluation 0, the iterations
# whose records the profiler lost, the last iteration's body and its
# evaluation, the tail), and the fetch's copy
EVENTS = [
    X("qrbench.window", "user_annotation", 0, 1000),
    X("qrbench.call", "user_annotation", 0, 500),
    X("qrk.fit.initial_guess", "user_annotation", 1, 50),
    X("qrk.fit.upload", "user_annotation", 51, 30),
    X("qrk.loop.copy_in", "user_annotation", 81, 2),
    X("qrk.loop.launch", "user_annotation", 83, 7),
    X("qrk.loop.fetch", "user_annotation", 90, 390),
    X("qrk.fit.canonical", "user_annotation", 480, 10),
    K("Memcpy HtoD (Pageable -> Device)", 60, 5, cat="gpu_memcpy"),
    K("copy_kernel", 66, 2),  # the copy of the inputs into the loop's buffers
    K("init_kernel", 100, 4),
    K("loop_cond_kernel(...)", 106, 1),
    K("body_kernel", 190, 6),
    K("loop_cond_kernel(...)", 198, 1),
    K("tail_kernel", 205, 3),
    K("Memcpy DtoH (Device -> Pageable)", 210, 2, cat="gpu_memcpy"),
]
AT = [106.1, 136.1, 166.1, 198.1]  # the four evaluations, on the trace's clock
PLACED = [t - 0.1 for t in AT]  # placed: stamp 0 on its L1 record's start
RECORDS = [{"name": "lm.fit", "iterations": 3,
            "stamps": [round((t + DEVICE_AHEAD_US) * 1e3) for t in AT]}]
SETUP = {"import": (0.3, 1), "build": (2.0, 1), "load": (0.5, 3), "first_call": (1.0, 2),
         "capture": (0.25, 2)}


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(profiling, "loop_records", lambda: [dict(r) for r in RECORDS],
                        raising=False)
    monkeypatch.setattr(profiling, "setup_seconds", lambda: dict(SETUP), raising=False)
    return SimpleNamespace(trace=Trace(EVENTS), traced=[{}], records=[{}] * 10, window_s=5000e-6)


def read(name, ctx):
    return registry.module("metrics", name).read(ctx)


def test_launches_are_placed_by_evaluation_0(ctx):
    (x,) = program_trace.launches(ctx.trace)
    assert x.iterations == 3 and x.at == pytest.approx(PLACED)
    assert (x.lo, x.hi) == (100, 208)  # the init's first record to the tail's last, not the copy-in


def test_the_readers_on_one_traced_call(ctx):
    assert read("loop_iter_us", ctx) == pytest.approx(31.0)  # (30 + 32) / 2, stamp 1 onward
    # busy: the upload 5 µs, the copy-in 2, the loop's interval [100, 208], the fetch 2
    assert read("device_idle_pct.fit", ctx) == pytest.approx(100 * (1 - 117 / 500))
    # the last iteration's period [166, 198] holds the body's record; the
    # others hold none (L1's own records do not count an iteration as kept)
    assert read("loop_busy_pct", ctx) == pytest.approx(100 * 6 / 32)
    assert read("fit_host_ms", ctx) == pytest.approx((50 + 30 + 10 + 2 + 7) / 1e3)
    assert read("setup_build_s", ctx) == pytest.approx(2.5)
    assert read("setup_capture_s", ctx) == pytest.approx(1.25)


def test_stamps_are_placed_without_evaluation_0():
    """The profiler lost evaluation 0's record and kept evaluations 1 and
    3: the stamps still land on them (a shift by one stamp places one)."""
    stamps = [t + DEVICE_AHEAD_US for t in AT]
    assert program_trace.place([136.0, 198.0], stamps, 100.0, 208.0) == pytest.approx(PLACED)
    assert program_trace.place([136.0, 150.0], stamps, 100.0, 208.0) is None  # none places two
    # even iterations: a shift by one places two as well, but puts stamp 3
    # past the graph's last record
    even = [t + DEVICE_AHEAD_US for t in (106.0, 136.0, 166.0, 196.0)]
    assert program_trace.place([136.0, 196.0], even, 100.0, 200.0)[0] == pytest.approx(106.0)


def test_stamps_are_placed_across_a_rate_difference():
    """The trace's device clock runs 300 ppm fast against the stamps': over
    a 10 ms loop evaluation k's record lies 3 µs off a shifted stamp, and
    the placement follows the rate."""
    stamps = [0.0, 1000.0, 2000.0, 10000.0]
    l1 = [500.0, 500.0 + 10000.0 * 1.0003]
    at = program_trace.place(l1, stamps, 400.0, 10600.0)
    assert at[0] == pytest.approx(500.0) and at[-1] == pytest.approx(l1[-1])
    assert program_trace.place(l1, [0.0, 1000.0, 2000.0, 9000.0], 400.0, 10600.0) is None


def test_a_call_without_a_loop_is_no_launch(ctx):
    """A call whose records between its upload and its fetch hold no L1
    record ran no loop: it is not a launch."""
    other = [K("Memcpy HtoD (Pageable -> Device)", 600, 5, cat="gpu_memcpy"),
             K("some_kernel", 610, 5), K("Memcpy DtoH (Device -> Pageable)", 620, 2, cat="gpu_memcpy")]
    (x,) = program_trace.launches(Trace(EVENTS + other))
    assert x.at == pytest.approx(PLACED) and (x.lo, x.hi) == (100, 208)


def test_a_launch_of_another_window_is_left_out(ctx, monkeypatch):
    other = {"name": "lm.fit", "iterations": 1,
             "stamps": [round((t + DEVICE_AHEAD_US) * 1e3) for t in (4000.0, 4030.0)]}
    monkeypatch.setattr(profiling, "loop_records", lambda: [other] + RECORDS)
    (x,) = program_trace.launches(ctx.trace)
    assert x.at == pytest.approx(PLACED)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, monkeypatch):
    """A program without the records (an older commit): every new reader
    returns None and raises nothing."""
    for attr in ("loop_records", "setup_seconds"):
        monkeypatch.delattr(profiling, attr, raising=False)
    bare = [e for e in EVENTS if not e["name"].startswith("qrk.")]
    ctx = SimpleNamespace(trace=Trace(bare), traced=[{}], records=[{}] * 10, window_s=5000e-6)
    assert read(name, ctx) is None


def test_new_metrics_are_listed_for_their_cells():
    bench = registry.benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    fits = ["ellipse-n500k", "ellipse-b100-n500"]
    for name in NEW[:4]:
        assert by_name[name]["workloads"] == fits and by_name[name]["moves"] == "fit_rate"
    for name in NEW[4:]:
        assert by_name[name]["workloads"] == fits + ["banded-c3-refactor"]
        assert by_name[name]["moves"] == "setup_s"
