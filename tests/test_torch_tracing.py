"""The port's spans, set-up parts and captured-loop stamps
(``qrkit_tpu_torch.profiling``).

On the CPU the captured paths run through the test backends
(``Recording`` for the programs, ``RecordingLoop`` for the loops, which
stamps each evaluation of the loop's condition with the host's clock as
kernel L1 stamps the device's); the ``cuda`` cases read the device's
``%globaltimer`` stamps on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``.
"""
import json
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from qrkit_tpu_torch import _program, lm, profiling
from qrkit_tpu_torch.examples import ellipse as tell
from qrkit_tpu_torch.ops import _build

from test_torch_dispatch_count import Recording, _banded_setup
from test_torch_lm_programs import RecordingLoop

DEV = torch.device("cpu")
MATCH = profiling._MATCH_US  # µs: a placed stamp and its L1 record's start


@pytest.fixture
def recording():
    lm.clear_programs()
    with _program._use_backend(Recording), _program._use_loop_backend(RecordingLoop):
        yield
    lm.clear_programs()


def _fit():
    return tell.fit_ellipse(tell.ellipse_points(tell.Ellipse(), 64), device=DEV)


def _fit_batch():
    pts = np.stack([tell.ellipse_points(tell.Ellipse(a=7.5 + i), 48) for i in range(3)])
    return tell.fit_ellipse_batch(pts, lm.LMConfig(max_iters=30), device=DEV)


def _annotations(prof, tmp_path):
    """``(name, start, end)`` of the trace's user annotations, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                  key=lambda a: (a[1], -a[2]))


def test_span_is_inert_without_a_profiler(monkeypatch):
    """No profiler: no ``record_function`` is entered, the span is one
    shared do-nothing context."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    with profiling.span("qrk.test.part") as got:
        assert got is None
    assert profiling.span("qrk.a") is profiling.span("qrk.b")
    with profiling.span("qrk.setup.test_inert", setup=True) as setup:
        pass
    assert setup.seconds >= 0.0


def _banded_calls():
    st = _banded_setup("segmented", "tallblock_p2w")(np.random.default_rng(3), DEV)
    qr = st["qr"]
    for _ in range(2):  # the eager call, then the capture
        qr.factorize_values(st["v"])
        qr.solve(st["b"])
    return lambda: (qr.factorize_values(st["v"]), qr.solve(st["b"]))


ENTRIES = {
    "fit_ellipse": (lambda: _fit, ["qrk.fit.initial_guess", "qrk.fit.upload", "qrk.loop.copy_in",
                                   "qrk.loop.launch", "qrk.loop.fetch", "qrk.fit.canonical"]),
    "fit_ellipse_batch": (lambda: _fit_batch, ["qrk.fit.initial_guess", "qrk.fit.upload",
                                               "qrk.loop.copy_in", "qrk.loop.launch",
                                               "qrk.loop.fetch"]),
    "banded": (_banded_calls, ["qrk.program.replay", "qrk.program.replay"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_nest_under_the_callers_range(entry, recording, tmp_path):
    """Under a CPU profiler a warm call names its host parts as ``qrk.*``
    user annotations, in order, each inside the caller's range."""
    make, want = ENTRIES[entry]
    call = make()
    call()
    call()  # warm: the loop or the programs captured
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            call()
    ann = _annotations(prof, tmp_path)
    (outer,) = [a for a in ann if a[0] == "caller"]
    spans = [a for a in ann if a[0].startswith("qrk.")]
    assert [a[0] for a in spans] == want
    assert all(outer[1] <= s <= t <= outer[2] for _, s, t in spans)
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # one after another


def test_setup_parts_nest_as_self_time():
    """A set-up span's seconds leave out those of the set-up spans inside
    it, and each adds one to its part's count."""
    before = profiling.setup_seconds()
    with profiling.span("qrk.setup.test_outer", setup=True) as outer:
        time.sleep(0.01)
        with profiling.span("qrk.setup.test_inner", setup=True) as inner:
            time.sleep(0.03)
    after = profiling.setup_seconds()
    assert inner.seconds >= 0.03 and 0.01 <= outer.seconds < inner.seconds
    assert after["test_outer"][1] - before.get("test_outer", (0.0, 0))[1] == 1
    assert after["test_inner"][0] - before.get("test_inner", (0.0, 0))[0] == pytest.approx(
        inner.seconds)
    assert after["import"][1] == 1  # the package's own import, once


def test_setup_counts_build_and_load(monkeypatch, tmp_path):
    """An nvcc run (stubbed) is part ``build``, a library's CDLL (stubbed)
    part ``load``; a library already built is loaded without a build."""
    def fake_nvcc(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: SimpleNamespace(
        qrk_loop_cond=SimpleNamespace(), qrk_error_string=SimpleNamespace()))
    sig = (("qrk_loop_cond", ()),)
    count = lambda part: profiling.setup_seconds().get(part, (0.0, 0))[1]  # noqa: E731
    before = count("build"), count("load")
    _build.load_source.__wrapped__(_build.GRAPH_LOOP_SOURCE, (("QRK_TEST", 1),), sig, "_test")
    assert (count("build"), count("load")) == (before[0] + 1, before[1] + 1)
    _build.load_source.__wrapped__(_build.GRAPH_LOOP_SOURCE, (("QRK_TEST", 1),), sig, "_test")
    assert (count("build"), count("load")) == (before[0] + 1, before[1] + 2)


def test_setup_counts_first_call_and_capture(recording):
    """A fit's first call (eager iteration 1, then the loop's capture) and
    a program key's (eager call, then capture) are parts ``first_call`` and
    ``capture``; warm calls add to neither, and each program keeps its
    capture's seconds."""
    count = lambda part: profiling.setup_seconds().get(part, (0.0, 0))[1]  # noqa: E731
    before = count("first_call"), count("capture")
    _fit()
    assert (count("first_call"), count("capture")) == (before[0] + 1, before[1] + 1)
    (prog,) = lm._LOOPS.programs().values()
    assert prog.capture_seconds > 0.0
    _fit()
    assert (count("first_call"), count("capture")) == (before[0] + 1, before[1] + 1)
    call = _banded_calls()  # factorize and solve: a first call and a capture each
    assert (count("first_call"), count("capture")) == (before[0] + 3, before[1] + 3)
    call()
    assert (count("first_call"), count("capture")) == (before[0] + 3, before[1] + 3)


def test_loop_stamps_and_records(recording):
    """A launch stamps each evaluation of the condition (iterations + 1,
    increasing); the records fill only under a profiler and outlive
    ``lm.clear_programs()``."""
    _fit()
    n = len(profiling.loop_records())
    result, _ = _fit()
    (prog,) = lm._LOOPS.programs().values()
    k = result.iterations
    stamps = prog.stamps.tolist()
    assert all(b > a for a, b in zip(stamps[:k], stamps[1:k + 1]))
    assert len(profiling.loop_records()) == n  # no profiler: no record
    with profile(activities=[ProfilerActivity.CPU]):
        result, _ = _fit()
    recs = profiling.loop_records()
    assert len(recs) == n + 1
    rec = recs[-1]
    assert rec["name"] == prog.name and rec["iterations"] == result.iterations
    assert rec["stamps"] == prog.stamps[: result.iterations + 1].tolist()
    assert len(rec["stamps"]) == rec["iterations"] + 1
    lm.clear_programs()
    assert profiling.loop_records()[-1] == rec


def test_loop_body_nodes_without_a_body_graph(recording):
    """One entry a cached loop; a test backend's loop holds no body graph,
    as the private path the benchmark's census reads finds none."""
    assert profiling.loop_body_nodes() == []
    _fit()
    _fit_batch()
    assert profiling.loop_body_nodes() == [
        {"name": "lm.levenberg_marquardt_device", "nodes": None},
        {"name": "lm.levenberg_marquardt_device_batch", "nodes": None}]
    assert not [g for prog in lm._LOOPS._cache.values()
                for g in getattr(prog._loop, "graphs", [])[:1]
                if isinstance(g, torch.cuda.CUDAGraph)]


def _X(name, cat, ts, dur, corr, tid=7):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": {"correlation": corr}}


def test_exporter_places_each_launch_by_its_l1_records():
    """The exporter's loop events on a hand-made trace: two graph launches
    (their records' correlation ids) whose stamps run on a clock 1,000 µs
    behind the trace's; each interval spans its graph's records, each
    iteration a pair of stamps placed by the launch's L1 records."""
    events = []
    for corr, base in ((11, 100.0), (12, 400.0)):
        events += [_X("init_kernel", "kernel", base - 6, 4, corr),
                   _X("loop_cond_kernel(...)", "kernel", base, 1, corr),
                   _X("body_kernel", "kernel", base + 62, 20, corr),
                   _X("loop_cond_kernel(...)", "kernel", base + 89.7, 1, corr),
                   _X("tail_kernel", "kernel", base + 95, 3, corr)]
    records = [{"name": "lm.fit", "iterations": 3,
                "stamps": [round((b - 1000 + d) * 1e3) for d in (0.3, 30.2, 60.1, 90.0)]}
               for b in (100.0, 400.0)]
    out = profiling._place_loops(events, records)
    loops = [e for e in out if e["name"] == "qrk.loop lm.fit"]
    assert [(e["ts"], e["ts"] + e["dur"]) for e in loops] == [(94.0, 198.0), (394.0, 498.0)]
    assert all(e["tid"] == profiling._LOOP_ROW + 7 and e["args"]["iterations"] == 3
               for e in loops)
    iters = [e for e in out if e["name"] == "qrk.loop.iteration"]
    assert [e["args"]["iteration"] for e in iters] == [1, 2, 3, 1, 2, 3]
    assert iters[0]["ts"] == pytest.approx(100.0) and iters[1]["ts"] == pytest.approx(129.9)
    assert iters[3]["ts"] == pytest.approx(400.0)
    assert iters[2]["ts"] + iters[2]["dur"] == pytest.approx(189.7)  # stamp 3, on eval 3's record
    assert any(e["ph"] == "M" and e["tid"] == profiling._LOOP_ROW + 7 for e in out)
    assert profiling._place_loops([e for e in events if "loop_cond" not in e["name"]],
                                  records) == []
    assert profiling._place_loops(events, records[:1]) == []  # launches and records disagree
    lost = [e for e in events if e["ts"] != 400.0]  # launch 2's evaluation 0
    iters = [e for e in profiling._place_loops(lost, records) if e["name"] == "qrk.loop.iteration"]
    assert len(iters) == 3  # launch 2's one L1 record could be any evaluation's: not placed
    lost.append(_X("loop_cond_kernel(...)", "kernel", 429.9, 1, 12))  # its evaluation 1
    iters = [e for e in profiling._place_loops(lost, records) if e["name"] == "qrk.loop.iteration"]
    assert iters[3]["ts"] == pytest.approx(400.0)  # placed by evaluations 1 and 3


def test_trace_exports_a_traced_fit(recording, tmp_path):
    """``profiling.trace`` over a CPU fit writes the trace with the fit's
    spans (no device records: no loop events to place)."""
    _fit()
    with profiling.trace(str(tmp_path / "tr")):
        _fit()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"qrk.fit.upload", "qrk.loop.launch", "qrk.loop.fetch"} <= names
    assert not [e for e in events if e.get("cat") == "qrk_loop"]


# --- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel L1 stamps the device's clock")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_stamps_place_the_loop(cuda_device, tmp_path):
    """On the card: a traced fit's record holds iterations + 1 increasing
    ``%globaltimer`` stamps; in the exported trace, placed by evaluation 0's
    record, every L1 record the profiler kept (evaluation 0, and those of
    the iterations it kept inside the WHILE node) starts within 1 µs of a
    stamp (3 µs asked), and the loop's interval holds its iterations."""
    lm.clear_programs()
    pts = tell.ellipse_points(tell.Ellipse(), 200)
    for _ in range(2):
        tell.fit_ellipse(pts, dtype=torch.float32, device=cuda_device)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        result, _ = tell.fit_ellipse(pts, dtype=torch.float32, device=cuda_device)
        torch.cuda.synchronize()
    rec = profiling.loop_records()[-1]
    k = result.iterations
    assert rec["iterations"] == k >= 2 and len(rec["stamps"]) == k + 1
    assert all(b > a for a, b in zip(rec["stamps"], rec["stamps"][1:]))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    l1 = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") == "kernel" and profiling.L1_RECORD in e.get("name", "")))
    (loop,) = [e for e in events if e.get("name") == f"qrk.loop {rec['name']}"]
    iters = [e for e in events if e.get("name") == "qrk.loop.iteration"]
    assert len(iters) == k and len(l1) >= 2
    at = [e["ts"] for e in iters] + [iters[-1]["ts"] + iters[-1]["dur"]]
    assert at[0] == pytest.approx(l1[0][0], abs=MATCH)  # evaluation 0's record
    assert all(min(abs(s - a) for a in at) <= MATCH for s, _ in l1)
    assert loop["ts"] <= at[0] and at[-1] <= loop["ts"] + loop["dur"]
    lm.clear_programs()


@pytest.mark.cuda
def test_cuda_loop_body_nodes_match_the_graph(cuda_device):
    """On the card: the public reader of a captured loop's body agrees with
    the benchmark's census of the body graph (``qrbench.graphs``, reached
    through the loop cache's private names)."""
    from qrbench import graphs

    lm.clear_programs()
    pts = tell.ellipse_points(tell.Ellipse(), 200)
    for _ in range(2):
        tell.fit_ellipse(pts, dtype=torch.float32, device=cuda_device)
    ((_, prog),) = lm._LOOPS._cache.items()
    census = graphs.node_types(prog._loop.graphs[0].raw_cuda_graph())
    (body,) = profiling.loop_body_nodes()
    assert body["name"] == prog.name and body["nodes"] == dict(census)
    # the ellipse iteration: its model is K4 (K4j, K4r twice, K4g and its
    # memset), beside K3 and the LM driver's elementwise ops (71 nodes on
    # the H100; over 100 before K4)
    assert 60 < sum(body["nodes"].get(t, 0) for t in graphs.DEVICE) < 100
    lm.clear_programs()
