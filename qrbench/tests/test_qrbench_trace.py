"""The trace reader on a hand-made Chrome trace: busy time as a union,
launches attributed to their qrbench range, idle gaps named by the host."""
import pytest

from qrbench.trace import Trace


def X(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1, "pid": 1,
            "args": args}


EVENTS = [
    X("qrbench.window", "user_annotation", 0, 100),
    X("qrbench.call", "user_annotation", 0, 50),
    X("qrbench.factorize", "user_annotation", 1, 10),
    X("cudaGraphLaunch", "cuda_runtime", 2, 1, correlation=7),
    X("qrbench.solve", "user_annotation", 12, 10),
    X("cudaGraphLaunch", "cuda_runtime", 13, 1, correlation=8),
    X("qrbench.call", "user_annotation", 60, 40),
    X("cudaLaunchKernel", "cuda_runtime", 61, 1, correlation=9),
    X("aten::sleep", "cpu_op", 70, 20),
    {**X("chain_reg_kernel", "kernel", 5, 10, correlation=7), "tid": 7},
    {**X("apply_w_reg_kernel", "kernel", 10, 10, correlation=7), "tid": 8},
    {**X("two_seg_kernel", "kernel", 20, 5, correlation=8), "tid": 7},
    {**X("Memset", "gpu_memset", 62, 3, correlation=9), "tid": 7},
    {**X("outside", "kernel", 150, 3, correlation=9), "tid": 7},
]


def test_busy_is_the_union_inside_the_window():
    tr = Trace(EVENTS)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_intervals() == [(5.0, 25.0), (62.0, 65.0)]
    assert tr.busy_s() == pytest.approx(23e-6)


def test_kernels_are_attributed_to_the_innermost_range():
    tr = Trace(EVENTS)
    assert [op[0] for op in tr.kernels("qrbench.factorize")] == ["chain_reg_kernel",
                                                                 "apply_w_reg_kernel"]
    assert [op[0] for op in tr.kernels("qrbench.solve")] == ["two_seg_kernel"]
    assert [op[4] for op in tr.ops if op[0] == "Memset"] == ["qrbench.call"]


def test_breakdown_names_ops_and_gaps():
    b = Trace(EVENTS).breakdown()
    assert b["device_ops"][0] == ["chain_reg_kernel", 10e-6]
    gaps = dict(b["idle_gaps"])  # each gap named by the host event at its middle
    assert gaps == pytest.approx({"aten::sleep": 35e-6, "qrbench.call": 37e-6,
                                  "cudaGraphLaunch": 5e-6})


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        Trace(EVENTS[1:])


def test_lost_records_are_counted_for_every_kernel_file(tmp_path, monkeypatch):
    import shutil

    from qrbench import registry, run

    tr = Trace(EVENTS)
    launched = {"banded_segment_chains": 1, "banded_chain_qr": 1, "banded_apply_w": 1,
                "chain_two_seg": 1, "lm_step": 0}
    line = run.record_counts(tr, launched)
    assert "b3_b5: 2 launched, 1 records, lost 1" in line
    assert "b4: 1 launched, 1 records, lost 0" in line and "k1: 1 launched, 1 records" in line
    assert "k3" not in line  # neither launched nor recorded
    # a kernel a later cell adds is a new file, read without an edit
    shutil.copytree(registry.HERE / "kernels", tmp_path / "kernels")
    (tmp_path / "kernels" / "zz.json").write_text(
        '{"kernel": "a test", "counters": ["zz_counter"], "records": ["two_seg"]}')
    monkeypatch.setattr(registry, "HERE", tmp_path)
    line = run.record_counts(tr, {**launched, "zz_counter": 3})
    assert "zz: 3 launched, 1 records, lost 2" in line


def test_idle_share_is_taken_against_the_untraced_window():
    from types import SimpleNamespace

    from qrbench import registry

    ctx = SimpleNamespace(trace=Trace(EVENTS), traced=[{}, {}], records=[{}] * 10,
                          window_s=200e-6)
    idle = registry.module("metrics", "device_idle_pct.solve").read(ctx)
    assert idle == pytest.approx(100 * (1 - 11.5 / 20))  # 23 us busy over 2 traced calls


def test_kernels_per_iter_counts_the_captured_body_and_l1():
    from types import SimpleNamespace

    from qrbench import registry

    read = registry.module("metrics", "kernels_per_iter").read
    ctx = SimpleNamespace(census=10, launched={"graph_loop_cond": 12},
                          traced=[{"loop_iters": 5}, {"loop_iters": 5}])
    assert read(ctx) == pytest.approx(11.2)  # 10 body nodes, 12 evaluations over 10 iterations
    assert read(SimpleNamespace(census=None, launched={}, traced=[{"loop_iters": 5}])) is None
