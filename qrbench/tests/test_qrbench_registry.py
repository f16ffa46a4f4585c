"""The harness takes a new configuration, traffic mix, caller and metrics
as new files and new entries of BENCHMARK.json, with no edit to a file it
already has; and a run without the card, or without the program, fails
with no result."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

DUMMY_CALLER = '''
import time


class Caller:
    kind = "solve"

    def __init__(self, config, mix, seed, device):
        self.spans, self.tracing, self.n = {}, False, config["size"] * mix["scale"]

    def warm(self):
        pass

    def call(self):
        t0 = time.perf_counter()
        total = sum(range(self.n))
        t1 = time.perf_counter()
        return {"start": t0, "end": t1, "problems": 1, "converged": 1, "total": total}

    def release(self):
        pass

    def checks(self, records):
        want = self.n * (self.n - 1) // 2
        return {"sum_gap": (max(abs(r["total"] - want) for r in records), 0)}
'''


def digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "qrbench").rglob("*")) if p.is_file()}


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "qrbench", tmp_path / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_a_new_cell_and_metric_are_new_files(copy):
    before = digest(copy)
    q = copy / "qrbench"
    (q / "configs" / "dummy-config.json").write_text(json.dumps({"size": 1000}))
    (q / "traffic" / "dummy-mix.json").write_text(json.dumps({"caller": "dummy", "scale": 3}))
    (q / "callers" / "dummy.py").write_text(DUMMY_CALLER)
    (q / "e2e" / "dummy_calls.py").write_text(
        "def compute(ctx):\n    return float(len(ctx.records))\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-config", "source": "a test", "reduced": [],
                             "file": "qrbench/configs/dummy-config.json", "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["dummy-cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from qrbench import run; "
            "res, checks = run.run_cell('dummy-cell', 2**40, 0.05, False, device='cpu'); "
            "print(json.dumps([res, checks]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res, checks = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and checks == {"sum_gap": [0, 0]}
    assert set(res["metrics"]) == {"dummy_calls", "setup_s"}
    assert res["metrics"]["dummy_calls"]["value"] == res["attempted"] > 0
    after = digest(copy)
    assert {k: v for k, v in after.items() if k in before} == before


def run_module(cwd, *args):
    return subprocess.run([sys.executable, "-m", "qrbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


ARGS = ("--workload", "ellipse-n500k", "--seed", "1", "--seconds", "1", "--trace", "0")


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run_module(ROOT, *ARGS)
    assert out.returncode == 2 and out.stdout == "" and "CUDA card" in out.stderr


def test_without_the_program_no_result(copy):
    out = run_module(copy, *ARGS)
    assert out.returncode != 0 and out.stdout == ""
