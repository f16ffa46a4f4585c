"""Run one cell of the benchmark once, on the card::

    python3 -m qrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run sets up (imports, the card, the
inputs from ``--seed``, the solver, every kernel build and capture, a warm
pass over the cell's inputs), then calls the cell's entry in a closed loop,
one caller and no think time, until ``--seconds`` have passed; the window
runs from the first call's start to the last call's end.  With ``--trace
1`` a traced window of the mix's ``trace_calls`` calls follows, and the
per-layer metrics are read from both windows.  Then the program's state is
freed, and the plain reference checks the answers.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and ``breakdown``
with ``--trace 1``), and last ``checks``: each compared number with its
limit.  The last lines of standard error give the same numbers.

Exit codes: 0 with a result; 2 without a CUDA card (or with fewer than the
cell asks for), 3 if the process loaded JAX or the JAX package; an
exception exits 1.  No result is printed unless the code is 0.
"""
import time

_T0 = time.perf_counter()  # set-up is timed from here, before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "qrkit_tpu")  # top-level module names, whole


def steady_process(threads=None) -> None:
    """Before torch loads: every compile cache at a fixed path inside the
    checkout (the port's nvcc libraries already go to
    ``build/qrkit_tpu_torch/``), and the host threads of the CPU math
    libraries that the configuration's deployment states (``host_threads``;
    left as they are where it states none)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
    if threads is not None:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(int(threads))


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def window(caller, seconds: float):
    """Calls until ``seconds`` have passed; (records, window seconds)."""
    records = []
    start = time.perf_counter()
    while True:
        records.append(caller.call())
        if records[-1]["end"] - start >= seconds:
            break
    return records, records[-1]["end"] - records[0]["start"]


def traced_window(caller, mix):
    """The mix's ``trace_calls`` calls under the profiler; (records, Trace,
    the program's kernel launches in the window by counter)."""
    import torch
    from qrkit_tpu_torch import profiling

    from . import trace

    def body():
        caller.tracing = True
        try:
            before = profiling.launch_counts()
            with torch.profiler.record_function("qrbench.window"):
                records = [caller.call() for _ in range(mix["trace_calls"])]
            return records, {k: v - before[k] for k, v in profiling.launch_counts().items()}
        finally:
            caller.tracing = False

    (records, launched), tr = trace.profile(body)
    return records, tr, launched


def record_counts(tr, launched):
    """One line: each kernel's launches in the traced window, by the
    program's counters, beside the kernel records the profiler kept (fewer
    records: lost), for every kernel that ``kernels/`` names."""
    from . import registry

    parts = []
    for name, k in registry.kernels().items():
        n = sum(launched.get(c, 0) for c in k["counters"])
        got = len([op for op in tr.kernels() if any(p in op[0] for p in k["records"])])
        if n or got:
            parts.append(f"{name}: {n} launched, {got} records, lost {max(n - got, 0)}")
    return "profiler records in the traced window: " + ("; ".join(parts) or "none counted")


def device_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    kind = torch.cuda.get_device_name(0)
    info = {"platform": "gpu", "kind": kind, "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             bench=None, config=None, mix=None, t0: float = None):
    """Everything of a run after the look for a card: returns (result
    without ``checks``, checks).  ``bench``, ``config`` and ``mix`` replace
    what the files say (tests run small copies on the CPU)."""
    import torch

    from . import registry

    bench = bench or registry.benchmark()
    w, config_file, mix_file = registry.cell(bench, workload)
    config, mix = config or config_file, mix or mix_file
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    caller = registry.module("callers", mix["caller"]).Caller(config, mix, seed, device)
    caller.warm()
    setup_s = time.perf_counter() - (_T0 if t0 is None else t0)

    records, window_s = window(caller, seconds)
    traced, tr, launched, census = [], None, {}, None
    if trace:
        traced, tr, launched = traced_window(caller, mix)
        census = caller.loop_census() if hasattr(caller, "loop_census") else None
    dev = device_info(device)
    caller.release()
    checks = caller.checks(records + traced)

    ctx = SimpleNamespace(records=records, window_s=window_s, setup_s=setup_s, traced=traced,
                          trace=tr, launched=launched, census=census, caller=caller,
                          kind=dev["kind"])
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_for(bench, section, workload):
        mod = registry.module("metrics" if trace else "e2e", m["name"])
        value = mod.read(ctx) if trace else mod.compute(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    done = records + traced
    attempted = sum(r["problems"] for r in done)
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": attempted,
              "failed": attempted - sum(r["converged"] for r in done),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = tr.breakdown()
        result["records_line"] = record_counts(tr, launched)
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from . import registry

    bench = registry.benchmark()
    threads = registry.cell(bench, args.workload)[1].get("host_threads")
    steady_process(threads)

    import torch

    if threads is not None:
        torch.set_num_threads(int(threads))
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"qrbench: the cell needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              bench=bench)
    loaded = forbidden_modules()
    if loaded:
        print(f"qrbench: the process loaded {loaded}", file=sys.stderr)
        return 3
    if "records_line" in result:
        print(result.pop("records_line"), file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}",
              file=sys.stderr)
    result["checks"] = {k: {"value": v if math.isfinite(v) else repr(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
