"""Time one checkout's ellipse LM fits and lane-major damped step (K3) on the card.

    python3 profile_lm_step.py --label NAME [--tree CHECKOUT] [--case fit|split|trace|sweep|stage]

Imports ``qrkit_tpu_torch`` from ``--tree`` (default: this checkout) and
nothing else of the repo, so a checkout from before kernel K3
(``ops/lm_step.py``) runs it too.  fp32 on the card, with the points of
``chip_smoke.py``'s ``ellipse_lm`` (``Ellipse(7.5, 2, 17, 23, 0.23)``, 1.3π
of arc) and its ``LMConfig(max_iters=40, ftol=1e-8, xtol=1e-8)``:

* ``--case fit`` (the default):
  - ``fit``: ``fit_ellipse`` at 100,000 and 500,000 points and
    ``fit_ellipse_batch`` on 16 problems of 10,000 (problem i: a = 7.5 +
    0.1 i, r = 0.23 + 0.01 i): after the key's first fit (the capture), the
    wall ms of a warm fit (the host clock around the call, which ends in its
    fetch; median of 5), then one warm fit under torch.profiler: its kernel
    launches and device ms, each over the iterations;
  - ``step``: ``functional.lm_damped_step_blockdiag1`` at the 100,000-point
    fit's start (its Jacobian and residuals, λ = 1e-3), eager
    (``_program.eager()``): the kernels one call launches and their device ms
    (torch.profiler), and the wall ms of a call (CUDA events, synchronize
    before and after, median of 20).
* ``--case split``: K3 by part at the ellipse step's start (100,000 and
  500,000 points), each part a CUDA graph of 10 of its own launches
  replayed between CUDA events (the median of 5 replays over 10), beside
  an empty cooperative kernel on the part's grid (the launch floor, the
  same way; built from this checkout's ``lm_step.cu``, ``qrk_lm_empty``):
  the whole step, its first mode alone (``ops.lm_step.partial_step``: the
  point pass through the last CTA's reduction, no wait, no x1), and
  torch.profiler's split of a call into the memset and the kernel.
* ``--case trace``: K3 timed inside, at the sweep's steps, from a build
  with ``-DQRK_TRACE=1``: each CTA's thread 0 marks ``%globaltimer`` and
  its SM clock at entry, after its points, after the CTA merge, after the
  ticket, after the finish (the finisher), after the flag and at exit;
  per part the median and the largest over the CTAs (SM clock cycles, and
  µs at the clock the marks give), the finisher's parts, the span from the
  first entry to the last exit and the wait between the finisher's flag
  and the median CTA's (global time), each the median of 5 traced calls.
* ``--case sweep``: K3 built with ``-DQRK_CTAS=C`` for each grid size C
  of ``SWEEP_CTAS`` at 100,000 and 500,000 points, the batch's 16 × 10,000
  and (7, 2, 5) at 100,000, the same timing; a C the card cannot make
  co-resident is refused by the launch and recorded.
* ``--case stage``: the default build (on the path whose factor rows go
  to memory, each thread's operands of the next tiles copied into shared
  memory by ``cp.async`` while it reduces the current ones) against a
  ``-DQRK_STAGE=0`` build (the operands loaded to registers as they are
  needed) at the sweep's steps, in turns unstaged, staged, staged,
  unstaged, the same timing; the two builds' steps bitwise equal.

To compare a change with its parent in turns on one card, each tree in its
own process::

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 profile_lm_step.py --tree $t --label $t; done

One JSON line per case, each with the label, the checkout and the card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TRUTH = (7.5, 2.0, 17.0, 23.0, 0.23)
NS = (100_000, 500_000)
BATCH = (16, 10_000)
SWEEP_CTAS = (33, 66, 132, 198, 264)
HERE = Path(__file__).resolve().parent


def graph_ms(torch, fn, calls=10, reps=5):
    """Device ms of one ``fn()``: a CUDA graph of ``calls`` calls replayed
    ``reps`` times between CUDA events, the median replay over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def empty_launcher(torch):
    """``qrk_lm_empty`` of this checkout's ``lm_step.cu`` (built by this
    checkout's ``ops/_build.py``, loaded by its path, so the tree under test
    may predate it): ``empty(grid, block, cooperative)`` on the current card."""
    spec = importlib.util.spec_from_file_location("_build_here", HERE / "qrkit_tpu_torch/ops/_build.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    lib = here.load_lm_step(2, 1, 5)
    dev = torch.cuda.current_device()

    def empty(grid, block, cooperative):
        err = lib.qrk_lm_empty(dev, grid, block, int(cooperative), here.current_stream(dev))
        if err:
            raise RuntimeError(f"qrk_lm_empty({grid}, {block}, {cooperative}): CUDA error {err}")

    return empty


def step_operands(torch, ellipse, n):
    """The ellipse step's operands at its fit's start, ``[1, …]``."""
    f = ellipse.EllipseFitting(ellipse.ellipse_points(ellipse.Ellipse(*TRUTH), n), dtype=torch.float32,
                               device="cuda")
    params = f.initial_params()
    left, right = ellipse._jacobian_soa(params, f.pts)
    res = ellipse._residuals_soa(params, f.pts)
    lam = torch.tensor([1e-3], dtype=torch.float32, device="cuda")
    return left[None, :, None, :].contiguous(), right[None].contiguous(), res[None].contiguous(), lam


def one_launch_parts(ls, _build, left, right, res, lam):
    """K3's whole step (its memset and cooperative launch) and its first
    mode alone (``partial_step``), each with its grid, and the geometry."""
    P, bl, bc, nb = left.shape
    m2 = right.shape[2]
    tiles, segs, grid, reg = _build.lm_step_geometry(bl, bc, m2, left.dtype, nb, P, ls.TILE)
    geo = {"tiles": tiles, "segs": segs, "factor_rows_in_registers": reg}
    return [
        ("step", lambda: ls._damped_step_kernel(left, right, res, lam, ls.TILE), (grid, ls.TILE)),
        ("partial_mode", lambda: ls.partial_step(left, right, res, lam), (grid, ls.TILE)),
    ], geo


def kernels(torch, fn):
    """(kernel launches, kernel ms) of one ``fn()`` under torch.profiler (the
    device-side records only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, ms = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "Memcpy" not in e.key and "Memset" not in e.key:
            launches += e.count
            ms += e.self_device_time_total / 1e3
    return launches, ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--tree", help="checkout to import qrkit_tpu_torch from (default: this one)")
    ap.add_argument("--case", choices=("fit", "split", "sweep", "trace", "stage"), default="fit")
    ap.add_argument("--ctas", type=int, nargs="*", default=[0],
                    help="--case trace: the grid sizes C to trace (0: the source's)")
    args = ap.parse_args()
    if args.tree is not None:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch

    from qrkit_tpu_torch import _program, functional, lm
    from qrkit_tpu_torch.examples import ellipse

    if not torch.cuda.is_available():
        raise SystemExit("profile_lm_step: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    head = {"label": args.label, "tree": str(Path(ellipse.__file__).resolve().parents[2]), "gpu": smi}
    cfg = lm.LMConfig(max_iters=40, ftol=1e-8, xtol=1e-8)

    def emit(**rec):
        print(json.dumps({**head, **rec}), flush=True)

    if args.case == "split":
        return split(torch, emit)
    if args.case == "sweep":
        return sweep(torch, emit)
    if args.case == "trace":
        return trace(torch, emit, args.ctas)
    if args.case == "stage":
        return stage(torch, emit)

    fits = [(f"fit_ellipse_{n}", lambda pts=ellipse.ellipse_points(ellipse.Ellipse(*TRUTH), n):
             ellipse.fit_ellipse(pts, cfg, dtype=torch.float32, device="cuda")[0]) for n in NS]
    nb, n = BATCH
    pts_b = np.stack([ellipse.ellipse_points(ellipse.Ellipse(7.5 + 0.1 * i, 2.0, 17.0, 23.0,
                                                             0.23 + 0.01 * i), n) for i in range(nb)])
    fits.append((f"fit_ellipse_batch_{nb}x{n}", lambda: ellipse.fit_ellipse_batch(
        pts_b, cfg, dtype=torch.float32, device="cuda")))
    for label, fit in fits:
        lm.clear_programs()
        result = fit()  # the key's first fit: iteration 1, the capture, the loop
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            result = fit()
            walls.append((time.perf_counter() - t0) * 1e3)
        k = int(np.max(result.iterations))
        launches, ms = kernels(torch, fit)
        emit(case="fit", fit=label, iterations=k, wall_ms=statistics.median(walls), wall_ms_runs=walls,
             kernel_launches=launches, launches_per_iteration=launches / k, device_ms=ms,
             device_ms_per_iteration=ms / k)
    lm.clear_programs()

    f = ellipse.EllipseFitting(ellipse.ellipse_points(ellipse.Ellipse(*TRUTH), NS[0]),
                               dtype=torch.float32, device="cuda")
    params = f.initial_params()
    left, right = ellipse._jacobian_soa(params, f.pts)
    res = ellipse._residuals_soa(params, f.pts)
    lam = torch.tensor(1e-3, dtype=torch.float32, device="cuda")

    def step():
        with _program.eager():
            return functional.lm_damped_step_blockdiag1(left, right, res, lam)

    step()
    launches, ms = kernels(torch, step)
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    emit(case="step", n=NS[0], kernel_launches=launches, device_ms=ms,
         wall_ms=statistics.median(times))


def split(torch, emit):
    """``--case split`` (the module docstring)."""
    from qrkit_tpu_torch.examples import ellipse
    from qrkit_tpu_torch.ops import _build
    from qrkit_tpu_torch.ops import lm_step as ls
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    empty = empty_launcher(torch)
    for n in NS:
        ops = step_operands(torch, ellipse, n)
        parts, geo = one_launch_parts(ls, _build, *ops)
        for _, fn, _ in parts:  # in order: every buffer written once
            fn()
        torch.cuda.synchronize()
        for name, fn, (grid, block) in parts:
            ms = graph_ms(torch, fn)
            floor = graph_ms(torch, lambda g=grid, b=block: empty(g, b, True))
            emit(case="split", n=n, part=name, ms=ms, grid=grid, block=block, cooperative=True,
                 floor_ms=floor, **geo, method="a CUDA graph of 10 launches replayed between CUDA "
                 "events, median of 5 over 10; floor: an empty kernel on the same grid, the same way")
        step = parts[0][1]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                step()
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                key = "memset" if "Memset" in e.key else ("kernel" if "lm_step" in e.key else e.key)
                by[key] = [by.get(key, [0, 0.0])[0] + e.count,
                           by.get(key, [0, 0.0])[1] + e.self_device_time_total / 1e3 / 10]
        emit(case="split_profiler", n=n, by_name={k: {"records": c, "device_ms_per_call": m}
                                                  for k, (c, m) in by.items()},
             method="torch.profiler over 10 eager calls; ms per call")


def sweep_steps(torch):
    """The sweep's steps: (label, ``[P, …]`` fp32 operands)."""
    import numpy as np

    from qrkit_tpu_torch.examples import ellipse

    rng = np.random.default_rng(3)
    cases = [(f"ellipse_{n}", step_operands(torch, ellipse, n)) for n in NS]
    nb, n = BATCH
    f32 = dict(dtype=torch.float32, device="cuda")
    cases.append((f"batch_{nb}x{n}", (torch.as_tensor(rng.normal(size=(nb, 2, 1, n)), **f32),
                                      torch.as_tensor(rng.normal(size=(nb, 2, 5, n)), **f32),
                                      torch.as_tensor(rng.normal(size=(nb, 2, n)), **f32),
                                      torch.as_tensor(rng.uniform(1e-3, 1, size=nb), **f32))))
    cases.append(("7x2x5_100000", tuple(torch.as_tensor(rng.normal(size=s), **f32) for s in
                                        ((1, 7, 2, NS[0]), (1, 7, 5, NS[0]), (1, 7, NS[0])))
                  + (torch.tensor([1e-3], **f32),)))
    return cases


TRACE_PARTS = {"points": (0, 1), "cta_merge": (1, 2), "ticket": (2, 3), "x1": (5, 6)}
TRACE_SLOTS = 7  # kTraceSlots in the source


def trace(torch, emit, ctas_list=(0,)):
    """``--case trace`` (the module docstring), at each grid size C of
    ``ctas_list`` (0: the source's), each a ``-DQRK_TRACE=1`` build."""
    from qrkit_tpu_torch.ops import _build
    from qrkit_tpu_torch.ops import lm_step as ls

    for (label, (left, right, res, lam)), ctas in ((c, n) for c in sweep_steps(torch) for n in ctas_list):
        P, bl, bc, nb = left.shape
        m2 = right.shape[2]
        extra = (("QRK_TRACE", 1),) + ((("QRK_CTAS", ctas),) if ctas else ())
        tiles, segs, grid, reg = _build.lm_step_geometry(bl, bc, m2, left.dtype, nb, P, ls.TILE, extra)
        lib = _build.load_lm_step(bl, bc, m2, extra)
        lib.qrk_lm_trace.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        dev = left.device.index
        marks = torch.zeros((1024, TRACE_SLOTS, 2), dtype=torch.int64, device="cuda")

        def marks_op(zero):
            err = lib.qrk_lm_trace(dev, marks.data_ptr(), zero, _build.current_stream(dev))
            if err:
                raise RuntimeError(f"qrk_lm_trace: CUDA error {err}")

        runs = []
        for rep in range(6):
            marks_op(1)
            try:
                ls._damped_step_kernel(left, right, res, lam, ls.TILE, extra=extra)
            except RuntimeError as e:  # a grid the card cannot make co-resident
                runs = [{"refused": str(e)}]
                break
            marks_op(0)
            torch.cuda.synchronize()
            if rep == 0:
                continue  # the first call warms the caches
            g, c = marks[:grid, :, 0].double().cpu(), marks[:grid, :, 1].double().cpu()
            ghz = float(((c[:, 6] - c[:, 0]) / (g[:, 6] - g[:, 0])).median())
            fin = int(torch.nonzero(g[:, 4]).flatten()[-1]) if bool((g[:, 4] > 0).any()) else None
            run = {"clock_ghz": ghz, "span_us": float(g[:, 6].max() - g[:, 0].min()) / 1e3,
                   "entry_spread_us": float(g[:, 0].max() - g[:, 0].min()) / 1e3}
            for part, (a, b) in TRACE_PARTS.items():
                d = (c[:, b] - c[:, a]) / ghz / 1e3
                run[f"{part}_us_median"], run[f"{part}_us_max"] = float(d.median()), float(d.max())
            if fin is not None:
                run["finish_us"] = float(c[fin, 4] - c[fin, 3]) / ghz / 1e3
                run["finisher_entry_to_ticket_us"] = float(g[fin, 3] - g[:, 0].min()) / 1e3
                run["flag_to_median_cta_us"] = float(g[:, 5].median() - g[fin, 4]) / 1e3
                run["last_exit_after_flag_us"] = float(g[:, 6].max() - g[fin, 4]) / 1e3
            runs.append(run)
        med = runs[0] if "refused" in runs[0] else {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        emit(case="trace", step=label, ctas=ctas or ls.CTAS, tiles=tiles, segs=segs, grid=grid,
             factor_rows_in_registers=reg, batch_points=ls.batch_points(bl, m2, left.element_size()), **med,
             method="a -DQRK_TRACE=1 build; thread 0 of each CTA: %globaltimer and clock64 at its marks; "
                    "per part the median and the largest over the CTAs (cycles over the median clock "
                    "the marks give); the median of 5 traced eager calls after one untraced")


def sweep(torch, emit):
    """``--case sweep`` (the module docstring)."""
    from qrkit_tpu_torch.ops import _build
    from qrkit_tpu_torch.ops import lm_step as ls

    with concurrent.futures.ThreadPoolExecutor(len(SWEEP_CTAS) * 2) as pool:  # one nvcc a library
        list(pool.map(lambda a: _build.build_lm_step(*a[0], (("QRK_CTAS", a[1]),)),
                      [(shape, c) for shape in ((2, 1, 5), (7, 2, 5)) for c in SWEEP_CTAS]))
    for label, ops in sweep_steps(torch):
        P, bl, bc, nb_ = ops[0].shape
        for ctas in SWEEP_CTAS:
            extra = (("QRK_CTAS", ctas),)
            tiles, segs, grid, reg = _build.lm_step_geometry(bl, bc, ops[1].shape[2], ops[0].dtype, nb_, P,
                                                             ls.TILE, extra)
            rec = dict(case="sweep", step=label, ctas=ctas, tiles=tiles, segs=segs, grid=grid,
                       factor_rows_in_registers=reg)
            try:
                rec["ms"] = graph_ms(torch, lambda: ls._damped_step_kernel(*ops, ls.TILE, extra=extra))
            except RuntimeError as e:  # a grid the card cannot make co-resident
                rec["refused"] = str(e)
                torch.cuda.synchronize()
            emit(**rec)


UNSTAGED = (("QRK_STAGE", 0),)


def stage(torch, emit):
    """``--case stage`` (the module docstring)."""
    from qrkit_tpu_torch.ops import _build
    from qrkit_tpu_torch.ops import lm_step as ls

    for label, ops in sweep_steps(torch):
        P, bl, bc, nb = ops[0].shape
        m2 = ops[1].shape[2]
        reg = _build.lm_step_geometry(bl, bc, m2, ops[0].dtype, nb, P, ls.TILE)[3]
        staged = ls._damped_step_kernel(*ops, ls.TILE)
        unstaged = ls._damped_step_kernel(*ops, ls.TILE, extra=UNSTAGED)
        rounds = {"unstaged": [], "staged": []}
        for kind in ("unstaged", "staged", "staged", "unstaged"):
            extra = UNSTAGED if kind == "unstaged" else ()
            rounds[kind].append(graph_ms(torch, lambda: ls._damped_step_kernel(*ops, ls.TILE, extra=extra)))
        emit(case="stage", step=label, factor_rows_in_registers=reg,
             bitwise_equal=bool(torch.equal(staged, unstaged)),
             unstaged_ms=statistics.mean(rounds["unstaged"]), staged_ms=statistics.mean(rounds["staged"]),
             rounds=rounds, method="a CUDA graph of 10 calls replayed between CUDA events, median of 5 "
             "over 10, rounds unstaged, staged, staged, unstaged; the mean of each build's rounds")


if __name__ == "__main__":
    main()
