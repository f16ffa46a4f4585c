"""Time one checkout's ellipse LM fits and lane-major damped step on the card.

    python3 profile_lm_step.py --label NAME [--tree CHECKOUT]

Imports ``qrkit_tpu_torch`` from ``--tree`` (default: this checkout) and
nothing else of the repo, so a checkout from before kernel K3
(``ops/lm_step.py``) runs it too.  fp32 on the card, with the points of
``chip_smoke.py``'s ``ellipse_lm`` (``Ellipse(7.5, 2, 17, 23, 0.23)``, 1.3π
of arc) and its ``LMConfig(max_iters=40, ftol=1e-8, xtol=1e-8)``:

* ``fit``: ``fit_ellipse`` at 100,000 and 500,000 points and
  ``fit_ellipse_batch`` on 16 problems of 10,000 (problem i: a = 7.5 +
  0.1 i, r = 0.23 + 0.01 i): after the key's first fit (the capture), the
  wall ms of a warm fit (the host clock around the call, which ends in its
  fetch; median of 5), then one warm fit under torch.profiler: its kernel
  launches and device ms, each over the iterations;
* ``step``: ``functional.lm_damped_step_blockdiag1`` at the 100,000-point
  fit's start (its Jacobian and residuals, λ = 1e-3), eager
  (``_program.eager()``): the kernels one call launches and their device ms
  (torch.profiler), and the wall ms of a call (CUDA events, synchronize
  before and after, median of 20).

To compare a change with its parent in turns on one card, each tree in its
own process::

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 profile_lm_step.py --tree $t --label $t; done

One JSON line per case, each with the label, the checkout and the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TRUTH = (7.5, 2.0, 17.0, 23.0, 0.23)
NS = (100_000, 500_000)
BATCH = (16, 10_000)


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


if __name__ == "__main__":
    main()
