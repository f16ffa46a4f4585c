"""Time one checkout's block-diagonal main path and one-shot entry points on the card.

    python3 profile_programs.py --label NAME [--tree CHECKOUT]

Imports ``qrkit_tpu_torch`` from ``--tree`` (default: this checkout) and
nothing else of the repo, so a checkout from before the captured programs
(``qrkit_tpu_torch/_program.py``) runs it too.  fp32 on the card:

* ``config2_compute_solve``: ``BlockDiagonalQR.compute`` + ``solve`` on one
  AoS container of 10,000 and of 1M blocks of 7×2 (config 2 and the
  1M-block point), the same container and rhs every call, as an LM loop
  refactorizes one structure: wall ms per call (CUDA events around one
  call, synchronize before and after, median of ``reps``), host µs per call
  (the host clock over ``reps`` calls back to back, synchronized after) and
  device ms per call (torch.profiler's kernel and copy time over ``reps``
  calls), after 3 warm calls; then the device memory the solver holds
  (``torch.cuda.memory_allocated`` with and without it);
* ``auto_qr_first_call``: ``auto_qr`` + ``solve`` with a new solver every
  call (as ``auto_qr`` and the CLI build one), on config 2 (10,000 × 7×2,
  rows permuted) and config 3 (2,499 blocks of 40×8 overlapping 4), each
  call synchronized, one call to load the libraries, then the median of 5;
* ``cli``: ``python -m qrkit_tpu_torch`` in process on the same two
  matrices written as MatrixMarket under ``build/``, one call, then the
  median of 3.

To compare a change with its parent in turns on one card, each tree in its
own process::

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 profile_programs.py --tree $t --label $t; done

One JSON line per case, each with the label, the checkout and the card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BR, BC = 7, 2
C3_NB, C3_BR, C3_BC, C3_OV = 2499, 40, 8, 4


def wall_ms(torch, fn, reps):
    """Median over ``reps`` calls of the CUDA-event time around one call,
    synchronized before and after."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_ms(torch, fn, reps):
    """torch.profiler's device time (kernels and copies) per call; None when
    the profiler kept no device record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / reps if total else None


def seconds(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def blockdiag_csr(qt, np, rng, nb):
    blocks = rng.uniform(0.5, 5.0, size=(nb, BR, BC))
    i, r, c = np.meshgrid(np.arange(nb), np.arange(BR), np.arange(BC), indexing="ij")
    mat = qt.SparseCSR.from_triplets((i * BR + r).ravel(), (i * BC + c).ravel(), blocks.ravel(),
                                     (nb * BR, nb * BC))
    return mat.permute_rows(qt.Permutation(rng.permutation(mat.nrows)))


def banded_csr(qt, np, rng):
    step = C3_BC - C3_OV
    ncols = step * C3_NB + C3_OV
    i, r, c = np.meshgrid(np.arange(C3_NB), np.arange(C3_BR), np.arange(C3_BC), indexing="ij")
    rows, cols = (i * C3_BR + r).ravel(), (i * step + c).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return qt.SparseCSR.from_triplets(rows[keep], cols[keep], vals[keep], (C3_BR * C3_NB, ncols))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--tree", help="checkout to import qrkit_tpu_torch from (default: this one)")
    args = ap.parse_args()
    if args.tree is not None:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch

    import qrkit_tpu_torch as qt
    from qrkit_tpu_torch.__main__ import main as cli_main

    if not torch.cuda.is_available():
        raise SystemExit("profile_programs: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    head = {"label": args.label, "tree": str(Path(qt.__file__).resolve().parents[1]), "gpu": smi}

    def emit(**rec):
        print(json.dumps({**head, **rec}), flush=True)

    rng = np.random.default_rng(0)
    f32 = dict(device="cuda", dtype=torch.float32)
    for nb, reps in ((10_000, 50), (1_000_000, 20)):
        blocks = torch.as_tensor(rng.uniform(0.5, 5.0, size=(nb, BR, BC)), **f32)
        b = torch.as_tensor(rng.normal(size=nb * BR), **f32)
        mat = qt.BlockDiagonal(blocks, nb * BR, nb * BC)
        base = torch.cuda.memory_allocated()
        qr = qt.BlockDiagonalQR(pivot=False)

        def step(qr=qr, mat=mat, b=b):
            qr.compute(mat)
            return qr.solve(b)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        programs = getattr(qr, "_programs", None)  # a tree with captured programs
        emit(case="config2_compute_solve", nb=nb, kernel_tier=qr._kernel_mode,
             pool_bytes=programs.pool_bytes() if programs is not None else None,
             wall_ms=wall_ms(torch, step, reps), host_us=host_us(torch, step, reps),
             device_ms=device_ms(torch, step, reps), solver_bytes=held, reps=reps,
             method="wall_ms: CUDA events around one compute + solve, synchronize before and "
                    "after, median; host_us: host clock over reps calls back to back; device_ms: "
                    "torch.profiler's CUDA kernel + memcpy time per call; solver_bytes: "
                    "memory_allocated with the solver minus before it (the container's SoA "
                    "cache included); pool_bytes: the solver's graph pool, reserved")
        del qr, step, mat, blocks, b
        torch.cuda.synchronize()

    c2, c3 = blockdiag_csr(qt, np, rng, 10_000), banded_csr(qt, np, rng)
    for label, m, sbc in (("config2", c2, 2), ("config3", c3, 8)):
        pb = rng.normal(size=m.nrows)

        def once(m=m, pb=pb, sbc=sbc):
            qr = qt.auto_qr(m, suggested_block_cols=sbc, **f32)
            x = qr.solve(torch.as_tensor(qr.rows_permutation().apply(pb), **f32))
            return qr.selection, float(x.abs().max())

        load_s = seconds(torch, once)
        times = [seconds(torch, once) for _ in range(5)]
        emit(case="auto_qr_first_call", matrix=label, shape=list(m.shape), selection=once()[0],
             first_s=load_s, median_s=statistics.median(times), times_s=times,
             method="auto_qr + solve with a new solver each call, synchronized; first_s loads "
                    "the libraries; median of the 5 calls after it")
    os.makedirs(ROOT / "build", exist_ok=True)
    for label, m, sbc in (("config2", c2, "2"), ("config3", c3, "8")):
        path = str(ROOT / "build" / f"profile_programs_{label}.mtx")
        qt.sparse.save_matrix_market(path, m)
        argv = [path, "--rhs-random", "--suggested-block-cols", sbc, "--device", "cuda",
                "--dtype", "float32"]
        err = io.StringIO()

        def cli(argv=argv, err=err):
            with contextlib.redirect_stderr(err):
                if cli_main(argv) != 0:
                    raise SystemExit(f"CLI failed: {err.getvalue()}")

        first = seconds(torch, cli)
        times = [seconds(torch, cli) for _ in range(3)]
        emit(case="cli", matrix=label, first_s=first, median_s=statistics.median(times),
             times_s=times, method="qrkit_tpu_torch.__main__.main in process, fp32, "
                                   "--rhs-random; synchronized; median of 3 after the first")


if __name__ == "__main__":
    main()
