"""Profile the banded CUDA kernels (B3, B4, B5) of one checkout on the card.

    python3 profile_banded.py time --label NAME [--tree CHECKOUT]
    python3 profile_banded.py ptxas

``time``: each banded kernel at the main paths' shapes (config 3's segment
chains, W apply, plain chain and boundary chain, and the banded ellipse
stack's 2,000-step 4×1 chain), fp32, timed as ``chip_smoke.py``'s
``banded_timing`` phase times it (CUDA events per call and torch.profiler's
device time); then ``SegmentedBandedQR`` and ``BandedBlockedQR`` compute +
solve on config 3 (host wall time ending in synchronize, one warm-up, median
of 20 and of 3).  ``--tree`` imports ``qrkit_tpu_torch`` from another
checkout, whose kernels are built into its own ``build/``; the operands and
the timing code are this checkout's.  To compare a change with its parent in
turns on one card, each tree in its own process::

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 profile_banded.py time --tree $t --label $t
    done

``--errors`` first holds the tree's kernels against its plain versions at
every banded shape ``chip_smoke.py`` checks, fp32 and fp64.

``ptxas``: compiles ``banded_chain.cu`` once with ``-Xptxas=-v`` (into
``build/``) and prints each kernel instantiation's registers, stack frame
and spills.

One JSON line per case, each with the label, the checkout and the card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BANDED_CU = ROOT / "qrkit_tpu_torch" / "ops" / "csrc" / "banded_chain.cu"


def load_smoke(tree):
    """This checkout's ``chip_smoke`` module, with ``qrkit_tpu_torch``
    imported from ``tree`` (default: this checkout)."""
    if tree is not None:
        sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_time(args):
    cs = load_smoke(args.tree)
    import numpy as np
    import torch

    smi = cs.phase_device()
    head = {"label": args.label, "tree": str(Path(cs.qt.__file__).resolve().parents[1]), "gpu": smi}

    def emit(**rec):
        print(json.dumps({**head, **rec}), flush=True)

    if args.errors:
        kernel_vs_plain(cs, emit)
    rng = np.random.default_rng(cs.SEED)
    mat = cs.banded_matrix(rng, cs.C3_NB, cs.C3_BR, cs.C3_BC, cs.C3_OV)
    t0 = time.perf_counter()
    ops, _ = cs.banded_operands(rng, mat, cs.C3_SEGMENT_BLOCKS, cs.C3_BC, torch.float32)
    ops["banded_chain_qr"].append(cs.ellipse_chain_case())
    for cases in ops.values():  # the first calls build the kernels
        for case in cases:
            case[1]()
    torch.cuda.synchronize()
    emit(case="setup", seconds=time.perf_counter() - t0)
    for name, cases in ops.items():
        for case, run_k, _, (steps, _, _) in cases:
            ms, device_ms, profiled_ms = cs.time_banded_kernel(run_k)
            emit(kernel=name, case=case, ms=ms, device_ms=device_ms,
                 profiled_events_ms=profiled_ms, steps=steps,
                 device_per_step_us=device_ms * 1e3 / steps, method=cs.BANDED_KERNEL_METHOD)

    b = torch.as_tensor(mat.matvec(rng.normal(size=mat.ncols)), dtype=torch.float32,
                        device=cs.DEVICE)
    solvers = (
        ("segmented_compute_solve", cs.qt.SegmentedBandedQR(
            suggested_block_cols=cs.C3_BC, segment_blocks=cs.C3_SEGMENT_BLOCKS,
            device=cs.DEVICE, dtype=torch.float32), 20),
        ("plain_compute_solve", cs.qt.BandedBlockedQR(
            suggested_block_cols=cs.C3_BC, device=cs.DEVICE, dtype=torch.float32), 3),
    )
    for case, solver, reps in solvers:
        ms, times = cs.wall_ms(lambda: (solver.compute(mat), solver.solve(b)), reps)
        emit(case=case, ms=ms, times_ms=times,
             method=f"host wall time ending in synchronize, one warm-up, median of {reps}")


def kernel_vs_plain(cs, emit):
    """The tree's kernels against its plain versions at every banded shape
    ``chip_smoke.py`` checks (its ``banded_kernel_vs_plain`` phase, then B5 on
    the banded ellipse stack's 4×1 chain), fp32 and fp64."""
    import numpy as np
    import torch

    cs.phase_banded_kernel_vs_plain(np.random.default_rng(cs.SEED))
    pts = cs.ellipse.ellipse_points(cs.ellipse.Ellipse(*cs.ELLIPSE_TRUTH), cs.BANDED_LEFT_N)
    for dtype in (torch.float32, torch.float64):
        f = cs.ellipse.EllipseFitting(pts, dtype=dtype, device=cs.DEVICE)
        panels, act, kw = cs.banded_left_chain(f, 1e-3)
        err, _ = cs.compare_outputs(cs.bk.chain_qr(panels, act, **kw),
                                    cs.bk._chain_qr_plain(panels, act, **kw), dtype)
        emit(kernel="banded_chain_qr", case="ellipse_4x1_chain", dtype=str(dtype).split(".")[1],
             max_abs_err=err)


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_KERNEL = re.compile(r"\d+([a-z][a-z_]*_kernel)I([fd])((?:L[ib]\d+E)*)E")


def kernel_name(entry):
    """``apply_w_reg_kernel<float, 2, 8, 1>`` from a mangled kernel name."""
    m = _KERNEL.search(entry)
    if not m:
        return entry
    args = ["float" if m.group(2) == "f" else "double"] + re.findall(r"L[ib](\d+)E", m.group(3))
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas(source, defines=(), name="kernels"):
    """Compile ``source`` once with ``-Xptxas=-v`` and the ``-D`` defines
    (into ``build/``); returns (seconds, flags, one dict per kernel
    instantiation with its registers, stack frame and spills)."""
    sys.path.insert(0, str(ROOT))
    from qrkit_tpu_torch.ops import _build

    out = ROOT / "build" / "qrkit_tpu_torch" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-Xptxas=-v", *(f"-D{k}={v}" for k, v in defines)]
    cmd = [_build.find_nvcc(), *flags, "-o", str(out / f"{name}.so"), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    kernels, cur = [], None
    for line in (proc.stderr + proc.stdout).splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": kernel_name(m.group(1))}
            kernels.append(cur)
        elif cur is not None:
            m = _FRAME.search(line)
            if m:
                cur.update(zip(("stack_bytes", "spill_store_bytes", "spill_load_bytes"),
                               map(int, m.groups())))
            m = _REGS.search(line)
            if m:
                cur["registers"] = int(m.group(1))
    return time.perf_counter() - t0, flags, sorted(kernels, key=lambda k: k["kernel"])


def run_ptxas(_args):
    seconds, flags, kernels = ptxas(BANDED_CU, name="banded_chain")
    print(json.dumps({"phase": "ptxas", "seconds": seconds, "flags": flags}), flush=True)
    for k in kernels:
        print(json.dumps(k), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)
    t = sub.add_parser("time", help="time one checkout's banded kernels and config-3 solves")
    t.add_argument("--label", required=True)
    t.add_argument("--tree", help="checkout to import qrkit_tpu_torch from (default: this one)")
    t.add_argument("--errors", action="store_true",
                   help="first hold the kernels against their plain versions at chip_smoke's shapes")
    t.set_defaults(run=run_time)
    sub.add_parser("ptxas", help="registers and spills of every banded kernel").set_defaults(
        run=run_ptxas)
    args = ap.parse_args()
    args.run(args)


if __name__ == "__main__":
    main()
