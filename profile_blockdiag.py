"""Profile the block-diagonal CUDA kernels (B1, B2) of one checkout on the card.

    python3 profile_blockdiag.py time --label NAME [--tree CHECKOUT] [--errors]
    python3 profile_blockdiag.py ptxas

``time``: B1 (``blockdiag_lstsq``) and B2 (``blockdiag_qr_r``) at the main
paths' shapes, fp32: config 2's 10,000 × 7×2, the bundle host loop's 5,000 ×
19×3 (B2) and the 1M × 7×2 point.  Each case: torch.profiler's device time
(``chip_smoke.device_time_ms``), the per-call time (CUDA events around one
call, ``profiling.cuda_time_ms``, which includes the wrapper's host time),
the host's time per call (``host_us``: the host clock over 200 calls back
to back, the fastest of 5 such batches: the wrapper's launch path), the
byte bound and the launch floor (the tree's empty kernel on its grid),
three passes.  Then config 2's ``BlockDiagonalQR`` compute + solve
(``chip_smoke.mesh_turns``: CUDA events around one call, synchronize before
and after).  ``--tree`` imports ``qrkit_tpu_torch`` from another checkout
(its kernels built into its own ``build/``); operands and timing are this
checkout's.  To compare a change with its parent in turns on one card, each
tree in its own process::

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 profile_blockdiag.py time --tree $t --label $t
    done

``--errors`` first holds the tree's B1/B2 against its plain versions at
every shape and batch ``chip_smoke.py`` checks, fp32 and fp64.

``ptxas``: registers, stack frame and spills of every kernel instantiation
of ``blockdiag_qr.cu`` for 7×2, 19×3 and 8×8.

The CTA-size sweep that chose the launchers' rule (``grid_for`` in
``blockdiag_qr.cu``) is this script's ``sweep`` at commit 9ec7e69; at
commit c5f28c7 it also crossed lanes per block, 1, 2 or 4.

One JSON line per case, each with the label, the checkout and the card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import time
from pathlib import Path

from profile_banded import ROOT, load_smoke, ptxas

BLOCKDIAG_CU = ROOT / "qrkit_tpu_torch" / "ops" / "csrc" / "blockdiag_qr.cu"
# (kernel, br, bc, n): the main paths' calls
CASES = (
    ("blockdiag_lstsq", 7, 2, 10_000),
    ("blockdiag_qr_r", 7, 2, 10_000),
    ("blockdiag_qr_r", 19, 3, 5_000),
    ("blockdiag_lstsq", 7, 2, 1_000_000),
    ("blockdiag_qr_r", 7, 2, 1_000_000),
)


def case_bytes(kernel, br, bc, n, itemsize=4):
    """Bytes a call must move: each input read once, each output written once."""
    out = bc if kernel == "blockdiag_lstsq" else bc * (bc + 1) // 2
    rhs = br if kernel == "blockdiag_lstsq" else 0
    return (br * bc + rhs + out) * n * itemsize


def empty_launch(cs, br, bc, n):
    """The tree's empty kernel on B1/B2's grid for n blocks of br×bc."""
    import torch

    fn = cs._build.blockdiag_launcher("empty", br, bc)
    dev = torch.cuda.current_device()
    return lambda: fn(dev, n)


def host_us(fn, calls=200, batches=5):
    """The host's time per call of ``fn`` in µs: the host clock over
    ``calls`` calls back to back (the card keeps up, so the host's launch
    path sets the pace), synchronized after; the fastest of ``batches``."""
    import torch

    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def run_time(args):
    cs = load_smoke(args.tree)
    import numpy as np
    import torch

    smi = cs.phase_device()
    head = {"label": args.label, "tree": str(Path(cs.qt.__file__).resolve().parents[1]), "gpu": smi}

    def emit(**rec):
        print(json.dumps({**head, **rec}), flush=True)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda s: cs._build.build(*s), ((7, 2), (19, 3))))
    emit(case="build", seconds=time.perf_counter() - t0)
    if args.errors:
        cs.phase_kernel_vs_plain(np.random.default_rng(cs.SEED))
    rng = np.random.default_rng(cs.SEED)
    runs = []
    for kernel, br, bc, n in CASES:
        a, b = cs.soa_operands(rng, n, br, bc, torch.float32, cs.DEVICE, degenerate=False)
        runs.append((kernel, br, bc, n, lambda k=kernel, a=a, b=b, br=br: cs.run_kernel(k, a, b, br),
                     empty_launch(cs, br, bc, n)))
    for _, _, _, _, fn, floor in runs:  # the first calls load the libraries
        fn()
        floor()
    torch.cuda.synchronize()
    for rep in range(3):
        for kernel, br, bc, n, fn, floor in runs:
            cs.spin(fn, 0.1)
            per_call = cs.profiling.cuda_time_ms(fn)
            device_ms = cs.device_time_ms(fn, one_kernel=True)
            floor_ms = cs.device_time_ms(floor, one_kernel=True)
            nbytes = case_bytes(kernel, br, bc, n)
            bound_ms, bound_by = cs.bound(nbytes, 0)
            emit(kernel=kernel, shape=[br, bc], n=n, rep=rep, device_ms=device_ms, per_call_ms=per_call,
                 host_us=host_us(fn), floor_ms=floor_ms, bound_ms=bound_ms, bound_by=bound_by,
                 bytes=nbytes,
                 method="device_ms / floor_ms: torch.profiler's mean kernel duration over the records it "
                        "kept of 20 calls; per_call_ms: CUDA events around each call, median of 50 "
                        "after 10 warm-ups, no synchronize between calls; host_us: the host clock over "
                        "200 calls back to back, synchronized after, the fastest of 5 batches")
    blocks, rhs = cs.flagship_system(rng, cs.NB_CONFIG2)
    a_soa = np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(cs.BR * cs.BC, cs.NB_CONFIG2))
    mat = cs.qt.BlockDiagonal.from_soa(a_soa, cs.BR, cs.BC, device=cs.DEVICE, dtype=torch.float32)
    bt = torch.as_tensor(rhs, dtype=torch.float32, device=cs.DEVICE)
    qr = cs.qt.BlockDiagonalQR(pivot=False)
    step = lambda: (qr.compute(mat), qr.solve(bt))  # noqa: E731
    ms, _, rounds = cs.mesh_turns(step, step, 50)
    emit(case="config2_compute_solve", ms=ms, rounds=rounds["none"] + rounds["mesh"],
         method="host-visible stream time between CUDA events around compute + solve, synchronize "
                "before and after; 4 rounds, each the median of 50 (chip_smoke.mesh_turns)")


def run_ptxas(_args):
    from qrkit_tpu_torch.ops import _build

    for br, bc in ((7, 2), (19, 3), (8, 8)):
        defines, _ = _build._blockdiag_defines(br, bc)
        seconds, flags, kernels = ptxas(BLOCKDIAG_CU, defines, name=f"blockdiag_qr_{br}x{bc}")
        print(json.dumps({"phase": "ptxas", "shape": [br, bc], "seconds": seconds, "flags": flags}),
              flush=True)
        for k in kernels:
            print(json.dumps({"shape": [br, bc], **k}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)
    t = sub.add_parser("time", help="time one checkout's B1/B2 and config-2 compute + solve")
    t.add_argument("--label", required=True)
    t.add_argument("--tree", help="checkout to import qrkit_tpu_torch from (default: this one)")
    t.add_argument("--errors", action="store_true",
                   help="first hold the kernels against their plain versions at chip_smoke's shapes")
    t.set_defaults(run=run_time)
    sub.add_parser("ptxas", help="registers and spills of blockdiag_qr.cu at 7x2, 19x3, 8x8").set_defaults(
        run=run_ptxas)
    args = ap.parse_args()
    args.run(args)


if __name__ == "__main__":
    main()
