"""GPU smoke gate for the PyTorch + CUDA port (``qrkit_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds every CUDA kernel of the block-diagonal main path from the sources
in ``qrkit_tpu_torch/ops/csrc/`` with nvcc (sm_90a), checks each kernel
against its plain PyTorch version on the card, drives the main path
(``SparseCSR`` → ``BlockDiagonal`` → ``BlockDiagonalQR.compute`` → ``solve``)
at the flagship size (10,000 blocks of 7×2) and at the 1M-block point,
times the kernels against their plain versions with CUDA events, and checks
the differentiable ``functional.block_diagonal_lstsq`` against the CPU.

Each phase prints one JSON line.  Any failure raises, so the script exits
non-zero without the final line; it also fails when no CUDA device is
visible.  The last two lines are the kernel summary
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import functional, profiling
from qrkit_tpu_torch.ops import _build
from qrkit_tpu_torch.ops import blockdiag as bd

SEED = 0
DEVICE = "cuda"
KERNEL_SHAPES = [(7, 2), (2, 1), (3, 3), (8, 8), (16, 4)]
KERNEL_NS = [1, 1000, 10_007]
BR, BC = 7, 2                       # the flagship block shape (BASELINE.json config 2)
NB_CONFIG2, NB_REAL = 10_000, 1_000_000
RESID_GATE = 1e-4                   # fp32 relative residual gate (bench.py)
SOURCE = "qrkit_tpu_torch/ops/csrc/blockdiag_qr.cu"
# name -> (TPU kernel replaced, kernel wrapper, plain version), both called (a, b, br)
KERNELS = {
    "blockdiag_lstsq": (
        "qrkit_tpu/ops/pallas_blockdiag.py:154",
        lambda a, b, br: bd.block_diagonal_lstsq_soa(a, b),
        lambda a, b, br: bd._lstsq_soa_plain(a, b),
    ),
    "blockdiag_qr_r": (
        "qrkit_tpu/ops/pallas_blockdiag.py:443",
        lambda a, b, br: bd.block_diagonal_qr_r_soa(a, br),
        lambda a, b, br: bd._qr_r_soa_plain(a, br),
    ),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def tolerance(dtype):
    """(rtol, atol relative to max|reference|) for kernel vs plain."""
    return (1e-10, 0.0) if dtype == torch.float64 else (1e-4, 1e-5)


def compare(out, ref, dtype):
    """Worst errors of out against ref; raises if outside the tolerance."""
    rtol, atol_rel = tolerance(dtype)
    out64, ref64 = out.double(), ref.double()
    if not torch.isfinite(out64).all() or not torch.isfinite(ref64).all():
        raise AssertionError("non-finite kernel or plain output")
    err = (out64 - ref64).abs()
    atol = atol_rel * ref64.abs().max().item() if ref64.numel() else 0.0
    bound = atol + rtol * ref64.abs()
    max_abs = err.max().item() if err.numel() else 0.0
    if bool((err > bound).any()):
        worst = (err - bound).argmax().item()
        raise AssertionError(
            f"kernel disagrees with plain version: max_abs_err={max_abs} "
            f"(worst at flat index {worst}, rtol={rtol}, atol={atol})"
        )
    return max_abs, bool(torch.equal(out, ref))


def soa_operands(rng, n, br, bc, dtype, device, degenerate=True):
    """Blocks uniform(0.5, 5) in SoA [br*bc, n], rhs [br, n]; block 0 gets a
    first column that is zero below a nonzero diagonal (the sigma <= 0 path)."""
    blocks = rng.uniform(0.5, 5.0, size=(n, br, bc))
    if degenerate and n:
        blocks[0, 1:, 0] = 0.0
    b = rng.normal(size=(br, n))
    a_soa = blocks.transpose(1, 2, 0).reshape(br * bc, n)
    return (
        torch.as_tensor(np.ascontiguousarray(a_soa), dtype=dtype, device=device),
        torch.as_tensor(b, dtype=dtype, device=device),
    )


def run_kernel(name, a, b, br):
    return KERNELS[name][1](a, b, br)


def run_plain(name, a, b, br):
    return KERNELS[name][2](a, b, br)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this gate needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
    })
    return smi


def phase_build():
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(KERNEL_SHAPES)) as pool:
        paths = list(pool.map(lambda s: _build.build(*s), KERNEL_SHAPES))
    for br, bc in KERNEL_SHAPES:
        _build.load(br, bc)
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "nvcc": _build.find_nvcc(), "flags": list(_build.NVCC_FLAGS),
        "libraries": [p.name for p in paths],
    })


def phase_kernel_vs_plain(rng):
    worst = {}
    for name in KERNELS:
        for br, bc in KERNEL_SHAPES:
            for dtype in (torch.float32, torch.float64):
                max_abs, bitwise = 0.0, True
                for n in KERNEL_NS:
                    a, b = soa_operands(rng, n, br, bc, dtype, DEVICE)
                    out = run_kernel(name, a, b, br)
                    torch.cuda.synchronize()
                    e, eq = compare(out, run_plain(name, a, b, br), dtype)
                    max_abs, bitwise = max(max_abs, e), bitwise and eq
                rtol, atol_rel = tolerance(dtype)
                emit({
                    "phase": "kernel_vs_plain", "kernel": name, "shape": [br, bc],
                    "dtype": str(dtype).split(".")[1], "ns": KERNEL_NS,
                    "max_abs_err": max_abs, "bitwise_equal": bitwise,
                    "rtol": rtol, "atol_x_max_abs": atol_rel,
                })
                worst[(name, br, bc)] = max(worst.get((name, br, bc), 0.0), max_abs)
    return worst


def host_residual(blocks_np, x, b_np):
    """fp64 relative residual ‖Ax − b‖/‖b‖ on the host."""
    nb, br, bc = blocks_np.shape
    xh = x.detach().cpu().double().numpy()[: nb * bc].reshape(nb, bc)
    r = np.einsum("bij,bj->bi", blocks_np, xh).reshape(-1) - b_np
    return float(np.linalg.norm(r) / np.linalg.norm(b_np))


def drive_main_path(label, mat, blocks_np, b_np, expect_kernels):
    """compute + solve through the class API with the counters checked."""
    b = torch.as_tensor(b_np, dtype=torch.float32, device=DEVICE)
    qr = qt.BlockDiagonalQR(pivot=not expect_kernels)
    profiling.reset_launch_counts()
    t0 = time.perf_counter()
    qr.compute(mat)
    after_compute = profiling.launch_counts()
    x = qr.solve(b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = profiling.launch_counts()
    info = qr.info()
    if info != qt.ComputationInfo.SUCCESS:
        raise AssertionError(f"{label}: info() = {info}")
    if tuple(x.shape) != (mat.ncols,) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{label}: solution shape {tuple(x.shape)} or non-finite values")
    resid = host_residual(blocks_np, x, b_np)
    if not resid < RESID_GATE:
        raise AssertionError(f"{label}: fp32 relative residual {resid} >= {RESID_GATE}")
    if expect_kernels:
        want_compute = {"blockdiag_lstsq": 0, "blockdiag_qr_r": 1}
        want = {"blockdiag_lstsq": 1, "blockdiag_qr_r": 1}
        if not qr._kernel_mode or after_compute != want_compute or counts != want:
            raise AssertionError(
                f"{label}: kernel tier not taken as expected (kernel_mode={qr._kernel_mode}, "
                f"after compute {after_compute}, after solve {counts})"
            )
    elif any(counts.values()) or qr._kernel_mode:
        raise AssertionError(f"{label}: batched-torch tier launched kernels {counts}")
    emit({
        "phase": "main_path", "case": label, "pivot": qr.pivot, "kernel_tier": qr._kernel_mode,
        "nb": mat.num_blocks, "rel_residual": resid, "info": info.name,
        "launches": counts, "launches_after_compute": after_compute,
        "wall_s_incl_first_use": seconds,
    })
    return counts


def flagship_system(rng, nb):
    blocks = rng.uniform(0.5, 5.0, size=(nb, BR, BC))
    x_true = rng.normal(size=nb * BC)
    b = np.einsum("bij,bj->bi", blocks, x_true.reshape(nb, BC)).reshape(-1)
    return blocks, b


def phase_config2(rng):
    blocks, b = flagship_system(rng, NB_CONFIG2)
    i, r, c = np.meshgrid(np.arange(NB_CONFIG2), np.arange(BR), np.arange(BC), indexing="ij")
    spj = qt.SparseCSR.from_triplets(
        (i * BR + r).ravel(), (i * BC + c).ravel(), blocks.ravel(),
        (NB_CONFIG2 * BR, NB_CONFIG2 * BC),
    )
    mat = qt.BlockDiagonal.from_block_diagonal_pattern(
        spj, BR, BC, device=DEVICE, dtype=torch.float32
    )
    counts = drive_main_path("config2_10k_7x2_kernel_tier", mat, blocks, b, True)
    drive_main_path("config2_10k_7x2_pivot_batched_torch", mat, blocks, b, False)
    return counts


def time_pair(name, a, b, br, nbytes, smi):
    """Kernel and plain version in turns (kernel, plain, plain, kernel), each
    round CUDA events per call, median of 50 after 10 warm-ups; the reported
    time is the mean of the two rounds' medians."""
    kernel_rounds, plain_rounds = [], []
    for rounds in (kernel_rounds, plain_rounds, plain_rounds, kernel_rounds):
        fn = run_kernel if rounds is kernel_rounds else run_plain
        rounds.append(profiling.cuda_time_ms(lambda: fn(name, a, b, br)))
    ms, plain_ms = statistics.mean(kernel_rounds), statistics.mean(plain_rounds)
    out = run_kernel(name, a, b, br)
    ref = run_plain(name, a, b, br)
    torch.cuda.synchronize()
    max_abs, bitwise = compare(out, ref, a.dtype)
    emit({
        "phase": "timing", "kernel": name, "n": a.shape[1], "shape": [BR, BC],
        "dtype": "float32", "ms": ms, "plain_ms": plain_ms,
        "ms_rounds": kernel_rounds, "plain_ms_rounds": plain_rounds,
        "gbps": nbytes / (ms * 1e-3) / 1e9, "plain_gbps": nbytes / (plain_ms * 1e-3) / 1e9,
        "bytes": nbytes, "max_abs_err": max_abs, "bitwise_equal": bitwise,
        "method": "CUDA events per call, 10 warm-up, median of 50, synchronize before "
                  "reading; rounds kernel, plain, plain, kernel; mean of round medians",
        "gpu": smi,
    })
    return ms, plain_ms, max_abs


def phase_real_size(rng, smi):
    blocks, b = flagship_system(rng, NB_REAL)
    a_soa = np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(BR * BC, NB_REAL))
    mat = qt.BlockDiagonal.from_soa(a_soa, BR, BC, device=DEVICE, dtype=torch.float32)
    counts = drive_main_path("real_1M_7x2_kernel_tier", mat, blocks, b, True)

    results = {name: [] for name in KERNELS}
    ntri = BC * (BC + 1) // 2
    for n in (NB_CONFIG2, NB_REAL):
        a = mat.soa()[:, :n].contiguous()
        bs = torch.as_tensor(b[: n * BR].reshape(n, BR).T.copy(), dtype=torch.float32, device=DEVICE)
        lstsq_bytes = (BR * BC + BR + BC) * n * 4
        qr_bytes = (BR * BC + ntri) * n * 4
        results["blockdiag_lstsq"].append(time_pair("blockdiag_lstsq", a, bs, BR, lstsq_bytes, smi))
        results["blockdiag_qr_r"].append(time_pair("blockdiag_qr_r", a, bs, BR, qr_bytes, smi))
    return counts, results


def phase_gradient():
    rng = np.random.default_rng(SEED)
    nb, br, bc = 512, 7, 2
    blocks = rng.normal(size=(nb, br, bc))
    b = rng.normal(size=nb * br)
    g = rng.normal(size=nb * bc)
    out = {}
    for dev in (DEVICE, "cpu"):
        A = torch.tensor(blocks, device=dev, requires_grad=True)
        v = torch.tensor(b, device=dev, requires_grad=True)
        x = functional.block_diagonal_lstsq(A, v, pivot=False)
        gA, gb = torch.autograd.grad(x, (A, v), torch.tensor(g, device=dev))
        out[dev] = [t.detach().cpu() for t in (x, gA, gb)]
    errs = {}
    for label, got, ref in zip(("x", "d_blocks", "d_b"), out[DEVICE], out["cpu"]):
        if not torch.allclose(got, ref, rtol=1e-9, atol=1e-9):
            raise AssertionError(f"gradient phase: {label} differs between CUDA and CPU")
        errs[label] = (got - ref).abs().max().item()
    emit({"phase": "gradient", "nb": nb, "shape": [br, bc], "dtype": "float64",
          "max_abs_err_cuda_vs_cpu": errs, "tol": 1e-9})


def main():
    rng = np.random.default_rng(SEED)
    smi = phase_device()
    phase_build()
    worst = phase_kernel_vs_plain(rng)
    counts10k = phase_config2(rng)
    counts1m, timings = phase_real_size(rng, smi)
    phase_gradient()
    kernels = []
    for name, (replaces, _, _) in KERNELS.items():
        ms, plain_ms, _ = timings[name][-1]  # the 1M-block point
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": counts10k[name] + counts1m[name],
            "max_abs_err": max([worst[(name, BR, BC)]] + [t[2] for t in timings[name]]),
            "ms": ms, "plain_ms": plain_ms,
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
