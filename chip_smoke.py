"""GPU smoke gate for the PyTorch + CUDA port (``qrkit_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds every CUDA kernel from the sources in ``qrkit_tpu_torch/ops/csrc/``
with nvcc (sm_90a), one nvcc per library, all started together (and prints
the driver's and the toolkit's CUDA versions: the captured LM loop's
conditional WHILE node needs 12.3 in both), and then:

* block-diagonal path (kernels B1, B2): checks each kernel against its plain
  PyTorch version, drives ``SparseCSR`` → ``BlockDiagonal`` →
  ``BlockDiagonalQR.compute`` → ``solve`` at the flagship size (10,000
  blocks of 7×2) and at the 1M-block point, times the kernels against their
  plain versions and against one PyTorch call of the same function
  (``torch.linalg.lstsq`` / ``torch.linalg.qr(mode="r")`` on the AoS
  batch; timed only, never called by the port) with CUDA events and under
  torch.profiler (device time), each beside its byte bound, and checks the
  differentiable ``functional.block_diagonal_lstsq`` against the CPU;
* banded path (kernels B3, B4, B5): checks each kernel against its plain
  version at small shapes and at the shapes of BASELINE.json config 3 (a
  99,960 × 10,000 banded matrix of 2,499 blocks of 40×8 overlapping by 4),
  drives config 3 through ``SegmentedBandedQR`` (compute, solve,
  ``factorize_values`` on device values) and ``BandedBlockedQR`` (compute,
  solve) with the launch counters read around each path, and times the
  kernels against their plain versions (plus B5 on the banded ellipse
  stack's 2,000-step 4×1 chain), each with its time per chain step, bytes,
  operations and bound; the solves launch K1 and K2;
* the banded family's chain scans (phase ``chain_kernels``, kernels K1 and
  K2 of ``qrkit_tpu_torch/ops/csrc/chain_apply.cu``): the two-segment
  compact-WY apply (Qᵀ and Q) and the blocked back-substitution, each in
  its one-launch form and, where the solver built a chunk plan, in its
  chunked form (the main path's: chunks side by side, level by level),
  against their serial plain versions on the chains the solvers build
  (config 3's plain chain of 2,499 steps of 48×8, its 79 segments of 32
  steps and its 12-step 88×32 boundary chain, the banded ellipse stack's
  2,000-step 4×1 chain; 1, 16 and 48 columns, 1 and 5 on the ellipse),
  fp32 and fp64; in fp32 each chain's forms timed in turns (events per
  call, a replayed graph, the profiler's time by kernel; the segments and
  the boundary chain, one form, on one column) with the plan's shape, time
  per step, bytes, operations and bound, the headline cases against the
  plain version; the chunk lengths swept on config 3's plain
  chain (``chain_chunk_sweep``); K2's yardstick,
  one PyTorch call on config 3's R (``torch.linalg.solve_triangular`` on
  the dense 10,000 × 10,000 R, ``torch.triangular_solve`` on R in sparse
  CSR where the installed PyTorch takes it; timed, never called by the
  port);
* the lane-major damped LM step (phase ``lm_step_kernels``, kernel K3 of
  ``qrkit_tpu_torch/ops/csrc/lm_step.cu``: one memset and one cooperative
  launch a step on a persistent grid of at most C CTAs, each thread's
  carry over its points, the warp and CTA merges, the last CTA's finish,
  x1 after a grid-wide flag): against its plain version (the same
  schedule in PyTorch) at the ellipse's shape, 2×1 blocks and 5 right
  columns, over 100,000 points (its Jacobian at the fit's start) and
  500,000, and at 2×2 and 7×2 blocks over 100,000, fp32 and fp64; two
  calls bitwise equal; a vmapped batch of 16 × 10,000 as one launch against
  16 solo calls; a step that requires grad (one launch forward, its
  gradient against the CPU's in fp64); its launches read off the card
  (one call captured into a CUDA graph and read node by node,
  ``profiling.graph_nodes``: one cooperative K3 node and one memset node a
  step, two of each in the mesh form; the calls into its C launcher
  counted by mode); in fp32 its time as a replayed
  graph of 10 calls beside the plain version's, its first mode alone (the
  point pass through the last CTA's reduction), an empty cooperative
  kernel on its grid (the launch floor), the profiler's memset and kernel,
  the chosen C and the geometry, the yardstick ``torch.linalg.qr(mode="r")``
  on the step's bottom panel (timed, never called by the port), host µs a
  call, bytes, operations and bound.  Every ellipse fit, the step programs
  and the mesh step below launch K3: once an iteration, once a replay,
  once a rank's step (its two mode launches); the mesh phase also holds
  the mesh step's gradient against ``mesh=None``'s;
* the ellipse model (phase ``ellipse_eval_kernels``, kernels K4r, K4j, K4g of
  ``qrkit_tpu_torch/ops/csrc/ellipse_eval.cu``: the residuals, the step's
  Jacobian and residuals, the gradient ``Jᵀr̄``, one thread a point) against
  their plain versions at the benchmark's shapes (500,000 points; 100
  problems of 500), fp32 and fp64: bitwise, but for K4g's five sums
  (within rtol of the sum of their terms' magnitudes); one kernel node a
  call (K4g's memset beside it); fp32 times beside the plain versions' and
  the byte bound.  Every ellipse fit runs K4r twice, K4j and K4g once an
  iteration;
* B1's ``b_scale`` / ``stepnorm`` options (phase ``blockdiag_lstsq_options``):
  every option combination against the plain version, every block shape,
  fp32 and fp64, and their time at the 1M-block point;
* block-angular path (phase ``block_angular_main_path``): config 4 on the
  ellipse Jacobian's shape (N blocks of 2×1, A2 2N × 5, uniform(0.5, 5);
  ``examples/bench_block_angular.make_problem``) at N = 100,000 and 500,000,
  fp32, through ``BlockAngularQR``'s fused dense program (compute + solve),
  its fused lane-major program (``compute_solve`` on SoA blocks and a
  transposed A2) and, at N = 100,000, the generic sparse-A2 composition
  (kernel B2 once per compute), each against the port's fp64 CPU result;
* LM ellipse fit (phase ``ellipse_lm``): ``fit_ellipse`` on the device loop
  at N = 100,000 and 500,000 (fp32, ``LMConfig(max_iters=40, ftol=1e-8,
  xtol=1e-8)``): the first fit of each key captures its loop (host reads
  and launches checked: iteration 1 eager, then the fit as one launch),
  warm fits' wall time and device busy share, and ``fit_ellipse_batch`` on
  16 problems of 10,000 points against the solo fits;
* banded-left ellipse step (phase ``ellipse_banded_left``): one
  ``EllipseFitting.damped_step_banded`` at N = 2,000 (kernel B5 on a chain of
  2,000 steps of 4×1 panels; K1 and K2 for its Q products and
  back-substitution) against ``damped_step``, fp64 and fp32, and B5
  against its plain version on that chain;
* bundle adjustment (phase ``bundle``): ``examples/bench_bundle.py``'s scene
  (8 cameras, noise 1e-3, seed 3, its perturbation; ``LMConfig(max_iters=
  40)``), fp32: ``fit_bundle`` (host loop, kernel B2 on the 19×3 point
  blocks every iteration) at 5,000 points and ``fit_bundle_device`` at
  5,000 and 20,000 points (its key's first fit: the capture), each a
  counted fit and a timed one, with rms reprojection, host reads and B2
  launches per iteration, the two loops held to each other by cost; B2
  timed at the 19×3 batch;
* one LM fit as one program (phase ``lm_programs``): ``fit_ellipse`` at
  100,000 and 500,000 points, ``fit_ellipse_batch`` at 16 × 10,000 and
  ``fit_bundle_device`` at 5,000 and 20,000 points, fp32: the eager loop
  (``_program.eager()``), the key's first fit (capture) and a warm fit,
  which must be one graph launch with one host read, no host-issued launch
  and kernel L1 (``csrc/graph_loop.cu``, the conditional WHILE node's
  condition) once before the loop and once an iteration, each bitwise equal
  to the eager fit (x, cost, λ, iterations, converged), L1's log of every
  evaluation against the plain condition, the parameter / rms gates; capture
  seconds, pool bytes, wall ms of eager and captured fits in turns, device
  ms per fit and per iteration, and L1's device time inside the loop; then
  L1 against its plain version on its own (phase ``loop_cond``), timed;
  then L2, a step's marks inside the loop's body (phase ``loop_marks``: a
  warm BAL fit of 12 cameras and 3,000 points under the profiler, the
  marks rising between L1's stamps, three L2 launches an iteration and
  K5's plan an iteration); then K5, the ragged step's R-only tall-skinny
  QR (phase ``tall_qr``: at BAL Venice-52's bottom, 694,814 × 469 fp32,
  against its plain version and a float64 Gram, two calls bitwise, timed
  in turns with the plain version, the TSQR it replaced and
  ``torch.linalg.qr(mode="r")`` beside its bounds; one BAL step read node
  by node, no ``geqrf``; K5's launches in a warm 3-iteration BAL fit);
* ``auto_qr`` and the CLI (phase ``auto_cli``): config 3 and config 2 (10,000
  blocks of 7×2, rows permuted) written as MatrixMarket files and run
  through ``qrkit_tpu_torch.__main__.main`` in this process (fp32,
  ``--rhs-random --export-r``): the selections, the recovery error and the
  kernels of each factorize; ``auto_qr`` on config 3 with 5 dense trailing
  columns (the block-angular split) and a plan saved, loaded and installed
  with ``set_analysis``;
* sparse-operand products (phase ``sparse_apply``): ``SegmentedBandedQR`` on
  config 3 times a sparse operand of 48 columns of 12 nonzeros, both
  directions, against the dense apply of the densified operand; that
  operand as the sparse A2 of ``BlockAngularQR(SegmentedBandedQR,
  DenseColPivQR)``, and the banded-left ellipse stack with a sparse A2 at
  N = 2,000 (B5 once per compute);
* blocked thin QR (phase ``blocked_thin``): ``BlockedThinDenseQR`` on dense
  100,000 × 48 (panel loop) and 100,000 × 256 (the library QR route),
  ``BlockedThinSparseQR`` on a 100,000 × 256 sparse matrix of about 800k
  nonzeros and on a copy with 3 columns replaced by copies of others (rank
  253, residual against the host's fp64 ``lstsq``);
* captured programs (phase ``programs``): each refactorize and solve that
  qrkit_tpu runs as one jitted program is one CUDA graph replay in the port
  (``qrkit_tpu_torch._program``); each such path at full width against the
  same call under ``_program.eager()``: config 2 at 10,000 and 1M × 7×2
  (``BlockDiagonalQR`` compute with B2 and solve with B1,
  ``functional.block_diagonal_lstsq``), config 3 through
  ``SegmentedBandedQR`` (``factorize_values`` with B3, B4 and B5; solve,
  vector and k = 3) and ``BandedBlockedQR`` (B5), the tall-block p2w
  geometry (4,096 blocks of 10×4 overlapping 2, 8 per segment; B3, B4, B5),
  ``DenseHouseholderQR`` / ``DenseColPivQR`` at 24×8 and 20,000×32,
  config 4's fused dense compute and solve at N = 100,000, the functional
  programs (``block_diagonal_factorize``, ``block_angular_lstsq`` with
  K5's plan a call, its graph read node by node: K5's nodes and no
  ``geqrf``, ``lm_damped_step_blockdiag(1)``) at the ellipse's width (100,000 points)
  and config 4's lane-major compute, solve and compute_solve: the first call's
  time (eager), the second's (warm-up + capture) and the capture's, a warm
  call's replays, ATen ops, host-issued launches and host reads (one
  replay, at most 3 ops, none and none), the launches inside a replay (K1
  and K2 in every banded solve's), host µs, wall µs and device time per
  call for replay and eager in turns, the graph pool's bytes, and the
  replay bitwise equal to eager; every kernel must run inside some
  replay;
* sparse-operand recomputes (phase ``sparse_programs``): config 3's
  48-column operand through both banded solvers' sparse Q products, the
  thin sparse compute at 100,000 × 256, config 4's sparse A2 at N =
  100,000 (B2), the banded left at N = 2,000 (B5) and config 3 as a
  segmented left (B3–B5), each captured against eager within the
  reference's pins;
* the banded family's Q products and back-substitutions (phase
  ``banded_programs``): config 3 through ``BandedBlockedQR`` (B5 in the
  refactorize replay) and ``SegmentedBandedQR`` (B3, B4, B5):
  ``apply_qt`` / ``apply_q`` on a vector and on 16 columns and
  ``solve_r``; ``BlockAngularQR``'s generic solve over the banded left
  at N = 2,000 with a sparse A2 (vector, 5 columns, compute + solve) and
  over config 3 as a segmented left with the 48-column A2; each warm call
  one replay with no host read, bitwise equal to eager, K1 in every Q
  product's replay and K2 in every back-substitution's, captured and
  eager in turns, capture seconds and the pool each capture added (gated
  at 3 × its rhs and factor bytes); then ``fit_bundle`` (host loop) at
  P = 5,000, two
  captured fits and one eager, every fit bitwise equal to the first,
  iterations included;
* the launch floor of B1/B2 (phase ``launch_floor``): the device time of a
  kernel that does nothing, launched on B1/B2's grid (the launcher picks it
  by n) at 10,000 × 7×2, 5,000 × 19×3 and 1M × 7×2;
* the mesh paths (phase ``mesh``, last): a one-rank NCCL process group in
  this process (a ``FileStore`` under ``build/``) and ``default_mesh()``;
  every ``mesh=`` path at full width against its ``mesh=None`` result in
  this process, fp32 rtol 1e-4 with atol 1e-5·max|·|, bitwise where both
  routes launch the same kernels on the same data: config 2 at 10,000 and
  1M × 7×2 (``BlockDiagonalQR``, B2 and B1), config 3 (``SegmentedBandedQR``
  compute, solve and ``factorize_values``: B3, B4, B5), config 4 at N =
  100,000 (``BlockAngularQR(BlockDiagonalQR(mesh), TSQRDenseQR(1, mesh),
  mesh)``, B2), the lane-major ellipse step at 100,000 points,
  ``fit_bundle_device`` at 20,000 points and the dry run's four steps
  (``qrkit_tpu_torch.dryrun``, its bundle step at 100,000 points); each
  path timed with and without the mesh in turns (the mesh calls replay
  their captured programs from the second call on); each collective helper
  timed eager and inside a graph; then (``mesh_programs``) every mesh path
  as a captured program at those widths (``dryrun.program_checks``): a warm
  call's replays, ops and host reads, bitwise equal to the eager call, the
  same collectives, wall and stream ms captured against eager, capture
  seconds, and the ``reduce=`` bundle fit at 20,000 points as the chunks
  of its chunked loop, bitwise the eager loop's (B1–B5, L1, K1 and K2
  each launched); the group torn down.

Each phase prints one JSON line per case.  Any failure raises, so the script
exits non-zero without the final line; it also fails when no CUDA device is
visible.  The launch counters are set to 0 right before each main path and
read right after it; launches made to compare a kernel with its plain
version are not counted there.  K1 and K2 launch once a chain scan, so a
path's pin holds each of them to at least one launch where the path runs
the scan, and to none elsewhere; the other kernels are held to their exact
counts.  Bounds are the larger of the bytes a call
must move over 3.35 TB/s and its fp32 operations over 67 TFLOP/s (H100 SXM
at 700 W).  The last lines are the card's name and power limit, the kernel
summary ``{"kernels": [...]}`` (B1–B5, L1, K1, K2, K3) and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import io
import json
import os
import re
import statistics
import tempfile
import subprocess
import sys
import time

import numpy as np
import torch

import qrkit_tpu_torch as qt
from qrkit_tpu_torch import _program, dryrun, functional, lm, profiling
from qrkit_tpu_torch.__main__ import main as cli_main
from qrkit_tpu_torch.examples import bal, bundle, ellipse
from qrkit_tpu_torch.ops import _build
from qrkit_tpu_torch.ops import banded as bk
from qrkit_tpu_torch.ops import blockdiag as bd
from qrkit_tpu_torch.ops import chain_plan
from qrkit_tpu_torch.ops import compact_wy as cw
from qrkit_tpu_torch.ops import graph_loop
from qrkit_tpu_torch.ops import tall_qr
from qrkit_tpu_torch.parallel import tsqr
from qrkit_tpu_torch.solvers import segmented_factorize

SEED = 0
DEVICE = "cuda"
# block shapes with a B1/B2 library: config 2's 7×2, the tests', and the
# bundle point blocks [2C+3, 3] at C = 8 and C = 3
KERNEL_SHAPES = [(7, 2), (2, 1), (3, 3), (8, 8), (16, 4), (19, 3), (9, 3)]
# batch sizes that take every CTA size the block-diagonal launchers pick (32 … 256)
KERNEL_NS = [1, 31, 4225, 10_007, 20_000, 200_003]
BR, BC = 7, 2                       # the flagship block shape (BASELINE.json config 2)
NB_CONFIG2, NB_REAL = 10_000, 1_000_000
RESID_GATE = 1e-4                   # fp32 relative residual gate (bench.py)
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12
SOURCE = "qrkit_tpu_torch/ops/csrc/blockdiag_qr.cu"
BANDED_SOURCE = "qrkit_tpu_torch/ops/csrc/banded_chain.cu"
BLOCKDIAG_KERNELS = ("blockdiag_lstsq", "blockdiag_qr_r")
KERNEL_NAMES = ("blockdiag_lstsq", "blockdiag_qr_r", "banded_segment_chains", "banded_apply_w",
                "banded_chain_qr")  # B1-B5
BANDED_KERNELS = {  # name -> TPU kernel replaced
    "banded_segment_chains": "qrkit_tpu/ops/pallas_banded.py:61",
    "banded_apply_w": "qrkit_tpu/ops/pallas_banded.py:148",
    "banded_chain_qr": "qrkit_tpu/ops/pallas_banded.py:325",
}
CHAIN_SOURCE = "qrkit_tpu_torch/ops/csrc/chain_apply.cu"
SCAN_KERNELS = {  # K1, K2: name -> the reference's lax.scan the kernel replaces
    "chain_two_seg": "none: lax.scan _apply_two_seg(_cols), qrkit_tpu/ops/compact_wy.py:185",
    "chain_solve": "none: lax.scan _banded_solve_chunk, qrkit_tpu/solvers/banded_blocked.py:238",
}
K1, K2 = SCAN_KERNELS
# BASELINE.json config 3 (examples/bench_banded.py config3)
C3_NB, C3_BR, C3_BC, C3_OV = 2499, 40, 8, 4
C3_SEGMENT_BLOCKS = 32
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


def launches_ok(counts, want, scans=()):
    """A path's launch pin: every kernel of ``want`` exactly, every kernel
    of ``scans`` (K1 / K2, one launch a chain scan: their number follows
    the path's chains and calls) at least once, every other kernel none."""
    names = set(counts) | set(want) | set(scans)
    return all(counts.get(n, 0) >= 1 if n in scans else counts.get(n, 0) == want.get(n, 0)
               for n in names)


def pin_text(want, scans=()):
    return f"{want} and {list(scans)} at least once" if scans else f"{want}"


def factorize_scans(solver):
    """K1's launches in one refactorize: the segmented solver's phase-2
    slabs of the segments B4 does not take (all of them off B4's route),
    one launch; none in the plain chain's."""
    if isinstance(solver, qt.SegmentedBandedQR) and solver._delegate is None:
        fused = solver._fac_kernel and solver._p2w is not None
        return {K1: int(not fused or solver._p2w["excl"].numel() > 0)}
    return {}


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes moved over the HBM rate and the fp32 operations over the
    fp32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def qr_flops(m, n):
    """Operations of an unblocked Householder QR of an m×n panel (m ≥ n;
    otherwise of its leading m columns): 2mn² − 2n³/3."""
    k = min(m, n)
    return 2 * m * n * k - 2 * k ** 3 / 3


def tolerance(dtype):
    """(rtol, atol relative to max|reference|) for kernel vs plain."""
    return (1e-10, 0.0) if dtype == torch.float64 else (1e-4, 1e-5)


def compare(out, ref, dtype, tol=None):
    """Worst errors of out against ref; raises if outside the tolerance
    (``tol``: (rtol, atol relative to max|reference|), default
    :func:`tolerance`)."""
    rtol, atol_rel = tol if tol is not None else tolerance(dtype)
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
    """One nvcc per library, all started together: the block-diagonal
    library of each block shape, the single banded library, which takes
    every banded shape (config 3's and the tests') as kernel arguments, the
    chain-scan library (K1, K2, every shape too), the graph-loop library
    the damped-step library (K3) of each step shape, the ellipse model's
    library (K4) and the tall-skinny QR's (K5)."""
    t0 = time.perf_counter()
    jobs = [lambda s=s: _build.build(*s) for s in KERNEL_SHAPES]
    jobs.append(lambda: _build.build_source(_build.BANDED_SOURCE))
    jobs.append(lambda: _build.build_source(_build.CHAIN_SOURCE))
    jobs.append(lambda: _build.build_source(_build.GRAPH_LOOP_SOURCE))
    jobs += [lambda s=s: _build.build_lm_step(*s) for s in LM_STEP_SHAPES]
    jobs.append(lambda: _build.build_source(_build.ELLIPSE_SOURCE))
    jobs.append(lambda: _build.build_source(_build.TALL_QR_SOURCE))
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        paths = [f.result() for f in [pool.submit(job) for job in jobs]]
    for br, bc in KERNEL_SHAPES:
        _build.load(br, bc)
    _build.load_banded()
    _build.load_chain()
    for shape in LM_STEP_SHAPES:
        _build.load_lm_step(*shape)
    _build.load_ellipse_eval()
    _build.load_tall_qr()
    driver, runtime = graph_loop.versions()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "nvcc": _build.find_nvcc(), "flags": list(_build.NVCC_FLAGS),
        "libraries": [p.name for p in paths],
    })
    # conditional WHILE graph nodes (the captured LM loop) need 12.3 in both
    emit({"phase": "cuda_versions", "driver": driver, "toolkit": runtime,
          "torch_cuda": torch.version.cuda})
    if min(driver, runtime) < 12030:
        raise AssertionError(f"CUDA driver {driver} / toolkit {runtime}: conditional WHILE nodes need 12030")


def phase_kernel_vs_plain(rng):
    """B1 and B2 against their plain versions, every shape, fp32 and fp64,
    every batch of ``KERNEL_NS``: bitwise equal, or the phase fails."""
    worst = {}
    for name in KERNELS:
        for br, bc in KERNEL_SHAPES:
            for dtype in (torch.float32, torch.float64):
                max_abs = 0.0
                for n in KERNEL_NS:
                    a, b = soa_operands(rng, n, br, bc, dtype, DEVICE)
                    out = run_kernel(name, a, b, br)
                    torch.cuda.synchronize()
                    e, eq = compare(out, run_plain(name, a, b, br), dtype)
                    if not eq:  # built with --fmad=false, summing in the plain version's order
                        raise AssertionError(f"{name} {br}x{bc} {dtype} n={n}: not bitwise equal "
                                             f"to its plain version (max_abs_err={e})")
                    max_abs = max(max_abs, e)
                rtol, atol_rel = tolerance(dtype)
                emit({
                    "phase": "kernel_vs_plain", "kernel": name, "shape": [br, bc],
                    "dtype": str(dtype).split(".")[1], "ns": KERNEL_NS,
                    "max_abs_err": max_abs, "bitwise_equal": True,
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
    if any(counts[name] for name in BANDED_KERNELS):
        raise AssertionError(f"{label}: the block-diagonal path launched banded kernels {counts}")
    blockdiag = lambda c: {name: c[name] for name in BLOCKDIAG_KERNELS}  # noqa: E731
    if expect_kernels:
        want_compute = {"blockdiag_lstsq": 0, "blockdiag_qr_r": 1}
        want = {"blockdiag_lstsq": 1, "blockdiag_qr_r": 1}
        if (
            not qr._kernel_mode
            or blockdiag(after_compute) != want_compute
            or blockdiag(counts) != want
        ):
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


def time_pair(name, a, b, br, nbytes, flops, library, smi, shape=(BR, BC)):
    """Kernel, plain version and the yardstick library call (``library()``,
    one PyTorch call computing the same function on the AoS batch; timed,
    never called by the port) in turns (kernel, plain, library, library,
    plain, kernel), each round CUDA events per call, median of 50 after 10
    warm-ups; each reported time is the mean of its two rounds' medians.
    The line also says whether the kernel is within twice its bound."""
    rounds = {"kernel": [], "plain": [], "library": []}
    calls = {"kernel": lambda: run_kernel(name, a, b, br), "plain": lambda: run_plain(name, a, b, br),
             "library": library}
    spin(calls["kernel"], 0.25)  # the card at its clocks before the rounds
    for key in ("kernel", "plain", "library", "library", "plain", "kernel"):
        rounds[key].append(profiling.cuda_time_ms(calls[key]))
    ms, plain_ms, library_ms = (statistics.mean(rounds[k]) for k in ("kernel", "plain", "library"))
    device_ms = device_time_ms(calls["kernel"], one_kernel=True)
    library_device_ms = device_time_ms(library)
    out = run_kernel(name, a, b, br)
    ref = run_plain(name, a, b, br)
    torch.cuda.synchronize()
    max_abs, bitwise = compare(out, ref, a.dtype)
    bound_ms, bound_by = bound(nbytes, flops)
    emit({
        "phase": "timing", "kernel": name, "n": a.shape[1], "shape": list(shape),
        "dtype": "float32", "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "ms_rounds": rounds["kernel"], "plain_ms_rounds": rounds["plain"],
        "library_ms_rounds": rounds["library"],
        "gbps": nbytes / (ms * 1e-3) / 1e9, "plain_gbps": nbytes / (plain_ms * 1e-3) / 1e9,
        "device_ms": device_ms, "library_device_ms": library_device_ms,
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
        "device_within_twice_bound": device_ms <= 2 * bound_ms,
        "max_abs_err": max_abs, "bitwise_equal": bitwise,
        "method": "0.25 s of kernel calls first; CUDA events per call, 10 warm-up, median "
                  "of 50, synchronize before reading; rounds kernel, plain, library, library, "
                  "plain, kernel; mean of round medians; device_ms: torch.profiler's mean "
                  "kernel duration over the records it kept of 20 calls; library_device_ms: its "
                  "device time of 20 calls (every kernel the call launches) over 20",
        "gpu": smi,
    })
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "max_abs_err": max_abs,
            "bound_ms": bound_ms, "bound_by": bound_by, "device_ms": device_ms}


def spin(fn, seconds):
    """Call ``fn`` back to back for ``seconds`` of wall time (synchronized)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()


PROFILER_ATTEMPTS = 3


def device_time_ms(fn, reps=20, with_events=False, one_kernel=False):
    """Device time of one ``fn()`` under torch.profiler: the kernels' time
    of ``reps`` calls over ``reps`` (the host's launch time excluded), or,
    for an ``fn`` that launches ``one_kernel``, the mean over the kernel
    records the profiler kept: it keeps only some of them (10–17 of 20
    seen, and sometimes none), so a sum over ``reps`` would read low.  A
    profile that kept no record is taken again, up to ``PROFILER_ATTEMPTS``
    times; after that the CUDA-event time stands in (it includes the
    wrapper's host time) and a ``profiler_fallback`` line says so.
    ``with_events``: also return the CUDA-event time of the same ``reps``
    back-to-back calls over ``reps``, a check on the profiler (the two agree
    when the kernels, not their launches, fill the stream)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        events_ms = start.elapsed_time(end) / reps
        ms, records = device_kernels(prof)
        if records > reps and one_kernel:
            raise AssertionError(f"device_time_ms: {records} kernel records for {reps} one-kernel calls")
        if records:
            device_ms = ms / records if one_kernel else ms / reps
            break
    else:
        emit({"phase": "profiler_fallback", "attempts": PROFILER_ATTEMPTS, "reps": reps,
              "events_ms": events_ms, "note": "torch.profiler kept no kernel record; the CUDA-event "
              "time (with the host's launch time) stands for the device time"})
        device_ms = events_ms
    return (device_ms, events_ms) if with_events else device_ms


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
        # the yardsticks' AoS operands [n, 7, 2] and [n, 7, 1]
        a_aos = a.T.reshape(n, BR, BC).contiguous()
        b_aos = bs.T.reshape(n, BR, 1).contiguous()
        lstsq_bytes = (BR * BC + BR + BC) * n * 4
        qr_bytes = (BR * BC + ntri) * n * 4
        qr_ops = qr_flops(BR, BC) * n
        results["blockdiag_lstsq"].append(time_pair(
            "blockdiag_lstsq", a, bs, BR, lstsq_bytes, qr_ops + (4 * BR * BC + BC * BC) * n,
            lambda: torch.linalg.lstsq(a_aos, b_aos).solution, smi))
        results["blockdiag_qr_r"].append(time_pair(
            "blockdiag_qr_r", a, bs, BR, qr_bytes, qr_ops,
            lambda: torch.linalg.qr(a_aos, mode="r").R, smi))
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


BANDED_TOL64 = (1e-10, 1e-12)  # fp64: rtol, atol relative to max|reference|


def banded_tolerance(dtype):
    """Kernel vs plain for the banded kernels: fp64 rtol 1e-10 with atol
    1e-12·max|·| (their reductions add in another order, so entries that
    cancel to roundoff differ by roundoff); fp32 as :func:`tolerance`."""
    return BANDED_TOL64 if dtype == torch.float64 else tolerance(dtype)


def banded_matrix(rng, nb, br, bc, ov):
    """Row-sorted banded matrix: nb blocks of br×bc overlapping ov columns,
    uniform(0.5, 5) values (examples/bench_banded.py's layout)."""
    step = bc - ov
    ncols = step * nb + ov
    i, r, c = np.meshgrid(np.arange(nb), np.arange(br), np.arange(bc), indexing="ij")
    rows, cols = (i * br + r).ravel(), (i * step + c).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return qt.SparseCSR.from_triplets(rows[keep], cols[keep], vals[keep], (br * nb, ncols))


def chain_cost(panels, act, mca, me):
    """(serial steps, bytes, operations) of a chain kernel (B3/B5) call:
    panels and act read once, Y, τ and R rows written once; a panel QR and
    the carry add per active step."""
    *lead, ma, mc = panels.shape
    n = panels.numel() // (ma * mc)
    nbytes = panels.element_size() * (2 * n * ma * mc + n + n * mc + n * me * mc)
    active = int((act > 0.5).sum())
    return lead[-1], nbytes, active * (qr_flops(ma, mc) + mca * mc)


def apply_w_cost(y, tau, w, ab):
    """(serial steps, bytes, operations) of a W-apply (B4) call: Y, τ, the
    fed rows and the window starts read once, the window rows written once;
    per reflector with τ ≠ 0 a dot product and an update over the window
    rows of every operand column."""
    S, L, ma, mc = y.shape
    ko = w.shape[3]
    nbytes = y.element_size() * (y.numel() + tau.numel() + 2 * w.numel()) + ab.numel() * 4
    return L, nbytes, int((tau != 0).sum()) * 4 * ma * ko


def banded_operands(rng, mat, L, suggested, dtype):
    """Each banded kernel's operands at the shapes the main path gives it on
    ``mat``: B3's gathered panels and B4's fed window rows from the
    segmented plan (B4's Y and τ from B3's plain version), B5's panels from
    the plain chain's plan, and random panels at the boundary chain's shape.
    Returns {kernel: [(case, kernel call, plain call, (serial steps, bytes,
    operations))]}."""
    seg = qt.SegmentedBandedQR(suggested, L, use_kernel=False, device=DEVICE, dtype=dtype)
    seg.analyze_pattern(mat)
    seg._layout_maps(mat, mat)
    vals = torch.as_tensor(mat.data, dtype=dtype, device=DEVICE)
    pad = torch.cat([vals, vals.new_zeros(1)])
    kw = seg._kw
    ci, ci0_rest = seg._kernel_ci
    panels = pad[seg._panel_gmap]
    b3 = dict(mca=kw["max_carry"], me=kw["max_emit"], ci=ci, ci0_rest=ci0_rest)
    y, tau, _ = bk._segment_chains_plain(panels, seg._kernel_act, **b3)
    st = seg._p2w["statics"]
    w = segmented_factorize.p2w_window_rows(seg, pad[seg._slab_gmap])
    b4 = dict(mca=st["mca"], h=st["h"], wrows=st["wrows"])
    ab = seg._p2w["ab"]
    nbc = len(seg._chain_geom["ncols"])
    ckw = seg._chain_kw
    bpan = torch.as_tensor(
        rng.uniform(0.5, 5.0, size=(nbc, ckw["max_active"], ckw["max_cols"])), dtype=dtype,
        device=DEVICE,
    )
    bact = torch.ones(nbc, dtype=dtype, device=DEVICE)
    plain = qt.BandedBlockedQR(suggested_block_cols=suggested, use_kernel=False, device=DEVICE, dtype=dtype)
    plain.analyze_pattern(mat)
    plain._layout_maps(mat, mat)
    ppan = pad[plain._panel_gmap]
    pkw, skw = plain._chain_kernel, seg._chain_kernel
    return {
        "banded_segment_chains": [(
            "segment_chains", lambda: bk.segment_chains(panels, seg._kernel_act, **b3),
            lambda: bk._segment_chains_plain(panels, seg._kernel_act, **b3),
            chain_cost(panels, seg._kernel_act, b3["mca"], b3["me"]),
        )],
        "banded_apply_w": [(
            "segment_apply_w", lambda: bk.segment_apply_w(y, tau, w, ab, **b4),
            lambda: bk._segment_apply_w_plain(y, tau, w, ab, **b4),
            apply_w_cost(y, tau, w, ab),
        )],
        "banded_chain_qr": [
            ("plain_chain", lambda: bk.chain_qr(ppan, plain._chain_act, **pkw),
             lambda: bk._chain_qr_plain(ppan, plain._chain_act, **pkw),
             chain_cost(ppan, plain._chain_act, pkw["mca"], pkw["me"])),
            ("boundary_chain", lambda: bk.chain_qr(bpan, bact, **skw),
             lambda: bk._chain_qr_plain(bpan, bact, **skw),
             chain_cost(bpan, bact, skw["mca"], skw["me"])),
        ],
    }, dict(
        segment_chains=list(panels.shape), segment_apply_w=list(w.shape), plain_chain=list(ppan.shape),
        boundary_chain=list(bpan.shape),
    )


def compare_outputs(out, ref, dtype):
    """compare() over every output of a kernel; (worst abs error, bitwise)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    worst, bitwise = 0.0, True
    for o, r in zip(outs, refs):
        e, eq = compare(o, r, dtype, banded_tolerance(dtype))
        worst, bitwise = max(worst, e), bitwise and eq
    return worst, bitwise


BANDED_SHAPES = {  # label -> (nb, br, bc, ov, segment_blocks, suggested_block_cols)
    "small_64x10x4": (64, 10, 4, 2, 8, 4),
    "config3": (C3_NB, C3_BR, C3_BC, C3_OV, C3_SEGMENT_BLOCKS, C3_BC),
}


def phase_banded_kernel_vs_plain(rng):
    """B3, B4, B5 against their plain versions at a small shape and at the
    config-3 shapes, fp32 and fp64.  Returns {kernel: worst error at the
    config-3 shapes in fp32} and the fp32 config-3 operands for timing."""
    worst, c3_ops = {}, None
    for label, (nb, br, bc, ov, L, sug) in BANDED_SHAPES.items():
        mat = banded_matrix(rng, nb, br, bc, ov)
        for dtype in (torch.float32, torch.float64):
            ops, shapes = banded_operands(rng, mat, L, sug, dtype)
            if label == "config3" and dtype == torch.float32:
                c3_ops = ops
            for name, cases in ops.items():
                for case, run_k, run_p, _ in cases:
                    out = run_k()
                    torch.cuda.synchronize()
                    err, bitwise = compare_outputs(out, run_p(), dtype)
                    rtol, atol_rel = banded_tolerance(dtype)
                    emit({
                        "phase": "banded_kernel_vs_plain", "kernel": name, "case": case,
                        "shape": label, "operand_shape": shapes[case],
                        "dtype": str(dtype).split(".")[1], "max_abs_err": err,
                        "bitwise_equal": bitwise, "rtol": rtol, "atol_x_max_abs": atol_rel,
                    })
                    if label == "config3" and dtype == torch.float32:
                        worst[name] = max(worst.get(name, 0.0), err)
    return worst, c3_ops


def host_residual_sparse(mat, x, b_np):
    """fp64 relative residual ‖Ax − b‖/‖b‖ on the host, A sparse."""
    xh = x.detach().cpu().double().numpy()
    return float(np.linalg.norm(mat.matvec(xh) - b_np) / np.linalg.norm(b_np))


def drive_banded(label, solver, mat, b_np, want, values=None):
    """compute (or factorize_values) + solve with the counters read right
    before and after: ``want`` is the launches the factorize must make
    (with :func:`factorize_scans`' K1), the solve launches K1 and K2 (its
    Q products and back-substitutions) and nothing else; info(), the
    solution's shape and finiteness and the fp32 residual gate are
    checked."""
    b = torch.as_tensor(b_np, dtype=torch.float32, device=DEVICE)
    profiling.reset_launch_counts()
    t0 = time.perf_counter()
    if values is None:
        solver.compute(mat)
    else:
        solver.factorize_values(values)
    after_compute = profiling.launch_counts()
    x = solver.solve(b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = profiling.launch_counts()
    info = solver.info()
    if info != qt.ComputationInfo.SUCCESS:
        raise AssertionError(f"{label}: info() = {info}")
    if tuple(x.shape) != (mat.ncols,) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{label}: solution shape {tuple(x.shape)} or non-finite values")
    resid = host_residual_sparse(mat, x, b_np)
    if not resid < RESID_GATE:
        raise AssertionError(f"{label}: fp32 relative residual {resid} >= {RESID_GATE}")
    fac_want = {**want, **factorize_scans(solver)}
    solve_counts = {name: counts[name] - after_compute[name] for name in counts}
    if not (launches_ok(after_compute, fac_want) and launches_ok(solve_counts, {}, SCAN_KERNELS)):
        raise AssertionError(
            f"{label}: launches after the factorize {after_compute} (want {fac_want}), "
            f"by the solve {solve_counts} (want K1 and K2, nothing else)"
        )
    emit({
        "phase": "banded_main_path", "case": label, "shape": [mat.nrows, mat.ncols],
        "nnz": mat.nnz, "rel_residual": resid, "info": info.name, "launches": counts,
        "wall_s_incl_first_use": seconds,
    })
    return counts


def wall_ms(step, reps):
    """Median host wall time of ``step()`` (ending in synchronize), after
    one warm-up step."""
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def phase_banded_main_path(rng, smi):
    """Config 3 through SegmentedBandedQR (compute + solve, then
    factorize_values on device values + solve) and BandedBlockedQR (compute
    + solve), fp32 on the card; then the wall time of compute + solve."""
    mat = banded_matrix(rng, C3_NB, C3_BR, C3_BC, C3_OV)
    x_true = rng.normal(size=mat.ncols)
    b_np = mat.matvec(x_true)
    seg = qt.SegmentedBandedQR(
        suggested_block_cols=C3_BC, segment_blocks=C3_SEGMENT_BLOCKS, device=DEVICE,
        dtype=torch.float32,
    )
    plain = qt.BandedBlockedQR(suggested_block_cols=C3_BC, device=DEVICE, dtype=torch.float32)
    want_seg = {name: 1 for name in BANDED_KERNELS}
    total = {name: 0 for name in profiling.launch_counts()}
    runs = [("config3_segmented_compute", seg, mat, b_np, want_seg, None)]
    scale = 0.5
    scaled = qt.SparseCSR(mat.shape, mat.indptr, mat.indices, mat.data * scale)
    device_values = torch.as_tensor(scaled.data, dtype=torch.float32, device=DEVICE)
    runs.append(("config3_segmented_factorize_values", seg, scaled, b_np * scale, want_seg, device_values))
    runs.append(("config3_plain_compute", plain, mat, b_np, {"banded_chain_qr": 1}, None))
    for label, solver, m, b, want, values in runs:
        counts = drive_banded(label, solver, m, b, want, values)
        for name in total:
            total[name] += counts[name]
    if not (seg._fac_kernel and plain._fac_kernel and seg._p2w is not None and seg._chain_kernel):
        raise AssertionError("config 3 did not take every banded kernel gate")
    b = torch.as_tensor(b_np, dtype=torch.float32, device=DEVICE)
    wall = {}
    for label, solver, reps in (("segmented", seg, 20), ("plain", plain, 3)):
        ms, times = wall_ms(lambda: (solver.compute(mat), solver.solve(b)), reps)
        wall[label] = ms
        emit({
            "phase": "banded_wall_time", "solver": label, "ms": ms, "times_ms": times,
            "method": f"host wall time of compute + solve ending in synchronize, one "
                      f"warm-up, median of {reps}", "gpu": smi,
        })
    return total, wall


def ellipse_chain_case():
    """B5's timing case on the banded ellipse stack's 2,000-step 4×1 chain
    (fp32), in the form of :func:`banded_operands`' cases."""
    f = ellipse.EllipseFitting(
        ellipse.ellipse_points(ellipse.Ellipse(*ELLIPSE_TRUTH), BANDED_LEFT_N),
        dtype=torch.float32, device=DEVICE,
    )
    epan, eact, ekw = banded_left_chain(f, 1e-3)
    return (
        "ellipse_4x1_chain", lambda: bk.chain_qr(epan, eact, **ekw),
        lambda: bk._chain_qr_plain(epan, eact, **ekw), chain_cost(epan, eact, ekw["mca"], ekw["me"]),
    )


BANDED_KERNEL_METHOD = (
    "ms: CUDA events per call, 10 warm-up, median of 50, synchronize before reading (includes "
    "the wrapper's host time when that exceeds the kernel's); device_ms: torch.profiler's "
    "mean kernel duration over 20 calls (the records it kept); profiled_events_ms: CUDA "
    "events around those 20 back-to-back calls over 20"
)


def time_banded_kernel(run_k):
    """(ms, device_ms, profiled_events_ms) of one banded kernel call: CUDA
    events per call, torch.profiler's device time (the host's launch time
    excluded) and the events around the profiled calls."""
    return (profiling.cuda_time_ms(run_k, warmup=10, reps=50),
            *device_time_ms(run_k, with_events=True, one_kernel=True))


def phase_banded_timing(ops, smi):
    """Kernel against plain at the config-3 shapes and on the banded
    ellipse stack's 2,000-step 4×1 chain (fp32) with CUDA events, in turns
    kernel, plain, plain, kernel; the kernels 10 warm-ups and a median of 50
    per round, the plain versions 1 warm-up and a median of 3; then the
    kernel's device time under torch.profiler.  Each line has the time per
    serial step, the bytes and operations of the call and its bound."""
    ops["banded_chain_qr"].append(ellipse_chain_case())
    results = {}
    for name, cases in ops.items():
        for case, run_k, run_p, (steps, nbytes, flops) in cases:
            k_rounds, p_rounds, device_ms, profiled_ms = [], [], None, None
            for rounds in (k_rounds, p_rounds, p_rounds, k_rounds):
                if rounds is k_rounds:
                    ms, device_ms, profiled_ms = time_banded_kernel(run_k)
                    rounds.append(ms)
                else:
                    rounds.append(profiling.cuda_time_ms(run_p, warmup=1, reps=3))
            ms, plain_ms = statistics.mean(k_rounds), statistics.mean(p_rounds)
            bound_ms, bound_by = bound(nbytes, flops)
            emit({
                "phase": "banded_timing", "kernel": name, "case": case, "dtype": "float32",
                "ms": ms, "plain_ms": plain_ms, "ms_rounds": k_rounds, "plain_ms_rounds": p_rounds,
                "device_ms": device_ms, "profiled_events_ms": profiled_ms, "steps": steps, "per_step_us": ms * 1e3 / steps,
                "device_per_step_us": device_ms * 1e3 / steps, "bytes": nbytes, "flops": flops,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "method": BANDED_KERNEL_METHOD + "; rounds kernel, plain, plain, kernel, plain 1 "
                          "warm-up + median of 3; mean of round medians; device_ms of the last "
                          "kernel round",
                "gpu": smi,
            })
            # the first case is the main path's
            results.setdefault(name, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                      "bound_by": bound_by, "device_ms": device_ms})
    return results


# --- the chain scans K1 and K2 against their plain versions ---------------------------
CHAIN_COLS = (1, 16, 48)  # config 3's vector, matrix rhs and sparse-product slab
ELLIPSE_CHAIN_COLS = (1, 5)  # the banded ellipse stack's vector and 5-column A2
CHAIN_FORM_ROUNDS = ("one_chunk", "chunked", "chunked", "one_chunk")
CHAIN_TIMING_METHOD = (
    "ms: CUDA events around each eager wrapper call (its padded-operand copy or zeroed output, "
    "its scratch and its launches), 3 warm-up + median of 20; graph_ms: one CUDA graph of 10 "
    "calls replayed, events over the replay / 10 (the kernels back to back, no host); device_ms: "
    "torch.profiler's kernel time over 10 eager calls / 10, by kernel name in device_kernels_ms; "
    "rounds one-chunk, chunked, chunked, one-chunk, means of the round values; plain version "
    "(the headline cases) 1 warm-up + median of 3, in turns with the chunked form"
)
CHAIN_SWEEP = (8, 12, 16, 24, 32, 48)  # chunk lengths timed on config 3's plain chain


def chain_operands(c3, left_sp, dtype):
    """K1's and K2's operands on the chains the main paths build, in the
    solvers' own factors and with their chunk plans: config 3 through
    ``BandedBlockedQR`` (one chain of 2,499 steps, 48×8 panels) and
    ``SegmentedBandedQR`` (79 segments of 32 steps, 48×8; its boundary
    chain, 12 steps of 88×32; both one chunk) and the banded ellipse stack's
    left at N = 2,000 (2,000 steps of 4×1).  Returns [(label, K1 (Y, T, s1,
    s2, split, h1, m), K2 (R panels, cols, emit_rows, ncols, active,
    max_emit, max_cols, n), plans (Qᵀ, Q, solve; None: one chunk), operand
    columns)]."""
    def one(seq):
        return seq.Y[None], seq.T[None], seq.s1[None], seq.s2[None], seq.split[None], seq.h1, seq.m

    def chain_solve(r, g, me, mc, n):
        act = torch.ones((1, r.shape[0]), dtype=torch.bool, device=DEVICE)
        return r[None], g["cols"][None], g["emit_rows"][None], g["ncols"][None], act, me, mc, n

    def plans(solver):
        p = solver._chain_plans
        return p["qt"], p["q"], p["solve"]

    plain = qt.BandedBlockedQR(suggested_block_cols=C3_BC, device=DEVICE, dtype=dtype).compute(c3)
    seg = qt.SegmentedBandedQR(suggested_block_cols=C3_BC, segment_blocks=C3_SEGMENT_BLOCKS,
                               device=DEVICE, dtype=dtype).compute(c3)
    ell = qt.BandedBlockedQR(3, 1, 0, 1, device=DEVICE, dtype=dtype).compute(left_sp)
    kw, ckw = seg._kw, seg._chain_kw
    return [
        ("config3_plain_chain", one(plain.q_seq),
         chain_solve(plain._r_panels, plain._geom_dev, plain._max_emit, plain._max_cols, plain.cols),
         plans(plain), CHAIN_COLS),
        ("config3_segments",
         (seg._Yws, seg._Ts, seg._starts, seg._rows2d, seg._carry2d, kw["max_carry"],
          seg._max_seg_rows),
         (seg._r_panels, seg._starts, seg._emit_d, seg._ncols_d, seg._active_d, seg._max_emit,
          seg._max_cols, seg._nloc_max), (None, None, None), CHAIN_COLS),
        ("config3_boundary_chain", one(seg._chain_seq),
         chain_solve(seg._chain_r, seg._chain_geom_dev, ckw["max_emit"], ckw["max_cols"], seg._m2),
         plans(seg), CHAIN_COLS),
        (f"ellipse_banded_left_{BANDED_LEFT_N}", one(ell.q_seq),
         chain_solve(ell._r_panels, ell._geom_dev, ell._max_emit, ell._max_cols, ell.cols),
         plans(ell), ELLIPSE_CHAIN_COLS),
    ]


def two_seg_cost(Y, T, M):
    """(serial steps, bytes, operations) of a K1 call: Y, T and the three
    index arrays read once, the operand read and written once; Yᵀw, T'u and
    Yz per column of every step whose T is not zero (a padded step is a
    no-op)."""
    B, n, A, C = Y.shape
    k = M.shape[2]
    nbytes = Y.element_size() * (Y.numel() + T.numel() + 2 * M.numel()) + 3 * 8 * B * n
    live = int((T.reshape(B, n, -1) != 0).any(-1).sum())
    return n, nbytes, live * (4 * A * C + 2 * C * C) * k


def solve_chunk_cost(ypad, r, cols, emit, ncols, active, me, mc):
    """(serial steps, bytes, operations) of a K2 call: the R panels' first
    me rows, the index arrays and y read once, x written once; per column of
    an active step the overlap product over its er rows and nc - er
    columns and the er × er triangular solve."""
    k = ypad.shape[2]
    er = emit.clamp(max=me).cpu().numpy()
    over = np.maximum(ncols.clamp(max=mc).cpu().numpy() - er, 0)
    act = active.cpu().numpy()
    flops = int((act * (2 * er * over + er * er)).sum()) * k
    B, L = cols.shape
    nbytes = ypad.element_size() * (B * L * me * mc + 2 * ypad.numel()) + B * L * (3 * 8 + 1)
    return L, nbytes, flops


def kernel_device_ms(fn, part, reps=10):
    """torch.profiler's kernel time of ``reps`` calls of ``fn`` over
    ``reps``, summed over the kernels whose name holds one of ``part``'s
    strings, and by kernel name: ``(ms, {name: ms}, records)`` (ms None if
    it kept no record after ``PROFILER_ATTEMPTS`` profiles)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, records = {}, 0
        for e in prof.key_averages():
            name = next((p for p in part if p in e.key), None)
            if e.device_type == DeviceType.CUDA and name is not None:
                by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
                records += e.count
        if records:
            return sum(by_name.values()), by_name, records
    return None, {}, 0


def time_kernel_plain(run_k, run_p):
    """(kernel ms, plain ms, rounds): CUDA events per call in turns kernel,
    plain, plain, kernel (kernel 3 warm-up + median of 20, plain 1 warm-up
    + median of 3)."""
    rounds = {"kernel": [], "plain": []}
    for kind in ("kernel", "plain", "plain", "kernel"):
        if kind == "kernel":
            rounds[kind].append(profiling.cuda_time_ms(run_k, warmup=3, reps=20))
        else:
            rounds[kind].append(profiling.cuda_time_ms(run_p, warmup=1, reps=3))
    return statistics.mean(rounds["kernel"]), statistics.mean(rounds["plain"]), rounds


def graph_ms(fn, calls=10, reps=5):
    """Device time of one ``fn()`` as a captured program: a CUDA graph of
    ``calls`` calls, replayed ``reps`` times between CUDA events; the median
    replay over ``calls`` (the kernels back to back, no host time)."""
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


def time_forms(forms, parts):
    """``forms``: {"one_chunk": fn, "chunked": fn} (the second may be
    absent); each timed in turns :data:`CHAIN_FORM_ROUNDS` by CUDA events
    per eager call and by a replayed graph, then its profiler device time
    (``parts``: {form: kernel name parts})."""
    rounds = {f: {"ms": [], "graph_ms": []} for f in forms}
    for f in CHAIN_FORM_ROUNDS:
        if f in forms:
            rounds[f]["ms"].append(profiling.cuda_time_ms(forms[f], warmup=3, reps=20))
            rounds[f]["graph_ms"].append(graph_ms(forms[f]))
    out = {}
    for f, fn in forms.items():
        dev, by_name, records = kernel_device_ms(fn, parts[f])
        out[f] = {"ms": statistics.mean(rounds[f]["ms"]),
                  "graph_ms": statistics.mean(rounds[f]["graph_ms"]), "device_ms": dev,
                  "device_kernels_ms": by_name, "device_records_per_call": records / 10,
                  "rounds": rounds[f]}
    return out


def r_dense_square(qr):
    """The plain chain's R as a dense ``n × n`` upper-triangular matrix on
    the card, from its panels (each row owned by one block)."""
    g = qr.geom
    panels = qr._r_panels
    nb, me, mc = panels.shape
    r = np.arange(me)[None, :, None]
    c = np.arange(mc)[None, None, :]
    keep = (r < g["emit_rows"][:, None, None]) & (c < g["ncols"][:, None, None])
    blk = np.broadcast_to(np.arange(nb)[:, None, None], keep.shape)[keep]
    rows = np.broadcast_to(g["cols"][:, None, None] + r, keep.shape)[keep]
    cols = np.broadcast_to(g["cols"][:, None, None] + c, keep.shape)[keep]
    rr = np.broadcast_to(r, keep.shape)[keep]
    cc = np.broadcast_to(c, keep.shape)[keep]
    R = panels.new_zeros((qr.cols, qr.cols))
    idx = lambda a: torch.as_tensor(a, device=DEVICE)  # noqa: E731
    R[idx(rows), idx(cols)] = panels[idx(blk), idx(rr), idx(cc)]
    return torch.triu(R)


def chain_library(c3, smi):
    """K2's yardstick, timed and never used by the port: one PyTorch call
    that solves config 3's R x = y, fp32, the dense
    ``torch.linalg.solve_triangular`` on R as a 10,000 × 10,000 matrix, and
    ``torch.triangular_solve`` on R in sparse CSR where the installed
    PyTorch takes it; both against K2 on the same R.  Returns (library ms,
    the call)."""
    qr = qt.BandedBlockedQR(suggested_block_cols=C3_BC, device=DEVICE, dtype=torch.float32).compute(c3)
    R = r_dense_square(qr)
    y = torch.as_tensor(np.random.default_rng(SEED + 14).normal(size=(qr.cols, 1)),
                        dtype=torch.float32, device=DEVICE)
    x = qr.solve_r(y)
    calls = {"torch.linalg.solve_triangular(dense R)":
             lambda: torch.linalg.solve_triangular(R, y, upper=True)}
    try:
        Rs = R.to_sparse_csr()
        torch.triangular_solve(y, Rs, upper=True)
        calls["torch.triangular_solve(sparse CSR R)"] = lambda: torch.triangular_solve(y, Rs, upper=True)[0]
        sparse_note = None
    except (RuntimeError, NotImplementedError) as err:
        sparse_note = f"{type(err).__name__}: {str(err).splitlines()[0][:200]}"
    results = {}
    for name, call in calls.items():
        diff = float((call() - x).abs().max())
        results[name] = {"ms": profiling.cuda_time_ms(call, warmup=2, reps=10),
                         "max_abs_diff_vs_k2": diff, "max_abs_x": float(x.abs().max())}
    k2_ms = profiling.cuda_time_ms(lambda: qr.solve_r(y), warmup=3, reps=20)
    name = min(results, key=lambda n: results[n]["ms"])
    emit({"phase": "chain_library", "kernel": K2, "n": qr.cols, "calls": results,
          "sparse_csr_refused": sparse_note, "k2_solve_r_program_ms": k2_ms, "fastest": name,
          "method": "CUDA events per call, 2 warm-up + median of 10; R assembled from the panels, "
                    "not timed; K2 through solve_r's program, 3 + median of 20", "gpu": smi})
    return results[name]["ms"], name


CHAIN_PARTS = {  # kernel name parts of each form, for the profiler
    K1: {"one_chunk": ("two_seg_kernel",), "chunked": ("two_seg_chunk_kernel", "chunk_join_kernel")},
    K2: {"one_chunk": ("banded_solve_kernel",),
         "chunked": ("solve_chunk_kernel", "chunk_join_kernel")},
}


def phase_chain_kernels(smi):
    """K1 (Qᵀ and Q) and K2, each in its one-chunk form (one launch) and,
    where the solver built a chunk plan, in its chunked form (the main
    path's: per level P1, P2, P3), against their serial plain versions on
    the chains of :func:`chain_operands`, at 1, 16 and 48 operand columns
    (the ellipse left: 1 and 5), fp32 (rtol 1e-4, atol 1e-5·max|·|) and fp64
    (rtol 1e-10, atol 1e-12·max|·|: the kernels sum in another order, and a
    chunk's interface reaches it through the boundary pass); then, in fp32,
    the forms timed in turns with their device time, time per step, bytes,
    operations, bound and the plan's shape (the chains without a plan, one
    form, on one column only); the headline cases against the plain
    version; and K2's library yardstick.  Launches here are comparisons, not a main
    path.  Returns ({kernel: worst fp32 error}, {kernel: the plain chain's
    vector timing, chunked})."""
    rng = np.random.default_rng(SEED + 13)
    c3 = banded_matrix(rng, C3_NB, C3_BR, C3_BC, C3_OV)
    left_sp, _, _ = banded_left_problem()
    worst, headline = {K1: 0.0, K2: 0.0}, {}
    for dtype in (torch.float32, torch.float64):
        tol = banded_tolerance(dtype)
        for label, (Y, T, s1, s2, sp, h1, m), (r, cols, emit_, ncols, act, me, mc, n), \
                (pqt, pq, psolve), ks in chain_operands(c3, left_sp, dtype):
            B = Y.shape[0]
            for k in ks:
                M = torch.as_tensor(rng.normal(size=(B, m, k)), dtype=dtype, device=DEVICE)
                ypad = torch.as_tensor(rng.normal(size=(B, n + mc, k)), dtype=dtype, device=DEVICE)

                def k1(transpose, plan):
                    return lambda: cw.two_segment_apply(Y, T, s1, s2, sp, M, h1, transpose,
                                                        plan=plan)

                def k2(plan):
                    return lambda: bk.banded_solve_chunk(ypad, r, cols, emit_, ncols, act,
                                                         max_emit=me, max_cols=mc, plan=plan)

                runs = {
                    "apply_qt": (K1, pqt, k1(True, None), k1(True, pqt),
                                 lambda: cw._two_segment_apply_plain(Y, T, s1, s2, sp, M, h1, True)),
                    "apply_q": (K1, pq, k1(False, None), k1(False, pq),
                                lambda: cw._two_segment_apply_plain(Y, T, s1, s2, sp, M, h1, False)),
                    "solve": (K2, psolve, k2(None), k2(psolve),
                              lambda: bk._banded_solve_chunk_plain(ypad, r, cols, emit_, ncols, act,
                                                                   max_emit=me, max_cols=mc)),
                }
                for call, (kernel, plan, run_one, run_chunked, run_p) in runs.items():
                    forms = {"one_chunk": run_one}
                    if plan is not None:
                        forms["chunked"] = run_chunked
                    ref = run_p()
                    line = {"phase": "chain_kernels", "kernel": kernel, "chain": label, "call": call,
                            "k": k, "dtype": str(dtype).split(".")[1], "shape": list(Y.shape),
                            "rtol": tol[0], "atol_x_max_abs": tol[1],
                            "plan": None if plan is None else plan.summary()}
                    for f, fn in forms.items():
                        out = fn()
                        torch.cuda.synchronize()
                        err, bitwise = compare(out, ref, dtype, tol)
                        line[f] = {"max_abs_err": err, "bitwise_equal_plain": bitwise}
                        if f == "chunked":
                            line[f]["bitwise_repeat"] = bool(torch.equal(out, fn()))
                        if dtype == torch.float32:
                            worst[kernel] = max(worst[kernel], err)
                    del ref
                    if dtype == torch.float32 and (plan is not None or k == 1):
                        steps, nbytes, flops = (
                            two_seg_cost(Y, T, M) if kernel == K1 else
                            solve_chunk_cost(ypad, r, cols, emit_, ncols, act, me, mc))
                        bound_ms, bound_by = bound(nbytes, flops)
                        timed = time_forms(forms, CHAIN_PARTS[kernel])
                        for f, t in timed.items():
                            line[f].update(t, per_step_us=t["ms"] * 1e3 / steps,
                                           graph_per_step_us=t["graph_ms"] * 1e3 / steps)
                        if "chunked" in timed:
                            one, ch = timed["one_chunk"], timed["chunked"]
                            line["speedup"] = {"ms": one["ms"] / ch["ms"],
                                               "graph_ms": one["graph_ms"] / ch["graph_ms"]}
                        line.update({"steps": steps, "bytes": nbytes, "flops": flops,
                                     "bound_ms": bound_ms, "bound_by": bound_by,
                                     "method": CHAIN_TIMING_METHOD, "gpu": smi})
                        if k == 1 and call != "apply_q" and label == "config3_plain_chain":
                            best = timed.get("chunked", timed["one_chunk"])
                            _, plain_ms, _ = time_kernel_plain(forms.get("chunked", run_one), run_p)
                            line["plain_ms"] = plain_ms
                            headline[kernel] = {
                                "ms": best["ms"], "device_ms": best["graph_ms"],
                                "profiler_device_ms": best["device_ms"], "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "per_step_us": best["ms"] * 1e3 / steps,
                                "device_per_step_us": best["graph_ms"] * 1e3 / steps,
                                "plain_per_step_us": plain_ms * 1e3 / steps,
                                "one_chunk_ms": timed["one_chunk"]["ms"],
                                "one_chunk_device_ms": timed["one_chunk"]["graph_ms"],
                                "case": f"{label} {call} k={k}, chunked"}
                    emit(line)
    chain_chunk_sweep(c3, smi)
    lib_ms, lib_call = chain_library(c3, smi)
    headline[K2].update(library_ms=lib_ms, library_call=lib_call)
    return worst, headline


def chain_chunk_sweep(c3, smi):
    """The chunked forms on config 3's plain chain, fp32, at 1 and 16
    columns, with plans of :data:`CHAIN_SWEEP` steps a chunk (the solvers
    use ``chain_plan.CHUNK_STEPS``): each call's replayed device time
    (:func:`graph_ms`) and the plan's shape, the lengths in turns up and
    down."""
    qr = qt.BandedBlockedQR(suggested_block_cols=C3_BC, device=DEVICE, dtype=torch.float32).compute(c3)
    s, g, gd = qr.q_seq, qr.geom, qr._geom_dev
    nb = s.Y.shape[0]
    rng = np.random.default_rng(SEED + 15)
    k1 = dict(h1=s.h1, A=s.Y.shape[1], m=s.m, device=DEVICE)
    plans = {c: (chain_plan.two_segment_plan(g["cols"], g["rows"], g["carry_rows"], transpose=True,
                                             chunk_steps=c, **k1),
                 chain_plan.two_segment_plan(g["cols"], g["rows"], g["carry_rows"], transpose=False,
                                             chunk_steps=c, **k1),
                 chain_plan.solve_plan(g["cols"], g["emit_rows"], g["ncols"], np.ones(nb, bool),
                                       max_emit=qr._max_emit, max_cols=qr._max_cols,
                                       rows=qr.cols + qr._max_cols, device=DEVICE, chunk_steps=c))
             for c in CHAIN_SWEEP}
    act = torch.ones((1, nb), dtype=torch.bool, device=DEVICE)
    for k in (1, 16):
        M = torch.as_tensor(rng.normal(size=(1, s.m, k)), dtype=torch.float32, device=DEVICE)
        ypad = torch.as_tensor(rng.normal(size=(1, qr.cols + qr._max_cols, k)),
                               dtype=torch.float32, device=DEVICE)
        args = (s.Y[None], s.T[None], s.s1[None], s.s2[None], s.split[None], M, s.h1)
        sargs = (ypad, qr._r_panels[None], gd["cols"][None], gd["emit_rows"][None],
                 gd["ncols"][None], act)
        times = {c: {"apply_qt": [], "apply_q": [], "solve": []} for c in CHAIN_SWEEP}
        for order in (CHAIN_SWEEP, CHAIN_SWEEP[::-1]):
            for c in order:
                pqt, pq, ps = plans[c]
                for call, fn in (
                        ("apply_qt", lambda: cw.two_segment_apply(*args, True, plan=pqt)),
                        ("apply_q", lambda: cw.two_segment_apply(*args, False, plan=pq)),
                        ("solve", lambda: bk.banded_solve_chunk(*sargs, max_emit=qr._max_emit,
                                                                max_cols=qr._max_cols, plan=ps))):
                    times[c][call].append(graph_ms(fn))
        emit({"phase": "chain_chunk_sweep", "chain": "config3_plain_chain", "k": k,
              "chunk_steps_used": chain_plan.CHUNK_STEPS,
              "graph_ms": {c: {call: statistics.mean(v) for call, v in t.items()}
                           for c, t in times.items()},
              "plans": {c: {name: p.summary() for name, p in zip(("qt", "q", "solve"), plans[c])}
                        for c in CHAIN_SWEEP},
              "method": "graph_ms: a CUDA graph of 10 calls replayed 5 times between events, the "
                        "median over 10; the mean of two rounds, lengths ascending then descending",
              "gpu": smi})


OPTION_COMBOS = [(False, False), (True, False), (False, True), (True, True)]


def stepnorm_tolerance(dtype):
    """Σx² of the kernel (a CTA tree, then the partials in order) against
    torch's sum: rounding of two summation orders."""
    return (1e-12, 0.0) if dtype == torch.float64 else (1e-5, 0.0)


def lstsq_options(a, b, scale, stepnorm, plain):
    """B1 (or its plain version) with ``b_scale=scale`` (a device scalar or
    None) and ``stepnorm``."""
    if plain:
        return bd._lstsq_soa_plain(a, b, scale, stepnorm)
    return bd.block_diagonal_lstsq_soa(a, b, b_scale=scale, stepnorm=stepnorm)


def phase_blockdiag_options(rng, smi):
    """B1 with each combination of b_scale (a device scalar multiplying x)
    and stepnorm (Σx² reduced on the device) against the plain version:
    every block shape, fp32 and fp64, ragged batch sizes.  Then, at the
    1M-block point (fp32), the kernel with both options against the kernel
    without and the plain version, in turns.  Returns the worst x error."""
    worst = 0.0
    for br, bc in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.float64):
            for scaled, stepnorm in OPTION_COMBOS:
                err_x, err_sn = 0.0, 0.0
                scale = torch.tensor(-1.75, dtype=dtype, device=DEVICE) if scaled else None
                for n in KERNEL_NS:
                    a, b = soa_operands(rng, n, br, bc, dtype, DEVICE)
                    out = lstsq_options(a, b, scale, stepnorm, plain=False)
                    torch.cuda.synchronize()
                    ref = lstsq_options(a, b, scale, stepnorm, plain=True)
                    if stepnorm:
                        (out, sn), (ref, ref_sn) = out, ref
                        if tuple(sn.shape) != () or sn.device != a.device:
                            raise AssertionError(f"stepnorm returned {tuple(sn.shape)} on {sn.device}")
                        e, _ = compare(sn, ref_sn, dtype, stepnorm_tolerance(dtype))
                        err_sn = max(err_sn, e)
                    e, eq = compare(out, ref, dtype)
                    if not eq:
                        raise AssertionError(f"blockdiag_lstsq options {scaled, stepnorm} {br}x{bc} "
                                             f"{dtype} n={n}: x not bitwise equal (max_abs_err={e})")
                    err_x = max(err_x, e)
                emit({
                    "phase": "blockdiag_lstsq_options", "shape": [br, bc],
                    "dtype": str(dtype).split(".")[1], "b_scale": scaled, "stepnorm": stepnorm,
                    "ns": KERNEL_NS, "max_abs_err_x": err_x, "x_bitwise_equal": True,
                    "max_abs_err_stepnorm": err_sn if stepnorm else None,
                    "stepnorm_rtol": stepnorm_tolerance(dtype)[0] if stepnorm else None,
                })
                worst = max(worst, err_x)
    blocks, b = flagship_system(rng, NB_REAL)
    a = torch.as_tensor(
        np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(BR * BC, NB_REAL)),
        dtype=torch.float32, device=DEVICE,
    )
    bs = torch.as_tensor(b.reshape(NB_REAL, BR).T.copy(), dtype=torch.float32, device=DEVICE)
    scale = torch.tensor(-1.75, dtype=torch.float32, device=DEVICE)
    runs = {
        "options": lambda: lstsq_options(a, bs, scale, True, plain=False),
        "no_options": lambda: lstsq_options(a, bs, None, False, plain=False),
        "plain_options": lambda: lstsq_options(a, bs, scale, True, plain=True),
    }
    rounds = {k: [] for k in runs}
    for key in ("options", "no_options", "plain_options", "plain_options", "no_options", "options"):
        rounds[key].append(profiling.cuda_time_ms(runs[key]))
    ms = {k: statistics.mean(v) for k, v in rounds.items()}
    emit({
        "phase": "blockdiag_lstsq_options_timing", "n": NB_REAL, "shape": [BR, BC],
        "dtype": "float32", "ms_b_scale_stepnorm": ms["options"], "ms_no_options": ms["no_options"],
        "plain_ms_b_scale_stepnorm": ms["plain_options"], "rounds": rounds,
        "method": "CUDA events per call, 10 warm-up, median of 50; rounds options, none, "
                  "plain, plain, none, options; mean of round medians",
        "gpu": smi,
    })
    return worst


# config 4: examples/bench_block_angular.make_problem (the ellipse Jacobian's
# [2N x N block-diagonal of 2x1 | 2N x 5 dense] shape)
BA_M2 = 5
BA_NS = (100_000, 500_000)
BA_SPARSE_N = 100_000
BA_REL_GATE = 1e-3  # fp32 solution against the port's fp64 CPU result


def block_angular_problem(rng, n):
    blocks = rng.uniform(0.5, 5.0, size=(n, 2, 1))
    a2 = rng.uniform(0.5, 5.0, size=(2 * n, BA_M2))
    xt = rng.normal(size=n + BA_M2)
    b = np.zeros(2 * n)
    b[0::2] = blocks[:, 0, 0] * xt[:n]
    b[1::2] = blocks[:, 1, 0] * xt[:n]
    b += a2 @ xt[n:]
    return blocks, a2, b


def ba_solver():
    return qt.BlockAngularQR(qt.BlockDiagonalQR(qt.QFormat.FULL_Q, pivot=False), qt.DenseColPivQR())


def phase_block_angular(rng, smi):
    """Config 4 through BlockAngularQR on the card (fp32): the fused dense
    compute + solve, the fused lane-major compute_solve and, at N = 100,000,
    the generic sparse-A2 composition, each with the launch counters read
    around it, checked against the port's fp64 CPU result, then timed.
    Returns the B2 launches of the sparse-A2 runs."""
    b2_launches = 0
    for n in BA_NS:
        blocks, a2, b = block_angular_problem(rng, n)
        x64 = ba_solver().compute(qt.BlockMatrix1x2(
            qt.BlockDiagonal(torch.as_tensor(blocks), 2 * n, n), torch.as_tensor(a2)
        )).solve(torch.as_tensor(b)).numpy()

        def dev(arr):
            return torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float32, device=DEVICE)

        bt = dev(b)
        aos = qt.BlockMatrix1x2(qt.BlockDiagonal(dev(blocks), 2 * n, n), dev(a2))
        soa = qt.BlockMatrix1x2(
            qt.BlockDiagonal.from_soa(dev(blocks.transpose(1, 2, 0).reshape(2, n)), 2, 1, nrows=2 * n),
            dev(a2.T), right_t=True,
        )
        cases = [
            ("fused_dense", lambda s: s.compute(aos).solve(bt), {}, lambda s: s._fused_dense),
            ("fused_soa", lambda s: s.compute_solve(soa, bt), {}, lambda s: s._fused_soa),
        ]
        if n == BA_SPARSE_N:
            sparse = qt.BlockMatrix1x2(qt.BlockDiagonal(dev(blocks), 2 * n, n), qt.SparseCSR.from_dense(a2))
            cases.append((
                "sparse_a2", lambda s: s.compute(sparse).solve(bt), {"blockdiag_qr_r": 1},
                lambda s: s._r12_coo is not None and s.left._kernel_mode,
            ))
        for label, call, want, took_path in cases:
            solver = ba_solver()
            profiling.reset_launch_counts()
            t0 = time.perf_counter()
            x = call(solver)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = profiling.launch_counts()
            expected = {name: want.get(name, 0) for name in counts}
            if counts != expected:
                raise AssertionError(f"block angular {label} N={n}: launches {counts}, want {expected}")
            if not took_path(solver):
                raise AssertionError(f"block angular {label} N={n}: the path was not taken")
            info = solver.info()
            if info != qt.ComputationInfo.SUCCESS:
                raise AssertionError(f"block angular {label} N={n}: info() = {info}")
            xh = x.double().cpu().numpy()
            if xh.shape != x64.shape or not np.isfinite(xh).all():
                raise AssertionError(f"block angular {label} N={n}: shape {xh.shape} or non-finite x")
            rel = float(np.linalg.norm(xh - x64) / np.linalg.norm(x64))
            if not rel < BA_REL_GATE:
                raise AssertionError(f"block angular {label} N={n}: ‖x − x64‖/‖x64‖ = {rel}")
            b2_launches += counts["blockdiag_qr_r"]
            ms, times = wall_ms(lambda: call(solver), 20)  # same solver: warm plans
            emit({
                "phase": "block_angular_main_path", "path": label, "n": n, "m2": BA_M2,
                "dtype": "float32", "rel_err_vs_fp64_cpu": rel, "gate": BA_REL_GATE,
                "info": info.name, "launches": counts, "wall_s_incl_first_use": seconds,
                "ms": ms, "times_ms": times,
                "method": "host wall time of one call on the same solver ending in synchronize "
                          "(compute + solve, or compute_solve), one warm-up, median of 20",
                "gpu": smi,
            })
    return b2_launches


ELLIPSE_TRUTH = (7.5, 2.0, 17.0, 23.0, 0.23)
ELLIPSE_NS = (100_000, 500_000)
ELLIPSE_GATE = 1e-3  # canonical parameters against the truth, fp32
LM_CFG = lm.LMConfig(max_iters=40, ftol=1e-8, xtol=1e-8)  # examples/bench_ellipse.py's


def device_kernels(prof, part=""):
    """(kernel ms, kernel launches) under torch.profiler: the device-side
    events only, so each launch counts once (the CPU op that launched a
    kernel carries its time too), as the profiler table's footer counts;
    only the kernels whose name holds ``part``."""
    from torch.autograd import DeviceType

    ms, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and part in e.key:
            ms += e.self_device_time_total / 1e3
            launches += e.count
    return ms, launches


def fit(pts, dtype=torch.float32):
    reads0 = lm.levenberg_marquardt_device.host_reads
    t0 = time.perf_counter()
    result, params = ellipse.fit_ellipse(pts, LM_CFG, dtype=dtype, device=DEVICE)
    torch.cuda.synchronize()
    return result, params, time.perf_counter() - t0, lm.levenberg_marquardt_device.host_reads - reads0


def k4_fit_launches(k, first):
    """K4's launches in an ellipse fit of ``k`` iterations: a warm fit runs
    K4r 2k + 1 times (the loop's start, then the trial residual and the
    gradient's forward an iteration), K4j and K4g k times; a key's ``first``
    fit adds its eager start, iteration 1 and the capture's warm-up body
    (only the start and iteration 1 where iteration 1 finishes it)."""
    if first and k <= 1:
        return {K4R: 3, K4J: 1, K4G: 1}
    extra = 2 if first else 0
    return {K4R: 2 * (k + extra) + 1 + (1 if first else 0), K4J: k + extra, K4G: k + extra}


def first_fit_contract(label, iterations, reads, counts, ellipse_fit=False, k5_step=0):
    """A key's first fit: iteration 1 eager (one host read; a fit that it
    finishes ends there), iteration 2 the capture's warm-up, then the whole
    fit as one launch of the captured loop (one fetch; L1 once before the
    loop and once an iteration, by its own count), with ``ellipse_fit`` K3
    (the step) once an iteration and once each for iteration 1 and the
    capture's warm-up body and K4 as ``k4_fit_launches``, with ``k5_step``
    (a dense block-angular step's K5 launches) K5 as often as K3 would be
    times that, no other kernel."""
    k = int(iterations)
    want_reads = 2 if k > 1 else 1
    want = {name: (k + 1 if name == "graph_loop_cond" and k > 1 else 0) for name in counts}
    steps = k + 2 if k > 1 else 1  # iteration 1's step, the warm-up's, one an iteration
    if ellipse_fit:
        want[K3] = steps
        want.update(k4_fit_launches(k, first=True))
    if k5_step:
        want[K5] = k5_step * steps
    if reads != want_reads or counts != want:
        raise AssertionError(f"{label}: first fit of {k} iterations: {reads} host reads, launches "
                             f"{counts}; want {want_reads} and {want}")


def phase_ellipse_lm(smi):
    """fit_ellipse on the device loop at N = 100,000 and 500,000, fp32: the
    first fit of each key captures its loop (iteration 1 eager, then the
    fit as one launch: host reads and launches checked), the canonical
    parameters against the truth, the wall time of warm fits (a median of 3)
    and, at N = 100,000, the device busy share of a warm fit under
    torch.profiler, with K3's kernel records and device time.  Then
    fit_ellipse_batch on 16 problems of 10,000 points against the solo
    fits, K3 once an iteration for the whole batch (vmap).  Returns K3's
    launches in the counted fits."""
    el = ellipse.Ellipse(*ELLIPSE_TRUTH)
    lm.clear_programs()
    k3_launches_total = 0
    for n in ELLIPSE_NS:
        pts = ellipse.ellipse_points(el, n)
        profiling.reset_launch_counts()
        result, params, first_s, reads = fit(pts)
        counts = profiling.launch_counts()
        first_fit_contract(f"ellipse LM N={n}", result.iterations, reads, counts, ellipse_fit=True)
        k3_launches_total += counts[K3]
        err = float(np.abs(params[n:] - np.array(ELLIPSE_TRUTH)).max())
        if not (np.isfinite(result.cost) and err < ELLIPSE_GATE and np.isfinite(params).all()):
            raise AssertionError(f"ellipse LM N={n}: cost {result.cost}, parameter error {err}")
        timed = [fit(pts) for _ in range(3)]
        if any(r[3] != 1 for r in timed):
            raise AssertionError(f"ellipse LM N={n}: warm fits read {[r[3] for r in timed]} times")
        times = sorted(r[2] * 1e3 for r in timed)
        busy = None
        if n == ELLIPSE_NS[0]:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, _, wall_s, _ = fit(pts)
            kernel_ms, launches = device_kernels(prof)
            k3 = [device_kernels(prof, part) for part in K3_PARTS]
            k3_ms, k3_records = sum(m for m, _ in k3), sum(r for _, r in k3)
            busy = {"device_ms": kernel_ms, "device_launches": launches,
                    "launches_per_iteration": launches / result.iterations,
                    "k3_kernel_records": k3_records, "k3_device_ms": k3_ms,
                    "k3_kernels_per_iteration": k3_records / result.iterations,
                    "wall_ms_under_profiler": wall_s * 1e3,
                    "busy_share": kernel_ms / (wall_s * 1e3) if kernel_ms > 0 else None}
        emit({
            "phase": "ellipse_lm", "n": n, "dtype": "float32", "iterations": result.iterations,
            "converged": result.converged, "cost": result.cost, "max_param_err": err,
            "gate": ELLIPSE_GATE, "params": [float(v) for v in params[n:]],
            "first_fit_host_reads": reads, "warm_fit_host_reads": 1,
            "first_fit_launches": counts, "first_fit_s": first_s, "ms": times[1], "times_ms": times,
            "profiler": busy,
            "method": "host wall time of a warm fit_ellipse (one captured loop; ends in its one "
                      "fetch and a synchronize), median of 3; first_fit_s includes the capture",
            "gpu": smi,
        })
    nb, n = 16, 10_000
    pts_b = ellipse_batch_points(nb, n)
    ellipse.fit_ellipse_batch(pts_b[:2], LM_CFG, dtype=torch.float32, device=DEVICE)  # warm-up
    profiling.reset_launch_counts()
    t0 = time.perf_counter()
    batch = ellipse.fit_ellipse_batch(pts_b, LM_CFG, dtype=torch.float32, device=DEVICE)
    batch_s = time.perf_counter() - t0
    counts = profiling.launch_counts()
    batch_k3, kb = counts[K3], int(np.max(batch.iterations))
    k4 = {name: counts[name] for name in K4}
    # one vmapped launch of each an iteration, as the solo fits
    if batch_k3 != (kb + 2 if kb > 1 else 1) or k4 != k4_fit_launches(kb, first=True):
        raise AssertionError(f"ellipse batch: K3 launched {batch_k3} times, K4 {k4}, in {kb} iterations")
    k3_launches_total += batch_k3
    worst, solo_s = 0.0, 0.0
    for i in range(nb):
        solo, _, s, _ = fit(pts_b[i])
        solo_s += s
        e, _ = compare(torch.as_tensor(batch.x[i]), torch.as_tensor(solo.x), torch.float32)
        worst = max(worst, e)
    emit({
        "phase": "ellipse_lm_batch", "problems": nb, "n": n, "dtype": "float32",
        "iterations": [int(v) for v in batch.iterations], "max_abs_err_vs_solo": worst,
        "rtol": tolerance(torch.float32)[0], "atol_x_max_abs": tolerance(torch.float32)[1],
        "batch_s_first_fit_of_key": batch_s, "sum_of_solo_s": solo_s, "k3_launches": batch_k3,
        "note": "the batch is its key's first fit (capture included); of the solo fits the first "
                "captures, the others are warm", "gpu": smi,
    })
    return k3_launches_total


def ellipse_batch_points(nb=16, n=10_000):
    """``nb`` ellipses of ``n`` points, problem i with a = 7.5 + 0.1 i and
    r = 0.23 + 0.01 i (their truths: :func:`ellipse_batch_truth`)."""
    return np.stack([ellipse.ellipse_points(ellipse.Ellipse(*ellipse_batch_truth(i)), n)
                     for i in range(nb)])


def ellipse_batch_truth(i):
    return (7.5 + 0.1 * i, 2.0, 17.0, 23.0, 0.23 + 0.01 * i)


BANDED_LEFT_N = 2000  # a row of the published ellipse table


def banded_left_chain(f, lam):
    """B5's operands on the banded ellipse stack: the left solver's shifted
    panels of the damped Jacobian (built as damped_step_banded builds them)."""
    x0 = f.initial_params()
    left_d, _, _ = f._damped(x0, f.residuals(x0), lam)
    n = f.n
    left_sp = qt.SparseCSR.from_triplets(
        np.arange(3 * n), np.repeat(np.arange(n), 3), left_d.cpu().numpy().reshape(-1),
        (3 * n + 5, n),
    )
    q = qt.BandedBlockedQR(3, 1, 0, 1, device=DEVICE, dtype=f.dtype)
    q.analyze_pattern(left_sp)
    q._layout_maps(left_sp, left_sp)
    vals = torch.as_tensor(left_sp.data, dtype=f.dtype, device=DEVICE)
    panels = torch.cat([vals, vals.new_zeros(1)])[q._panel_gmap]
    if q._chain_kernel != dict(mca=1, me=1, ci=1, ci0=1) or tuple(panels.shape[1:]) != (4, 1):
        raise AssertionError(f"banded ellipse left: chain {q._chain_kernel}, panels {tuple(panels.shape)}")
    return panels, q._chain_act, q._chain_kernel


def phase_ellipse_banded(smi):
    """One damped_step_banded (BandedBlockedQR(3, 1, 0, 1) left + dense
    ColPiv right) at N = 2,000, fp64 and fp32: B5 launched exactly once, K1
    and K2 (the left's Q products and back-substitution) at least once,
    the step against damped_step (fp64 atol 1e-8; fp32 rtol 1e-4, atol
    1e-5·max|·|), its wall time; then B5 against its plain version on this
    4×1 chain, and both timed (fp32).  Returns (the steps' launches by
    kernel, worst B5 error, (kernel ms, plain ms))."""
    pts = ellipse.ellipse_points(ellipse.Ellipse(*ELLIPSE_TRUTH), BANDED_LEFT_N)
    lam = 1e-3
    launches, worst, timing = {}, 0.0, None
    for dtype in (torch.float64, torch.float32):
        f = ellipse.EllipseFitting(pts, dtype=dtype, device=DEVICE)
        x0 = f.initial_params()
        r0 = f.residuals(x0)
        ref = f.damped_step(x0, r0, lam)
        torch.cuda.synchronize()
        profiling.reset_launch_counts()
        t0 = time.perf_counter()
        step = f.damped_step_banded(x0, r0, lam)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = profiling.launch_counts()
        want = {"banded_chain_qr": 1, K4J: 1}  # K4j: the damped system's Jacobian
        if not launches_ok(counts, want, SCAN_KERNELS):
            raise AssertionError(f"banded ellipse step ({dtype}): launches {counts}, want "
                                 f"{pin_text(want, SCAN_KERNELS)}")
        launches = {name: launches.get(name, 0) + n for name, n in counts.items()}
        tol = (0.0, 1e-8 / max(ref.abs().max().item(), 1e-300)) if dtype == torch.float64 else (1e-4, 1e-5)
        step_err, _ = compare(step, ref, dtype, tol)
        panels, act, kw = banded_left_chain(f, lam)
        out = bk.chain_qr(panels, act, **kw)
        torch.cuda.synchronize()
        b5_err, bitwise = compare_outputs(out, bk._chain_qr_plain(panels, act, **kw), dtype)
        worst = max(worst, b5_err) if dtype == torch.float32 else worst
        record = {
            "phase": "ellipse_banded_left", "n": BANDED_LEFT_N, "dtype": str(dtype).split(".")[1],
            "launches": counts, "max_abs_err_vs_damped_step": step_err,
            "chain": {"steps": int(panels.shape[0]), "panel": list(panels.shape[1:]), **kw},
            "b5_max_abs_err_vs_plain": b5_err, "b5_bitwise_equal": bitwise,
            "step_wall_s_incl_first_use": seconds,
        }
        if dtype == torch.float32:
            k_rounds, p_rounds = [], []
            for rounds in (k_rounds, p_rounds, p_rounds, k_rounds):
                if rounds is k_rounds:
                    rounds.append(profiling.cuda_time_ms(lambda: bk.chain_qr(panels, act, **kw)))
                else:
                    rounds.append(profiling.cuda_time_ms(
                        lambda: bk._chain_qr_plain(panels, act, **kw), warmup=1, reps=3))
            timing = (statistics.mean(k_rounds), statistics.mean(p_rounds))
            step_ms, step_times = wall_ms(lambda: f.damped_step_banded(x0, r0, lam), 3)
            record.update({
                "b5_ms": timing[0], "b5_plain_ms": timing[1], "b5_ms_rounds": k_rounds,
                "b5_plain_ms_rounds": p_rounds, "step_ms": step_ms, "step_times_ms": step_times,
                "method": "B5: CUDA events per call, rounds kernel, plain, plain, kernel (kernel "
                          "10 warm-up + median of 50, plain 1 + median of 3); step: host wall "
                          "time ending in synchronize, one warm-up, median of 3",
                "gpu": smi,
            })
        emit(record)
    return launches, worst, timing

# --- bundle adjustment, auto_qr and the CLI, sparse products, blocked thin ---

BUNDLE_CAMS, BUNDLE_NOISE, BUNDLE_SEED = 8, 1e-3, 3   # examples/bench_bundle.py's cases
BUNDLE_HOST_P, BUNDLE_DEVICE_PS = 5_000, (5_000, 20_000)
BUNDLE_CFG = lm.LMConfig(max_iters=40)
BUNDLE_RMS_GATE = 5e-3  # tests/test_bundle.py's bound
BUNDLE_COST_GATE = 1e-2  # the two LM loops' final costs, relative


def bundle_start(n_pts):
    """bench_bundle.py's scene and starting point (its perturbation, seed 7)."""
    cams, pts, uv = bundle.make_scene(n_cams=BUNDLE_CAMS, n_pts=n_pts, noise=BUNDLE_NOISE,
                                      seed=BUNDLE_SEED)
    rng = np.random.default_rng(7)
    return cams + 0.02 * rng.normal(size=cams.shape), pts + 0.02 * rng.normal(size=pts.shape), uv


def busy_share(fn):
    """(result, wall ms, device kernel ms, kernel launches) of one ``fn()``
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_ms, launches = device_kernels(prof)
    return out, wall, kernel_ms, launches


def phase_bundle(smi):
    """fit_bundle (host loop; B2 once per damped step) at 5,000 points and
    fit_bundle_device at 5,000 and 20,000 points, fp32 on the card: the
    first fit counted (launches, host reads, ATen ops; a device fit is its
    key's first: iteration 1 eager, then the fit as one captured launch),
    then one timed fit and one under the profiler (warm); rms reprojection
    gated, the two loops held to each other by final cost at 5,000 points.
    Returns (B2 launches of the host loop's counted fit, its iterations,
    its point-block shape)."""
    f32 = dict(device=DEVICE, dtype=torch.float32)
    out = {}
    runs = [("host_loop", BUNDLE_HOST_P, bundle.fit_bundle)] + [
        ("device_loop", p, bundle.fit_bundle_device) for p in BUNDLE_DEVICE_PS
    ]
    b2 = iters = 0
    lm.clear_programs()
    for loop, n_pts, fit_fn in runs:
        cams0, pts0, uv = bundle_start(n_pts)
        n_obs = 2 * n_pts * BUNDLE_CAMS
        reads0 = lm.levenberg_marquardt_device.host_reads
        profiling.reset_launch_counts()
        t0 = time.perf_counter()
        with profiling.count_dispatches() as d:
            res = fit_fn(cams0, pts0, uv, BUNDLE_CFG, **f32)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = profiling.launch_counts()
        loop_reads = lm.levenberg_marquardt_device.host_reads - reads0
        rms = float(np.sqrt(2.0 * res.cost / n_obs))
        it = int(res.iterations)
        x_np = res.x.detach().cpu().numpy() if isinstance(res.x, torch.Tensor) else np.asarray(res.x)
        if not (np.isfinite(res.cost) and rms < BUNDLE_RMS_GATE and np.isfinite(x_np).all()):
            raise AssertionError(f"bundle {loop} P={n_pts}: cost {res.cost}, rms {rms}")
        # the host loop makes one damped step, so one B2 launch, an
        # iteration; the device loop's fused dense step launches K5's plan,
        # its captured loop L1 once before the loop and once an iteration
        if loop == "host_loop":
            expected = {name: (it if name == "blockdiag_qr_r" else 0) for name in counts}
            if counts != expected or it < 1:
                raise AssertionError(f"bundle {loop} P={n_pts}: launches {counts} in {it} iterations")
        else:
            first_fit_contract(f"bundle {loop} P={n_pts}", it, loop_reads, counts,
                               k5_step=bundle_step_k5(n_pts, BUNDLE_CAMS))
        if loop == "host_loop":
            b2, iters = counts["blockdiag_qr_r"], it
        t0 = time.perf_counter()
        fit_fn(cams0, pts0, uv, BUNDLE_CFG, **f32)
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - t0
        _, wall_ms, kernel_ms, launches = busy_share(lambda: fit_fn(cams0, pts0, uv, BUNDLE_CFG, **f32))
        out[(loop, n_pts)] = res.cost
        emit({
            "phase": "bundle", "loop": loop, "n_pts": n_pts, "n_cams": BUNDLE_CAMS,
            "n_obs": n_obs, "params": 3 * n_pts + 6 * BUNDLE_CAMS, "dtype": "float32",
            "iterations": it, "converged": bool(res.converged), "cost": float(res.cost),
            "rms_reproj": rms, "gate": BUNDLE_RMS_GATE, "point_block": [2 * BUNDLE_CAMS + 3, 3],
            "launches": counts, "b2_launches_per_iteration": counts["blockdiag_qr_r"] / max(it, 1),
            "host_reads": d.host_reads, "host_reads_per_iteration": d.host_reads / max(it, 1),
            "device_loop_reads": loop_reads, "aten_ops_per_iteration": d.ops / max(it, 1),
            "first_fit_s_counted": first_s, "seconds": timed_s,
            "profiler": {"wall_ms": wall_ms, "device_ms": kernel_ms, "device_launches": launches,
                         "busy_share": kernel_ms / wall_ms if kernel_ms > 0 else None},
            "method": "first fit under count_dispatches (ATen ops, host reads: .item()/bool() and "
                      "device-to-host copies) with the launch counters (the device loop's first fit "
                      "captures its loop); device_loop_reads: the LM driver's reads that wait on the "
                      "loop; seconds: a second fit, host wall time ending in synchronize; profiler: "
                      "a third fit",
            "gpu": smi,
        })
    h, dv = out[("host_loop", BUNDLE_HOST_P)], out[("device_loop", BUNDLE_HOST_P)]
    rel = abs(h - dv) / dv
    emit({"phase": "bundle_loops", "n_pts": BUNDLE_HOST_P, "cost_host_loop": float(h),
          "cost_device_loop": float(dv), "rel_cost_diff": rel, "gate": BUNDLE_COST_GATE,
          "note": "compared by cost: a free similarity transform makes x non-unique"})
    if not rel < BUNDLE_COST_GATE:
        raise AssertionError(f"bundle LM loops: final costs {h} and {dv} differ by {rel}")
    return b2, iters


def bundle_step_breakdown(smi, lam=1e-3, reps=5):
    """Where one host-loop damped step's time goes (P = 5,000, fp32): the
    step's stages run one after another as ``_BundleStep.__call__`` runs
    them, each ending in synchronize (median of ``reps`` after a warm-up
    step), with the ATen ops and host reads of each stage counted once."""
    cams0, pts0, uv = bundle_start(BUNDLE_HOST_P)
    step = bundle._BundleStep(uv, device=DEVICE, dtype=torch.float32)
    x = torch.as_tensor(np.concatenate([pts0.ravel(), cams0.ravel()]), dtype=torch.float32, device=DEVICE)
    r = bundle.residuals(x, step.uv)
    step(x, r, lam)  # warm: plans and the right solver's shapes
    state = {}

    def jac():
        state["jp"], state["jc"] = bundle._jacobian_blocks(x, step.uv)

    def blocks():
        state["left_d"], state["rhs"] = bundle._damped_left_rhs(state["jp"], r, lam, step.n_cams)
        state["blk"] = qt.BlockDiagonal.from_dense_batch(state["left_d"], nrows=step.n1, ncols=3 * step.n_pts)

    def camera_csr():
        vals = np.concatenate([state["jc"].cpu().numpy().reshape(-1), np.full(6 * step.n_cams, np.sqrt(lam))])
        state["a2"] = qt.SparseCSR((step.n1, 6 * step.n_cams), step._indptr, step._indices, vals[step._order])

    def left():
        step._qr.left.compute(state["blk"])

    def compute():
        state["qr"] = step._qr.compute(qt.BlockMatrix1x2(state["blk"], state["a2"]))

    def solve():
        b = torch.cat([state["rhs"], state["rhs"].new_zeros(6 * step.n_cams)])
        state["qr"].solve(b)

    stages = [("jacobian_vmap_jacfwd", jac), ("damped_blocks", blocks), ("camera_csr_host", camera_csr),
              ("b2_left_compute_alone", left), ("block_angular_compute", compute), ("solve", solve)]
    out = {}
    for name, fn in stages:
        with profiling.count_dispatches() as d:
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms": statistics.median(times), "aten_ops": d.ops, "host_reads": d.host_reads,
                     "launches": {k: v for k, v in d.launches.items() if v}}
    emit({"phase": "bundle_step_breakdown", "n_pts": BUNDLE_HOST_P, "dtype": "float32", "stages": out,
          "note": "block_angular_compute includes its own left compute (B2); b2_left_compute_alone "
                  "is that part run by itself",
          "method": f"host wall time of each stage ending in synchronize, warm, median of {reps}; ops "
                    "and reads counted in one more run", "gpu": smi})


def phase_bundle_b2_timing(rng, smi):
    """B2 at the bundle host loop's point-block batch (5,000 blocks of 19×3,
    fp32) against its plain version and torch.linalg.qr(mode="r")."""
    br, bc = 2 * BUNDLE_CAMS + 3, 3
    a, bs = soa_operands(rng, BUNDLE_HOST_P, br, bc, torch.float32, DEVICE, degenerate=False)
    a_aos = a.T.reshape(BUNDLE_HOST_P, br, bc).contiguous()
    ntri = bc * (bc + 1) // 2
    return time_pair("blockdiag_qr_r", a, bs, br, (br * bc + ntri) * BUNDLE_HOST_P * 4,
                     qr_flops(br, bc) * BUNDLE_HOST_P,
                     lambda: torch.linalg.qr(a_aos, mode="r").R, smi, shape=(br, bc))


CLI_GATE = 1e-3  # fp32 recovery error of --rhs-random


def config2_matrix(rng):
    """Config 2: 10,000 blocks of 7×2, uniform(0.5, 5), rows permuted."""
    blocks = rng.uniform(0.5, 5.0, size=(NB_CONFIG2, BR, BC))
    i, r, c = np.meshgrid(np.arange(NB_CONFIG2), np.arange(BR), np.arange(BC), indexing="ij")
    mat = qt.SparseCSR.from_triplets((i * BR + r).ravel(), (i * BC + c).ravel(), blocks.ravel(),
                                     (NB_CONFIG2 * BR, NB_CONFIG2 * BC))
    return mat.permute_rows(qt.Permutation(rng.permutation(mat.nrows)))


def run_cli(argv):
    """``python -m qrkit_tpu_torch`` in this process: (rc, stderr,
    launches, seconds)."""
    err = io.StringIO()
    profiling.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, err.getvalue(), profiling.launch_counts(), time.perf_counter() - t0


def phase_auto_cli(rng, c3, smi):
    """Config 3 and config 2 through the CLI (fp32, --rhs-random,
    --export-r), auto_qr on config 3 with 5 dense trailing columns, and a
    persisted plan installed with set_analysis.  Returns the launches of
    the CLI and auto_qr runs."""
    total = {name: 0 for name in profiling.launch_counts()}
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        c2 = config2_matrix(rng)
        cases = [
            ("config3", c3, "8", "segmented_banded",
             {"banded_segment_chains": 1, "banded_apply_w": 1, "banded_chain_qr": 1}, SCAN_KERNELS),
            ("config2", c2, "2", "block_diagonal", {"blockdiag_qr_r": 1, "blockdiag_lstsq": 1}, ()),
        ]
        for label, mat, sbc, tag, want, scans in cases:
            path, rpath = os.path.join(tmp, f"{label}.mtx"), os.path.join(tmp, f"{label}_r.mtx")
            t0 = time.perf_counter()
            qt.sparse.save_matrix_market(path, mat)
            write_s = time.perf_counter() - t0
            rc, err, counts, seconds = run_cli([
                path, "--rhs-random", "--export-r", rpath, "--suggested-block-cols", sbc,
                "--device", DEVICE, "--dtype", "float32",
            ])
            m = re.search(r"x recovery rel err ([0-9.eE+-]+)", err)
            recovery = float(m.group(1)) if m else float("nan")
            expected = pin_text(want, scans)
            ok = (rc == 0 and f"solver={tag} " in err and recovery < CLI_GATE
                  and launches_ok(counts, want, scans) and os.path.getsize(rpath) > 0)
            emit({"phase": "auto_cli", "case": f"cli_{label}", "shape": list(mat.shape), "nnz": mat.nnz,
                  "rc": rc, "selection_expected": tag, "stderr": err.strip().splitlines(),
                  "recovery_rel_err": recovery, "gate": CLI_GATE, "launches": counts,
                  "mtx_write_s": write_s, "cli_s": seconds, "gpu": smi})
            if not ok:
                raise AssertionError(f"CLI {label}: rc {rc}, launches {counts} (want {expected}), stderr {err}")
            for name in total:
                total[name] += counts[name]
        # persisted plan: save, load, install; no re-analysis on compute
        seg = qt.SegmentedBandedQR(suggested_block_cols=C3_BC, device=DEVICE, dtype=torch.float32)
        seg.analyze_pattern(c3)
        plan_path = os.path.join(tmp, "plan.json")
        qt.save_analysis(plan_path, seg.plan, row_perm=seg.rows_permutation())
        plan, rp, _ = qt.load_analysis(plan_path)
        resumed = qt.SegmentedBandedQR(suggested_block_cols=C3_BC, device=DEVICE, dtype=torch.float32)
        resumed.set_analysis(plan, rp)

        def no_analysis(*a, **k):
            raise AssertionError("set_analysis solver re-ran the pattern analysis")

        resumed.analyze_pattern = no_analysis
        x_true = rng.normal(size=c3.ncols)
        b = torch.as_tensor(c3.matvec(x_true), dtype=torch.float32, device=DEVICE)
        x0 = seg.compute(c3).solve(b)
        x1 = resumed.compute(c3).solve(b)
        diff = float((x1 - x0).abs().max() / x0.abs().max())
        emit({"phase": "auto_cli", "case": "persist_round_trip", "plan_blocks": plan.num_blocks,
              "plan_equal": plan == seg.plan, "rel_diff_vs_fresh": diff,
              "json_bytes": os.path.getsize(plan_path)})
        if plan != seg.plan or not diff < 1e-6:
            raise AssertionError(f"persisted plan: equal {plan == seg.plan}, solution diff {diff}")
    # auto_qr on config 3 with 5 dense trailing columns: the block-angular split
    m, n = c3.shape
    dense = rng.uniform(0.5, 5.0, size=(m, 5))
    rows = np.concatenate([np.repeat(np.arange(m), np.diff(c3.indptr)), np.repeat(np.arange(m), 5)])
    cols = np.concatenate([c3.indices, np.tile(n + np.arange(5), m)])
    wide = qt.SparseCSR.from_triplets(rows, cols, np.concatenate([c3.data, dense.ravel()]), (m, n + 5))
    x_true = rng.normal(size=n + 5)
    b_np = wide.matvec(x_true)
    profiling.reset_launch_counts()
    t0 = time.perf_counter()
    qr = qt.auto_qr(wide, device=DEVICE, dtype=torch.float32)
    pb = torch.as_tensor(qr.rows_permutation().apply(b_np), dtype=torch.float32, device=DEVICE)
    x = qr.solve(pb).double().cpu().numpy()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = profiling.launch_counts()
    rec = float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    want_tag = "block_angular(segmented_banded, dense_colpiv)"
    want = {name: 1 for name in BANDED_KERNELS}
    emit({"phase": "auto_cli", "case": "auto_qr_config3_plus_5_dense", "shape": [m, n + 5],
          "selection": qr.selection, "recovery_rel_err": rec, "gate": CLI_GATE, "launches": counts,
          "info": qr.info().name, "seconds_incl_analysis": seconds, "gpu": smi})
    if qr.selection != want_tag or not rec < CLI_GATE or not launches_ok(counts, want, SCAN_KERNELS):
        raise AssertionError(f"auto_qr block-angular split: {qr.selection}, recovery {rec}, launches {counts}")
    for name in total:
        total[name] += counts[name]
    return total


SPARSE_OP_COLS, SPARSE_OP_NNZ = 48, 12  # a camera block's shape
SPARSE_TOL = (1e-4, 1e-5)  # fp32 rtol, atol relative to max|dense|


def sparse_operand(rng, m):
    rows = np.concatenate([rng.choice(m, size=SPARSE_OP_NNZ, replace=False) for _ in range(SPARSE_OP_COLS)])
    cols = np.repeat(np.arange(SPARSE_OP_COLS), SPARSE_OP_NNZ)
    return qt.SparseCSR.from_triplets(rows, cols, rng.normal(size=rows.size), (m, SPARSE_OP_COLS))


def phase_sparse_apply(rng, c3, smi):
    """SegmentedBandedQR on config 3 (fp32) times a sparse operand, both
    directions, against the dense apply of the densified operand (pattern
    and values); the operand as a sparse A2 under a segmented left; the
    banded-left ellipse stack with a sparse A2 at N = 2,000.  Returns the
    launches of the two compositions."""
    seg = qt.SegmentedBandedQR(suggested_block_cols=C3_BC, segment_blocks=C3_SEGMENT_BLOCKS,
                               device=DEVICE, dtype=torch.float32).compute(c3)
    S = sparse_operand(rng, c3.nrows)
    S_dense = torch.as_tensor(S.to_dense(), dtype=torch.float32, device=DEVICE)
    for name, dense_fn in (("apply_qt_sparse", seg.apply_qt), ("apply_q_sparse", seg.apply_q)):
        sparse_fn = getattr(seg, name)
        out = sparse_fn(S)
        ref = dense_fn(S_dense).double().cpu().numpy()
        ent = seg._sparse_apply_cache[name == "apply_qt_sparse"]
        fill = np.zeros(ref.shape, dtype=bool)
        fill[ent["rows"], ent["cols"]] = True
        outside = int(((ref != 0) & ~fill).sum())
        rtol, atol_rel = SPARSE_TOL
        err = np.abs(out.to_dense() - ref)
        bad = int((err > atol_rel * np.abs(ref).max() + rtol * np.abs(ref)).sum())
        sparse_ms, _ = wall_ms(lambda: sparse_fn(S), 5)
        dense_ms, _ = wall_ms(lambda: dense_fn(S_dense).cpu(), 5)
        emit({"phase": "sparse_apply", "case": name, "operand": [S.nrows, S.ncols], "operand_nnz": S.nnz,
              "fill_nnz": int(fill.sum()), "result_nnz": out.nnz, "dense_nonzeros": int((ref != 0).sum()),
              "nonzeros_outside_fill": outside, "max_abs_err": float(err.max()), "violations": bad,
              "rtol": rtol, "atol_x_max_abs": atol_rel, "sparse_ms": sparse_ms,
              "dense_apply_and_fetch_ms": dense_ms,
              "method": "host wall time ending in synchronize (the sparse product ends in its host "
                        "CSR), warm plan, one warm-up, median of 5", "gpu": smi})
        if outside or bad:
            raise AssertionError(f"{name}: {outside} nonzeros outside the fill, {bad} values out of tolerance")
    total = {name: 0 for name in profiling.launch_counts()}
    # the operand as A2 under a segmented left: consistent system, residual gate
    x_true = rng.normal(size=c3.ncols + SPARSE_OP_COLS)
    b_np = c3.matvec(x_true[: c3.ncols]) + S.matvec(x_true[c3.ncols :])
    cases = [("segmented_left_sparse_a2", qt.SegmentedBandedQR(
        suggested_block_cols=C3_BC, segment_blocks=C3_SEGMENT_BLOCKS, device=DEVICE, dtype=torch.float32),
        c3, S, b_np, {name: 1 for name in BANDED_KERNELS})]
    # the banded-left ellipse shape with a sparse A2 (its damped Jacobian)
    f = ellipse.EllipseFitting(ellipse.ellipse_points(ellipse.Ellipse(*ELLIPSE_TRUTH), BANDED_LEFT_N),
                               dtype=torch.float32, device=DEVICE)
    x0 = f.initial_params()
    r0 = f.residuals(x0)
    left_d, right_d, rhs = f._damped(x0, r0, 1e-3)
    n = f.n
    left_sp = qt.SparseCSR.from_triplets(np.arange(3 * n), np.repeat(np.arange(n), 3),
                                         left_d.cpu().numpy().reshape(-1), (3 * n + 5, n))
    a2_sp = qt.SparseCSR.from_dense(right_d.double().cpu().numpy())
    cases.append(("banded_left_sparse_a2_n2000", qt.BandedBlockedQR(
        3, 1, 0, 1, device=DEVICE, dtype=torch.float32), left_sp, a2_sp, None, {"banded_chain_qr": 1}))
    for label, left_solver, left_m, a2, b_np, want in cases:
        solver = qt.BlockAngularQR(left_solver, qt.DenseColPivQR())
        mat = qt.BlockMatrix1x2(left_m, a2)
        profiling.reset_launch_counts()
        t0 = time.perf_counter()
        solver.compute(mat)
        counts = profiling.launch_counts()
        if b_np is None:  # against the fused dense step on the same system
            x = solver.solve(rhs)
            ref = f.damped_step(x0, r0, 1e-3)
            err, _ = compare(x, ref, torch.float32, SPARSE_TOL)
            gate = {"max_abs_err_vs_damped_step": err, "rtol": SPARSE_TOL[0], "atol_x_max_abs": SPARSE_TOL[1]}
        else:
            pb = torch.as_tensor(solver.rows_permutation().apply(b_np), dtype=torch.float32, device=DEVICE)
            x = solver.solve(pb)
            xh = x.double().cpu().numpy()
            resid = float(np.linalg.norm(left_m.matvec(xh[: left_m.ncols]) + a2.matvec(xh[left_m.ncols :])
                                         - b_np) / np.linalg.norm(b_np))
            gate = {"rel_residual": resid, "gate": RESID_GATE}
            if not resid < RESID_GATE:
                raise AssertionError(f"{label}: fp32 relative residual {resid}")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # the compute's launches: the left's factorize and its Qᵀ of A2 (K1)
        if (not launches_ok(counts, want, (K1,)) or solver._r12_coo is None
                or "banded_a2" not in solver._plan_cache):
            raise AssertionError(f"{label}: launches {counts} (want {pin_text(want, (K1,))}) "
                                 "or the sparse path not taken")
        ms, _ = wall_ms(lambda: (solver.compute(mat), solver.solve(x.new_ones(mat.left_rows))), 3)
        emit({"phase": "sparse_apply", "case": label, "shape": [left_m.nrows, left_m.ncols + a2.ncols],
              "a2_nnz": a2.nnz, "launches": counts, **gate, "info": solver.info().name,
              "wall_s_incl_plan": seconds, "compute_solve_ms": ms,
              "method": "compute_solve_ms: host wall time of compute + solve on a warm plan, ending in "
                        "synchronize, one warm-up, median of 3", "gpu": smi})
        for name in total:
            total[name] += counts[name]
    return total


THIN_M = 100_000
THIN_SPARSE_NNZ = 800_000  # about config 3's
THIN_DEAD = {10: 5, 100: 50, 200: 150}  # column replaced -> the column it copies


def host_lstsq_residual(dense, b):
    x, *_ = np.linalg.lstsq(dense, b, rcond=None)
    return float(np.linalg.norm(dense @ x - b))


def phase_blocked_thin(rng, smi):
    """BlockedThinDenseQR on dense 100,000 × 48 and × 256, BlockedThinSparseQR
    on a 100,000 × 256 sparse matrix and its rank-deficient copy (fp32):
    consistent systems against the residual gate; the deficient copy's
    rank and its residual against the host's fp64 lstsq."""
    cases = []
    for n in (48, 256):
        a = rng.normal(size=(THIN_M, n))
        cases.append((f"dense_{THIN_M}x{n}", lambda: qt.BlockedThinDenseQR(2),
                      torch.as_tensor(a, dtype=torch.float32, device=DEVICE), a, n))
    n = 256
    rows = rng.integers(0, THIN_M, size=THIN_SPARSE_NNZ)
    cols = np.concatenate([np.arange(n), rng.integers(0, n, size=THIN_SPARSE_NNZ - n)])
    sp = qt.SparseCSR.from_triplets(rows, cols, rng.normal(size=rows.size), (THIN_M, n))
    dense = sp.to_dense()
    for dst, src in THIN_DEAD.items():
        dense[:, dst] = dense[:, src]
    dead = qt.SparseCSR.from_dense(dense)
    for label, mat, want_rank in (("sparse", sp, n), ("sparse_rank_deficient", dead, n - len(THIN_DEAD))):
        cases.append((f"{label}_{THIN_M}x{n}", lambda: qt.BlockedThinSparseQR(
            2, device=DEVICE, dtype=torch.float32), mat, mat.to_dense(), want_rank))
    for label, make, inp, host, want_rank in cases:
        m, n = host.shape
        consistent = want_rank == n
        b_np = host @ rng.normal(size=n) if consistent else rng.normal(size=m)
        solver = make()
        profiling.reset_launch_counts()
        t0 = time.perf_counter()
        solver.compute(inp)
        pb = torch.as_tensor(solver.rows_permutation().apply(b_np), dtype=torch.float32, device=DEVICE)
        x = solver.solve(pb)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = profiling.launch_counts()
        xh = x.double().cpu().numpy()
        resid = float(np.linalg.norm(host @ xh - b_np))
        rec = {"phase": "blocked_thin", "case": label, "shape": [m, n], "rank": solver.rank,
               "rank_expected": want_rank, "info": solver.info().name, "launches": counts,
               "wall_s_incl_first_use": seconds, "gpu": smi}
        if consistent:
            rec.update(rel_residual=resid / float(np.linalg.norm(b_np)), gate=RESID_GATE)
            ok = rec["rel_residual"] < RESID_GATE
        else:
            opt = host_lstsq_residual(host, b_np)
            rec.update(residual=resid, optimal_residual_fp64=opt, rel_excess=resid / opt - 1.0, gate=1e-4,
                       deficient_cols=sorted(int(c) for c in solver.deficient_cols()))
            ok = resid <= opt * (1 + 1e-4) and set(rec["deficient_cols"]) <= set(THIN_DEAD) | set(THIN_DEAD.values())
        if isinstance(solver, qt.BlockedThinDenseQR):
            rec["route"] = "geqrf" if n > 64 else f"panel loop, {solver.c} columns"
        ms, _ = wall_ms(lambda: (solver.compute(inp), solver.solve(pb)), 3)
        rec.update(compute_solve_ms=ms, method="host wall time of compute + solve ending in "
                   "synchronize (the sparse solver's host analysis included), one warm-up, median of 3")
        emit(rec)
        if not ok or solver.rank != want_rank or any(counts.values()):
            raise AssertionError(f"blocked thin {label}: {rec}")


# --- phase sparse_programs: the sparse-operand recomputes as captured programs ----------
SPARSE_PROGRAM_ROUNDS = ("captured", "eager", "eager", "captured")
SPARSE_PROGRAM_WARM = 3  # calls before the counted one: eager, capture, first replay
THIN_POOL_GATE = 3  # the thin program's pool at most this many working matrices (m·n·itemsize)


def host_arrays(*xs):
    """Fresh host copies of tensors, arrays and the arrays of a SparseCSR."""
    out = []
    for x in xs:
        if isinstance(x, qt.SparseCSR):
            out += [x.indptr.copy(), x.indices.copy(), np.asarray(x.data).copy()]
        elif isinstance(x, torch.Tensor):
            out.append(x.detach().cpu().numpy().copy())
        else:
            out.append(np.array(x))
    return out


def drive_sparse_program(path, label, programs, names, call, read, pin, want, reps, smi,
                         scans=()):
    """One sparse-operand recompute at full width: the warm-up calls (the
    first eager, the second warm-up + capture), the warm call counted
    against ``pin = (programs, counted, host reads)``, where counted is the
    reference's count (ATen ops, replays, host-issued launches, less the
    host reads: a fetch is a copy, not a launch), ``want`` the launches of
    its replays by kernel (``scans``: K1 / K2 at least once); the captured
    result against the same call under ``_program.eager()``, bitwise; then
    captured and eager in turns (host
    µs and wall µs per call, device time).  ``read(out)`` gives host
    arrays of what the call produced.  Returns the warm call's launches and
    the pool's bytes."""
    start = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(SPARSE_PROGRAM_WARM - 1):
        call()
    with profiling.count_dispatches() as d:
        out = call()
    torch.cuda.synchronize()
    got = read(out)
    progs = [p for key, p in programs.programs().items() if key[0] in names]
    eager = read(eagerly(call)())
    call()  # the left's program back (an eager call rebinds its factors)
    again = read(call())
    torch.cuda.synchronize()
    launches = {k: v for k, v in d.launches.items() if v}
    warm = {"programs": d.programs, "ops": d.ops, "host_reads": d.host_reads,
            "counted": d.count - d.host_reads,
            "host_launches": {k: v for k, v in d.host_launches.items() if v}}
    bitwise = all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(got, eager, again))
    n_programs, budget, reads = pin
    problems = []
    if (d.programs != n_programs or warm["counted"] > budget or d.host_reads != reads
            or warm["host_launches"]):
        problems.append(f"warm call {warm} outside the pin ({n_programs} replays, counted <= "
                        f"{budget}, {reads} host reads, no host-issued launch)")
    if not launches_ok(launches, want, scans):
        problems.append(f"launches {launches}, want {pin_text(want, scans)} inside the replays")
    if len(progs) != len(names):
        problems.append(f"programs {sorted(p.name for p in progs)}, want {sorted(names)}")
    if not bitwise:
        problems.append("the captured call differs from the eager call")
    if not all(np.isfinite(a).all() for a in got if a.dtype.kind == "f"):
        problems.append("non-finite output")
    if problems:
        raise AssertionError(f"sparse_programs {path} {label}: " + "; ".join(problems))
    times = {"captured": [], "eager": []}
    for kind in SPARSE_PROGRAM_ROUNDS:
        if kind == "captured":
            call()
        times[kind].append(host_and_wall_us(call if kind == "captured" else eagerly(call), reps))
    call()
    dev = {"captured": device_time_ms(call, reps=reps), "eager": device_time_ms(eagerly(call), reps=reps)}
    pool = programs.pool_bytes()
    mean = lambda xs, i: statistics.mean(x[i] for x in xs)  # noqa: E731
    emit({
        "phase": "sparse_programs", "path": path, "call": label,
        "programs": sorted(p.name for p in progs),
        "capture_s": sum(p.capture_seconds for p in progs), "first_call_s": first_s,
        "warm": warm, "pin": {"programs": n_programs, "counted": budget, "host_reads": reads},
        "launches_per_replay": launches, "bitwise_equal_eager": bitwise,
        "captured_host_us": mean(times["captured"], 0), "eager_host_us": mean(times["eager"], 0),
        "captured_wall_us": mean(times["captured"], 1), "eager_wall_us": mean(times["eager"], 1),
        "captured_device_ms": dev["captured"], "eager_device_ms": dev["eager"],
        "pool_mb": (pool or 0) / 2**20, "reps": reps, "rounds": list(SPARSE_PROGRAM_ROUNDS),
        "seconds": time.perf_counter() - start,
        "method": "first_call_s: the first call (eager), synchronized; counted: ATen ops + "
                  "replays + host-issued launches - host reads, of the fourth call; rounds "
                  "as listed (eager = _program.eager(); one untimed call before a captured "
                  "round binds the left's factors back); host_us: host clock over reps calls "
                  "before the synchronize; wall_us: the same ending in synchronize; means of "
                  "the rounds; device_ms: torch.profiler's kernel time per call; pool_mb: the "
                  "solver's graph pool "
                  "(memory_snapshot)",
        "gpu": smi,
    })
    return launches, pool


def phase_sparse_programs(rng, c3, smi):
    """Each same-pattern sparse-operand recompute at full width, captured
    against ``_program.eager()``, fp32: config 3's 48-column sparse operand
    through both banded solvers (``apply_qt_sparse``, ``apply_q_sparse``),
    ``BlockedThinSparseQR.compute`` on 100,000 × 256, config 4's sparse A2
    at N = 100,000 (B2 in the left's replay), the banded-left sparse A2 at
    N = 2,000 (B5) and config 3 as the segmented left of a sparse A2 (B3,
    B4, B5), each within the reference's pin.  Returns the launches of
    the warm calls' replays by kernel."""
    total = {name: 0 for name in profiling.launch_counts()}

    def drive(*args, **kw):
        launches, pool = drive_sparse_program(*args, **kw, smi=smi)
        for name, n in launches.items():
            total[name] += n
        return pool

    S = sparse_operand(rng, c3.nrows)
    # both directions on the segmented solver; Qᵀ on the plain one
    for cls, kw, methods, reps in (
            (qt.SegmentedBandedQR, dict(segment_blocks=C3_SEGMENT_BLOCKS),
             ("apply_qt_sparse", "apply_q_sparse"), 3),
            (qt.BandedBlockedQR, {}, ("apply_qt_sparse",), 3)):
        solver = cls(suggested_block_cols=C3_BC, device=DEVICE, dtype=torch.float32, **kw).compute(c3)
        for method in methods:
            name = f"{cls.__name__}.{method}"
            drive(f"config3_{cls.__name__}", method, solver._programs, {name},
                  lambda m=method: getattr(solver, m)(S), host_arrays, (1, 2, 1), {}, reps,
                  scans=(K1,))

    n = 256
    rows = rng.integers(0, THIN_M, size=THIN_SPARSE_NNZ)
    cols = np.concatenate([np.arange(n), rng.integers(0, n, size=THIN_SPARSE_NNZ - n)])
    sp = qt.SparseCSR.from_triplets(rows, cols, rng.normal(size=rows.size), (THIN_M, n))
    thin = qt.BlockedThinSparseQR(2, device=DEVICE, dtype=torch.float32)
    pool = drive(f"thin_sparse_{THIN_M}x{n}", "compute", thin._programs, {"BlockedThinSparseQR.compute"},
                 lambda: thin.compute(sp),
                 lambda qr: host_arrays(qr._R, qr.q_seq.Y, qr.q_seq.T, qr._lperms), (1, 9, 0), {}, 2)
    if not thin.rank == n:
        raise AssertionError(f"sparse_programs thin: rank {thin.rank}, want {n}")
    working = THIN_M * n * torch.finfo(torch.float32).bits // 8
    if pool is None or pool > THIN_POOL_GATE * working:
        raise AssertionError(f"sparse_programs thin: pool {pool} bytes, want at most "
                             f"{THIN_POOL_GATE} x the {working}-byte working matrix")

    def angular(path, left_solver, left_m, a2, want, reps):
        qr = qt.BlockAngularQR(left_solver, qt.DenseColPivQR())
        mat = qt.BlockMatrix1x2(left_m, a2)
        route = "blockdiag" if isinstance(left_solver, qt.BlockDiagonalQR) else "chunked"
        left_name = {qt.BlockDiagonalQR: "BlockDiagonalQR.compute", qt.BandedBlockedQR:
                     "BandedBlockedQR.factorize", qt.SegmentedBandedQR: "SegmentedBandedQR.factorize"}
        drive(path, "compute", _Both(qr), {f"BlockAngularQR.sparse_a2_{route}",
                                           left_name[type(left_solver)]},
              lambda: qr.compute(mat),
              lambda q: host_arrays(q.r_diagonal(), q._r12_coo[1], q._r12_coo[2], q.right.inner._R),
              (2, 6, 0), want, reps,
              scans=() if route == "blockdiag" else (K1,))  # Q1ᵀ A2 on a banded left
        if qr._r12_coo is None or qr.info() != qt.ComputationInfo.SUCCESS:
            raise AssertionError(f"sparse_programs {path}: the sparse path or info() {qr.info()}")

    nba = BA_SPARSE_N
    blocks_np, a2_np, _ = block_angular_problem(rng, nba)
    blocks = torch.as_tensor(blocks_np, dtype=torch.float32, device=DEVICE)
    angular(f"config4_sparse_a2_{nba}", qt.BlockDiagonalQR(qt.QFormat.FULL_Q, pivot=False),
            qt.BlockDiagonal(blocks, 2 * nba, nba), qt.SparseCSR.from_dense(a2_np),
            {"blockdiag_qr_r": 1}, 10)
    f = ellipse.EllipseFitting(ellipse.ellipse_points(ellipse.Ellipse(*ELLIPSE_TRUTH), BANDED_LEFT_N),
                               dtype=torch.float32, device=DEVICE)
    x0 = f.initial_params()
    left_d, right_d, _ = f._damped(x0, f.residuals(x0), 1e-3)
    nl = f.n
    left_sp = qt.SparseCSR.from_triplets(np.arange(3 * nl), np.repeat(np.arange(nl), 3),
                                         left_d.cpu().numpy().reshape(-1), (3 * nl + 5, nl))
    angular(f"banded_left_sparse_a2_n{BANDED_LEFT_N}", qt.BandedBlockedQR(
        3, 1, 0, 1, device=DEVICE, dtype=torch.float32), left_sp,
        qt.SparseCSR.from_dense(right_d.double().cpu().numpy()), {"banded_chain_qr": 1}, 3)
    angular("config3_segmented_left_sparse_a2", qt.SegmentedBandedQR(
        suggested_block_cols=C3_BC, segment_blocks=C3_SEGMENT_BLOCKS, device=DEVICE,
        dtype=torch.float32), c3, S, {name: 1 for name in BANDED_KERNELS}, 2)
    missing = [name for name in ("blockdiag_qr_r", *BANDED_KERNELS, K1) if not total[name]]
    if missing:
        raise AssertionError(f"sparse_programs: kernels never launched inside a replay: {missing}")
    return total


class _Both:
    """The programs of a BlockAngularQR and of its left solver, as one
    ``programs()`` / ``pool_bytes()`` for :func:`drive_sparse_program`."""

    def __init__(self, qr):
        self.qr = qr

    def programs(self):
        return {**self.qr.left._programs.programs(), **self.qr._programs.programs()}

    def pool_bytes(self):
        return sum(p.pool_bytes() or 0 for p in (self.qr.left._programs, self.qr._programs))


BUNDLE_FIT_ROUNDS = ("captured", "eager", "captured")


def bundle_fits(smi):
    """``fit_bundle`` (the host LM loop) at P = 5,000, fp32: two captured
    fits and one eager (``_program.eager()``) fit in turns, per fit and per
    iteration; within a fit (a new solver) the sparse-A2 recompute replays
    from the third step and the generic solve from the fourth, the left's
    compute (B2) runs eagerly each step (a new container a step).  Every
    fit is held bitwise to the first, iteration count included: R12's
    products are summed in a fixed order, so one input gives one result."""
    cams0, pts0, uv = bundle_start(BUNDLE_HOST_P)
    f32 = dict(device=DEVICE, dtype=torch.float32)

    def fit():
        return bundle.fit_bundle(cams0, pts0, uv, BUNDLE_CFG, **f32)

    fits = {"captured": [], "eager": []}
    counts = {}
    for kind in BUNDLE_FIT_ROUNDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.count_dispatches() as d:
            res = fit() if kind == "captured" else eagerly(fit)()
        torch.cuda.synchronize()
        fits[kind].append((time.perf_counter() - t0, res, d.programs, d.host_reads, d.ops))
        counts.setdefault(kind, d.launches)
    (cs, cres, cprog, creads, cops), (es, eres, *_ ) = fits["captured"][0], fits["eager"][0]
    results = [f[1] for kind in fits for f in fits[kind]]
    host = [(np.asarray(r.x.detach().cpu().numpy() if isinstance(r.x, torch.Tensor) else r.x),
             int(r.iterations), float(r.cost)) for r in results]
    it = int(cres.iterations)
    rms = float(np.sqrt(2.0 * cres.cost / (2 * BUNDLE_HOST_P * BUNDLE_CAMS)))
    bitwise = all(np.array_equal(x, host[0][0]) and i == host[0][1] and c == host[0][2]
                  for x, i, c in host)
    rel = abs(float(cres.cost) - float(eres.cost)) / float(eres.cost)
    line = {
        "phase": "banded_programs", "path": f"bundle_host_loop_{BUNDLE_HOST_P}", "call": "fit_bundle",
        "iterations": [h[1] for h in host], "rms_reproj": rms, "gate": BUNDLE_RMS_GATE,
        "rel_cost_diff_eager": rel, "bitwise_equal": bitwise,
        "captured_fit_s": statistics.mean(f[0] for f in fits["captured"]),
        "eager_fit_s": statistics.mean(f[0] for f in fits["eager"]),
        "captured_iteration_ms": statistics.mean(f[0] for f in fits["captured"]) / it * 1e3,
        "eager_iteration_ms": statistics.mean(f[0] for f in fits["eager"]) / it * 1e3,
        "captured_programs_per_fit": cprog, "captured_host_reads_per_iteration": creads / it,
        "captured_aten_ops_per_iteration": cops / it,
        "launches_captured_fit": {k: v for k, v in counts["captured"].items() if v},
        "launches_eager_fit": {k: v for k, v in counts["eager"].items() if v},
        "method": "host wall time of a whole fit ending in synchronize (a new solver a fit), rounds "
                  "captured, eager, captured, means; per iteration: the fit over its iterations; "
                  "counts from the first fit of each kind; bitwise: x, iterations and cost of every "
                  "fit equal to the first's",
        "gpu": smi,
    }
    emit(line)
    # from the fourth step a step replays two programs: the sparse-A2
    # recompute and the solve
    if not (rms < BUNDLE_RMS_GATE and bitwise and cprog >= 2 * (it - 3)):
        raise AssertionError(f"banded_programs bundle: {line}")


BANDED_PROGRAM_ROUNDS = ("captured", "eager", "eager", "captured")
BANDED_POOL_GATE = 3  # a new program's pool at most this many times its rhs and factor bytes
BANDED_RHS_COLS = 16  # config 3's matrix rhs
BANDED_LEFT_RHS_COLS = 5


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def factor_bytes(*caches):
    """Bytes of the factors the caches' factorize programs hold (their outputs)."""
    return sum(nbytes(*p.out) for c in caches for p in c.programs().values() if p.persistent)


class _Caches:
    """Several solvers' program caches as one ``programs()`` /
    ``pool_bytes()``."""

    def __init__(self, *caches):
        self.caches = caches

    def programs(self):
        return {k: p for c in self.caches for k, p in c.programs().items()}

    def pool_bytes(self):
        return sum(c.pool_bytes() or 0 for c in self.caches)


def drive_banded_program(path, label, programs, names, call, pin, want, rhs_bytes, fac_bytes,
                         reps, smi, rewarm=0, scans=()):
    """One newly captured call at full width: the first call (eager), the
    second (warm-up + capture; the pool it added gated at
    ``BANDED_POOL_GATE`` × (rhs + factor bytes)), the warm call counted
    against ``pin = (replays, counted, host reads)`` (counted: ATen ops +
    replays + host-issued launches − host reads) with ``want`` the launches
    of its replays (``scans``: K1 / K2 at least once); its result bitwise
    equal to the same call under
    ``_program.eager()`` and to a later replay (``rewarm`` calls first: a
    call whose eager form rebinds factors captures its solve again); then
    captured and eager in turns.  Returns the warm call's launches and its
    result."""
    start = time.perf_counter()
    torch.cuda.synchronize()
    pool0 = programs.pool_bytes() or 0
    before = {id(p) for p in programs.programs().values()}
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    capture_call_s = time.perf_counter() - t0
    pool1 = programs.pool_bytes() or 0
    call()
    with profiling.count_dispatches() as d:
        out = call()
    torch.cuda.synchronize()
    got = out.clone()
    # the programs this call captured (a compute + solve replays earlier ones)
    progs = [p for p in programs.programs().values() if p.name in names and id(p) not in before]
    missing = set(names) - {p.name for p in programs.programs().values()}
    eager = eagerly(call)()
    for _ in range(rewarm):
        call()
    again = call()
    torch.cuda.synchronize()
    launches = {k: v for k, v in d.launches.items() if v}
    warm = {"programs": d.programs, "ops": d.ops, "host_reads": d.host_reads,
            "counted": d.count - d.host_reads,
            "host_launches": {k: v for k, v in d.host_launches.items() if v}}
    bitwise = bool(torch.equal(got, eager) and torch.equal(got, again))
    n_programs, budget, reads = pin
    gate = BANDED_POOL_GATE * (rhs_bytes + fac_bytes)
    problems = []
    if (d.programs != n_programs or warm["counted"] > budget or d.host_reads != reads
            or warm["host_launches"]):
        problems.append(f"warm call {warm} outside the pin ({n_programs} replays, counted <= "
                        f"{budget}, {reads} host reads, no host-issued launch)")
    if not launches_ok(launches, want, scans):
        problems.append(f"launches {launches}, want {pin_text(want, scans)} inside the replays")
    if missing:
        problems.append(f"no program {sorted(missing)}")
    if not bitwise:
        problems.append("the captured call differs from the eager call")
    if not bool(torch.isfinite(got).all()):
        problems.append("non-finite output")
    if pool1 - pool0 > gate:
        problems.append(f"the capture added {pool1 - pool0} bytes to the pool, gate {gate}")
    if problems:
        raise AssertionError(f"banded_programs {path} {label}: " + "; ".join(problems))
    times = {"captured": [], "eager": []}
    for kind in BANDED_PROGRAM_ROUNDS:
        if kind == "captured":
            for _ in range(1 + rewarm):
                call()
            times[kind].append(host_and_wall_us(call, reps))
        else:
            times[kind].append(host_and_wall_us(eagerly(call), reps))
    for _ in range(1 + rewarm):
        call()
    dev = {"captured": device_time_ms(call, reps=reps), "eager": device_time_ms(eagerly(call), reps=reps)}
    pool = programs.pool_bytes()
    mean = lambda xs, i: statistics.mean(x[i] for x in xs)  # noqa: E731
    emit({
        "phase": "banded_programs", "path": path, "call": label,
        "programs": sorted(p.name for p in progs),
        "capture_s": sum(p.capture_seconds for p in progs), "first_call_s": first_s,
        "capture_call_s": capture_call_s,
        "warm": warm, "pin": {"programs": n_programs, "counted": budget, "host_reads": reads},
        "launches_per_replay": launches, "bitwise_equal_eager": bitwise,
        "captured_host_us": mean(times["captured"], 0), "eager_host_us": mean(times["eager"], 0),
        "captured_wall_us": mean(times["captured"], 1), "eager_wall_us": mean(times["eager"], 1),
        "captured_device_ms": dev["captured"], "eager_device_ms": dev["eager"],
        "capture_pool_mb": (pool1 - pool0) / 2**20, "pool_mb": (pool or 0) / 2**20,
        "pool_gate_mb": gate / 2**20, "rhs_mb": rhs_bytes / 2**20, "factor_mb": fac_bytes / 2**20,
        "reps": reps, "rounds": list(BANDED_PROGRAM_ROUNDS), "seconds": time.perf_counter() - start,
        "method": "first_call_s: the first call (eager), synchronized; capture_call_s: the second "
                  "(warm-up + capture), synchronized; capture_s: the capture alone; counted: ATen "
                  "ops + replays + host-issued launches - host reads, of the fourth call; host_us: "
                  "host clock over reps calls before the synchronize; wall_us: the same ending in "
                  "synchronize; rounds as listed (eager = _program.eager(); untimed calls before a "
                  "captured round bring its replays back), means; device_ms: torch.profiler's "
                  "kernel time per call; capture_pool_mb: what the "
                  "capture added to the solvers' graph pools (memory_snapshot), gated at "
                  f"{BANDED_POOL_GATE} x (rhs + factor bytes); pool_mb: the pools at the end",
        "gpu": smi,
    })
    return launches, got


def banded_left_problem():
    """The banded-left ellipse stack's operands at N = 2,000 (fp32): the
    3×1-block left as a host CSR with its 5 zero tail rows, the sparse A2
    and the damped rhs, from the first LM step's damped system."""
    f = ellipse.EllipseFitting(ellipse.ellipse_points(ellipse.Ellipse(*ELLIPSE_TRUTH), BANDED_LEFT_N),
                               dtype=torch.float32, device=DEVICE)
    x0 = f.initial_params()
    left_d, right_d, rhs = f._damped(x0, f.residuals(x0), 1e-3)
    nl = f.n
    left_sp = qt.SparseCSR.from_triplets(np.arange(3 * nl), np.repeat(np.arange(nl), 3),
                                         left_d.cpu().numpy().reshape(-1), (3 * nl + 5, nl))
    return left_sp, qt.SparseCSR.from_dense(right_d.double().cpu().numpy()), rhs


def phase_banded_programs(rng, c3, smi):
    """The banded family's Q products and back-substitutions as programs,
    fp32, each captured against ``_program.eager()``: config 3 through
    ``BandedBlockedQR`` (its refactorize B5) and ``SegmentedBandedQR`` (B3,
    B4, B5): ``apply_qt`` / ``apply_q`` on a vector and on 16 columns,
    ``solve_r`` on a vector; ``BlockAngularQR``'s generic solve over the
    banded left at N = 2,000 with a sparse A2 (vector, 5 columns, and a
    compute + solve; B5) and over config 3 as a segmented left with the
    48-column A2; then the bundle host loop's fits, bitwise.  Each warm call
    is one replay, no host read, no host-issued launch, bitwise equal to
    eager; Q products keep b's norm and Q·(Qᵀb) is b, ``solve_r`` of Qᵀb's
    top rows is the solve.  Returns the warm calls' launches by kernel."""
    total = {name: 0 for name in profiling.launch_counts()}
    solve_pin = (1, PROGRAM_BUDGET_OPS + 1, 0)  # the replay, copy in, clone out, one view

    def drive(*args, **kw):
        launches, out = drive_banded_program(*args, **kw, smi=smi)
        for name, n in launches.items():
            total[name] += n
        return out

    def close(got, want, what, path):
        g, w = got.double().cpu(), want.double().cpu()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if not err < 1e-4:
            raise AssertionError(f"banded_programs {path}: {what}, relative error {err}")

    for cls, kw, want, reps in (
            (qt.SegmentedBandedQR, dict(segment_blocks=C3_SEGMENT_BLOCKS),
             {name: 1 for name in BANDED_KERNELS}, 5),
            (qt.BandedBlockedQR, {}, {"banded_chain_qr": 1}, 5)):
        name = cls.__name__
        path = f"config3_{name}"
        solver = cls(suggested_block_cols=C3_BC, device=DEVICE, dtype=torch.float32, **kw).compute(c3)
        values = torch.as_tensor(c3.data, dtype=torch.float32, device=DEVICE)
        solver.factorize_values(values)  # the capture
        with profiling.count_dispatches() as d:
            solver.factorize_values(values)
        fac_want = {**want, **factorize_scans(solver)}
        if d.programs != 1 or not launches_ok(d.launches, fac_want):
            raise AssertionError(f"banded_programs {path}: refactorize {d.programs} replays, "
                                 f"launches {d.launches}, want {fac_want}")
        for k, v in fac_want.items():
            total[k] += v
        fac = factor_bytes(solver._programs)
        b = torch.as_tensor(rng.normal(size=c3.nrows), dtype=torch.float32, device=DEVICE)
        B = torch.as_tensor(rng.normal(size=(c3.nrows, BANDED_RHS_COLS)), dtype=torch.float32,
                            device=DEVICE)
        for label, rhs in (("apply_qt", b), (f"apply_qt_k{BANDED_RHS_COLS}", B)):
            qtb = drive(path, label, solver._programs, {f"{name}.apply_qt"},
                        lambda rhs=rhs: solver.apply_qt(rhs), solve_pin, {}, nbytes(rhs), fac, reps,
                        scans=(K1,))
            norms = (qtb.double().norm(dim=0), rhs.double().norm(dim=0))
            close(norms[0], norms[1], "|Q^T b| against |b|", path)
            qb = drive(path, label.replace("qt", "q"), solver._programs, {f"{name}.apply_q"},
                       lambda qtb=qtb: solver.apply_q(qtb), solve_pin, {}, nbytes(rhs), fac, reps,
                       scans=(K1,))
            close(qb, rhs, "Q (Q^T b) against b", path)
        y = solver.apply_qt(b)[: c3.ncols].clone()
        z = drive(path, "solve_r", solver._programs, {f"{name}.solve_r"},
                  lambda: solver.solve_r(y), solve_pin, {}, nbytes(y), fac, reps, scans=(K2,))
        close(solver._unpermute(z), solver.solve(b), "solve_r(Q^T b) against solve(b)", path)

    def angular(path, left_solver, left_m, a2, rhs_list, computes, reps, kernels):
        qr = qt.BlockAngularQR(left_solver, qt.DenseColPivQR())
        mat = qt.BlockMatrix1x2(left_m, a2)
        for _ in range(3):  # the left's and the sparse-A2 programs captured
            qr.compute(mat)
        caches = _Caches(qr.left._programs, qr._programs)
        fac = factor_bytes(qr.left._programs, qr._programs)
        if qr._programs.state() is None or not qr._solve_capture()[0]:
            raise AssertionError(f"banded_programs {path}: the generic solve is not capturable")
        for label, rhs in rhs_list:
            drive(path, label, caches, {"BlockAngularQR.generic_solve"},
                  lambda rhs=rhs: qr.solve(rhs), solve_pin, {}, nbytes(rhs), fac, reps,
                  scans=SCAN_KERNELS)  # the left's Qᵀ and back-substitution
        if computes:
            rhs = rhs_list[0][1]

            def compute_solve():
                qr.compute(mat)
                return qr.solve(rhs)

            names = {"BlockAngularQR.generic_solve", "BlockAngularQR.sparse_a2_chunked",
                     f"{type(left_solver).__name__}.factorize"}
            # three replays: the left's refactorize, the sparse-A2 recompute
            # (the reference's pin, counted <= 6) and the solve
            drive(path, "compute+solve", caches, names, compute_solve, (3, 6 + solve_pin[1], 0),
                  kernels, nbytes(rhs), fac, reps, rewarm=2, scans=SCAN_KERNELS)
        if qr.info() != qt.ComputationInfo.SUCCESS:
            raise AssertionError(f"banded_programs {path}: info() {qr.info()}")

    left_sp, a2_sp, rhs = banded_left_problem()
    rhs_k = torch.as_tensor(rng.normal(size=(left_sp.nrows, BANDED_LEFT_RHS_COLS)),
                            dtype=torch.float32, device=DEVICE)
    angular(f"banded_left_sparse_a2_n{BANDED_LEFT_N}", qt.BandedBlockedQR(
        3, 1, 0, 1, device=DEVICE, dtype=torch.float32), left_sp, a2_sp,
        (("solve", rhs), (f"solve_k{BANDED_LEFT_RHS_COLS}", rhs_k)), True, 5,
        {"banded_chain_qr": 1})
    S = sparse_operand(rng, c3.nrows)
    b3 = torch.as_tensor(rng.normal(size=c3.nrows), dtype=torch.float32, device=DEVICE)
    angular("config3_segmented_left_sparse_a2", qt.SegmentedBandedQR(
        suggested_block_cols=C3_BC, segment_blocks=C3_SEGMENT_BLOCKS, device=DEVICE,
        dtype=torch.float32), c3, S, (("solve", b3),), False, 5, {})

    missing = [name for name in (*BANDED_KERNELS, *SCAN_KERNELS) if not total[name]]
    if missing:
        raise AssertionError(f"banded_programs: kernels never launched inside a replay: {missing}")
    bundle_fits(smi)
    return total


LAUNCH_FLOOR_CASES = ((BR, BC, NB_CONFIG2), (2 * BUNDLE_CAMS + 3, 3, BUNDLE_HOST_P), (BR, BC, NB_REAL))


def phase_launch_floor(smi):
    """Device time of a kernel that does nothing on B1/B2's grid at config
    2's 10,000 × 7×2, the bundle's 5,000 × 19×3 and the 1M-block point: what
    a launch of that grid costs before any byte moves.  Returns
    {"{n}x{br}x{bc}": ms}."""
    out = {}
    dev = torch.cuda.current_device()
    for br, bc, n in LAUNCH_FLOOR_CASES:
        empty = _build.blockdiag_launcher("empty", br, bc)
        ms = device_time_ms(lambda: empty(dev, n), one_kernel=True)
        out[f"{n}x{br}x{bc}"] = ms
        emit({"phase": "launch_floor", "n": n, "shape": [br, bc], "device_ms": ms,
              "method": "torch.profiler's mean kernel "
              "duration over the records it kept of 20 launches of the empty kernel", "gpu": smi})
    return out


MESH_BA_N, MESH_ELLIPSE_N, MESH_BUNDLE_P, MESH_DRYRUN_BUNDLE_P = 100_000, 100_000, 20_000, 100_000


def mesh_turns(none_fn, mesh_fn, reps):
    """(none ms, mesh ms, rounds): each call between two CUDA events on the
    stream, with a synchronize before and after it; rounds none, mesh, mesh,
    none, each the median of ``reps`` calls, after one warm-up call each."""
    fns = {"none": none_fn, "mesh": mesh_fn}
    for fn in fns.values():
        fn()
    rounds = {"none": [], "mesh": []}
    for key in ("none", "mesh", "mesh", "none"):
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fns[key]()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        rounds[key].append(statistics.median(times))
    return statistics.mean(rounds["none"]), statistics.mean(rounds["mesh"]), rounds


def mesh_check(label, none_fn, mesh_fn, bitwise, reps, smi, want=None, extra=None, scans=()):
    """One mesh path: its mesh=None result, then its mesh result with the
    launch counters set to 0 right before and read right after (they must
    equal ``want``, or what ``want()`` gives after the run, with each of
    ``scans`` at least once), the two
    compared (fp32 rtol 1e-4, atol 1e-5·max|·|; bitwise where
    ``bitwise``), then both timed in turns (the mesh call's first run is
    eager, its second captures: the rounds replay).  Returns the mesh
    run's launches."""
    ref = none_fn()
    torch.cuda.synchronize()
    profiling.reset_launch_counts()
    out = mesh_fn()
    torch.cuda.synchronize()
    counts = profiling.launch_counts()
    want = (want() if callable(want) else want) or {}
    if not launches_ok(counts, want, scans):
        raise AssertionError(f"mesh {label}: launches {counts}, want {pin_text(want, scans)}")
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    max_abs, equal = 0.0, True
    for o, r in zip(outs, refs):
        if tuple(o.shape) != tuple(r.shape):
            raise AssertionError(f"mesh {label}: shape {tuple(o.shape)} against {tuple(r.shape)}")
        try:
            e, eq = compare(o, r, torch.float32)
        except AssertionError as err:
            raise AssertionError(f"mesh {label}: the mesh result differs from mesh=None: {err}")
        max_abs, equal = max(max_abs, e), equal and eq
    if bitwise and not equal:
        raise AssertionError(f"mesh {label}: the same kernels on the same data gave other bits")
    none_ms, mesh_ms, rounds = mesh_turns(none_fn, mesh_fn, reps)
    emit({"phase": "mesh", "path": label, "dtype": "float32", "max_abs_diff": max_abs,
          "bitwise_equal": equal, "bitwise_expected": bitwise, "launches": counts,
          "ms_none": none_ms, "ms_mesh": mesh_ms, "ms_rounds": rounds, **(extra or {}),
          "method": f"host-visible stream time between CUDA events around one call, synchronize "
                    f"before and after; rounds none, mesh, mesh, none, median of {reps}",
          "gpu": smi})
    return counts


def mesh_collective_costs(mesh, smi, reps=50):
    """Host-visible time of one call of each collective helper and of the
    mesh lookup they make (``mesh.get_group``), on this one-rank mesh: the
    all-gather at config 2's x (10,000 and 1M blocks × 2) and the scalar
    all-reduce of a health flag or an LM cost.  Median of ``reps`` calls,
    each between CUDA events with a synchronize before and after (the
    lookup by the host clock)."""
    from qrkit_tpu_torch.parallel.mesh import all_gather_leading, all_reduce_sum

    f32 = dict(dtype=torch.float32, device=DEVICE)
    cases = [(f"all_gather_{n * BC}", lambda t=torch.zeros(n * BC, **f32): all_gather_leading(t, mesh))
             for n in (NB_CONFIG2, NB_REAL)]
    cases.append(("all_reduce_scalar", lambda t=torch.zeros((), **f32): all_reduce_sum(t, mesh)))
    out, captured = {}, {}
    stream = torch.cuda.Stream()
    for label, fn in cases:
        out[label] = mesh_turns(fn, fn, reps)[0]
        graph = torch.cuda.CUDAGraph()  # the helper alone inside a graph, replayed
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            fn()
        captured[label] = mesh_turns(graph.replay, graph.replay, reps)[0]
        del graph
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.get_group("dp")
    out["get_group_host"] = (time.perf_counter() - t0) * 1e3 / reps
    emit({"phase": "mesh_collectives", "ms": out, "captured_ms": captured,
          "method": f"median of {reps} calls between CUDA events, synchronize before and after "
          "(mesh_turns); captured: a replay of a graph holding the one call "
          "(capture_error_mode thread_local); get_group by the host clock", "gpu": smi})


MESH_PROGRAM_REPS = 3  # timed calls a round (captured, eager, eager, captured)
MESH_PROGRAM_KERNELS = KERNEL_NAMES + ("graph_loop_cond",) + tuple(SCAN_KERNELS) + ("lm_step",)


def mesh_programs(mesh, smi):
    """Every mesh path as a captured program on this one-rank mesh, at the
    widths above (``dryrun.program_checks``): per path a warm call's
    replays, ATen ops and host reads, bitwise equality with the same call
    under ``_program.eager()``, the same collectives, agreement with
    ``mesh=None``, capture seconds, and wall and stream ms a call captured
    against eager; the ``reduce=`` bundle fit at 20,000 points: one launch
    and one host read a chunk of 8 iterations, its iterations, bitwise the
    eager loop's.  Counters set
    to 0 before, read after: B1–B5 and L1 must each have launched.
    Returns those launches."""
    profiling.reset_launch_counts()
    t0 = time.perf_counter()
    res = dryrun.program_checks(mesh, dryrun.program_inputs(1, "full"), torch.float32,
                                timed_reps=MESH_PROGRAM_REPS)
    torch.cuda.synchronize()
    counts = profiling.launch_counts()
    lines = dryrun.check_pins(res, torch.float32, captured=True, fetch_reads=1)
    for label, line in lines.items():
        emit({"phase": "mesh_programs", "path": label, **line,
              "method": "dryrun.program_checks: first call (eager), second (warm-up + capture; "
                        "capture_call_s, synchronized), first replay, then the counted warm call; "
                        "wall ms: host clock over reps calls ending in synchronize; stream ms: "
                        "median of CUDA events around each of reps calls; rounds captured, "
                        f"eager, eager, captured of {MESH_PROGRAM_REPS} (a fit: 1)", "gpu": smi})
    missing = [k for k in MESH_PROGRAM_KERNELS if not counts[k]]
    emit({"phase": "mesh_programs", "launches": counts, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    if missing:
        raise AssertionError(f"mesh programs: {missing} never launched")
    return counts


MESH_GRAD_TOL = 1e-10  # fp64 rtol, and atol relative to max|mesh=None|


def mesh_step_grad(mesh, smi):
    """The ``mesh=`` lane-major damped step under autograd on the one NCCL
    rank, at ``MESH_ELLIPSE_N`` points, fp64: the gradients of a loss of
    the step with respect to left, right, res and λ, for the bc = 2 form
    and the bc = 1 form (``dryrun.step_grad_case``), against ``mesh=None``'s
    within rtol 1e-10; one collective in the backward (the all-reduce of
    2·m2 + 1 values); K3 once a step.  Returns the kernel launches."""
    before, calls0 = profiling.launch_counts(), dict(K3_C_CALLS)
    t0 = time.perf_counter()
    cases = dryrun.step_grad_case(mesh, dryrun.step_grad_inputs(1, nb=MESH_ELLIPSE_N))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: v - before.get(k, 0) for k, v in profiling.launch_counts().items()}
    calls = k3_calls_since(calls0)
    errs = dryrun.check_step_grad(cases, MESH_GRAD_TOL)
    # each form: the mesh step (its partial and its finish) and the mesh=None step (one launch)
    n = len(cases)
    if counts.get(K3) != 2 * n or calls != {0: n, 1: n, 2: n}:
        raise AssertionError(f"mesh step grad: K3 counted {counts.get(K3)} steps, C launcher calls {calls}; "
                             f"want {2 * n} steps, {n} of each mode")
    emit({"phase": "mesh", "path": "lm_damped_step_grad", "n": MESH_ELLIPSE_N, "dtype": "float64",
          "forms": list(cases), "max_abs_err": errs, "rtol": MESH_GRAD_TOL,
          "atol_x_max_abs": MESH_GRAD_TOL, "backward_collectives": {"all_reduce": 1},
          "k3_steps": counts.get(K3), "k3_launcher_calls_by_mode": calls, "seconds": seconds, "gpu": smi})
    return counts


def phase_mesh(rng, smi):
    """The mesh paths on a one-rank NCCL mesh in this process (see the
    module docstring).  Returns the mesh runs' kernel launches by name."""
    import torch.distributed as dist

    workdir = os.path.join("build", "mesh")
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    t0 = time.perf_counter()
    mesh = dryrun.init_rank(0, 1, DEVICE, store)
    want = ("nccl", "cuda") if DEVICE == "cuda" else ("gloo", "cpu")  # no gloo on the card
    if (dist.get_backend(), mesh.device_type) != want:
        raise AssertionError(f"mesh: backend {dist.get_backend()} on {mesh.device_type}, want {want}")
    emit({"phase": "mesh_init", "backend": dist.get_backend(), "world": dist.get_world_size(),
          "mesh": str(mesh), "seconds": time.perf_counter() - t0})
    mesh_collective_costs(mesh, smi)
    total = {name: 0 for name in profiling.launch_counts()}

    def add(counts):
        for name, v in counts.items():
            total[name] += v

    f32 = dict(dtype=torch.float32, device=DEVICE)
    try:
        # config 2: the kernel tier per rank (B2 compute, B1 solve)
        for nb in (NB_CONFIG2, NB_REAL):
            blocks, b_np = flagship_system(rng, nb)
            a_soa = np.ascontiguousarray(blocks.transpose(1, 2, 0).reshape(BR * BC, nb))
            mat = qt.BlockDiagonal.from_soa(a_soa, BR, BC, **f32)
            b = torch.as_tensor(b_np, **f32)
            qn, qm = qt.BlockDiagonalQR(pivot=False), qt.BlockDiagonalQR(pivot=False, mesh=mesh)
            add(mesh_check(f"config2_{nb}_7x2", lambda: qn.compute(mat).solve(b),
                           lambda: qm.compute(mat).solve(b), True, 20, smi,
                           {"blockdiag_qr_r": 1, "blockdiag_lstsq": 1}))
            resid = host_residual(blocks, qm.solve(b), b_np)
            if not (qm._kernel_mode and qm.info() == qt.ComputationInfo.SUCCESS and resid < RESID_GATE):
                raise AssertionError(f"mesh config2 {nb}: kernel tier {qm._kernel_mode}, residual {resid}")

        # config 3: B3 and B4 on the rank's segments, B5 on the boundary chain
        mat = banded_matrix(rng, C3_NB, C3_BR, C3_BC, C3_OV)
        b_np = mat.matvec(rng.normal(size=mat.ncols))
        b = torch.as_tensor(b_np, **f32)
        seg = lambda m: qt.SegmentedBandedQR(  # noqa: E731
            suggested_block_cols=C3_BC, segment_blocks=C3_SEGMENT_BLOCKS, mesh=m, **f32)
        sn, sm = seg(None), seg(mesh)
        want = {name: 1 for name in BANDED_KERNELS}
        add(mesh_check("config3_segmented", lambda: sn.compute(mat).solve(b),
                       lambda: sm.compute(mat).solve(b), True, 10, smi, want, scans=SCAN_KERNELS))
        if not (sm._segs == (0, sm.S) and sm._fac_kernel and sm._p2w is not None and sm._chain_kernel):
            raise AssertionError(f"mesh config3: segments {sm._segs}, kernel gates not all taken")
        resid = host_residual_sparse(mat, sm.solve(b), b_np)
        if not resid < RESID_GATE:
            raise AssertionError(f"mesh config3: fp32 relative residual {resid}")
        vals = torch.as_tensor(mat.data * 0.5, **f32)
        add(mesh_check("config3_segmented_factorize_values",
                       lambda: sn.factorize_values(vals).solve(b),
                       lambda: sm.factorize_values(vals).solve(b), True, 10, smi, want,
                       scans=SCAN_KERNELS))

        # config 4: sharded block-diagonal left (B2) and TSQR right
        n = MESH_BA_N
        blocks, a2, b_np = block_angular_problem(rng, n)
        bam = qt.BlockMatrix1x2(qt.BlockDiagonal(torch.as_tensor(blocks, **f32), 2 * n, n),
                                torch.as_tensor(a2, **f32))
        b = torch.as_tensor(b_np, **f32)

        def ba(m):
            return qt.BlockAngularQR(qt.BlockDiagonalQR(qt.QFormat.FULL_Q, pivot=False, mesh=m),
                                     qt.parallel.TSQRDenseQR(1, mesh=m), mesh=m)

        ban, bam_q = ba(None), ba(mesh)
        add(mesh_check("config4_block_angular_tsqr", lambda: ban.compute(bam).solve(b),
                       lambda: bam_q.compute(bam).solve(b), True, 10, smi, {"blockdiag_qr_r": 1}))
        x = bam_q.solve(b).double().cpu().numpy()
        r = np.zeros(2 * n)
        r[0::2], r[1::2] = blocks[:, 0, 0] * x[:n], blocks[:, 1, 0] * x[:n]
        rel = float(np.linalg.norm(r + a2 @ x[n:] - b_np) / np.linalg.norm(b_np))
        if not (rel < RESID_GATE and bam_q.left._kernel_mode):
            raise AssertionError(f"mesh config4: residual {rel}, left kernel tier {bam_q.left._kernel_mode}")

        # the lane-major ellipse step, points sharded over lanes
        f = ellipse.EllipseFitting(ellipse.ellipse_points(ellipse.Ellipse(*ELLIPSE_TRUTH), MESH_ELLIPSE_N),
                                   **f32)
        params, pts = f.initial_params(), f.pts
        lam = torch.tensor(1e-3, **f32)
        res = ellipse._residuals(params, pts)
        add(mesh_check("ellipse_lane_major_step", lambda: ellipse._damped_step_aux(params, res, lam, pts),
                       lambda: ellipse._damped_step_aux(params, res, lam, pts, mesh=mesh), False, 10, smi,
                       {K3: 1, K4J: 1}, extra={"n": MESH_ELLIPSE_N}))

        # the mesh step's gradient (both forms, fp64) against mesh=None's
        add(mesh_step_grad(mesh, smi))

        # the point-sharded bundle device fit
        cams0, pts0, uv = bundle_start(MESH_BUNDLE_P)
        fits = {}

        def fit_b(m):
            fits[m is None] = r = bundle.fit_bundle_device(cams0, pts0, uv, BUNDLE_CFG, mesh=m, **f32)
            return torch.as_tensor(r.x)

        # the reduce= fit's first run: iteration 1 eager, then the whole fit
        # as the chunks of its captured loop (L1 once a gated iteration)
        def fit_want():  # K5: iteration 1's step, the warm-up's, one a gated iteration
            gated = _program.LOOP_CHUNK * _program.loop_chunks(fits[False].iterations,
                                                               BUNDLE_CFG.max_iters)
            return {"graph_loop_cond": gated,
                    K5: (gated + 2) * bundle_step_k5(MESH_BUNDLE_P, BUNDLE_CAMS, world=1)}

        add(mesh_check("bundle_device_fit", lambda: fit_b(None), lambda: fit_b(mesh), False, 1, smi,
                       fit_want,
                       extra={"n_pts": MESH_BUNDLE_P, "n_cams": BUNDLE_CAMS}))
        costs = (fits[True].cost, fits[False].cost)
        rms = float(np.sqrt(2.0 * fits[False].cost / (2 * MESH_BUNDLE_P * BUNDLE_CAMS)))
        if not (rms < BUNDLE_RMS_GATE and abs(costs[1] - costs[0]) <= BUNDLE_COST_GATE * costs[0]):
            raise AssertionError(f"mesh bundle fit: costs {costs}, rms {rms}")

        # the dry run's four steps, then its bundle step timed at 100,000 points
        profiling.reset_launch_counts()
        t0 = time.perf_counter()
        steps = dryrun.run_steps(mesh, bundle_points=MESH_DRYRUN_BUNDLE_P, dtype=torch.float32)
        torch.cuda.synchronize()
        add(profiling.launch_counts())
        emit({"phase": "mesh", "path": "dryrun", "steps": steps, "launches": profiling.launch_counts(),
              "seconds": time.perf_counter() - t0, "gpu": smi})
        cams, pts3d, uv = bundle.make_scene(n_cams=2, n_pts=MESH_DRYRUN_BUNDLE_P, noise=0.0, seed=4)
        prng = np.random.default_rng(5)  # the dry run's perturbation
        x0 = torch.as_tensor(np.concatenate([(pts3d + 0.05 * prng.normal(size=pts3d.shape)).ravel(),
                                             (cams + 0.02 * prng.normal(size=cams.shape)).ravel()]), **f32)
        uvt = torch.as_tensor(uv, **f32)
        rb = bundle.residuals(x0, uvt)
        step_n, step_m = bundle._make_damped_step(1), bundle._make_damped_step(1, mesh, "dp")
        add(mesh_check("bundle_step_100k", lambda: step_n(x0, rb, lam, uvt),
                       lambda: step_m(x0, rb, lam, uvt), False, 5, smi,
                       {K5: bundle_step_k5(MESH_DRYRUN_BUNDLE_P, 2, world=1)},
                       extra={"n_pts": MESH_DRYRUN_BUNDLE_P, "n_cams": 2}))
        add(mesh_programs(mesh, smi))
    finally:
        dryrun.release_programs()  # NCCL keeps a communicator while a graph holds it
        dist.destroy_process_group()
    return total


# --- phase programs: each refactorize and solve as one captured CUDA graph ----------
PROGRAM_BUDGET_OPS = 3  # ATen ops outside the replay: copy in, clone out, one view
P2W_NB, P2W_BR, P2W_BC, P2W_OV, P2W_SEGMENT_BLOCKS = 4096, 10, 4, 2, 8  # the tallblock_p2w geometry
DENSE_SHAPES = ((24, 8), (20_000, 32))  # the reference test's, and one past 16 columns (the panel recursion)
PROGRAM_ROUNDS = ("replay", "eager", "eager", "replay")


def eagerly(call):
    """``call`` under ``_program.eager()``: the same call, no capture, no replay."""
    def run():
        with _program.eager():
            return call()
    return run


def host_and_wall_us(call, n):
    """(host µs to issue one call, wall µs per call ending in synchronize)
    over ``n`` calls back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e6


def latest_program(programs, name):
    found = [p for key, p in programs.programs().items() if key[0] == name]
    if not found:
        raise AssertionError(f"{name}: no captured program after its second call on the card")
    return found[-1]


def drive_program(path, label, programs, name, call, read, want, reps, eager_reps, smi,
                  scans=()):
    """One captured call at full width: the first call (eager), the second
    (warm-up + capture), the budget of a warm call, bitwise equality with ``_program.eager()``,
    then replay and eager in turns (host µs per call, wall µs per call,
    device time).  ``read(out)`` gives a fresh tensor of what the call left
    or returned; ``want`` the launches inside one replay (``scans``: K1 /
    K2 at least once).  Returns the launches the warm call counted."""
    torch.cuda.synchronize()
    t0 = start = time.perf_counter()
    with profiling.count_dispatches() as d1:
        call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if d1.programs:
        raise AssertionError(f"programs {path} {label}: the first call replayed a program")
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    capture_call_s = time.perf_counter() - t0
    prog = latest_program(programs, name)
    call()
    with profiling.count_dispatches() as d:
        out = call()
    torch.cuda.synchronize()
    replay_val = read(out)
    with profiling.count_dispatches() as de:
        eager_out = eagerly(call)()
    eager_val = read(eager_out)
    again = read(call())
    torch.cuda.synchronize()
    launches = {k: v for k, v in d.launches.items() if v}
    warm = {"programs": d.programs, "ops": d.ops, "host_reads": d.host_reads,
            "host_launches": {k: v for k, v in d.host_launches.items() if v}}
    bitwise = bool(torch.equal(replay_val, eager_val) and torch.equal(again, eager_val))
    problems = []
    if d.programs != 1 or d.ops > PROGRAM_BUDGET_OPS or d.host_reads or warm["host_launches"]:
        problems.append(f"warm call {warm} outside the budget (1 replay, <= {PROGRAM_BUDGET_OPS} "
                        "ops, no host read, no host-issued launch)")
    if not (launches_ok(launches, want, scans) and launches_ok(prog.launches, want, scans)):
        problems.append(f"launches {launches} (captured {prog.launches}), want "
                        f"{pin_text(want, scans)}")
    if not bitwise:
        problems.append("replay differs from the eager call")
    if not bool(torch.isfinite(replay_val).all()):
        problems.append("non-finite output")
    if problems:
        raise AssertionError(f"programs {path} {label}: " + "; ".join(problems))
    times = {"replay": [], "eager": []}
    for kind in PROGRAM_ROUNDS:
        if kind == "replay":
            call()  # the solver's factors back on the program's outputs
            times[kind].append(host_and_wall_us(call, reps))
        else:
            times[kind].append(host_and_wall_us(eagerly(call), eager_reps))
    call()
    dev = {"replay": device_time_ms(call, reps=min(reps, 5)),
           "eager": device_time_ms(eagerly(call), reps=min(eager_reps, 2))}
    call()
    torch.cuda.synchronize()
    mean = lambda xs, i: statistics.mean(x[i] for x in xs)  # noqa: E731
    line = {
        "phase": "programs", "path": path, "call": label, "program": name,
        "capture_s": prog.capture_seconds, "first_call_s": first_s,
        "capture_call_s": capture_call_s,
        "warm": warm, "launches_per_replay": launches,
        "eager_ops": de.ops, "eager_launches": {k: v for k, v in de.launches.items() if v},
        "replay_host_us": mean(times["replay"], 0), "eager_host_us": mean(times["eager"], 0),
        "replay_wall_us": mean(times["replay"], 1), "eager_wall_us": mean(times["eager"], 1),
        "replay_device_ms": dev["replay"], "eager_device_ms": dev["eager"],
        "pool_bytes": programs.pool_bytes(), "bitwise_equal_eager": bitwise,
        "reps": [reps, eager_reps], "rounds": list(PROGRAM_ROUNDS), "seconds": time.perf_counter() - start,
        "method": "first_call_s: the first call (eager), synchronized; capture_call_s: the "
                  "second, warm-up + capture + instantiate, synchronized; capture_s: "
                  "torch.cuda.graph's block alone; host_us: host clock over reps calls back to "
                  "back before the synchronize, over reps; wall_us: the same ending in "
                  "synchronize; rounds as listed (eager = _program.eager()), means of the rounds; "
                  "device_ms: torch.profiler's kernel time per call; "
                  "pool_bytes: the graph pool of the solver (of the module for a function), every "
                  "program captured in it so far (memory_snapshot)",
        "gpu": smi,
    }
    emit(line)
    return launches


def concat(*ts):
    """One fresh flat tensor of ``ts`` (what a factorize left: its outputs are
    overwritten by the next replay)."""
    return torch.cat([t.reshape(-1) for t in ts])


def phase_programs(rng, smi):
    """Each captured path at full width against its ``_program.eager()`` form:
    config 2 at 10k and 1M × 7×2 (``BlockDiagonalQR`` compute with B2,
    solve with B1, ``functional.block_diagonal_lstsq``), config 3 through
    ``SegmentedBandedQR`` (``factorize_values`` with B3, B4, B5; solve,
    vector and k = 3) and ``BandedBlockedQR`` (B5), the tallblock_p2w
    geometry at 4,096 blocks (B3, B4, B5), the dense solvers at 24×8 and
    20,000×32, config 4's fused dense compute and solve at N = 100,000,
    and the functional and lane-major programs
    (:func:`functional_and_soa_programs`); fp32.  Returns the launches of
    the warm calls by kernel."""
    total = {name: 0 for name in profiling.launch_counts()}

    def drive(*args, **kw):
        for name, n in drive_program(*args, **kw, smi=smi).items():
            total[name] += n

    def dev(arr):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float32, device=DEVICE)

    for nb in (NB_CONFIG2, NB_REAL):
        blocks_np, b_np = flagship_system(rng, nb)
        blocks, b = dev(blocks_np), dev(b_np)
        mat = qt.BlockDiagonal(blocks, nb * BR, nb * BC)
        qr = qt.BlockDiagonalQR(pivot=False)
        path = f"config2_{nb}x{BR}x{BC}"
        reps = 50 if nb == NB_CONFIG2 else 20
        drive(path, "compute", qr._programs, "BlockDiagonalQR.compute", lambda: qr.compute(mat),
              lambda _: qr._r_soa.clone(), {"blockdiag_qr_r": 1}, reps, reps)
        if not qr._kernel_mode:
            raise AssertionError(f"programs {path}: the kernel tier was not taken")
        drive(path, "solve", qr._programs, "BlockDiagonalQR.solve", lambda: qr.solve(b),
              lambda x: x, {"blockdiag_lstsq": 1}, reps, reps)
        resid = host_residual(blocks_np, qr.solve(b), b_np)
        if not resid < RESID_GATE:
            raise AssertionError(f"programs {path}: fp32 relative residual {resid}")
        drive(path, "functional.block_diagonal_lstsq", functional._LSTSQ_PROGRAMS,
              "functional.block_diagonal_lstsq",
              lambda: functional.block_diagonal_lstsq(blocks, b), lambda x: x, {}, reps, reps)

    def banded_paths(path, mat, solver, reps, eager_reps, want):
        with _program.eager():  # the layout maps; the second factorize_values captures
            solver.compute(mat)
        if not solver._fac_kernel:
            raise AssertionError(f"programs {path}: the kernel route was not taken")
        values = dev(mat.data * 0.75)
        b = dev(mat.matvec(rng.normal(size=mat.ncols)))
        B = dev(rng.normal(size=(mat.nrows, 3)))
        cls = type(solver).__name__
        if isinstance(solver, qt.SegmentedBandedQR):
            factors = lambda: concat(solver._r_panels, solver._Yws, solver._chain_r, solver._j2_top)  # noqa: E731
        else:
            factors = lambda: concat(solver._r_panels, solver.q_seq.Y, solver.q_seq.T)  # noqa: E731
        drive(path, "factorize_values", solver._programs, f"{cls}.factorize",
              lambda: solver.factorize_values(values), lambda _: factors(),
              {**want, **factorize_scans(solver)}, reps, eager_reps)
        for label, rhs in (("solve", b), ("solve_k3", B)):
            drive(path, label, solver._programs, f"{cls}.solve", lambda rhs=rhs: solver.solve(rhs),
                  lambda x: x, {}, reps, eager_reps, scans=SCAN_KERNELS)
        x = solver.solve(b * 0.75)  # the factors are 0.75 A's
        resid = host_residual_sparse(mat, x, b.double().cpu().numpy())
        if not resid < RESID_GATE:
            raise AssertionError(f"programs {path}: fp32 relative residual {resid} after the replays")

    c3 = banded_matrix(rng, C3_NB, C3_BR, C3_BC, C3_OV)
    seg_want = {name: 1 for name in BANDED_KERNELS}
    banded_paths("config3_segmented", c3, qt.SegmentedBandedQR(
        suggested_block_cols=C3_BC, segment_blocks=C3_SEGMENT_BLOCKS, device=DEVICE,
        dtype=torch.float32), 20, 10, seg_want)
    banded_paths("config3_plain", c3, qt.BandedBlockedQR(
        suggested_block_cols=C3_BC, device=DEVICE, dtype=torch.float32), 10, 5,
        {"banded_chain_qr": 1})
    p2w = banded_matrix(rng, P2W_NB, P2W_BR, P2W_BC, P2W_OV)
    banded_paths("tallblock_p2w_4096", p2w, qt.SegmentedBandedQR(
        suggested_block_cols=P2W_BC, segment_blocks=P2W_SEGMENT_BLOCKS, device=DEVICE,
        dtype=torch.float32), 20, 10, seg_want)

    for m, n in DENSE_SHAPES:
        a = dev(rng.normal(size=(m, n)))
        for cls in (qt.DenseHouseholderQR, qt.DenseColPivQR):
            qr = cls()
            drive(f"dense_{m}x{n}", "compute", qr._programs, f"{cls.__name__}.compute",
                  lambda qr=qr: qr.compute(a), lambda _, qr=qr: concat(qr._R, qr._Y, qr._T), {},
                  20, 20)

    blocks_np, a2_np, b_np = block_angular_problem(rng, BA_NS[0])
    n = BA_NS[0]
    mat = qt.BlockMatrix1x2(qt.BlockDiagonal(dev(blocks_np), 2 * n, n), dev(a2_np))
    b = dev(b_np)
    ba = ba_solver()
    drive(f"config4_fused_dense_{n}", "compute", ba._programs, "BlockAngularQR.compute",
          lambda: ba.compute(mat), lambda _: concat(ba.left.R, ba.right._R, ba._r12), {}, 20, 20)
    if not ba._fused_dense:
        raise AssertionError("programs config4: the fused dense path was not taken")
    drive(f"config4_fused_dense_{n}", "solve", ba._programs, "BlockAngularQR.solve",
          lambda: ba.solve(b), lambda x: x, {}, 20, 20)

    functional_and_soa_programs(rng, drive, dev)

    missing = [name for name in (*KERNEL_NAMES, *SCAN_KERNELS, K3) if not total[name]]
    if missing:
        raise AssertionError(f"programs: kernels never launched inside a replay: {missing}")
    return total


def functional_and_soa_programs(rng, drive, dev):
    """The functional programs and the lane-major BlockAngularQR route
    (compute, solve, compute_solve) at the ellipse's width (N = 100,000
    points; config 4 and its damped system), each through ``drive``."""
    n = BA_NS[0]
    blocks = dev(rng.uniform(0.5, 5.0, size=(n, 3, 1)))
    right = dev(rng.uniform(0.5, 5.0, size=(3 * n + 5, BA_M2)))
    rhs = dev(rng.normal(size=3 * n + 5))
    left = dev(rng.normal(size=(2, n)))
    left3 = left[:, None, :]  # the general step's [bl, bc, N] with bc = 1
    sright = dev(rng.normal(size=(2, BA_M2, n)))
    res = dev(rng.normal(size=(2, n)))
    lam = torch.tensor(1e-3, dtype=torch.float32, device=DEVICE)
    functional.clear_programs()
    path = f"functional_{n}"

    def angular():
        return functional.block_angular_lstsq(blocks, right, rhs, 1, 5)

    k5_want = dense_step_k5(2 * n, 5, BA_M2)  # the bottom [2N + 5, 6]: K5's plan
    for label, programs, call in (
        ("block_diagonal_factorize", functional._FACTORIZE_PROGRAMS,
         lambda: functional.block_diagonal_factorize(blocks)),
        ("block_angular_lstsq", functional._ANGULAR_PROGRAMS, angular),
        ("lm_damped_step_blockdiag", functional._STEP_PROGRAMS,
         lambda: functional.lm_damped_step_blockdiag(left3, sright, res, lam)),
        ("lm_damped_step_blockdiag1", functional._STEP1_PROGRAMS,
         lambda: functional.lm_damped_step_blockdiag1(left, sright, res, lam)),
    ):
        drive(path, label, programs, f"functional.{label}", call,
              lambda out: concat(*(t.float() for t in (out if isinstance(out, tuple) else (out,)))),
              {K3: 1} if label.startswith("lm_") else {K5: k5_want} if label == "block_angular_lstsq"
              else {}, 20, 20)
    k5_nodes, library_qr_nodes, names = qr_node_census(eagerly(angular))
    emit({"phase": "programs", "path": path, "call": "block_angular_lstsq_nodes",
          "kernel_nodes": len(names), "k5_nodes": k5_nodes, "k5_want": k5_want,
          "library_qr_nodes": library_qr_nodes,
          "kernel_names": collections.Counter(nm[:60] for nm in names).most_common(8)})
    if k5_nodes != k5_want or library_qr_nodes:
        raise AssertionError(f"programs {path}: the dense step's graph holds {k5_nodes} K5 nodes "
                             f"(want {k5_want}) and {library_qr_nodes} library QR nodes (want 0)")
    blocks_np, a2_np, b_np = block_angular_problem(rng, n)
    soa = qt.BlockMatrix1x2(
        qt.BlockDiagonal.from_soa(dev(blocks_np.transpose(1, 2, 0).reshape(2, n)), 2, 1, nrows=2 * n),
        dev(a2_np.T), right_t=True,
    )
    b = dev(b_np)
    ba = ba_solver()
    path = f"config4_fused_soa_{n}"
    drive(path, "compute", ba._programs, "BlockAngularQR.soa_compute", lambda: ba.compute(soa),
          lambda _: concat(ba._sR1, ba._sR2, ba._sr12t), {}, 20, 20)
    if not ba._fused_soa:
        raise AssertionError("programs config4: the lane-major path was not taken")
    drive(path, "solve", ba._programs, "BlockAngularQR.soa_solve", lambda: ba.solve(b),
          lambda x: x, {}, 20, 20)
    drive(path, "compute_solve", ba._programs, "BlockAngularQR.soa_compute_solve",
          lambda: ba.compute_solve(soa, b), lambda x: x, {}, 20, 20)


# --- K3: the lane-major damped LM step ---------------------------------------------
LM_STEP_SOURCE = "qrkit_tpu_torch/ops/csrc/lm_step.cu"
K3 = "lm_step"
K3_REPLACES = ("none: the jitted lm_damped_step_blockdiag(1), qrkit_tpu/functional.py:278-433 "
               "(_soa_tall_qr_solve :278, lm_damped_step_blockdiag :319, ...1 :419)")
LM_STEP_SHAPES = ((2, 1, 5), (2, 2, 5), (7, 2, 5))  # the ellipse's, and two more step shapes
# (bl, bc, m2, nb): the ellipse at 100,000 and 500,000 points, the other shapes at 100,000
LM_STEP_CASES = ((2, 1, 5, 100_000), (2, 1, 5, 500_000), (2, 2, 5, 100_000), (7, 2, 5, 100_000))
LM_STEP_TOL = {torch.float32: (1e-4, 1e-5), torch.float64: (1e-10, 1e-12)}
LM_STEP_GRAD_N = 3000  # points of the step differentiated on the card and on the CPU
K3_PARTS = ("lm_step_kernel",)  # its kernel's name, for the profiler and the graph census
# calls into K3's C launcher (qrk_lm_step_*) that returned, by mode (0: a
# step's one launch; 1, 2: the mesh form's two), each one memset and one
# kernel launch (count_k3_launcher_calls)
K3_C_CALLS = {0: 0, 1: 0, 2: 0}


def count_k3_launcher_calls():
    """Wraps ``_build.lm_step_launcher`` so that every call into K3's C
    launcher that returns adds one to ``K3_C_CALLS`` under its mode."""
    bind = _build.lm_step_launcher

    def launcher(kind, *args, **kw):
        inner = bind(kind, *args, **kw)
        if kind != "step":
            return inner

        def call(device, *a):
            inner(device, *a)
            K3_C_CALLS[a[-1]] += 1

        return call

    _build.lm_step_launcher = launcher


def k3_calls_since(before):
    """K3's C launcher calls by mode since the snapshot ``before``."""
    return {mode: n - before[mode] for mode, n in K3_C_CALLS.items()}


def k3_graph_census(fn):
    """One call of ``fn`` captured into a CUDA graph, read node by node
    (``profiling.graph_nodes``): K3's kernel nodes, its grid, block and
    cooperative attribute, the memset nodes and any other node."""
    nodes = profiling.graph_nodes(fn)
    k3 = [n for n in nodes if n["type"] == "kernel" and K3_PARTS[0] in n["name"]]
    memsets = sum(n["type"] == "memset" for n in nodes)
    return {"k3_kernel_nodes": len(k3), "memset_nodes": memsets, "other_nodes": len(nodes) - len(k3) - memsets,
            "cooperative": all(n["cooperative"] for n in k3), "grids": [n["grid"][0] for n in k3],
            "blocks": [n["block"][0] for n in k3]}


def check_k3_census(label, census, launches, grid):
    """K3's census (``k3_graph_census``) holds ``launches`` cooperative
    kernel nodes of ``grid`` CTAs of ``TILE`` threads and as many memsets."""
    from qrkit_tpu_torch.ops import lm_step as ls

    want = {"k3_kernel_nodes": launches, "memset_nodes": launches, "cooperative": True,
            "grids": [grid] * launches, "blocks": [ls.TILE] * launches}
    if {k: census[k] for k in want} != want:
        raise AssertionError(f"K3 {label}: a captured call holds {census}, want {want}")


def lm_step_operands(rng, bl, bc, m2, nb, dtype, lead=()):
    """Normal operands of a step, ``lead`` problems; the ellipse's shape at
    its fit's start (its Jacobian and residuals at the initial parameters
    of ``ellipse_points``) where there are no leading axes."""
    f32 = dict(dtype=dtype, device=DEVICE)
    if (bl, bc, m2) == (2, 1, 5) and not lead:
        f = ellipse.EllipseFitting(ellipse.ellipse_points(ellipse.Ellipse(*ELLIPSE_TRUTH), nb), **f32)
        params = f.initial_params()
        left, right = ellipse._jacobian_soa(params, f.pts)
        return left[:, None, :].contiguous(), right, ellipse._residuals_soa(params, f.pts)
    return tuple(torch.as_tensor(rng.normal(size=(*lead, *shape)), **f32)
                 for shape in ((bl, bc, nb), (bl, m2, nb), (bl, nb)))


def lm_step_cost(bl, bc, m2, nb, itemsize):
    """(bytes, operations) of one step: each input read once and the output
    written once; the point pass's bc Householder steps on its (bl + bc)-row
    block and m2 + 1 columns, the absorb of its bl rows into its thread's
    carry (per column j: σ, the reflector, and for each later column r the
    sum, w_r and the updates of the carry row and the bl rows), the
    back-substitution (the merges of the carries, some 20 per 256 points,
    not counted)."""
    nbytes = ((bl * bc + bl * m2 + bl) * nb + bc * nb + m2 + 1) * itemsize
    br = bl + bc
    point = sum(2 * (br - j) + sum(4 * (br - j) + 1 for _ in range(bc - j - 1 + m2 + 1))
                for j in range(bc))
    panel = sum(2 * bl + 3 + (m2 - j) * (4 + 4 * bl) for j in range(m2))
    back = bc * 2 * m2 + bc * bc
    return nbytes, (point + panel + back) * nb


def phase_lm_step_kernels(smi):
    """K3 against its plain version (``ops.lm_step._damped_step_plain``, the
    same tiled algorithm in PyTorch on the same card) at the ellipse's
    shape (100,000 and 500,000 points at its fit's start) and
    at (2, 2, 5) and (7, 2, 5) over 100,000, fp32 (rtol 1e-4, atol
    1e-5·max|·|) and fp64 (rtol 1e-10, atol 1e-12·max|·|: the panel's sums
    run in another order); two calls bitwise equal; a vmapped batch of 16 ×
    10,000 (one launch) against 16 solo calls; a step that requires grad
    (K3 forward) with its gradient against the CPU's, fp64.  fp32 times: the kernels as
    a replayed CUDA graph of 10 wrapper calls between events (``graph_ms``),
    the plain version the same way, the yardstick ``torch.linalg.qr(M,
    mode="r")`` on the step's bottom panel M ``[bl·nb + m2, m2 + 1]``
    (CUDA events per call; the port never calls it), the host µs a call,
    the bound.  Launches here are not the main path's.  Returns (worst error,
    {case: timing})."""
    from qrkit_tpu_torch.ops import lm_step as ls

    rng = np.random.default_rng(SEED + 15)
    worst, timings = 0.0, {}
    for bl, bc, m2, nb in LM_STEP_CASES:
        for dtype in (torch.float32, torch.float64):
            left, right, res = lm_step_operands(rng, bl, bc, m2, nb, dtype)
            lam = torch.tensor(1e-3, dtype=dtype, device=DEVICE)
            before, calls0 = ls.damped_step_lane_major.launches, dict(K3_C_CALLS)
            out = ls.damped_step_lane_major(left, right, res, lam)
            again = ls.damped_step_lane_major(left, right, res, lam)
            torch.cuda.synchronize()
            calls = k3_calls_since(calls0)
            if ls.damped_step_lane_major.launches != before + 2 or calls != {0: 2, 1: 0, 2: 0}:
                raise AssertionError(f"K3 {bl}x{bc}x{m2} n={nb}: two steps counted "
                                     f"{ls.damped_step_lane_major.launches - before}, C launcher calls {calls}")
            plain = ls._damped_step_plain(left[None], right[None], res[None], lam.reshape(1))[0]
            err, equal = compare(out, plain, dtype, LM_STEP_TOL[dtype])
            if not torch.equal(out, again):
                raise AssertionError(f"K3 {bl}x{bc}x{m2} n={nb} {dtype}: two calls differ")
            worst = max(worst, err)
            line = {"phase": "lm_step_kernels", "shape": [bl, bc, m2], "n": nb,
                    "dtype": str(dtype).split(".")[1], "max_abs_err": err,
                    "bitwise_equal_plain": equal, "repeat_bitwise_equal": True,
                    "rtol": LM_STEP_TOL[dtype][0], "atol_x_max_abs": LM_STEP_TOL[dtype][1],
                    "operands": "the ellipse's Jacobian and residuals at its fit's start"
                    if (bl, bc, m2) == (2, 1, 5) else "normal",
                    "launcher_calls_per_call": calls[0] / 2}
            if dtype == torch.float32:
                step = lambda: ls.damped_step_lane_major(left, right, res, lam)  # noqa: E731
                plain_fn = lambda: ls._damped_step_plain(  # noqa: E731
                    left[None], right[None], res[None], lam.reshape(1))
                rounds = {"kernel": [], "plain": []}
                for kind in ("kernel", "plain", "plain", "kernel"):
                    rounds[kind].append(graph_ms(step if kind == "kernel" else plain_fn))
                M = torch.cat([right.permute(0, 2, 1).reshape(-1, m2), -res.reshape(-1, 1)], dim=1)
                M = torch.cat([M, M.new_zeros((m2, m2 + 1))])
                library_ms = profiling.cuda_time_ms(lambda: torch.linalg.qr(M, mode="r"),
                                                    warmup=3, reps=20)
                host_us, wall_us = host_and_wall_us(step, 50)
                dev_ms, by_name, _ = kernel_device_ms(step, K3_PARTS + ("Memset",))
                nbytes, flops = lm_step_cost(bl, bc, m2, nb, 4)
                bound_ms, bound_by = bound(nbytes, flops)
                tiles, segs, grid, reg = _build.lm_step_geometry(bl, bc, m2, dtype, nb, 1, ls.TILE)
                if (tiles, segs, grid) != ls.schedule(nb, 1):
                    raise AssertionError(f"K3 geometry {(tiles, segs, grid)} against the mirror "
                                         f"{ls.schedule(nb, 1)}")
                census = k3_graph_census(step)
                check_k3_census(f"{bl}x{bc}x{m2} n={nb}", census, 1, grid)
                mesh_census = k3_graph_census(lambda: ls.damped_step_lane_major(
                    left, right, res, lam, gather=lambda part: part))  # a one-rank gather
                check_k3_census(f"{bl}x{bc}x{m2} n={nb} mesh form", mesh_census, 2, grid)
                empty = _build.lm_step_launcher("empty", bl, bc, m2)
                dev = torch.cuda.current_device()
                t = {"ms": statistics.mean(rounds["kernel"]), "plain_ms": statistics.mean(rounds["plain"]),
                     "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "flops": flops, "device_ms": by_name.get(K3_PARTS[0]),
                     "device_kernels_ms": by_name,
                     "host_us_per_call": host_us, "wall_us_per_call": wall_us,
                     "host_us_per_launch": host_us / census["k3_kernel_nodes"], "rounds": rounds,
                     "k3_launches": census["k3_kernel_nodes"], "memset_nodes": census["memset_nodes"],
                     "other_nodes": census["other_nodes"], "cooperative": census["cooperative"],
                     "mesh_form_k3_launches": mesh_census["k3_kernel_nodes"],
                     "mesh_form_memset_nodes": mesh_census["memset_nodes"],
                     "ctas": ls.CTAS, "geometry": {"tiles": tiles, "segs": segs, "grid": grid,
                                                   "factor_rows_in_registers": reg},
                     "partial_mode_ms": graph_ms(lambda: ls.partial_step(
                         left[None], right[None], res[None], lam.reshape(1))),
                     "floor_ms": graph_ms(lambda: empty(dev, grid, ls.TILE, 1)),
                     "floor_device_ms": device_time_ms(lambda: empty(dev, grid, ls.TILE, 1),
                                                       one_kernel=True)}
                timings[(bl, bc, m2, nb)] = t
                line.update(t, method="k3_launches, memset_nodes, cooperative: the kernel and memset "
                            "nodes of one call captured into a CUDA graph and read through the driver "
                            "(profiling.graph_nodes), mesh_form_*: the same of the mesh form with a "
                            "one-rank gather; launcher_calls_per_call: calls into qrk_lm_step_* a call; "
                            "ms / plain_ms: a CUDA graph of 10 calls replayed between "
                            "CUDA events over 10, median of 5 replays, rounds kernel, plain, plain, "
                            "kernel; partial_mode_ms: K3's first mode alone (the point pass through the last "
                            "CTA's reduction), floor_ms: an empty cooperative kernel on K3's grid, each a "
                            "graph of 10 launches the same way; floor_device_ms: the profiler's time "
                            "of that kernel; library_ms: torch.linalg.qr(M, mode='r') on the bottom panel "
                            "[bl*nb + m2, m2 + 1], CUDA events per call, median of 20; host_us: "
                            "host clock over 50 eager calls before the synchronize; device_ms: "
                            "torch.profiler's kernel time per call; bound: bytes (inputs read once, "
                            "output written once) over 3.35 TB/s against the fp32 operations over "
                            "67 TFLOP/s", gpu=smi)
            emit(line)
    # the batch fit's step: 16 problems of 10,000 points under vmap, one launch
    nbatch, nb = LM_BATCH
    for dtype in (torch.float32, torch.float64):
        left, right, res = lm_step_operands(rng, 2, 1, 5, nb, dtype, lead=(nbatch,))
        lam = torch.as_tensor(rng.uniform(1e-4, 1.0, size=nbatch), dtype=dtype, device=DEVICE)
        before, calls0 = ls.damped_step_lane_major.launches, dict(K3_C_CALLS)
        batch = torch.func.vmap(ls.damped_step_lane_major)(left, right, res, lam)
        torch.cuda.synchronize()
        calls = k3_calls_since(calls0)
        if ls.damped_step_lane_major.launches != before + 1 or calls != {0: 1, 1: 0, 2: 0}:
            raise AssertionError(f"K3 under vmap: {ls.damped_step_lane_major.launches - before} steps "
                                 f"counted, C launcher calls {calls}; want one for the batch")
        errs = [compare(batch[i], ls.damped_step_lane_major(left[i], right[i], res[i], lam[i]),
                        dtype, LM_STEP_TOL[dtype])[0] for i in range(nbatch)]
        worst = max(worst, max(errs))
        vstep = lambda: torch.func.vmap(ls.damped_step_lane_major)(left, right, res, lam)  # noqa: E731
        census = k3_graph_census(vstep)
        check_k3_census(f"vmap {nbatch}x{nb}", census, 1, ls.schedule(nb, nbatch)[2])
        line = {"phase": "lm_step_kernels", "case": f"vmap_{nbatch}x{nb}", "dtype": str(dtype).split(".")[1],
                "max_abs_err_vs_solo": max(errs), "launcher_calls_for_the_batch": calls[0],
                "k3_launches_for_the_batch": census["k3_kernel_nodes"], "memset_nodes": census["memset_nodes"],
                "gpu": smi}
        if dtype == torch.float32:
            line["ms"] = graph_ms(vstep)
            line["solo_ms_sum"] = sum(graph_ms(lambda i=i: ls.damped_step_lane_major(
                left[i], right[i], res[i], lam[i]), calls=10, reps=3) for i in range(nbatch))
            tiles, segs, grid, reg = _build.lm_step_geometry(2, 1, 5, dtype, nb, nbatch, ls.TILE)
            line["geometry"] = {"tiles": tiles, "segs": segs, "grid": grid, "factor_rows_in_registers": reg}
            timings["vmap"] = {k: line[k] for k in ("ms", "solo_ms_sum", "geometry")}
        emit(line)
    # a step whose operands require grad: K3 runs the forward, the backward is
    # ops.lm_step._damped_step_dense's vector-Jacobian product; the gradient
    # against the CPU's
    nb = LM_STEP_GRAD_N
    ops = [t.detach().clone().requires_grad_() for t in lm_step_operands(rng, 2, 1, 5, nb, torch.float64)]
    ops.append(torch.tensor(1e-3, dtype=torch.float64, device=DEVICE, requires_grad=True))
    g = torch.as_tensor(rng.normal(size=nb + 5), dtype=torch.float64, device=DEVICE)
    before, calls0 = ls.damped_step_lane_major.launches, dict(K3_C_CALLS)
    got = torch.autograd.grad(ls.damped_step_lane_major(*ops), ops, g)
    torch.cuda.synchronize()
    calls = k3_calls_since(calls0)
    if ls.damped_step_lane_major.launches != before + 1 or calls != {0: 1, 1: 0, 2: 0}:
        raise AssertionError(f"K3 with grad: {ls.damped_step_lane_major.launches - before} steps counted, "
                             f"C launcher calls {calls}; want the forward's one")
    cpu = [t.detach().cpu().requires_grad_() for t in ops]
    want = torch.autograd.grad(ls.damped_step_lane_major(*cpu), cpu, g.cpu())
    err = max(compare(a.cpu(), b, torch.float64, LM_STEP_TOL[torch.float64])[0]
              for a, b in zip(got, want))
    worst = max(worst, err)
    emit({"phase": "lm_step_kernels", "case": f"grad_{nb}", "dtype": "float64",
          "max_abs_err_grad_vs_cpu": err, "launcher_calls": calls[0], "gpu": smi})
    return worst, timings


# --- the ellipse model's residuals, Jacobian and gradient (K4) ---

ELLIPSE_EVAL_SOURCE = "qrkit_tpu_torch/ops/csrc/ellipse_eval.cu"
K4R, K4G, K4J = "ellipse_residuals", "ellipse_residuals_vjp", "ellipse_jacobian"
K4 = (K4R, K4G, K4J)
K4_PARTS = {K4R: "residuals_kernel", K4G: "vjp_kernel", K4J: "jacobian_kernel"}
K4_REPLACES = ("none: the ellipse model's jnp expressions under jax.jit, qrkit_tpu/examples/ellipse.py:65, "
               "134, 147, and the gradient's jax.vjp, qrkit_tpu/lm.py")
K4_CASES = ((500_000, 1), (500, 100))  # points, problems: the benchmark's two ellipse cells
K4_SUM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # of Σ|terms|: K4g's sums in another order


def k4_operands(n, problems, dtype):
    """The ellipse model's operands at a fit's start: points of
    ``ellipse_points`` (the batch's truths as ``ellipse_batch_truth``), the
    initial parameters, and their residuals as r̄ (the gradient's)."""
    from qrkit_tpu_torch.ops import ellipse_eval as ee

    if problems == 1:
        pts_np = ellipse.ellipse_points(ellipse.Ellipse(*ELLIPSE_TRUTH), n)
        params_np = ellipse.initial_params_np(pts_np)
    else:
        pts_np = ellipse_batch_points(problems, n)
        params_np = np.stack([ellipse.initial_params_np(p) for p in pts_np])
    params = torch.as_tensor(params_np, dtype=dtype, device=DEVICE)
    pts = torch.as_tensor(pts_np, dtype=dtype, device=DEVICE)
    return params, pts, ee._residuals_plain(params, pts)


def k4_bytes(name, n, problems, itemsize):
    """Bytes of one call, each input read once and each output written
    once: K4r reads t and the points and writes 2 residuals a point, K4j
    writes left, right and res (14 values a point), K4g reads t and r̄ and
    writes g."""
    per_point = {K4R: 1 + 2 + 2, K4J: 1 + 2 + 14, K4G: 1 + 2 + 1}[name]
    return problems * (per_point * n + 5) * itemsize


def phase_ellipse_eval_kernels(smi):
    """K4 against its plain versions (``ops.ellipse_eval``'s torch formulas
    on the same card) at the benchmark's ellipse shapes, 500,000 points and
    100 problems of 500, at a fit's start, fp32 and fp64: K4r and K4j
    bitwise, K4g's point entries bitwise and its five sums within rtol of
    Σ|terms| (1e-5 fp32, 1e-12 fp64), two calls bitwise; one call of each
    captured and read node by node (one kernel node each, K4g's memset
    beside it).  fp32 times: each kernel as a replayed graph of 10 wrapper
    calls (``graph_ms``), the profiler's time of its kernel, the plain
    version the same way, bytes and bound.  Returns {(name, n, problems):
    timing}."""
    from qrkit_tpu_torch.ops import ellipse_eval as ee

    timings = {}
    for n, problems in K4_CASES:
        case = f"{problems}x{n}" if problems > 1 else f"{n}"
        for dtype in (torch.float32, torch.float64):
            params, pts, rbar = k4_operands(n, problems, dtype)
            calls = {K4R: lambda: ee.ellipse_residuals(params, pts),
                     K4J: lambda: ee.ellipse_jacobian_residuals(params, pts),
                     K4G: lambda: ee.ellipse_residuals_vjp(params, rbar)}
            plain = {K4R: lambda: ee._residuals_plain(params, pts),
                     K4J: lambda: ee._jacobian_residuals_plain(params, pts),
                     K4G: lambda: ee._residuals_vjp_plain(params, rbar)}
            for name in K4:
                before = profiling.launch_counts()[name]
                out, again, want = calls[name](), calls[name](), plain[name]()
                torch.cuda.synchronize()
                if profiling.launch_counts()[name] != before + 2:
                    raise AssertionError(f"K4 {name} {case}: two calls counted "
                                         f"{profiling.launch_counts()[name] - before}")
                outs, agains, wants = (o if isinstance(o, tuple) else (o,) for o in (out, again, want))
                repeat = all(torch.equal(a, b) for a, b in zip(outs, agains))
                if name == K4G:
                    left, right = ee._jacobian_plain(params, n)
                    rb = rbar.reshape(*rbar.shape[:-1], n, 2)
                    scale = ((right[..., 0, :, :] * rb[..., None, :, 0]).abs().sum(-1)
                             + (right[..., 1, :, :] * rb[..., None, :, 1]).abs().sum(-1))
                    sum_err = float(((out[..., n:] - want[..., n:]).abs() / scale).max())
                    bitwise = torch.equal(out[..., :n], want[..., :n])
                    ok = bitwise and sum_err <= K4_SUM_RTOL[dtype]
                else:
                    sum_err, bitwise = None, all(torch.equal(a, b) for a, b in zip(outs, wants))
                    ok = bitwise
                nodes = profiling.graph_nodes(calls[name])
                kernels = [nd for nd in nodes if nd["type"] == "kernel"]
                memsets = sum(nd["type"] == "memset" for nd in nodes)
                census_ok = (len(kernels) == 1 and K4_PARTS[name] in kernels[0]["name"]
                             and memsets == (name == K4G) and len(nodes) == 1 + memsets)
                line = {"phase": "ellipse_eval_kernels", "kernel": name, "case": case,
                        "dtype": str(dtype).split(".")[1], "bitwise_equal": bitwise,
                        "sum_err_over_abs_terms": sum_err, "two_calls_bitwise": repeat,
                        "kernel_nodes": len(kernels), "memset_nodes": memsets,
                        "grid": kernels[0]["grid"] if kernels else None, "gpu": smi}
                if dtype == torch.float32:
                    nbytes = k4_bytes(name, n, problems, 4)
                    bound_ms, _ = bound(nbytes, 0)
                    device_ms, _, records = kernel_device_ms(calls[name], (K4_PARTS[name],))
                    line.update(ms=graph_ms(calls[name]), plain_ms=graph_ms(plain[name], reps=3),
                                device_ms=device_ms, device_records=records, bytes=nbytes,
                                bound_ms=bound_ms, bound_by="bytes",
                                roofline_pct=100 * bound_ms / device_ms if device_ms else None,
                                method="ms / plain_ms: a replayed CUDA graph of 10 calls between events "
                                       "over 10 (K4g's memset included); device_ms: torch.profiler's "
                                       "kernel time a call; bound: bytes (inputs read once, outputs "
                                       "written once) over 3.35 TB/s")
                    timings[(name, n, problems)] = line
                emit(line)
                if not (ok and repeat and census_ok):
                    raise AssertionError(f"K4 {name} {case} {dtype}: {line}")
    return timings


# --- one LM fit as one program (the captured loop, L1) ---

GRAPH_LOOP_SOURCE = "qrkit_tpu_torch/ops/csrc/graph_loop.cu"
LM_BATCH = (16, 10_000)  # fit_ellipse_batch: problems, points each
L1_REPLACES = "none: XLA's lax.while_loop predicate, qrkit_tpu/lm.py:149"
LM_PROGRAM_ROUNDS = ("eager", "captured", "captured", "eager")


def lm_program_fits():
    """The five fits of phase ``lm_programs``: (label, fit() → (LMResult,
    canonical ellipse parameters or None), gate(result, params) → (value,
    bound))."""
    el = ellipse.Ellipse(*ELLIPSE_TRUTH)
    fits = []
    for n in ELLIPSE_NS:
        pts = ellipse.ellipse_points(el, n)

        def ell(pts=pts):
            return ellipse.fit_ellipse(pts, LM_CFG, dtype=torch.float32, device=DEVICE)

        def ell_gate(res, params, n=n):
            return float(np.abs(params[n:] - np.array(ELLIPSE_TRUTH)).max()), ELLIPSE_GATE

        fits.append((f"fit_ellipse_{n}", ell, ell_gate))
    nb, nbp = LM_BATCH
    pts_b = ellipse_batch_points(nb, nbp)

    def batch():
        return ellipse.fit_ellipse_batch(pts_b, LM_CFG, dtype=torch.float32, device=DEVICE), None

    def batch_gate(res, _):
        errs = [np.abs(ellipse.canonicalize_ellipse(res.x[i], nbp)[nbp:] - np.array(ellipse_batch_truth(i))).max()
                for i in range(nb)]
        return float(max(errs)), ELLIPSE_GATE

    fits.append((f"fit_ellipse_batch_{nb}x{nbp}", batch, batch_gate))
    for p in BUNDLE_DEVICE_PS:
        cams0, pts0, uv = bundle_start(p)

        def bun(cams0=cams0, pts0=pts0, uv=uv):
            return bundle.fit_bundle_device(cams0, pts0, uv, BUNDLE_CFG, device=DEVICE,
                                            dtype=torch.float32), None

        def bun_gate(res, _, p=p):
            return float(np.sqrt(2.0 * np.max(res.cost) / (2 * p * BUNDLE_CAMS))), BUNDLE_RMS_GATE

        fits.append((f"fit_bundle_device_{p}", bun, bun_gate))
    return fits


def lm_fields(res):
    return [np.asarray(v) for v in (res.x, res.cost, res.lambda_final, res.iterations, res.converged)]


def drive_lm_program(label, fit, gate, smi):
    """One fit at full width: the eager loop (``_program.eager()``), the
    key's first fit (capture), a warm fit counted (one program, one host
    read, no host-issued launch, L1 once before the loop and once an
    iteration, K3 once an iteration and K4 as ``k4_fit_launches`` in the
    ellipse fits, K5's plan a step in the bundle fits), each bitwise
    equal to the eager fit, L1's log against the
    plain condition on every iteration, the gate; then eager and captured
    fits in turns (wall ms), device ms per fit under torch.profiler and
    L1's device time in a captured fit.  Returns (L1 launches of the warm
    fit, L1 device ms an evaluation or None)."""
    lm.clear_programs()
    start = time.perf_counter()
    with _program.eager():
        eager, _ = fit()
    k = int(np.max(eager.iterations))
    reads0 = lm.levenberg_marquardt_device.host_reads
    t0 = time.perf_counter()
    with profiling.count_dispatches() as d1:
        first, _ = fit()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_reads = lm.levenberg_marquardt_device.host_reads - reads0
    (prog,) = lm._LOOPS.programs().values()
    prog.log.fill_(-1)
    reads0 = lm.levenberg_marquardt_device.host_reads
    with profiling.count_dispatches() as d:
        warm, params = fit()
    torch.cuda.synchronize()
    warm_reads = lm.levenberg_marquardt_device.host_reads - reads0
    log = prog.log.cpu().tolist()[: k + 1]
    launches = {n: v for n, v in d.launches.items() if v}
    bitwise = {"first": all(np.array_equal(a, b) for a, b in zip(lm_fields(first), lm_fields(eager))),
               "warm": all(np.array_equal(a, b) for a, b in zip(lm_fields(warm), lm_fields(eager)))}
    value, bound_ = gate(warm, params)
    problems = []
    if d.programs != 1 or d.host_reads != 1 or warm_reads != 1 or any(d.host_launches.values()):
        problems.append(f"warm fit: {d.programs} programs, {d.host_reads} host reads (driver "
                        f"{warm_reads}), host launches {d.host_launches}; want 1, 1, none")
    want = {"graph_loop_cond": k + 1}
    if label.startswith("fit_ellipse"):  # the step: K3 once an iteration; the model: K4
        want.update({K3: k, **k4_fit_launches(k, first=False)})
    if label.startswith("fit_bundle_device_"):  # the dense step: K5's plan an iteration
        want[K5] = k * bundle_step_k5(int(label.rsplit("_", 1)[1]), BUNDLE_CAMS)
    if launches != want:
        problems.append(f"warm fit launches {launches}, want {want}")
    if first_reads != (2 if k > 1 else 1):
        problems.append(f"first fit: {first_reads} host reads")
    if log != [1] * k + [0]:
        problems.append(f"L1's evaluations {log} differ from the plain condition (true {k} times, then false)")
    if not all(bitwise.values()):
        problems.append(f"captured fits differ from the eager fit: {bitwise}")
    if not (np.isfinite(warm.x).all() and np.isfinite(warm.cost).all() and value < bound_):
        problems.append(f"gate: {value} (bound {bound_}), finite x {np.isfinite(warm.x).all()}")
    if problems:
        raise AssertionError(f"lm_programs {label}: " + "; ".join(problems))

    def captured():
        return fit()

    def eager_fit():
        with _program.eager():
            return fit()

    walls = {"eager": [], "captured": []}
    for kind in LM_PROGRAM_ROUNDS:
        fn = captured if kind == "captured" else eager_fit
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
    dev_ms = {"captured": device_time_ms(captured, reps=2), "eager": device_time_ms(eager_fit, reps=1)}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        captured()
        torch.cuda.synchronize()
    l1_ms, l1_records = device_kernels(prof, "loop_cond")
    l1_each = l1_ms / l1_records if l1_records else None
    iters = k
    line = {
        "phase": "lm_programs", "fit": label, "dtype": "float32", "iterations": k,
        "iterations_per_problem": [int(v) for v in np.atleast_1d(warm.iterations)],
        "converged": bool(np.all(warm.converged)), "gate_value": value, "gate": bound_,
        "program": prog.name, "capture_s": prog.capture_seconds, "first_fit_s": first_s,
        "first_fit_host_reads": first_reads, "first_fit_ops": d1.ops,
        "warm": {"programs": d.programs, "host_reads": d.host_reads, "ops": d.ops,
                 "host_launches": {n: v for n, v in d.host_launches.items() if v},
                 "launches": launches},
        "l1_log_matches_plain": True, "bitwise_equal_eager": bitwise,
        "pool_bytes": lm._LOOPS.pool_bytes(),
        "wall_ms": {kind: statistics.mean(v) for kind, v in walls.items()}, "wall_ms_runs": walls,
        "device_ms": dev_ms,
        "device_ms_per_iteration": {kind: v / iters for kind, v in dev_ms.items()},
        "l1_device_ms_each": l1_each, "l1_records": l1_records,
        "body_device_ms_per_iteration": ((dev_ms["captured"] - l1_each * (k + 1)) / iters
                                         if l1_records else None),
        "seconds": time.perf_counter() - start,
        "method": "eager: the same fit under _program.eager() (one host read an iteration); "
                  "first: the key's first fit (iteration 1 eager, capture, the fit as one launch); warm: "
                  "one launch, one fetch, under count_dispatches; wall_ms: host clock ending in "
                  "synchronize, rounds eager, captured, captured, eager of 2 fits, means; "
                  "device_ms: torch.profiler's kernel time per fit (device_time_ms); L1: the "
                  "mean of the profiler's loop_cond_kernel records around one captured fit "
                  "(records of an earlier profile may arrive late: l1_records can exceed k + 1); "
                  "body: device ms less k + 1 L1 evaluations, over k",
        "gpu": smi,
    }
    emit(line)
    return k + 1, l1_each


def phase_lm_programs(smi):
    """Each device fit as one program: fit_ellipse at N = 100,000 and
    500,000, fit_ellipse_batch at 16 × 10,000 and fit_bundle_device at
    5,000 and 20,000 points, fp32 (:func:`drive_lm_program`).  Returns the
    L1 device ms of an evaluation in each fit."""
    l1 = {}
    for label, fit_fn, gate in lm_program_fits():
        _, l1[label] = drive_lm_program(label, fit_fn, gate, smi)
    return l1


def phase_loop_cond(smi, l1_in_loop):
    """L1 against its plain version, ``(k < max_iters) & ~done.all()``, at
    the main path's shapes (done [1] and [16]) and a few more, every k
    around max_iters; then both timed at done [16] (device time), with the
    byte bound.  Launches here are not the main path's."""
    rng = np.random.default_rng(SEED)
    mismatches = cases = 0
    for nb in (1, 16, 1000, 5000):
        for k in (0, 1, LM_CFG.max_iters - 1, LM_CFG.max_iters, LM_CFG.max_iters + 1):
            for frac in (0.0, 0.5, 1.0):
                done = torch.as_tensor(rng.random(nb) < frac, device=DEVICE)
                kk = torch.tensor(k, dtype=torch.int32, device=DEVICE)
                got = graph_loop.loop_condition(done, kk, LM_CFG.max_iters)
                want = graph_loop._loop_condition_plain(done, kk, LM_CFG.max_iters)
                mismatches += int(not torch.equal(got, want))
                cases += 1
    torch.cuda.synchronize()
    if mismatches:
        raise AssertionError(f"L1: {mismatches} of {cases} cases differ from the plain condition")
    done = torch.zeros(16, dtype=torch.bool, device=DEVICE)
    kk = torch.tensor(3, dtype=torch.int32, device=DEVICE)
    rounds = {"kernel": [], "plain": []}
    for kind in ("kernel", "plain", "plain", "kernel"):
        fn = graph_loop.loop_condition if kind == "kernel" else graph_loop._loop_condition_plain
        rounds[kind].append(device_time_ms(lambda fn=fn: fn(done, kk, LM_CFG.max_iters), reps=20,
                                           one_kernel=kind == "kernel"))
    nbytes = done.numel() + 4 + 1
    bound_ms, bound_by = bound(nbytes, done.numel() + 2)
    out = {"ms": statistics.mean(rounds["kernel"]), "plain_ms": statistics.mean(rounds["plain"]),
           "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0}
    emit({"phase": "loop_cond", "cases": cases, "mismatches": mismatches, "shape": [16],
          **out, "rounds": rounds, "in_loop_device_ms_each": l1_in_loop,
          "method": "device time under torch.profiler of 20 calls (one kernel a call for L1; the "
                    "plain expression: several), rounds kernel, plain, plain, kernel; bound: the "
                    "bytes read and written over the HBM rate", "gpu": smi})
    return out


BAL_CFG = lm.LMConfig(max_iters=50, ftol=1e-6, xtol=1e-8)  # the BAL cell's
BAL_SMOKE = (12, 3000, (2, 10))  # cameras, points, track lengths
L2_REPLACES = "none: the reference's step has no marks (XLA's profile times its fusions)"


def phase_loop_marks(smi):
    """L2, a step's stamps inside the captured loop's body: a BAL fit
    (``fit_bal_device``, fp32, 12 cameras, 3,000 points, tracks 2 to 10)
    under the profiler, warm.  Each iteration's marks (the step's entry, its
    bottom assembled, its R2 and y2 done) rise between L1's stamps around it,
    the fit launches L2 three times an iteration, K5 its plan's launches an
    iteration and nothing else than L1, L2 and K5 among the port's kernels,
    and a warm fit is one launch and one fetch."""
    n_cams, n_pts, tracks = BAL_SMOKE
    cams, pts, oc, op, uv = bal.make_scene(n_cams, n_pts, tracks, seed=SEED)
    rng = np.random.default_rng(SEED)
    cams0 = cams + np.r_[[0.01] * 3, [0.05] * 3, [8.0], [0.0, 0.0]] * rng.normal(size=cams.shape)
    pts0 = pts + 0.05 * rng.normal(size=pts.shape)

    def fit():
        return bal.fit_bal_device(cams0, pts0, oc, op, uv, BAL_CFG, device=DEVICE,
                                  dtype=torch.float32)

    fit()  # the first fit: iteration 1 eagerly, then the capture
    reads = lm.levenberg_marquardt_device.host_reads
    with profiling.count_dispatches() as d:
        fit()
    warm = {"programs": d.programs, "host_reads": lm.levenberg_marquardt_device.host_reads - reads}
    profiling.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        res = fit()
    counts = {k: v for k, v in profiling.launch_counts().items() if v}
    rec = profiling.loop_records()[-1]
    k, st, marks = res.iterations, rec["stamps"], rec.get("marks", [])
    rising = len(marks) == k and all(st[i] < m["step"] < m["bottom"] < m["tsqr"] < st[i + 1]
                                     for i, m in enumerate(marks))
    part = lambda a, b: statistics.mean((m[b] - m[a]) / 1e3 for m in marks)  # noqa: E731
    want = {"graph_loop_cond": k + 1, "loop_mark": 3 * k,
            "tall_qr": k * tall_qr.plan(*bal_bottom_shape(oc, n_cams)).launches}
    line = {"phase": "loop_marks", "scene": BAL_SMOKE, "iterations": k, "converged": res.converged,
            "launches": counts, "want": want, "marks_rise": rising, "warm_fit": warm,
            "left_us": part("step", "bottom") if marks else None,
            "right_us": part("bottom", "tsqr") if marks else None,
            "iteration_us": statistics.mean((b - a) / 1e3 for a, b in zip(st[1:], st[2:]))
            if k > 1 else None,
            "method": "one warm fit under torch.profiler; marks and stamps from "
                      "profiling.loop_records(), launches from the program's counters",
            "gpu": smi}
    emit(line)
    if not (rising and counts == want and res.converged
            and warm == {"programs": 1, "host_reads": 1}):
        raise AssertionError(f"loop_marks: {line}")
    return counts["loop_mark"]


TALL_QR_SOURCE = "qrkit_tpu_torch/ops/csrc/tall_qr.cu"
K5 = "tall_qr"
K5_REPLACES = ("none: the block-angular steps' bottom [J2 | rhs] in the reference is a TSQR "
               "(geqrf, the T factors, Q^T on the rhs: parallel.tsqr.tsqr_factorize + tsqr_apply, "
               "kept for TSQRDenseQR); K5 keeps R2 and y2 alone, for the ragged and the dense step")
BAL_BOTTOM = (694_814, 468)  # Venice-52: 2 x 347,173 observation rows + 468 damping rows, 9 x 52 columns
TALL_QR_REPS = 5


def bal_bottom_shape(obs_cam, n_cams):
    """(rows, columns) of a BAL step's bottom: two rows an observation and
    the camera damping, 9 columns a camera (the rhs past them)."""
    m2 = bal.CAMERA * n_cams
    return 2 * len(obs_cam) + m2, m2


def dense_step_k5(compl, tail, m2, world=0):
    """K5's launches in one dense block-angular step
    (``functional.block_angular_lstsq``) of ``m2`` right columns whose
    blocks hand on ``compl`` complement rows (a rank's, with ``world``
    ranks of a mesh) with ``tail`` rows under them: one R-only QR of the
    bottom; over a mesh one of the rank's rows and one of the gathered
    ``[R | y]`` stack with the tail."""
    if not world:
        return tall_qr.plan(compl + tail, m2).launches
    return tall_qr.plan(compl, m2).launches + tall_qr.plan(world * m2 + tail, m2).launches


def bundle_step_k5(n_pts, n_cams, world=0):
    """:func:`dense_step_k5` of the bundle's dense step (``bundle._damped_step``):
    2C complement rows a point, 6C camera columns and damping rows."""
    return dense_step_k5(2 * n_cams * n_pts, 6 * n_cams, 6 * n_cams, world)


def tsqr_r_and_qtb(w):
    """R2 and y2 of ``w = [J2 | rhs]`` by the TSQR on one shard
    (``parallel.tsqr``: ``geqrf``, the T factors and Qᵀ on the rhs), the
    route K5 replaced, timed beside it."""
    n = w.shape[1] - 1
    Yl, Tl, Y2, T2, R2 = tsqr.tsqr_factorize(w[:, :n], 1)
    return R2, tsqr.tsqr_apply(Yl, Tl, Y2, T2, w[:, n], 1, True)[:n]


def qr_node_census(fn):
    """(K5's kernel nodes, library QR nodes, every kernel node's name) of
    one call of ``fn`` captured into a graph (``profiling.graph_nodes``)."""
    names = [nd.get("name", "") for nd in profiling.graph_nodes(fn) if nd["type"] == "kernel"]
    return (sum("level_kernel" in nm for nm in names),
            sum(any(k in nm.lower() for k in ("geqr", "larf", "orgqr", "ormqr")) for nm in names),
            names)


def tall_qr_cost(m, n, itemsize=4):
    """(bytes, operations) of K5 on ``[m, n + 1]``: the operand read once,
    R2 and y2 written; Householder QR of the m × n J2 (2mn² − 2n³/3) and
    Qᵀ on the rhs (4mn)."""
    return itemsize * (m * (n + 1) + n * n + n), 2 * m * n * n - 2 * n ** 3 / 3 + 4 * m * n


def phase_tall_qr(smi):
    """K5 at BAL Venice-52's bottom ``[694,814, 469]`` (fp32; columns
    scaled over two decades): against its plain version on the same card
    (R2, y2) and R's Gram residual against float64; two calls bitwise
    equal; CUDA-event times of one call on a fresh copy of the operand (the
    copy outside the events), in turns: K5, the plain version, the TSQR it
    replaced (:func:`tsqr_r_and_qtb`, one shard) and
    ``torch.linalg.qr(mode="r")`` of the operand (``library_ms``: timed,
    never called by the port), beside the bounds (operations at the fp32
    rate, bytes at the HBM rate).  Then one BAL step at the smoke scene
    captured and read node by node (K5's kernels, no ``geqrf`` kernel), and
    K5's launches in a warm 3-iteration BAL fit (its plan's an
    iteration)."""
    m, n = BAL_BOTTOM
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    a = torch.randn((m, n + 1), generator=g, device=DEVICE) * torch.logspace(
        0, 2, n + 1, device=DEVICE)
    work = torch.empty_like(a)
    calls = {
        "kernel": lambda w: tall_qr.r_and_qtb(w),
        "plain": lambda w: tall_qr._r_and_qtb_plain(w),
        "tsqr": tsqr_r_and_qtb,
        "library": lambda w: (torch.linalg.qr(w, mode="r")[1],),
    }

    def once(name):
        work.copy_(a)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = calls[name](work)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    _, (R2, y2) = once("kernel")
    _, (R2b, y2b) = once("kernel")
    _, (pR2, py2) = once("plain")
    repeat = bool(torch.equal(R2, R2b) and torch.equal(y2, y2b))
    scale = float(pR2.abs().max())
    err = max(float((R2 - pR2).abs().max()), float((y2 - py2).abs().max())) / scale
    J = a[:, :n].double()
    gram = J.mT @ J
    gram_res = float(torch.linalg.matrix_norm(R2.double().mT @ R2.double() - gram)
                     / torch.linalg.matrix_norm(gram))
    del J, gram, pR2, py2, R2b, y2b
    once("tsqr")
    once("library")
    rounds = {name: [] for name in calls}
    for _ in range(TALL_QR_REPS):
        for name in ("kernel", "plain", "tsqr", "library", "library", "tsqr", "plain", "kernel"):
            rounds[name].append(once(name)[0])
    nbytes, flops = tall_qr_cost(m, n)
    ms = statistics.median(rounds["kernel"])
    plan = tall_qr.plan(m, n)

    # one BAL step at the smoke scene: its nodes
    n_cams, n_pts, tracks = BAL_SMOKE
    cams, pts, oc, op, uv = bal.make_scene(n_cams, n_pts, tracks, seed=SEED)
    cam_d, pt_d, order, buckets, inverse, rows = bal._device_plan(oc, op, n_pts, n_cams, DEVICE)
    aux = (cam_d, pt_d, torch.as_tensor(uv, dtype=torch.float32, device=DEVICE)[order], buckets,
           inverse, n_cams, rows)
    x0 = torch.as_tensor(np.concatenate([pts.ravel(), cams.ravel()]), dtype=torch.float32,
                         device=DEVICE)
    r0 = bal._residuals_aux(x0, aux)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=DEVICE)
    k5_nodes, geqrf_nodes, names = qr_node_census(lambda: bal._damped_step_aux(x0, r0, lam, aux))
    smoke_plan = tall_qr.plan(*bal_bottom_shape(oc, n_cams))

    # K5's launches in a warm 3-iteration fit
    rng = np.random.default_rng(SEED)
    cams0 = cams + np.r_[[0.01] * 3, [0.05] * 3, [8.0], [0.0, 0.0]] * rng.normal(size=cams.shape)
    pts0 = pts + 0.05 * rng.normal(size=pts.shape)
    cfg3 = lm.LMConfig(max_iters=3, ftol=0.0, xtol=0.0)

    def fit():
        return bal.fit_bal_device(cams0, pts0, oc, op, uv, cfg3, device=DEVICE, dtype=torch.float32)

    fit()
    profiling.reset_launch_counts()
    res = fit()
    fit_launches = profiling.launch_counts()[K5]
    out = {"ms": ms, "plain_ms": statistics.median(rounds["plain"]),
           "tsqr_ms": statistics.median(rounds["tsqr"]),
           "library_ms": statistics.median(rounds["library"]),
           "bound_ms": bound(nbytes, flops)[0], "bound_by": bound(nbytes, flops)[1],
           "ops_bound_ms": flops / FP32_FLOPS_PER_S * 1e3, "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "roofline_pct": 100 * bound(nbytes, flops)[0] / ms, "max_abs_err": err}
    line = {"phase": "tall_qr", "shape": [m, n + 1], "dtype": "float32", **out,
            "rounds": rounds, "repeat_bitwise": repeat, "gram_residual": gram_res,
            "plan": plan._asdict(), "step_kernel_nodes": len(names), "step_k5_nodes": k5_nodes,
            "step_library_qr_nodes": geqrf_nodes,
            "step_kernel_names": collections.Counter(nm[:60] for nm in names).most_common(8),
            "smoke_plan_launches": smoke_plan.launches,
            "fit_iterations": res.iterations, "fit_launches": fit_launches,
            "fit_launches_want": res.iterations * smoke_plan.launches,
            "method": "CUDA events around one call on a fresh copy of the operand, median of "
                      f"{TALL_QR_REPS} rounds in turns; bound: operations at 67 TFLOP/s and bytes at "
                      "3.35 TB/s; err: max |K5 - plain| over max |R2| (plain)", "gpu": smi}
    emit(line)
    if not (repeat and err < 1e-4 and gram_res < 1e-5 and k5_nodes == smoke_plan.launches
            and geqrf_nodes == 0 and res.iterations == 3
            and fit_launches == res.iterations * smoke_plan.launches):
        raise AssertionError(f"tall_qr: {line}")
    return {**out, "launches": fit_launches, "plan": plan._asdict()}


def main():
    rng = np.random.default_rng(SEED)
    count_k3_launcher_calls()
    smi = phase_device()
    phase_build()
    worst = phase_kernel_vs_plain(rng)
    counts10k = phase_config2(rng)
    counts1m, timings = phase_real_size(rng, smi)
    # the bundle's 19×3 batch, timed with the other B1/B2 timings
    b2_bundle_timing = phase_bundle_b2_timing(rng, smi)
    phase_gradient()
    banded_worst, c3_ops = phase_banded_kernel_vs_plain(rng)
    banded_counts, _ = phase_banded_main_path(rng, smi)
    banded_timings = phase_banded_timing(c3_ops, smi)
    scan_worst, scan_timings = phase_chain_kernels(smi)
    k3_worst, k3_timings = phase_lm_step_kernels(smi)
    k4_timings = phase_ellipse_eval_kernels(smi)
    profiling.reset_launch_counts()
    replayed = phase_programs(rng, smi)
    program_counts = profiling.launch_counts()
    options_worst = phase_blockdiag_options(rng, smi)
    ba_b2 = phase_block_angular(rng, smi)
    ellipse_k3 = phase_ellipse_lm(smi)
    ell_counts, ell_b5_worst, _ = phase_ellipse_banded(smi)
    bundle_b2, bundle_iters = phase_bundle(smi)
    bundle_step_breakdown(smi)
    profiling.reset_launch_counts()
    l1_in_loop = phase_lm_programs(smi)
    lm_counts = profiling.launch_counts()
    l1 = phase_loop_cond(smi, l1_in_loop)
    l2_launches = phase_loop_marks(smi)
    k5 = phase_tall_qr(smi)
    c3 = banded_matrix(rng, C3_NB, C3_BR, C3_BC, C3_OV)
    cli_counts = phase_auto_cli(rng, c3, smi)
    sp_counts = phase_sparse_apply(rng, c3, smi)
    phase_blocked_thin(rng, smi)
    profiling.reset_launch_counts()
    sparse_replayed = phase_sparse_programs(rng, c3, smi)
    sparse_counts = profiling.launch_counts()
    profiling.reset_launch_counts()
    banded_replayed = phase_banded_programs(rng, c3, smi)
    banded_program_counts = profiling.launch_counts()
    floor = phase_launch_floor(smi)
    mesh_counts = phase_mesh(rng, smi)
    # the block-angular, ellipse, bundle, CLI, sparse-product and mesh main paths
    extra = {name: cli_counts[name] + sp_counts[name] + mesh_counts[name] + program_counts[name]
             + sparse_counts[name] + banded_program_counts[name] for name in cli_counts}
    extra["blockdiag_qr_r"] += ba_b2 + bundle_b2
    for name, n in ell_counts.items():
        extra[name] += n
    kernels = []
    for name, (replaces, _, _) in KERNELS.items():
        t = timings[name][-1]  # the 1M-block point
        errs = [e for (k, _, _), e in worst.items() if k == name] + [r["max_abs_err"] for r in timings[name]]
        if name == "blockdiag_qr_r":
            errs.append(b2_bundle_timing["max_abs_err"])
        if name == "blockdiag_lstsq":
            errs.append(options_worst)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": counts10k[name] + counts1m[name] + extra.get(name, 0),
            "max_abs_err": max(errs), "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "mesh_launches": mesh_counts[name],
            "program_launches": program_counts[name], "replayed_warm_launches": replayed[name],
            "sparse_program_launches": sparse_counts[name],
            "sparse_replayed_warm_launches": sparse_replayed[name],
            "banded_program_launches": banded_program_counts[name],
            "banded_replayed_launches": banded_replayed[name],
            "floor_device_ms": floor[f"{NB_REAL}x{BR}x{BC}"],
            "config2_10k": {**{k: timings[name][0][k] for k in ("ms", "device_ms", "plain_ms",
                                                                 "library_ms", "bound_ms", "bound_by")},
                            "floor_device_ms": floor[f"{NB_CONFIG2}x{BR}x{BC}"]},
        })
        if name == "blockdiag_qr_r":
            br19 = 2 * BUNDLE_CAMS + 3
            kernels[-1]["bundle_19x3"] = {
                "n": BUNDLE_HOST_P, "launches_per_host_loop_iteration": bundle_b2 / max(bundle_iters, 1),
                **{k: b2_bundle_timing[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by", "device_ms")},
                "floor_device_ms": floor[f"{BUNDLE_HOST_P}x{br19}x3"],
            }
    for name, replaces in BANDED_KERNELS.items():
        t = banded_timings[name]  # config 3; B5 on the plain chain
        err = banded_worst[name]
        if name == "banded_chain_qr":
            err = max(err, ell_b5_worst)
        kernels.append({
            "name": name, "route": "cuda", "source": BANDED_SOURCE, "replaces": replaces,
            "launches": banded_counts[name] + extra.get(name, 0), "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,  # no single PyTorch call
            "device_ms": t["device_ms"], "mesh_launches": mesh_counts[name],
            "program_launches": program_counts[name], "replayed_warm_launches": replayed[name],
            "sparse_program_launches": sparse_counts[name],
            "sparse_replayed_warm_launches": sparse_replayed[name],
            "banded_program_launches": banded_program_counts[name],
            "banded_replayed_launches": banded_replayed[name],
        })
    for name, replaces in SCAN_KERNELS.items():
        t = scan_timings[name]  # config 3's plain chain, one column
        kernels.append({
            "name": name, "route": "cuda", "source": CHAIN_SOURCE, "replaces": replaces,
            "launches": banded_counts[name] + extra[name], "max_abs_err": scan_worst[name],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms", "case",
                                 "per_step_us", "device_per_step_us", "plain_per_step_us")},
            "library_ms": t.get("library_ms"),
            "library_call": t.get("library_call", "none: no single PyTorch call applies a "
                                                  "two-segment compact-WY chain"),
            "mesh_launches": mesh_counts[name], "program_launches": program_counts[name],
            "replayed_warm_launches": replayed[name],
            "sparse_program_launches": sparse_counts[name],
            "sparse_replayed_warm_launches": sparse_replayed[name],
            "banded_program_launches": banded_program_counts[name],
            "banded_replayed_launches": banded_replayed[name],
            "ellipse_banded_launches": ell_counts[name], "cli_launches": cli_counts[name],
            "sparse_apply_launches": sp_counts[name],
        })
    t = k3_timings[LM_STEP_CASES[0]]  # the ellipse at 100,000 points, fp32
    kernels.append({
        "name": K3, "route": "cuda", "source": LM_STEP_SOURCE, "replaces": K3_REPLACES,
        "launches": ellipse_k3 + lm_counts[K3] + program_counts[K3] + mesh_counts[K3],
        "max_abs_err": k3_worst,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                             "host_us_per_call", "host_us_per_launch")},
        "library_call": "torch.linalg.qr(M, mode='r') on the step's bottom panel [2N + 5, 6]",
        "case": "ellipse step, 100,000 points (2x1 blocks, 5 right columns), fp32",
        **{k: t[k] for k in ("k3_launches", "memset_nodes", "cooperative", "mesh_form_k3_launches",
                             "mesh_form_memset_nodes", "ctas", "geometry", "partial_mode_ms", "floor_ms",
                             "floor_device_ms")},
        "launches_are": "steps: the step counter, one a step; a mesh step's two kernel launches count once",
        "at_500k": {k: k3_timings[LM_STEP_CASES[1]][k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "partial_mode_ms", "floor_ms",
            "geometry")},
        f"vmap_{LM_BATCH[0]}x{LM_BATCH[1]}": k3_timings["vmap"],
        "other_shapes_100k": {f"{bl}x{bc}x{m2}": {k: k3_timings[(bl, bc, m2, nb)][k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "floor_ms")}
            for bl, bc, m2, nb in LM_STEP_CASES[2:]},
        "ellipse_lm_launches": ellipse_k3, "lm_program_launches": lm_counts[K3],
        "program_launches": program_counts[K3], "replayed_warm_launches": replayed[K3],
        "mesh_steps": mesh_counts[K3],
    })
    for name in K4:  # the ellipse cells' shapes, fp32
        kernels.append({
            "name": name, "route": "cuda", "source": ELLIPSE_EVAL_SOURCE, "replaces": K4_REPLACES,
            "launches": lm_counts[name] + extra.get(name, 0),
            "lm_program_launches": lm_counts[name],
            **{f"n{n}" if p == 1 else f"b{p}_n{n}": {k: k4_timings[(name, n, p)][k] for k in (
                "ms", "plain_ms", "device_ms", "bytes", "bound_ms", "roofline_pct", "grid")}
               for n, p in K4_CASES},
            "library_ms": None,  # no single PyTorch call evaluates the model
        })
    kernels.append({
        "name": "graph_loop_cond", "route": "cuda", "source": GRAPH_LOOP_SOURCE,
        "replaces": L1_REPLACES,
        "launches": lm_counts["graph_loop_cond"] + mesh_counts["graph_loop_cond"], **l1,
        "mesh_launches": mesh_counts["graph_loop_cond"],
        "library_ms": None,  # no PyTorch call sets a graph's condition
        "in_loop_device_ms_each": l1_in_loop,
    })
    kernels.append({
        "name": "loop_mark", "route": "cuda", "source": GRAPH_LOOP_SOURCE,
        "replaces": L2_REPLACES, "launches": l2_launches,
        "library_ms": None,  # no PyTorch call stamps the device's clock
    })
    kernels.append({
        "name": K5, "route": "cuda", "source": TALL_QR_SOURCE, "replaces": K5_REPLACES,
        **k5, "case": "BAL Venice-52's bottom [694,814, 469], fp32",
        "library_call": "torch.linalg.qr(a, mode='r')",
    })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
