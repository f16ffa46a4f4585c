"""Multi-rank dry run of the port's mesh paths, and the rank launcher.

Counterpart of ``__graft_entry__.dryrun_multichip``.  Four steps run on a
``DeviceMesh`` over every rank, each checked against its ``mesh=None``
result on the same inputs:

1. ``ellipse_block_angular``: the ellipse LM step through
   :func:`~qrkit_tpu_torch.functional.block_angular_lstsq`, the rank's left
   blocks and their rows, the bottom's R-only QR on each rank and on the
   gathered factors; it must descend;
2. ``ellipse_lane_major``: the lane-major damped step
   (``examples.ellipse._damped_step_aux``) with the points sharded over
   lanes; it must descend;
3. ``segmented``: :class:`~qrkit_tpu_torch.solvers.SegmentedBandedQR` with
   the segment axis sharded (segmented path taken, factors sharded when S
   tiles the mesh, x within 1e-4 of the truth);
4. ``bundle``: the point-sharded bundle damped step at ``bundle_points``
   points and 2 cameras (100,000 by default, the reference's documented
   one-chip ceiling); it must descend.

The lane-major damped step's gradient over the mesh (both forms,
:func:`step_grad_case`) is then held against ``mesh=None``'s
(:func:`check_step_grad`).  Then every ``mesh=`` path that the reference runs as one SPMD program runs
as a captured program (:func:`program_checks`, held by
:func:`check_pins`): per rank, a warm call is one replay, bitwise the same
call under ``_program.eager()``, with the same collectives, rank 0's result
on every rank and ``mesh=None``'s within :func:`_check_close`; the
``reduce=`` bundle fit is one loop launch.  On the card the run starts with
:func:`probe_graph_collectives` (collectives inside a graph and inside a
WHILE node's body), times every path captured against eager and each
collective eager against captured (:func:`time_collectives`).

Run::

    python -m qrkit_tpu_torch.dryrun --ranks N --device cpu|cuda [--widths small|full]

It spawns N processes that meet through a ``FileStore`` under ``build/``
(gloo on the CPU, NCCL on the card, one card per rank) and opens no network
port.  :func:`launch` runs any module-level function on N such ranks (the
tests run :func:`mesh_cases` through it).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import datetime
import functools
import gc
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from . import _device, _program, profiling
from .parallel.mesh import all_reduce_sum, default_mesh, mesh_rank, shard_bounds, shard_leading_axis

__all__ = ["check_step_grad", "count_collectives", "init_rank", "launch", "mesh_cases",
           "program_checks", "release_programs", "run_steps", "step_grad_case", "step_grad_inputs"]

RANK_TIMEOUT_S = 300  # a collective that waits longer raises (a deadlock surfaces as an error)


@contextlib.contextmanager
def count_collectives():
    """The collectives the block issues through
    :mod:`~qrkit_tpu_torch.parallel.mesh`, by ``torch.distributed`` name (a
    ``Counter``, filled when the block ends); a replay of a captured
    program counts the collectives its graph holds, as the eager call
    issues them."""
    calls = collections.Counter()
    before = profiling.collective_counts()
    try:
        yield calls
    finally:
        after = profiling.collective_counts()
        calls.update({k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)})


# --- ranks --------------------------------------------------------------------------
def init_rank(rank: int, world: int, device, store_path: str):
    """Join the default process group through the ``FileStore`` at
    ``store_path`` (NCCL on CUDA, one card per rank; gloo on the CPU) and
    return :func:`~qrkit_tpu_torch.parallel.default_mesh` on that device."""
    dev = _device.resolve(device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S), **kw,
    )
    return default_mesh(device=dev)


def release_programs() -> None:
    """Drop the captured programs this process holds in module caches (the
    mesh paths' and the LM loops'; a solver's go with it) and collect them.
    NCCL destroys a communicator only once no graph holding its collectives
    is left: release before ``destroy_process_group``."""
    from . import functional, lm
    from .examples import bundle, ellipse

    functional.clear_programs()
    ellipse._MESH_STEP_PROGRAMS.clear()
    bundle._make_damped_step.cache_clear()
    bundle._mesh_fit_fns.cache_clear()
    lm.clear_programs()
    gc.collect()
    profiling._sync()


def _rank_main(rank, fn, world, device, store_path, args):
    if _device.resolve(device).type == "cpu":
        torch.set_num_threads(2)
    mesh = init_rank(rank, world, device, store_path)
    try:
        fn(mesh, *args)
    finally:
        release_programs()
        dist.destroy_process_group()


def launch(fn, ranks: int, device, workdir: str, args=(), timeout: float = 600.0) -> None:
    """Run ``fn(mesh, *args)`` on ``ranks`` spawned processes (``fn`` a
    module-level function: the children import it by name), which meet in
    ``workdir/store``.  Raises if a rank fails or the run outlasts
    ``timeout`` seconds (the ranks are then killed)."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, ranks, device, store, tuple(args)), nprocs=ranks,
        join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {ranks} ranks did not finish within {timeout} s")


# --- checks -------------------------------------------------------------------------
def _check_close(name: str, a, b, dtype) -> float:
    """Hold a mesh result against its ``mesh=None`` result: rtol 1e-9 in
    float64, 1e-4 in float32, with an atol of a tenth of that times max|b|."""
    rtol = 1e-9 if dtype == torch.float64 else 1e-4
    a, b = (torch.as_tensor(t).detach().cpu().double() for t in (a, b))
    err = (a - b).abs()
    scale = float(b.abs().max())
    if not bool((err <= rtol * b.abs() + 0.1 * rtol * scale).all()):
        raise AssertionError(f"{name}: mesh result differs from mesh=None by {float(err.max())}")
    return float(err.max())


def _sq(r: torch.Tensor) -> float:
    return float((r.double() * r.double()).sum())


def step_ellipse_block_angular(mesh, npoints: int, dtype=torch.float64, axis: str = "dp"):
    """Dry-run step 1 (see the module docstring)."""
    from .examples.ellipse import EllipseFitting, Ellipse, _damped_system, _jacobian_blocks, \
        _residuals, ellipse_points
    from .functional import block_angular_lstsq

    world = mesh_rank(mesh, axis)[1]
    dev = mesh.device_type
    functor = EllipseFitting(ellipse_points(Ellipse(), npoints), dtype=dtype, device=dev)
    params, pts = functor.initial_params(), functor.pts
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    r = _residuals(params, pts)
    left_d, right_d, rhs = _damped_system(*_jacobian_blocks(params, pts), r, lam)
    lo, hi = shard_bounds(npoints, mesh, axis)
    own = lambda t: torch.cat([t[3 * lo : 3 * hi], t[3 * npoints :]])  # noqa: E731
    delta = block_angular_lstsq(left_d[lo:hi], own(right_d), own(rhs), n_shards=world, tail=5,
                                mesh=mesh, axis=axis)
    ref = block_angular_lstsq(left_d, right_d, rhs, n_shards=world, tail=5)
    err = _check_close("ellipse_block_angular", delta, ref, dtype)
    new = _residuals(params + delta, pts)
    assert _sq(new) < _sq(r), "the sharded block-angular LM step must descend"
    return dict(max_abs_diff=err, cost_before=0.5 * _sq(r), cost_after=0.5 * _sq(new))


def step_ellipse_lane_major(mesh, npoints: int, dtype=torch.float64, axis: str = "dp"):
    """Dry-run step 2 (see the module docstring)."""
    from .examples.ellipse import Ellipse, EllipseFitting, _damped_step_aux, _residuals, \
        ellipse_points

    dev = mesh.device_type
    functor = EllipseFitting(ellipse_points(Ellipse(), npoints), dtype=dtype, device=dev)
    params, pts = functor.initial_params(), functor.pts
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    r = _residuals(params, pts)
    delta = _damped_step_aux(params, r, lam, pts, mesh=mesh, axis=axis)
    err = _check_close("ellipse_lane_major", delta, _damped_step_aux(params, r, lam, pts), dtype)
    new = _residuals(params + delta, pts)
    assert _sq(new) < _sq(r), "the sharded lane-major damped step must descend"
    return dict(max_abs_diff=err, cost_before=0.5 * _sq(r), cost_after=0.5 * _sq(new))


def _segmented_matrix(world: int, seed: int = 0):
    """The reference dry run's banded matrix: 7×4 blocks overlapping by 2
    columns, 16·max(world, 2) of them (enough for the segmented path at
    segment_blocks=16 even on one rank); values from ``seed``."""
    from .sparse import SparseCSR

    rng = np.random.default_rng(seed)
    nblk = 16 * max(world, 2)
    rows, cols, vals = [], [], []
    for i in range(nblk):
        for r in range(7):
            for c in range(4):
                if i * 2 + c < 2 * nblk + 2:
                    rows.append(i * 7 + r)
                    cols.append(i * 2 + c)
                    vals.append(rng.uniform(0.5, 5.0))
    return SparseCSR.from_triplets(rows, cols, vals, (7 * nblk, 2 * nblk + 2)), rng


def step_segmented(mesh, dtype=torch.float64, axis: str = "dp"):
    """Dry-run step 3 (see the module docstring)."""
    from .solvers import SegmentedBandedQR

    world = mesh_rank(mesh, axis)[1]
    dev = mesh.device_type
    spj, rng = _segmented_matrix(world)
    make = functools.partial(SegmentedBandedQR, suggested_block_cols=4, segment_blocks=16,
                             device=dev, dtype=dtype)
    qr = make(mesh=mesh, axis=axis).compute(spj)
    assert qr._delegate is None, "the dry run must take the segmented path"
    if qr.S % world == 0:
        assert qr._Yws.shape[0] == qr.S // world, "each rank holds only its segments' factors"
    x_true = rng.normal(size=spj.ncols)
    b = torch.as_tensor(qr.rows_permutation().apply(spj.to_dense() @ x_true), dtype=dtype, device=dev)
    x = qr.solve(b)
    truth = float(np.abs(x.double().cpu().numpy() - x_true).max())
    assert truth < 1e-4, f"sharded banded solve is {truth} from the truth"
    err = _check_close("segmented", x, make().compute(spj).solve(b), dtype)
    return dict(max_abs_diff=err, max_err_vs_truth=truth, S=int(qr.S), sharded=qr._segs is not None)


def step_bundle(mesh, n_pts: int, dtype=torch.float64, axis: str = "dp"):
    """Dry-run step 4 (see the module docstring)."""
    from .examples.bundle import _make_damped_step, _residuals_own, make_scene, residuals

    world = mesh_rank(mesh, axis)[1]
    dev = mesh.device_type
    n_pts -= n_pts % world
    cams, pts3d, uv = make_scene(n_cams=2, n_pts=n_pts, noise=0.0, seed=4)
    prng = np.random.default_rng(5)
    x0 = np.concatenate([(pts3d + 0.05 * prng.normal(size=pts3d.shape)).ravel(),
                         (cams + 0.02 * prng.normal(size=cams.shape)).ravel()])
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
    uv = torch.as_tensor(uv, dtype=dtype, device=dev)
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    uv_own = shard_leading_axis(uv, mesh, axis)
    r_own = _residuals_own(x0, uv_own, mesh=mesh, axis=axis)
    delta = _make_damped_step(world, mesh, axis)(x0, r_own, lam, uv_own)
    rb = residuals(x0, uv)
    err = _check_close("bundle", delta, _make_damped_step(world)(x0, rb, lam, uv), dtype)
    # the descent check reads the sharded residuals through the mesh
    before = float(all_reduce_sum((r_own * r_own).sum(), mesh, axis))
    r_new = _residuals_own(x0 + delta, uv_own, mesh=mesh, axis=axis)
    after = float(all_reduce_sum((r_new * r_new).sum(), mesh, axis))
    assert after < before, "the sharded bundle damped step must descend"
    return dict(max_abs_diff=err, cost_before=0.5 * before, cost_after=0.5 * after, n_pts=n_pts)


STEPS = ("ellipse_block_angular", "ellipse_lane_major", "segmented", "bundle")


def run_steps(mesh, bundle_points: int = 100_000, dtype=torch.float64, axis: str = "dp") -> dict:
    """The four dry-run steps on ``mesh``; returns ``{step: result}`` (each
    raises AssertionError on a failed check).  The ellipse steps take the
    reference's sizes, 8 and 16 points per rank."""
    world = mesh_rank(mesh, axis)[1]
    return {
        "ellipse_block_angular": step_ellipse_block_angular(mesh, 8 * world, dtype, axis),
        "ellipse_lane_major": step_ellipse_lane_major(mesh, 16 * world, dtype, axis),
        "segmented": step_segmented(mesh, dtype, axis),
        "bundle": step_bundle(mesh, bundle_points, dtype, axis),
    }


def _steps_worker(mesh, bundle_points: int, widths: str, reps: int):
    """A rank of the command line: on the card the probe first (a failed
    probe stops the run), then the four steps, then every mesh path as a
    captured program (:func:`program_checks`, held by :func:`check_pins`,
    the same on every rank) and the collectives' costs, eager against
    captured.  Rank 0 prints one JSON line each."""
    rank, world = mesh_rank(mesh)
    cuda = mesh.device_type == "cuda"
    say = (lambda obj: print(json.dumps(obj), flush=True)) if rank == 0 else (lambda obj: None)
    if cuda:
        probe = probe_graph_collectives(mesh)
        say({"probe": probe})
        if not probe["plain"]["ok"]:
            raise RuntimeError(f"rank {rank}: collectives inside a graph: {probe}")
    for name, res in run_steps(mesh, bundle_points).items():
        say({"step": name, **res})
    errs = check_step_grad(step_grad_case(mesh, step_grad_inputs(world, nb=2000)))
    say({"step": "lm_damped_step_grad", "world": world, "max_abs_err": errs})
    dtype = torch.float32 if cuda else torch.float64
    res = program_checks(mesh, program_inputs(world, widths), dtype, timed_reps=reps if cuda else 0)
    for label, r in check_pins(res, dtype, captured=cuda, fetch_reads=int(cuda)).items():
        say({"path": label, "world": world, "dtype": str(dtype), **r})
    _same_on_every_rank(mesh, res)
    if cuda:
        say({"collectives": time_collectives(mesh, reps=max(reps, 20))})


def check_pins(res: dict, dtype, captured: bool = True, fetch_reads: int = 0) -> dict:
    """Hold :func:`program_checks`' results to the contract (raises
    AssertionError): each path's first call ran eagerly; a warm call is one
    replay (two for the sparse-A2 recompute: the left's and its own), at
    most 3 ATen ops outside it (6 for the recompute), no host read (a
    sparse product's fetch: ``fetch_reads``) and no host-issued launch; it
    equals the same call under ``_program.eager()`` bitwise, issues the
    same collectives, and agrees with ``mesh=None`` (:func:`_check_close`);
    the ``reduce=`` fit is one launch and one host read a chunk of its
    chunked loop (``_program.loop_chunks``), bitwise the eager loop's, its
    collectives the eager loop's and those of the gated iterations past the
    end.
    Without ``captured`` (the CPU, where every call runs
    eagerly) only the results are held.  Returns the printable fields by
    path."""
    out = {}
    for label, r in res.items():
        if "error" in r:
            raise AssertionError(f"{label}: {r['error']}")
        printable = {k: v for k, v in r.items() if not isinstance(v, torch.Tensor)}
        same = r["collectives_replay"] == r["collectives_eager"]
        if label == "bundle.fit_reduce":
            chunks = _program.loop_chunks(r["iterations"], FIT_CFG_ITERS)
            same = r["collectives_replay"] == r["collectives_expected"]
            ok = r["bitwise_equal_eager"] and (not captured or (
                r["programs"] == chunks and r["lm_host_reads"] == chunks))
        else:
            recompute = label == "block_angular_sparse_a2.compute"
            reads = fetch_reads if label.endswith("_sparse") else 0
            ok = r["bitwise_equal_eager"] and (not captured or (
                r["first_programs"] == 0 and r["programs"] == 1 + recompute
                and r["ops"] <= (6 if recompute else 3) and r["host_reads"] == reads
                and r["host_launches"] == 0))
            printable["max_abs_diff_none"] = _check_close(label, r["value"], r["none"], dtype)
        if not (ok and same):
            raise AssertionError(f"{label}: outside the contract: {printable}")
        out[label] = printable
    return out


def _same_on_every_rank(mesh, res: dict, axis: str = "dp") -> None:
    """Raise unless every path's value is rank 0's, bitwise (one broadcast a
    path)."""
    group = mesh.get_group(axis)
    for label, r in res.items():
        for key in ("value", "x"):
            if key in r:
                v = r[key].to(mesh.device_type).contiguous()
                first = v.clone()
                dist.broadcast(first, src=dist.get_global_rank(group, 0), group=group)
                if not torch.equal(first, v):
                    raise AssertionError(f"{label}: rank {dist.get_rank(group)} differs from rank 0")


def time_collectives(mesh, reps: int = 50, axis: str = "dp") -> dict:
    """µs per collective on this rank, eager against captured: each between
    CUDA events on the current stream, the median of ``reps`` (the captured
    one a replay of a graph holding it alone, captured after a warm-up, in
    ``"thread_local"`` mode).  The widths: ``all_gather_into_tensor`` of
    the ``[R | Qᵀy]`` stack of the bundle step ([12, 13] float32 a rank) and of
    config 3's CAQR R factors at 80 segments ([80/world, 8, 8]);
    ``all_reduce`` of a scalar (an LM cost) and of the bundle fit's
    gradient at 20,000 points × 8 cameras ([60,048])."""
    group = mesh.get_group(axis)
    world = dist.get_world_size(group)
    dev = torch.device("cuda", torch.cuda.current_device())
    f32 = dict(dtype=torch.float32, device=dev)

    def gather(n):
        x, out = torch.ones(n, **f32), torch.empty(world * n, **f32)
        return lambda: dist.all_gather_into_tensor(out, x, group=group)

    def reduce(n):
        x = torch.ones(n, **f32) if n else torch.ones((), **f32)
        return lambda: dist.all_reduce(x, group=group)

    cases = {"all_gather_into_tensor_tsqr_156": gather(12 * 13),
             f"all_gather_into_tensor_caqr_{80 // world * 64}": gather(80 // world * 64),
             "all_reduce_scalar": reduce(0), "all_reduce_60048": reduce(60_048)}
    stream = torch.cuda.Stream(device=dev)
    out = {}
    for label, fn in cases.items():
        fn()
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            fn()
        times = {}
        for kind, run in (("eager", fn), ("captured", graph.replay)):
            run()
            events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(reps)]
            for start, end in events:
                start.record()
                run()
                end.record()
            torch.cuda.synchronize(dev)
            times[f"{kind}_us"] = float(np.median([s.elapsed_time(e) for s, e in events])) * 1e3
        out[label] = times
        del graph
    return out


# --- the probe: collectives inside captured graphs -------------------------------------
def probe_graph_collectives(mesh, axis: str = "dp", n: int = 4096, max_iters: int = 10) -> dict:
    """Whether NCCL collectives captured into CUDA graphs run as recorded,
    on every rank of ``mesh`` (one card each; the loop part decided the
    design of a loop that holds collectives: on 4 cards the WHILE graph's
    build refuses NCCL's nodes, so such loops run as chunks of plain
    graphs, ``_program._ChunkedLoop``):

    * ``plain``: one graph holding an ``all_reduce`` of ``[n]`` and an
      ``all_gather_into_tensor`` of ``[n]`` per rank, captured with
      ``capture_error_mode="thread_local"`` and replayed on new data;
    * ``loop``: an ``all_reduce`` of one value inside the body of a
      conditional WHILE node (:class:`~qrkit_tpu_torch.ops.graph_loop.LoopGraph`):
      the body adds the all-reduced 1 to an accumulator and sets ``done``
      once it reaches 3·world, so the loop must stop after 3 iterations on
      every rank, with 4 evaluations of its condition.

    Returns ``{part: {"ok": bool, ...}}`` (an error as its message)."""
    from .ops.graph_loop import LoopGraph

    group = mesh.get_group(axis)
    rank, world = mesh_rank(mesh, axis)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    stream = torch.cuda.Stream(device=dev)
    pool = torch.cuda.graph_pool_handle()
    x = torch.full((n,), float(rank + 1), device=dev)
    red, gathered = torch.empty(n, device=dev), torch.empty(world * n, device=dev)

    def collectives():
        red.copy_(x)
        dist.all_reduce(red, group=group)
        dist.all_gather_into_tensor(gathered, x, group=group)

    try:
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            collectives()  # the warm-up, on every rank
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            collectives()
        x.fill_(rank + 2.0)
        graph.replay()
        torch.cuda.synchronize(dev)
        want_red = float(sum(r + 2 for r in range(world)))
        want_gather = torch.arange(world, device=dev, dtype=torch.float32).repeat_interleave(n) + 2.0
        out["plain"] = dict(ok=bool((red == want_red).all()) and bool(torch.equal(gathered, want_gather)))
    except Exception as e:  # reported, not raised: the probe decides a design
        out["plain"] = dict(ok=False, error=f"{type(e).__name__}: {e}")

    acc = torch.zeros(1, device=dev)
    one = torch.ones(1, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    log = torch.full((max_iters + 1,), -1, dtype=torch.int32, device=dev)
    stamps = torch.zeros(max_iters + 1, dtype=torch.int64, device=dev)
    res = torch.zeros(3, device=dev)

    def init():
        acc.zero_()
        k.zero_()
        count.zero_()
        done.zero_()

    def body():
        t = one.clone()
        dist.all_reduce(t, group=group)
        acc.add_(t)
        k.add_(1)
        done.copy_(acc >= 3.0 * world)

    def tail():
        res.copy_(torch.cat([acc, k.float()[None], count.float()[None]]))

    try:
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            body()  # the warm-up
        torch.cuda.current_stream(dev).wait_stream(stream)
        graphs = []
        for fn in (body, init, tail):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(g, pool=pool, stream=stream, capture_error_mode="thread_local"):
                fn()
            graphs.append(g)
        body_g, init_g, tail_g = (g.raw_cuda_graph() for g in graphs)
        loop = LoopGraph(init_g, body_g, tail_g, done, k, max_iters, count, log, stamps)
        runs = []
        for _ in range(2):
            loop.launch()
            torch.cuda.synchronize(dev)
            runs.append(res.tolist())
        loop.close()
        ok = all(r == [3.0 * world, 3.0, 4.0] for r in runs)
        out["loop"] = dict(ok=ok, runs=runs)
    except Exception as e:
        out["loop"] = dict(ok=False, error=f"{type(e).__name__}: {e}")
    return out


def _probe_worker(mesh):
    res = probe_graph_collectives(mesh)
    print(json.dumps({"probe": res, "rank": mesh_rank(mesh)[0]}), flush=True)


# --- the mesh paths as captured programs -----------------------------------------------
# the sizes of program_checks: "small" for the CPU tests, "full" the card's
# widths (chip_smoke.py's mesh phase: config 2 at 10,000 and 1,000,000 blocks
# of 7×2, config 3's 40×8 blocks in segments of 32, config 4 at N = 100,000,
# the lane-major ellipse step at 100,000 points, the bundle step at 100,000
# points × 2 cameras and the bundle device fit at 20,000 points × 8 cameras)
PROGRAM_SIZES = {
    "small": dict(bd_nb=(16,), pivot=True, seg=(64, 10, 4, 2, 8, 4), ba_n=16, ba_m2=4,
                  ellipse_n=32, step_p=16, fit=(8, 2, 0.0, 9)),
    "full": dict(bd_nb=(10_000, 1_000_000), pivot=False, seg=(2499, 40, 8, 4, 32, 8),
                 ba_n=100_000, ba_m2=5, ellipse_n=100_000, step_p=100_000,
                 fit=(20_000, 8, 1e-3, 3)),
}
PROGRAM_WARM = 3  # calls before the counted one: eager, warm-up + capture, first replay
FIT_CFG_ITERS = 40


def _tiled_blocks(nb: int, segment_blocks: int, world: int) -> int:
    """The least block count >= ``nb`` whose segments tile ``world`` ranks
    (config 3's 2,499 blocks make 79 segments of 32, which tile one rank)."""
    tile = segment_blocks * world
    return nb if -(-nb // segment_blocks) % world == 0 else -(-nb // tile) * tile


def _banded(rng, nb, br, bc, ov):
    """A row-sorted banded matrix: ``nb`` blocks of ``br×bc`` overlapping
    ``ov`` columns, uniform(0.5, 5) values."""
    from .sparse import SparseCSR

    step = bc - ov
    ncols = step * nb + ov
    i, r, c = np.meshgrid(np.arange(nb), np.arange(br), np.arange(bc), indexing="ij")
    rows, cols = (i * br + r).ravel(), (i * step + c).ravel()
    keep = cols < ncols
    vals = rng.uniform(0.5, 5.0, size=rows.size)
    return SparseCSR.from_triplets(rows[keep], cols[keep], vals[keep], (br * nb, ncols))


def _sparse_cols(rng, nrows: int, ncols: int, keep: float = 0.4):
    """A host CSR ``[nrows, ncols]``: normal values, ``keep`` of them kept,
    the leading diagonal always (no empty column)."""
    from .sparse import SparseCSR

    dense = np.where(rng.random((nrows, ncols)) < keep, rng.normal(size=(nrows, ncols)), 0.0)
    dense[np.arange(ncols), np.arange(ncols)] = 1.0
    return SparseCSR.from_dense(dense)


def program_inputs(world: int, size: str = "small", seed: int = 0) -> dict:
    """The host inputs of :func:`program_checks` for ``world`` ranks, made
    with NumPy from ``seed`` (the CPU tests rebuild them for the
    reference)."""
    from .examples.bundle import make_scene
    from .examples.ellipse import Ellipse, ellipse_points

    sz = PROGRAM_SIZES[size]
    rng = np.random.default_rng(seed)
    inp = {"bd_nb": sz["bd_nb"], "pivot": sz["pivot"]}
    for nb in sz["bd_nb"]:
        inp[f"bd{nb}"] = (rng.uniform(0.5, 5.0, size=(nb, 7, 2)), rng.normal(size=nb * 7))
    nb, br, bc, ov, L, sbc = sz["seg"]
    seg = _banded(rng, _tiled_blocks(nb, L, world), br, bc, ov)
    inp["seg"] = (seg, rng.normal(size=seg.nrows), rng.normal(size=seg.ncols),
                  _sparse_cols(rng, seg.nrows, 5), (br, bc, ov, L, sbc))
    n, m2 = sz["ba_n"], sz["ba_m2"]
    blocks = rng.uniform(0.5, 5.0, size=(n, 2, 1))
    a2 = rng.uniform(0.5, 5.0, size=(2 * n, m2))
    inp["ba"] = (blocks, a2, _sparse_cols(rng, 2 * n, m2), rng.normal(size=2 * n))
    inp["tsqr"] = (rng.normal(size=(16 * world + 3, 7)), rng.normal(size=16 * world + 3))
    n = sz["ellipse_n"] - sz["ellipse_n"] % world
    inp["ellipse"] = ellipse_points(Ellipse(), n)
    p = sz["step_p"] - sz["step_p"] % world
    cams, pts3d, uv = make_scene(n_cams=2, n_pts=p, noise=0.0, seed=4)
    prng = np.random.default_rng(5)
    x0 = np.concatenate([(pts3d + 0.05 * prng.normal(size=pts3d.shape)).ravel(),
                         (cams + 0.02 * prng.normal(size=cams.shape)).ravel()])
    inp["step"] = (x0, uv)
    p, c, noise, scene_seed = sz["fit"]
    p -= p % world
    cams, pts3d, uv = make_scene(n_cams=c, n_pts=p, noise=noise, seed=scene_seed)
    prng = np.random.default_rng(7)
    inp["fit"] = (cams + 0.02 * prng.normal(size=cams.shape),
                  pts3d + 0.02 * prng.normal(size=pts3d.shape), uv)
    return inp


def _program_paths(mesh, inp: dict, dtype, axis: str = "dp"):
    """The captured mesh paths: ``[(label, call, read, none)]`` where
    ``call()`` is the counted call on the mesh, ``read(out)`` the tensor it
    is held to (a factorize: what it left), ``none()`` the same on one
    device (``mesh=None``, eager).  Setup calls (the computes a solve
    reads) run here, on every rank."""
    from . import functional
    from .containers import BlockDiagonal, BlockMatrix1x2
    from .examples import bundle, ellipse
    from .parallel import TSQRDenseQR
    from .solvers import BlockAngularQR, BlockDiagonalQR, QFormat, SegmentedBandedQR

    world = mesh_rank(mesh, axis)[1]
    dev = mesh.device_type
    T = functools.partial(torch.as_tensor, dtype=dtype, device=dev)
    same = lambda out: out  # noqa: E731
    paths = []

    def blockdiag(nb, pivot):
        blocks, b = inp[f"bd{nb}"]
        mat = BlockDiagonal.from_dense_batch(T(blocks))
        bt = T(b)
        make = functools.partial(BlockDiagonalQR, QFormat.FULL_Q, pivot,
                                 use_kernel=False if pivot else True)
        qm, qn = make(mesh=mesh, axis=axis), make()
        qm.compute(mat)
        qn.compute(mat)
        if pivot:  # the batched tier: its solve is eager glue, with a mesh or without
            return [(f"blockdiag{nb}_pivot.compute", lambda: qm.compute(mat),
                     lambda _: qm.r_diagonal(), qn.r_diagonal)]
        return [(f"blockdiag{nb}.compute", lambda: qm.compute(mat), lambda _: qm.r_diagonal(),
                 qn.r_diagonal),
                (f"blockdiag{nb}.solve", lambda: qm.solve(bt), same, lambda: qn.solve(bt))]

    for nb in inp["bd_nb"]:
        paths += blockdiag(nb, False)
    if inp["pivot"]:
        paths += blockdiag(inp["bd_nb"][0], True)

    spj, b_np, v_np, sop, (br, bc, ov, L, sbc) = inp["seg"]
    make = functools.partial(SegmentedBandedQR, suggested_block_cols=sbc, segment_blocks=L,
                             use_kernel=True, device=dev, dtype=dtype)
    sm, sn = make(mesh=mesh, axis=axis).compute(spj), make().compute(spj)
    vals = T(spj.data * 1.5)
    sn.factorize_values(vals)
    b, y = T(b_np), T(v_np)
    paths += [
        ("segmented.factorize_values", lambda: sm.factorize_values(vals), lambda _: sm.r_diagonal(),
         sn.r_diagonal),
        ("segmented.solve", lambda: sm.solve(b), same, lambda: sn.solve(b)),
        ("segmented.apply_qt", lambda: sm.apply_qt(b), same, lambda: sn.apply_qt(b)),
        ("segmented.apply_q", lambda: sm.apply_q(b), same, lambda: sn.apply_q(b)),
        ("segmented.solve_r", lambda: sm.solve_r(y), same, lambda: sn.solve_r(y)),
        ("segmented.apply_qt_sparse", lambda: sm.apply_qt_sparse(sop), _csr_values,
         lambda: sn.apply_qt_sparse(sop)),
        ("segmented.apply_q_sparse", lambda: sm.apply_q_sparse(sop), _csr_values,
         lambda: sn.apply_q_sparse(sop)),
    ]

    blocks, a2, a2_sparse, b_np = inp["ba"]
    n = blocks.shape[0]
    left = BlockDiagonal(T(blocks), 2 * n, n)
    bt = T(b_np)

    def angular(m, right):
        return BlockAngularQR(BlockDiagonalQR(QFormat.FULL_Q, pivot=False, mesh=m, axis=axis,
                                              use_kernel=True),
                              right(m), mesh=m, axis=axis)

    tsqr_right = lambda m: TSQRDenseQR(world, mesh=m, axis=axis)  # noqa: E731
    sparse_mat = BlockMatrix1x2(left, a2_sparse)
    am, an = angular(mesh, tsqr_right), angular(None, tsqr_right)
    an.compute(sparse_mat)
    am.compute(sparse_mat)
    paths.append(("block_angular_sparse_a2.compute", lambda: am.compute(sparse_mat),
                  lambda _: am.r_diagonal(), an.r_diagonal))
    paths.append(("block_angular_sparse_a2.solve", lambda: am.solve(bt), same,
                  lambda: an.solve(bt)))
    dense_mat = BlockMatrix1x2(left, T(a2))
    dm, dn = angular(mesh, tsqr_right), angular(None, tsqr_right)
    for _ in range(PROGRAM_WARM):  # the children's factorize programs captured
        dm.compute(dense_mat)
    dn.compute(dense_mat)
    paths.append(("block_angular_tsqr.solve", lambda: dm.solve(bt), same, lambda: dn.solve(bt)))

    A_np, v_np = inp["tsqr"]
    A, v = T(A_np), T(v_np)
    tm, tn = TSQRDenseQR(world, mesh=mesh, axis=axis), TSQRDenseQR(world)
    tm.compute(A)
    tn.compute(A)
    paths += [
        ("tsqr.compute", lambda: tm.compute(A), lambda _: tm.matrix_r_dense(), tn.matrix_r_dense),
        ("tsqr.apply_qt", lambda: tm.apply_qt(v), same, lambda: tn.apply_qt(v)),
        ("tsqr.apply_q", lambda: tm.apply_q(v), same, lambda: tn.apply_q(v)),
        ("tsqr.solve_r", lambda: tm.solve_r(v[:7]), same, lambda: tn.solve_r(v[:7])),
    ]

    pts_np = inp["ellipse"]
    npts = pts_np.shape[1]
    f = ellipse.EllipseFitting(pts_np, dtype=dtype, device=dev)
    params, pts = f.initial_params(), f.pts
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    res = ellipse._residuals(params, pts)
    left_d, right_d, rhs = ellipse._damped_system(*ellipse._jacobian_blocks(params, pts), res, lam)
    lo, hi = shard_bounds(npts, mesh, axis)
    own = lambda t: torch.cat([t[3 * lo : 3 * hi], t[3 * npts :]])  # noqa: E731
    lb, rr, rv = left_d[lo:hi].contiguous(), own(right_d), own(rhs)
    paths.append(("functional.block_angular_lstsq",
                  lambda: functional.block_angular_lstsq(lb, rr, rv, n_shards=world, tail=5,
                                                         mesh=mesh, axis=axis), same,
                  lambda: functional.block_angular_lstsq(left_d, right_d, rhs, n_shards=world,
                                                         tail=5)))
    paths.append(("ellipse._damped_step_aux",
                  lambda: ellipse._damped_step_aux(params, res, lam, pts, mesh=mesh, axis=axis),
                  same, lambda: ellipse._damped_step_aux(params, res, lam, pts)))

    x0_np, uv_np = inp["step"]
    x0, uv = T(x0_np), T(uv_np)
    uv_own = shard_leading_axis(uv, mesh, axis)
    r_own = bundle._residuals_own(x0, uv_own, mesh=mesh, axis=axis)
    rb = bundle.residuals(x0, uv)
    step_m, step_n = bundle._make_damped_step(world, mesh, axis), bundle._make_damped_step(1)
    paths.append(("bundle._damped_step", lambda: step_m(x0, r_own, lam, uv_own), same,
                  lambda: step_n(x0, rb, lam, uv)))
    return paths


def _csr_values(s) -> torch.Tensor:
    """A sparse product's values and pattern as one float64 tensor."""
    return torch.as_tensor(np.concatenate([s.indptr, s.indices, s.data]).astype(np.float64))


def _wall_and_stream_ms(call, reps: int):
    """(wall ms, stream ms) per call: the host clock over ``reps`` calls
    back to back ending in a synchronize, and the median of CUDA events
    recorded around each call of another ``reps`` (the stream's time from
    the call's first enqueued work to its last)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    return wall, float(np.median([s.elapsed_time(e) for s, e in events]))


def _eager(call):
    def run():
        with _program.eager():
            return call()
    return run


def _pin(call, read, none, timed_reps: int = 0) -> dict:
    """One captured path on this rank: the first call (eager: no program,
    the collectives' communicator already made), the warm-up + capture, the
    first replay, then a counted warm call (replays, ATen ops, host reads,
    host-issued launches, collectives) against the same call under
    ``_program.eager()`` (bitwise, and the same collectives); the
    ``mesh=None`` value beside it.  With ``timed_reps`` (the card), wall and
    stream ms per call, captured against eager, in the rounds captured,
    eager, eager, captured."""
    with profiling.count_dispatches() as first:
        call()
    t0 = time.perf_counter()
    call()
    profiling._sync()
    capture_s = time.perf_counter() - t0
    call()
    with count_collectives() as replayed, profiling.count_dispatches() as d:
        out = call()
    value = read(out).detach().clone()
    with count_collectives() as issued:
        eager_out = _eager(call)()
    eager = read(eager_out).detach().clone()
    call()  # a factorize's factors back on its program's outputs, which later solves read
    res = dict(first_programs=first.programs, programs=d.programs, ops=d.ops,
               host_reads=d.host_reads, host_launches=sum(d.host_launches.values()),
               launches={k: v for k, v in d.launches.items() if v},
               collectives_replay=dict(replayed), collectives_eager=dict(issued),
               bitwise_equal_eager=bool(torch.equal(value, eager)), value=value,
               none=read(none()).detach().clone(), capture_call_s=capture_s)
    if timed_reps:
        times = {"captured": [], "eager": []}
        for kind in ("captured", "eager", "eager", "captured"):
            times[kind].append(_wall_and_stream_ms(call if kind == "captured" else _eager(call),
                                                   timed_reps))
        for kind, ts in times.items():
            res[f"{kind}_wall_ms"] = float(np.mean([t[0] for t in ts]))
            res[f"{kind}_stream_ms"] = float(np.mean([t[1] for t in ts]))
    return res


def _fit_pin(mesh, inp: dict, dtype, axis: str = "dp", timed_reps: int = 0) -> dict:
    """The ``reduce=`` LM loop (``fit_bundle_device(mesh=)``): two fits
    (the first runs iteration 1 eagerly, captures and launches the loop),
    then a counted warm fit (graph launches: the chunks of its chunked
    loop; host reads: the LM driver's count) against the eager loop
    (``_program.eager()``), bitwise in x, cost and iterations.  With
    ``timed_reps``, wall ms per fit, captured against eager, in the rounds
    captured, eager, eager, captured."""
    from . import lm
    from .examples.bundle import fit_bundle_device

    cams0, pts0, uv = inp["fit"]
    cfg = lm.LMConfig(max_iters=FIT_CFG_ITERS)
    fit = lambda: fit_bundle_device(cams0, pts0, uv, cfg, mesh=mesh, axis=axis,  # noqa: E731
                                    device=mesh.device_type, dtype=dtype)
    fit()
    fit()
    reads = lm.levenberg_marquardt_device.host_reads
    with count_collectives() as replayed, profiling.count_dispatches() as d:
        r = fit()
    reads = lm.levenberg_marquardt_device.host_reads - reads
    with count_collectives() as issued:
        e = _eager(fit)()
    # a chunked loop's last chunk runs its gated iterations past the end
    # too, collectives included (their results discarded)
    loops = [p for p in lm._LOOPS.programs().values() if p.chunked]
    padding = loops[-1].reads * _program.LOOP_CHUNK - r.iterations if loops else 0
    body = loops[-1].collectives.get("body", {}) if loops else {}
    expected = {k: n + padding * body.get(k, 0) for k, n in issued.items()}
    times = {"captured": [], "eager": []}
    for kind in ("captured", "eager", "eager", "captured") if timed_reps else ():
        times[kind].append(_wall_and_stream_ms(fit if kind == "captured" else _eager(fit),
                                               max(timed_reps // 2, 1)))
    timing = {f"{kind}_{what}_ms": float(np.mean([t[i] for t in ts]))
              for kind, ts in times.items() if ts for i, what in enumerate(("wall", "stream"))}
    return dict(programs=d.programs, lm_host_reads=reads,
                launches={k: v for k, v in d.launches.items() if v},
                collectives_replay=dict(replayed), collectives_eager=dict(issued),
                collectives_expected=expected, padding_iterations=padding,
                x=torch.as_tensor(r.x), cost=r.cost, iterations=r.iterations,
                eager_x=torch.as_tensor(e.x), eager_cost=e.cost, eager_iterations=e.iterations,
                bitwise_equal_eager=bool(np.array_equal(r.x, e.x) and r.cost == e.cost
                                         and r.iterations == e.iterations), **timing)


def program_checks(mesh, inp: dict, dtype=torch.float64, axis: str = "dp",
                   timed_reps: int = 0) -> dict:
    """Every ``mesh=`` path that the reference runs as one SPMD program, as a
    captured program on this rank (:func:`_pin` each; the ``reduce=`` fit
    :func:`_fit_pin`), on :func:`program_inputs`' ``inp``.  Returns
    ``{label: result}``; a path that raises records its traceback.  The
    module-level program caches are released first
    (:func:`release_programs`), so that each path's first call is its key's
    first."""
    release_programs()
    out = {}
    try:
        paths = _program_paths(mesh, inp, dtype, axis)
    except Exception:
        return {"setup": {"error": traceback.format_exc()}}
    for label, call, read, none in paths:
        try:
            out[label] = _pin(call, read, none, timed_reps)
        except Exception:
            out[label] = {"error": traceback.format_exc()}
    try:
        out["bundle.fit_reduce"] = _fit_pin(mesh, inp, dtype, axis, timed_reps)
    except Exception:
        out["bundle.fit_reduce"] = {"error": traceback.format_exc()}
    return out


# --- the cases of the CPU tests -------------------------------------------------------
def step_grad_inputs(world: int, nb: int = 24, seed: int = 7) -> dict:
    """Global operands of :func:`step_grad_case` (numpy, ``world·nb``
    points): the (2, 2, 5) step of ``lm_damped_step_blockdiag``, the
    (2, 1, 5) step of ``…1`` and a loss weight each."""
    rng = np.random.default_rng(seed)
    n = world * nb
    out = {}
    for bc in (2, 1):
        out[f"bc{bc}"] = dict(left=rng.normal(size=(2, bc, n)), right=rng.normal(size=(2, 5, n)),
                              res=rng.normal(size=(2, n)), w=rng.normal(size=bc * n + 5), lam=0.3)
    return out


def step_grad_case(mesh, inputs: dict, dtype=torch.float64, axis: str = "dp") -> dict:
    """Gradients of a loss of the replicated step (the same on every rank)
    through the ``mesh=`` lane-major damped steps, for the bc = 2 form
    (``lm_damped_step_blockdiag``) and the bc = 1 form (``…1``): each rank
    passes its own points; the backward pass's collectives counted.  Beside
    them the same loss without a mesh on every point (``none_*``).  Returns
    {form: results} (:func:`step_grad_inputs`' operands)."""
    from .functional import lm_damped_step_blockdiag, lm_damped_step_blockdiag1

    dev = mesh.device_type
    T = functools.partial(torch.as_tensor, dtype=dtype, device=dev)
    out = {}
    for form, op in inputs.items():
        n = op["left"].shape[-1]
        lo, hi = shard_bounds(n, mesh, axis)
        bc1 = op["left"].shape[1] == 1

        def loss_of(sl, m):
            left = op["left"][:, 0, sl] if bc1 else op["left"][..., sl]
            ts = [T(a).requires_grad_() for a in (left, op["right"][..., sl], op["res"][..., sl])]
            lam = T(op["lam"]).requires_grad_()
            if bc1:
                x = lm_damped_step_blockdiag1(*ts, lam, mesh=m, axis=axis)
            else:
                x1, x2 = lm_damped_step_blockdiag(*ts, lam, mesh=m, axis=axis)
                x = torch.cat([x1.reshape(-1), x2])
            loss = (T(op["w"]) * x).sum() + 0.5 * (x * x).sum()
            with count_collectives() as calls:
                loss.backward()
            return x.detach(), [t.grad for t in ts] + [lam.grad], dict(calls)

        x, grads, calls = loss_of(slice(lo, hi), mesh)
        x_none, grads_none, _ = loss_of(slice(None), None)
        out[form] = dict(x=x, x_none=x_none, collectives=calls, lo=lo, hi=hi,
                         **{f"local_{k}": g for k, g in zip(("left", "right", "res"), grads[:3])},
                         lam=grads[3], **{f"none_{k}": g for k, g in
                                         zip(("left", "right", "res", "lam"), grads_none)})
    return out


def check_step_grad(cases: dict, rtol: float = 1e-10) -> dict:
    """Hold :func:`step_grad_case`'s results (raises AssertionError): each
    form's step and its gradients (the rank's points' and λ's) within
    ``rtol`` (atol ``rtol``·max|·|) of ``mesh=None``'s, the gradients not
    zero, one collective in the backward (the all-reduce).  Returns the
    largest absolute differences by form and operand."""
    errs = {}
    for form, c in cases.items():
        lo, hi = c["lo"], c["hi"]
        pairs = {"x": (c["x"], c["x_none"]), "lam": (c["lam"], c["none_lam"])}
        pairs.update({k: (c[f"local_{k}"], c[f"none_{k}"][..., lo:hi]) for k in ("left", "right", "res")})
        for name, (got, want) in pairs.items():
            got, want = (torch.as_tensor(t).detach().cpu().double() for t in (got, want))
            diff = (got - want).abs()
            ok = bool((diff <= rtol * want.abs() + rtol * float(want.abs().max())).all())
            if not (ok and bool(torch.isfinite(got).all()) and (name == "x" or float(got.abs().max()) > 0)):
                raise AssertionError(f"mesh step grad {form} {name}: {float(diff.max())} off mesh=None's")
            errs[f"{form}_{name}"] = float(diff.max())
        if c["collectives"] != {"all_reduce": 1}:
            raise AssertionError(f"mesh step grad {form}: backward collectives {c['collectives']}")
    return errs


def mesh_cases(mesh, inputs: dict, out_dir: str, only=None) -> None:
    """Run every ``mesh=`` path and its ``mesh=None`` form on the numpy
    ``inputs`` (float64, on the mesh's device) and write this rank's results,
    host tensors by case, to ``out_dir/rank{r}.pt``; ``only``: the names of
    the cases to run (default: all).  A case that raises records its error.
    ``tests/test_torch_parallel.py`` asserts them."""
    from .containers import BlockDiagonal, BlockMatrix1x2
    from .examples.bundle import fit_bundle_device
    from .examples.ellipse import _damped_step_aux
    from .lm import LMConfig
    from .parallel import TSQRDenseQR
    from .solvers import BlockAngularQR, BlockDiagonalQR, QFormat, SegmentedBandedQR
    from .sparse import SparseCSR

    rank, world = mesh_rank(mesh)
    dev, dt = mesh.device_type, torch.float64
    T = functools.partial(torch.as_tensor, dtype=dt, device=dev)
    host = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731

    def tsqr():
        A = T(inputs["tsqr_A"])
        out = {}
        for tag, m in (("mesh", mesh), ("none", None)):
            qr = TSQRDenseQR(world, mesh=m, axis="dp").compute(A)
            out[tag] = dict(Q=qr.matrix_q_dense(), R=qr.matrix_r_dense(),
                            x=qr.solve(A @ T(inputs["tsqr_x"])), local_shards=qr.Yl.shape[0])
        return out

    def blockdiag(pivot, use_kernel):
        blk = BlockDiagonal.from_dense_batch(T(inputs["bd_blocks"]))
        b = T(inputs["bd_b"])
        out = {}
        for tag, m in (("mesh", mesh), ("none", None)):
            qr = BlockDiagonalQR(QFormat.FULL_Q, pivot, mesh=m, axis="dp", use_kernel=use_kernel)
            qr.compute(blk)
            local = qr.R.shape[0] if qr.R is not None else qr._a_soa.shape[1]
            out[tag] = dict(R=qr._global_factors()[1], x=qr.solve(b), qtb=qr.apply_qt(b),
                            qb=qr.apply_q(b), diag=qr.r_diagonal(), rank=qr.rank,
                            info=qr.info().name, perm=torch.as_tensor(qr.cols_permutation().indices),
                            local_blocks=local, kernel=qr._kernel_mode)
        return out

    def uneven():
        blocks = inputs["bd_blocks"]
        blk = BlockDiagonal.from_dense_batch(T(np.concatenate([blocks, blocks[:1]])))
        return dict(message=_error(lambda: BlockDiagonalQR(mesh=mesh).compute(blk)))

    def block_angular():
        blk = BlockDiagonal.from_dense_batch(T(inputs["ba_blocks"]))
        mat = BlockMatrix1x2(blk, T(inputs["ba_right"]))
        out = {}
        for tag, m in (("mesh", mesh), ("none", None)):
            qr = BlockAngularQR(
                BlockDiagonalQR(QFormat.FULL_Q, pivot=False, mesh=m, axis="dp"),
                TSQRDenseQR(n_shards=world, mesh=m, axis="dp"), mesh=m, axis="dp",
            ).compute(mat)
            out[tag] = dict(x=qr.solve(T(inputs["ba_b"])), R=qr.matrix_r_dense(),
                            local_blocks=qr.left.R.shape[0])
        return out

    def lstsq_grad():
        """Gradients of a loss of the replicated x (the same on every rank)
        through the sharded ``block_angular_lstsq``, with and without tail
        rows; the backward pass's collectives counted."""
        from .functional import block_angular_lstsq

        blocks, right, b, w = (inputs[k] for k in ("lg_blocks", "lg_right", "lg_b", "lg_w"))
        nb, br, _ = blocks.shape
        lo, hi = shard_bounds(nb, mesh)
        out = {}
        for tail in (0, right.shape[0] - nb * br):
            rows = np.r_[lo * br : hi * br, nb * br : nb * br + tail]
            lb, r, v = (T(a).requires_grad_() for a in (blocks[lo:hi], right[rows], b[rows]))
            x = block_angular_lstsq(lb, r, v, n_shards=world, tail=tail, mesh=mesh, axis="dp")
            loss = (T(w[: x.shape[0]]) * x).sum() + 0.5 * (x * x).sum()
            with count_collectives() as calls:
                loss.backward()
            body = (hi - lo) * br
            out[f"tail{tail}"] = dict(
                x=x.detach(), collectives=dict(calls), tail_right=r.grad[body:],
                tail_b=v.grad[body:], local_left=lb.grad, local_right=r.grad[:body],
                local_b=v.grad[:body],
            )
        return out

    def soa_step():
        pts, params = T(inputs["soa_pts"]), T(inputs["soa_params"])
        lam = torch.tensor(1e-3, dtype=dt, device=dev)
        return dict(mesh=_damped_step_aux(params, None, lam, pts, mesh=mesh, axis="dp"),
                    none=_damped_step_aux(params, None, lam, pts))

    def segmented(key):
        spj = SparseCSR(*inputs[key])
        b = T(inputs[key + "_b"])
        sbc, L, use_kernel = inputs[key + "_cfg"]
        out = {}
        for tag, m in (("mesh", mesh), ("none", None)):
            qr = SegmentedBandedQR(suggested_block_cols=sbc, segment_blocks=L, mesh=m, axis="dp",
                                   use_kernel=use_kernel, device=dev, dtype=dt).compute(spj)
            x = qr.solve(b)
            qr.factorize_values(torch.as_tensor(spj.data, dtype=dt, device=dev) * 2.0)
            out[tag] = dict(x=x, x_fv=qr.solve(b), qtb=qr.apply_qt(b), R=qr.matrix_r_dense(),
                            diag=qr.r_diagonal(), info=qr.info().name, S=qr.S,
                            delegate=qr._delegate is not None, sharded=qr._segs is not None,
                            kernels=tuple(qr._fac_kernel and g for g in (True, qr._p2w is not None,
                                                                        qr._chain_kernel is not None)),
                            local_segments=qr._Yws.shape[0])
        return out

    def bundle_fit():
        cams0, pts0, uv = (inputs[k] for k in ("bf_cams0", "bf_pts0", "bf_uv"))
        cfg = LMConfig(max_iters=40)
        out = {}
        for tag, m in (("mesh", mesh), ("none", None)):
            r = fit_bundle_device(cams0, pts0, uv, cfg, mesh=m, axis="dp", device=dev, dtype=dt)
            out[tag] = dict(x=torch.as_tensor(r.x), cost=r.cost, iterations=r.iterations)
        return out

    def bundle_step():
        from .examples.bundle import _make_damped_step, _residuals_own, residuals

        x0, uv = T(inputs["bs_x0"]), T(inputs["bs_uv"])
        lam = torch.tensor(1e-3, dtype=dt, device=dev)
        uv_own = shard_leading_axis(uv, mesh)
        step = _make_damped_step(world, mesh, "dp")
        return dict(mesh=step(x0, _residuals_own(x0, uv_own, mesh=mesh, axis="dp"), lam, uv_own),
                    none=_make_damped_step(1)(x0, residuals(x0, uv), lam, uv))

    def dryrun_steps():
        return run_steps(mesh, bundle_points=inputs["dryrun_bundle_points"])

    def programs():
        """Every mesh path as a captured program, through the test's capture
        backends (``inputs["backends"]``: the program's and the loop's)."""
        backend, loop_backend = inputs["backends"]
        with _program._use_backend(backend), _program._use_loop_backend(loop_backend):
            return program_checks(mesh, program_inputs(world, "small"), dt)

    def shard():
        tree = {"a": torch.arange(4 * world, device=dev), "b": (torch.ones(2 * world, 3, device=dev),)}
        return dict(shards=shard_leading_axis(tree, mesh), rank=rank,
                    odd=_error(lambda: shard_leading_axis(torch.arange(2 * world + 1), mesh)))

    cases = dict(
        shard=shard,
        tsqr=tsqr,
        blockdiag_pivot=functools.partial(blockdiag, True, "auto"),
        blockdiag_kernel=functools.partial(blockdiag, False, True),
        uneven=uneven,
        block_angular=block_angular,
        lstsq_grad=lstsq_grad,
        step_grad=lambda: step_grad_case(mesh, inputs["step_grad"]),
        soa_step=soa_step,
        segmented=functools.partial(segmented, "seg"),
        segmented_kernel=functools.partial(segmented, "seg_kernel"),
        segmented_untiled=functools.partial(segmented, "seg_untiled"),
        bundle_step=bundle_step,
        bundle_fit=bundle_fit,
        dryrun=dryrun_steps,
        programs=programs,
    )
    results = {}
    for name, fn in cases.items():
        if only is not None and name not in only:
            continue
        try:
            results[name] = _map(host, fn())
        except Exception:  # recorded for the test that asserts this case
            results[name] = {"error": traceback.format_exc()}
    os.makedirs(out_dir, exist_ok=True)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _error(fn):
    """The ValueError message ``fn()`` raises (None if it raises none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --- command line ---------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qrkit_tpu_torch.dryrun", description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--bundle-points", type=int, default=100_000)
    ap.add_argument("--widths", choices=tuple(PROGRAM_SIZES), default=None,
                    help="the sizes of the captured-program checks (default: full on "
                         "cuda, small on cpu)")
    ap.add_argument("--reps", type=int, default=5, help="timed calls a round (cuda)")
    a = ap.parse_args(argv)
    if a.device == "cuda" and torch.cuda.device_count() < a.ranks:
        raise SystemExit(f"--ranks {a.ranks} needs {a.ranks} cards, found {torch.cuda.device_count()}")
    widths = a.widths or ("full" if a.device == "cuda" else "small")
    workdir = os.path.join("build", "dryrun")
    launch(_steps_worker, a.ranks, a.device, workdir, (a.bundle_points, widths, a.reps),
           timeout=1500.0)
    print(json.dumps({"ok": True, "ranks": a.ranks, "device": a.device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
