"""Multi-rank dry run of the port's mesh paths, and the rank launcher.

Counterpart of ``__graft_entry__.dryrun_multichip``.  Four steps run on a
``DeviceMesh`` over every rank, each checked against its ``mesh=None``
result on the same inputs:

1. ``ellipse_block_angular``: the ellipse LM step through
   :func:`~qrkit_tpu_torch.functional.block_angular_lstsq`, the rank's left
   blocks and their rows, TSQR over the ranks; it must descend;
2. ``ellipse_lane_major``: the lane-major damped step
   (``examples.ellipse._damped_step_aux``) with the points sharded over
   lanes; it must descend;
3. ``segmented``: :class:`~qrkit_tpu_torch.solvers.SegmentedBandedQR` with
   the segment axis sharded (segmented path taken, factors sharded when S
   tiles the mesh, x within 1e-4 of the truth);
4. ``bundle``: the point-sharded bundle damped step at ``bundle_points``
   points and 2 cameras (100,000 by default, the reference's documented
   one-chip ceiling); it must descend.

Run::

    python -m qrkit_tpu_torch.dryrun --ranks N --device cpu|cuda

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
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from . import _device
from .parallel.mesh import all_reduce_sum, default_mesh, mesh_rank, shard_bounds, shard_leading_axis

__all__ = ["count_collectives", "init_rank", "launch", "mesh_cases", "run_steps"]

RANK_TIMEOUT_S = 300  # a collective that waits longer raises (a deadlock surfaces as an error)
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single", "reduce",
                "gather", "scatter", "barrier")


@contextlib.contextmanager
def count_collectives():
    """The ``torch.distributed`` collectives the block calls, by name (a
    ``Counter``)."""
    calls = collections.Counter()
    saved = {name: getattr(dist, name) for name in _COLLECTIVES}

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counting(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


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


def _rank_main(rank, fn, world, device, store_path, args):
    if _device.resolve(device).type == "cpu":
        torch.set_num_threads(2)
    mesh = init_rank(rank, world, device, store_path)
    try:
        fn(mesh, *args)
    finally:
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


def _steps_worker(mesh, bundle_points: int):
    rank = mesh_rank(mesh)[0]
    out = run_steps(mesh, bundle_points)
    if rank == 0:
        for name, res in out.items():
            print(json.dumps({"step": name, **res}), flush=True)


# --- the cases of the CPU tests -------------------------------------------------------
def mesh_cases(mesh, inputs: dict, out_dir: str) -> None:
    """Run every ``mesh=`` path and its ``mesh=None`` form on the numpy
    ``inputs`` (float64, on the mesh's device) and write this rank's results,
    host tensors by case, to ``out_dir/rank{r}.pt``.  A case that raises
    records its error.  ``tests/test_torch_parallel.py`` asserts them."""
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
        soa_step=soa_step,
        segmented=functools.partial(segmented, "seg"),
        segmented_kernel=functools.partial(segmented, "seg_kernel"),
        segmented_untiled=functools.partial(segmented, "seg_untiled"),
        bundle_step=bundle_step,
        bundle_fit=bundle_fit,
        dryrun=dryrun_steps,
    )
    results = {}
    for name, fn in cases.items():
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
    a = ap.parse_args(argv)
    if a.device == "cuda" and torch.cuda.device_count() < a.ranks:
        raise SystemExit(f"--ranks {a.ranks} needs {a.ranks} cards, found {torch.cuda.device_count()}")
    workdir = os.path.join("build", "dryrun")
    launch(_steps_worker, a.ranks, a.device, workdir, (a.bundle_points,), timeout=900.0)
    print(json.dumps({"ok": True, "ranks": a.ranks, "device": a.device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
