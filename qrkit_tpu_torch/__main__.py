"""Command-line entry point: structured sparse QR on MatrixMarket files.

Counterpart of ``qrkit_tpu/__main__.py``, with the same flags and the same
report on stderr, plus ``--device`` (default ``cuda``; there is no fallback
to the CPU)::

    python -m qrkit_tpu_torch A.mtx                     # analyze + factorize, report
    python -m qrkit_tpu_torch A.mtx -b b.mtx -o x.mtx   # least-squares solve
    python -m qrkit_tpu_torch A.mtx --export-r R.mtx --export-q Q.mtx
    python -m qrkit_tpu_torch A.mtx --solver banded --suggested-block-cols 8
    python -m qrkit_tpu_torch A.mtx --device cpu --dtype float64

The stack is chosen by :func:`qrkit_tpu_torch.auto_qr` unless ``--solver``
forces one.  The report names the selection, shape, rank, factorization
health (``info()``) and timings; results are written as MatrixMarket.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

_DTYPES = ("float64", "float32")


def _build_parser():
    p = argparse.ArgumentParser(
        prog="python -m qrkit_tpu_torch",
        description="Structured sparse QR (PyTorch + CUDA) on MatrixMarket files.",
    )
    p.add_argument("matrix", help="MatrixMarket file of A")
    p.add_argument("-b", "--rhs", help="MatrixMarket/plain-text RHS vector b")
    p.add_argument("-o", "--out", help="write the solution x (MatrixMarket)")
    p.add_argument("--export-r", help="write sparse R (MatrixMarket)")
    p.add_argument("--export-q", help="write sparse Q (MatrixMarket)")
    p.add_argument(
        "--solver",
        choices=["auto", "block-diagonal", "banded", "segmented", "thin", "dense"],
        default="auto",
        help="force a solver stack (default: auto-select from structure)",
    )
    p.add_argument("--suggested-block-cols", type=int, default=8)
    p.add_argument(
        "--rhs-random",
        action="store_true",
        help="solve against b = A x_true for a random x_true and report the "
        "recovery error (round-trip check)",
    )
    p.add_argument("--device", default="cuda", help="torch device of the factors (default: cuda)")
    p.add_argument("--dtype", choices=_DTYPES, default="float64",
                   help="factor dtype (default: float64)")
    return p


def _load_rhs(path: str, nrows: int) -> np.ndarray:
    if path.endswith(".mtx"):
        from .sparse import load_matrix_market

        d = load_matrix_market(path).to_dense()
        return d[:, 0] if d.ndim == 2 else d
    return np.loadtxt(path).reshape(-1)[:nrows]


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    import torch

    from .auto import BlockDiagonalCSRQR, auto_qr
    from .solvers import (
        BandedBlockedQR,
        BlockedThinSparseQR,
        ComputationInfo,
        DenseColPivQR,
        SegmentedBandedQR,
    )
    from .sparse import SparseCSR, load_matrix_market, save_matrix_market

    place = dict(device=torch.device(args.device), dtype=getattr(torch, args.dtype))
    t0 = time.perf_counter()
    mat = load_matrix_market(args.matrix)
    print(f"loaded {args.matrix}: {mat.nrows}x{mat.ncols}, nnz={mat.nnz}", file=sys.stderr)

    t1 = time.perf_counter()
    sbc = args.suggested_block_cols
    if args.solver == "auto":
        qr = auto_qr(mat, suggested_block_cols=sbc, **place)
        selection = qr.selection
    else:
        make = {
            "block-diagonal": lambda: BlockDiagonalCSRQR(sbc, pivot=False, **place),
            "banded": lambda: BandedBlockedQR(suggested_block_cols=sbc, **place),
            "segmented": lambda: SegmentedBandedQR(suggested_block_cols=sbc, **place),
            "thin": lambda: BlockedThinSparseQR(**place),
            "dense": lambda: DenseColPivQR(**place),
        }[args.solver]
        qr = make().compute(mat)
        selection = args.solver
    info = qr.info()  # reads the device: the factorize has finished
    t2 = time.perf_counter()
    print(
        f"solver={selection} rank={qr.rank}/{qr.cols} info={info.name} "
        f"(load {t1 - t0:.3f}s, factorize {t2 - t1:.3f}s)",
        file=sys.stderr,
    )
    rc = 0 if info == ComputationInfo.SUCCESS else 2

    b = x_true = None
    if args.rhs_random:
        x_true = np.random.default_rng(0).normal(size=mat.ncols)
        b = mat.matvec(x_true)
    elif args.rhs:
        b = _load_rhs(args.rhs, mat.nrows)

    if b is not None:
        t3 = time.perf_counter()
        pb = torch.as_tensor(qr.rows_permutation().apply(b), **place)
        x = qr.solve(pb).cpu().double().numpy()
        t4 = time.perf_counter()
        resid = np.linalg.norm(mat.matvec(x) - b) / max(np.linalg.norm(b), 1e-300)
        msg = f"solve {t4 - t3:.3f}s, relative residual {resid:.3e}"
        if x_true is not None:
            msg += f", x recovery rel err {np.linalg.norm(x - x_true) / np.linalg.norm(x_true):.3e}"
        print(msg, file=sys.stderr)
        if args.out:
            save_matrix_market(
                args.out,
                SparseCSR.from_triplets(
                    np.arange(x.size), np.zeros(x.size, dtype=np.int64), x, (x.size, 1)
                ),
            )
            print(f"wrote {args.out}", file=sys.stderr)

    if args.export_r:
        save_matrix_market(args.export_r, qr.matrix_r_sparse())
        print(f"wrote {args.export_r}", file=sys.stderr)
    if args.export_q:
        save_matrix_market(args.export_q, qr.matrix_q_sparse())
        print(f"wrote {args.export_q}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
