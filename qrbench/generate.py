"""The benchmark's one generator: every input of every cell, from its
configuration's file, its traffic mix's file and ``--seed``.

Nothing here imports the system under test.  The program receives only
what these functions return: host NumPy points and sparse triplets, and
value and right-hand-side tensors made on the device from a
``torch.Generator``.

Ellipse problems come from a catalog that the traffic file fixes
(``catalog_seed``): an LM fit's iteration count moves by a third when a
truth moves by a millionth (the fp32 loop's last, rejected steps), so
problems drawn afresh from each ``--seed`` would change the work from run
to run.  ``--seed`` orders the calls and draws the checked sample instead
(``callers.Order``, ``callers.Sample``).
Banded values and right-hand sides are drawn from ``--seed``: a QR's work
does not depend on its values.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

TRUTH_KEYS = ("a", "b", "x0", "y0", "r")


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent NumPy stream of ``seed`` (any non-negative integer,
    past 32 bits too) for the purpose ``stream``."""
    return np.random.default_rng([int(seed) & (2**63 - 1), int(stream)])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, stream).integers(2**62)))
    return gen


# --- ellipse problems -------------------------------------------------------------


def ellipse_truths(config: Dict, count: int, catalog_seed: int) -> np.ndarray:
    """``[count, 5]`` truths (a, b, x0, y0, r): a Latin hypercube over the
    configuration's ``truth_ranges``, from ``catalog_seed``."""
    r = rng(catalog_seed, 0)
    ranges = config["truth_ranges"]
    out = np.empty((count, len(TRUTH_KEYS)))
    for k, key in enumerate(TRUTH_KEYS):
        lo, hi = ranges[key]
        strata = (r.permutation(count) + r.uniform(size=count)) / count
        out[:, k] = lo + (hi - lo) * strata
    return out


def ellipse_points(truth, n: int, arc: float) -> np.ndarray:
    """``[2, n]`` float64 points at ``t_i = i·arc/n`` on the ellipse
    (bench_sparse_qr_extra.cpp:281-292 samples them so)."""
    a, b, x0, y0, r = (float(v) for v in truth)
    t = np.arange(n) * (arc / n)
    return np.stack([
        x0 + a * np.cos(t) * math.cos(r) - b * np.sin(t) * math.sin(r),
        y0 + a * np.cos(t) * math.sin(r) + b * np.sin(t) * math.cos(r),
    ])


def ellipse_catalog(config: Dict, mix: Dict) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(truths ``[calls, per_call, 5]``, points of each call ``[per_call,
    2, n]``, or ``[2, n]`` where a call fits one problem)."""
    calls, per = mix["catalog_calls"], mix["problems_per_call"]
    arc = config["arc_over_pi"] * math.pi
    truths = ellipse_truths(config, calls * per, mix["catalog_seed"]).reshape(calls, per, 5)
    pts = [np.stack([ellipse_points(t, mix["points"], arc) for t in row]) for row in truths]
    if per == 1:
        pts = [p[0] for p in pts]
    return truths, pts


# --- banded systems ---------------------------------------------------------------


def banded_pattern(config: Dict) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """(rows, cols, shape) of the block-banded pattern in row-major (CSR)
    order: ``blocks`` blocks of ``block_rows`` × ``block_cols``, each
    starting ``block_cols - overlap`` columns after the one before
    (test/test-qrkit.cpp:63-96's generator)."""
    nb, br, bc, ov = (config[k] for k in ("blocks", "block_rows", "block_cols", "overlap"))
    step = bc - ov
    ncols = step * nb + ov
    i, r, c = np.meshgrid(np.arange(nb), np.arange(br), np.arange(bc), indexing="ij")
    rows, cols = (i * br + r).ravel(), (i * step + c).ravel()
    keep = cols < ncols
    return rows[keep], cols[keep], (br * nb, ncols)


def banded_values(config: Dict, seed: int, sets: int, nnz: int, device) -> torch.Tensor:
    """``[sets, nnz]`` values, uniform over the configuration's ``values``
    range, in the pattern's order, made on ``device`` in float32."""
    lo, hi = config["values"]
    gen = torch_generator(seed, 2, device)
    v = torch.rand((sets, nnz), generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * v


def banded_rhs(seed: int, count: int, rows: int, columns: int, device) -> torch.Tensor:
    """``[count, rows]`` or ``[count, rows, columns]`` standard normal
    right-hand sides in float32, made on ``device``."""
    gen = torch_generator(seed, 3, device)
    shape = (count, rows) if columns == 1 else (count, rows, columns)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
