"""Banded least-squares solves through ``qrkit_tpu_torch.auto_qr`` (which
picks ``SegmentedBandedQR`` for the block-banded configuration).

A call is an LM step on a banded Jacobian: ``factorize_values`` on one of
the pool's ``value_sets`` value sets, then ``solve`` of one of its
``rhs_pool`` right-hand sides of ``rhs_columns`` columns.  A call ends in
``torch.cuda.synchronize()``.

The check solves the sampled calls' systems again by the plain reference
(``reference/banded_lstsq.py``, float64 normal equations on the card) and
compares ``x_gap``: the widest gap of a solution entry, relative to the
reference solution's largest entry.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import generate
from ..reference import banded_lstsq
from . import Order, Sample, mark, rel_gap, worst


class Caller:
    kind = "solve"

    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.device = config, mix, device
        self.rows, self.cols, self.shape = generate.banded_pattern(config)
        nnz, (m, n) = self.rows.size, self.shape
        self.values = generate.banded_values(config, seed, mix["value_sets"], nnz, device)
        self.rhs = generate.banded_rhs(seed, mix["rhs_pool"], m, mix["rhs_columns"], device)
        self.order = Order(mix["value_sets"] * mix["rhs_pool"], seed)
        self.sample = Sample(mix["sample_calls"], seed)
        self.tracing = False
        self.setup_program()

    def setup_program(self) -> None:
        from qrkit_tpu_torch import SparseCSR, auto_qr

        device, m = self.device, self.shape[0]
        mat = SparseCSR.from_triplets(self.rows, self.cols,
                                      self.values[0].double().cpu().numpy(), self.shape)
        if not (np.array_equal(mat.indices, self.cols)
                and np.array_equal(np.diff(mat.indptr), np.bincount(self.rows, minlength=m))):
            raise AssertionError("the pattern's order is not the CSR's stored order")
        if torch.device(device).type == "cuda":
            from qrkit_tpu_torch.ops import _build

            _build.load_banded()  # the kernels' builds (a checkout's first run) and loads,
            _build.load_chain()  # outside the analysis's span
        t0 = time.perf_counter()
        self.qr = auto_qr(mat, suggested_block_cols=self.config["suggested_block_cols"],
                          dtype=torch.float32, device=device)
        _sync(device)
        self.spans = {"analysis_s": time.perf_counter() - t0}
        perm = self.qr.rows_permutation()
        # the caller applies the row permutation (QRSolver.solve's contract)
        self.rhs_in = self.rhs
        if not perm.is_identity():
            self.rhs_in = torch.empty_like(self.rhs)
            self.rhs_in[:, torch.as_tensor(perm.indices, device=device)] = self.rhs

    def _solve(self, item: int):
        v, b = divmod(item, self.mix["rhs_pool"])
        with mark(self.tracing, "qrbench.factorize"):
            self.qr.factorize_values(self.values[v])
        with mark(self.tracing, "qrbench.solve"):
            return self.qr.solve(self.rhs_in[b])

    def warm(self) -> None:
        """The first call of a program runs eagerly, the second captures it;
        then one pass over the pool."""
        for item in [0, 0] + list(range(self.mix["value_sets"] * self.mix["rhs_pool"])):
            self._solve(item)
        _sync(self.device)

    def call(self) -> dict:
        item = self.order.next()
        with mark(self.tracing, "qrbench.call"):
            t0 = time.perf_counter()
            x = self._solve(item)
            t1 = time.perf_counter()
            _sync(self.device)
            t2 = time.perf_counter()
        self.sample.offer((item, x))
        return {"start": t0, "host_end": t1, "end": t2, "item": item, "problems": 1,
                "converged": 1}

    def release(self) -> None:
        self.qr = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def checks(self, records, precision="float64") -> dict:
        gaps = []
        by_set = {}
        for item, x in self.sample.items:
            by_set.setdefault(item // self.mix["rhs_pool"], []).append((item, x))
        for v, answers in sorted(by_set.items()):
            ne = banded_lstsq.NormalEquations(self.rows, self.cols, self.shape, self.values[v],
                                              precision)
            for item, x in answers:
                want = ne.solve(self.rhs[item % self.mix["rhs_pool"]])
                gaps.append(rel_gap(x.double().cpu().numpy(), want.cpu().numpy()))
            del ne
        return {"x_gap": (worst(gaps), self.config["limits"]["x_gap"])}

    def chain(self):
        """(steps, block_rows, block_cols, rows, unknowns, columns) of the
        problem's banded chain."""
        c = self.config
        return (c["blocks"], c["block_rows"], c["block_cols"], self.shape[0], self.shape[1],
                self.mix["rhs_columns"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Control(Caller):
    """The control: the reference in TF32 in the program's place."""

    def setup_program(self) -> None:
        self.rhs_in, self.factors = self.rhs, {}

    def _solve(self, item: int):
        v, b = divmod(item, self.mix["rhs_pool"])
        if v not in self.factors:
            self.factors = {v: banded_lstsq.NormalEquations(
                self.rows, self.cols, self.shape, self.values[v], "tf32")}
        return self.factors[v].solve(self.rhs_in[b])

    def warm(self) -> None:
        pass

    def release(self) -> None:
        self.factors = {}
