"""The benchmark's callers of the program: each drives one family of
entries, as a traffic mix's ``caller`` names it, in a closed loop.  A
caller module defines ``Caller(config, mix, seed, device)``: set-up in the
constructor, then
``warm()``, ``call()`` (one timed call, returning its record), ``release()``
(frees the program's state) and ``checks()`` (the comparison with the plain
reference: ``{name: (value, limit)}``)."""
from __future__ import annotations

import contextlib

import numpy as np

from .. import generate


class Sample:
    """A reservoir of ``k`` items drawn uniformly from a stream, by a
    seeded generator: the answers that the check compares in full."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = generate.rng(seed, 4)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class Order:
    """The catalog index of each call: the catalog in a seeded order, again
    and again, each pass its own order."""

    def __init__(self, catalog: int, seed: int):
        self.catalog, self.rng, self.queue = catalog, generate.rng(seed, 1), []

    def next(self) -> int:
        if not self.queue:
            self.queue = list(self.rng.permutation(self.catalog))
        return int(self.queue.pop(0))


def mark(on: bool, name: str):
    """A ``record_function`` range for the traced window; nothing otherwise."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def worst(values) -> float:
    v = [float(x) for x in values]
    return max(v) if v else float("nan")


def rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """max|got - ref| / max|ref| (inf where got is not finite)."""
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
