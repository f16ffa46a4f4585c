"""LM ellipse fits (``qrkit_tpu_torch.examples.ellipse``): the mix's
``entry`` is ``fit_ellipse`` (one problem a call, the device loop) or
``fit_ellipse_batch`` (``problems_per_call`` problems a call).  A call runs
from the host points to the host holding the canonical parameters.

The check fits every catalog problem again with the plain reference
(``reference/ellipse_lm.py``, float64 on the card) and compares:

* ``param_gap``: over every problem of every call, the widest gap of the
  five ellipse parameters, relative to max(1, |reference|);
* ``latent_gap``: over a seeded sample of calls, the widest gap of a
  point's latent angle (radians).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import generate
from ..reference import ellipse_lm
from . import Order, Sample, mark, worst


class Caller:
    kind = "fit"

    def __init__(self, config, mix, seed, device):
        self.config, self.device = config, device
        _, self.pts = generate.ellipse_catalog(config, mix)
        self.n, self.per = mix["points"], mix["problems_per_call"]
        self.entry = mix["entry"]
        if self.entry not in ("fit_ellipse", "fit_ellipse_batch"):
            raise ValueError(f"ellipse caller: unknown entry {self.entry!r}")
        self.order = Order(len(self.pts), seed)
        self.sample = Sample(mix["sample_calls"], seed)
        self.tracing = False
        self.setup_program()

    def setup_program(self) -> None:
        from qrkit_tpu_torch.examples import ellipse
        from qrkit_tpu_torch.lm import LMConfig

        self.ellipse, self.lm = ellipse, LMConfig(**self.config["lm"])

    def _fit(self, j: int):
        """(x canonical [per, n + 5], iterations [per], converged [per])."""
        e = self.ellipse
        if self.entry == "fit_ellipse":
            res, params = e.fit_ellipse(self.pts[j], self.lm, dtype=torch.float32, loop="device",
                                        device=self.device)
            return params[None], np.array([res.iterations]), np.array([res.converged])
        res = e.fit_ellipse_batch(self.pts[j], self.lm, dtype=torch.float32, device=self.device)
        params = np.stack([e.canonicalize_ellipse(x, self.n) for x in res.x])
        return params, np.asarray(res.iterations), np.asarray(res.converged)

    def warm(self) -> None:
        """The first fit captures the loop; then one pass over the catalog."""
        for j in [0] + list(range(len(self.pts))):
            self._fit(j)

    def call(self, name: str = "qrbench.call") -> dict:
        j = self.order.next()
        with mark(self.tracing, name):
            t0 = time.perf_counter()
            x, iters, conv = self._fit(j)
            t1 = time.perf_counter()
        self.sample.offer((j, x))
        return {"start": t0, "end": t1, "item": j, "problems": self.per,
                "converged": int(conv.sum()), "iterations": iters.tolist(),
                "loop_iters": int(iters.max()), "model": x[:, self.n:].copy()}

    def loop_census(self):
        """The device operations (kernel, memset and copy nodes) of the
        captured loop body that the calls replay an iteration, read from
        its graph; None where the program holds no one captured loop."""
        from qrkit_tpu_torch import lm

        from .. import graphs

        cache = getattr(getattr(lm, "_LOOPS", None), "_cache", {})
        bodies = [g for prog in cache.values()
                  for g in getattr(getattr(prog, "_loop", None), "graphs", [])[:1]
                  if isinstance(g, torch.cuda.CUDAGraph)]
        if len(bodies) != 1:
            return None
        types = graphs.node_types(bodies[0].raw_cuda_graph())
        return sum(types[t] for t in graphs.DEVICE)

    def release(self) -> None:
        from qrkit_tpu_torch import lm

        lm.clear_programs()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, items, precision="float64"):
        """{catalog index: canonical reference x [per, n + 5]}."""
        s = ellipse_lm.LMSettings(**self.config["lm"])
        out = {}
        for j in sorted(set(items)):
            pts = self.pts[j] if self.per > 1 else self.pts[j][None]
            out[j] = np.stack([ellipse_lm.fit(p, s, precision, self.device)[0] for p in pts])
        return out

    def checks(self, records) -> dict:
        ref = self.reference([r["item"] for r in records] + [j for j, _ in self.sample.items])
        n, lim = self.n, self.config["limits"]
        param = []
        for r in records:
            want = ref[r["item"]][:, n:]
            param.append(_param_gap(r["model"], want))
        latent = [float(np.abs(x[:, :n] - ref[j][:, :n]).max()) if np.all(np.isfinite(x))
                  else float("inf") for j, x in self.sample.items]
        return {"param_gap": (worst(param), lim["param_gap"]),
                "latent_gap": (worst(latent), lim["latent_gap"])}

    def k3_cost(self):
        from ..roofline import k3

        return k3.cost(self.n, self.per)


def _param_gap(got: np.ndarray, want: np.ndarray) -> float:
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


class Control(Caller):
    """The control: the reference in bfloat16 in the program's place."""

    def setup_program(self) -> None:
        self.settings = ellipse_lm.LMSettings(**self.config["lm"])

    def _fit(self, j: int):
        pts = self.pts[j] if self.per > 1 else self.pts[j][None]
        fits = [ellipse_lm.fit(p, self.settings, "bfloat16", self.device) for p in pts]
        return (np.stack([f[0] for f in fits]), np.array([f[1] for f in fits]),
                np.array([f[2] for f in fits]))

    def release(self) -> None:
        pass
