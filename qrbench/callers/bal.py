"""BAL bundle adjustment (``qrkit_tpu_torch.examples.bal``): one
``fit_bal_device`` a call, from the host problem (start, observations) to
the host holding the fitted parameters.  The scenes come from a catalog
over one visibility pattern (``bal_scene.catalog``), so every call replays
the one captured loop.

The check fits every catalog scene again with the plain reference
(``reference/bal_lm.py``, float64 on the card, from the same start) and
compares what does not depend on the gauge (a similarity transform of the
whole scene leaves the residuals unchanged):

* ``cost_gap``: over every call, |cost − cost_ref| ÷ cost_ref, the
  program's cost worked out again in float64 from its parameters;
* ``proj_gap``: over a seeded sample of calls, the widest gap in pixels
  between the program's and the reference's predicted image points.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import bal_scene
from ..reference import bal_lm
from . import Order, Sample, mark, worst
from .ellipse import Caller as _EllipseCaller


class Caller:
    kind = "fit"

    def __init__(self, config, mix, seed, device):
        self.config, self.device = config, device
        self.pattern, self.scenes = bal_scene.catalog(config, mix)
        self.n_cams, self.n_pts = config["cameras"], config["points"]
        self.order = Order(len(self.scenes), seed)
        self.sample = Sample(mix["sample_calls"], seed)
        self.tracing = False
        self.setup_program()

    def setup_program(self) -> None:
        from qrkit_tpu_torch.examples import bal
        from qrkit_tpu_torch.lm import LMConfig

        self.bal, self.lm = bal, LMConfig(**self.config["lm"])

    def _fit(self, j: int):
        """(x ``[3P + 9C]``, iterations, converged)."""
        s, p = self.scenes[j], self.pattern
        res = self.bal.fit_bal_device(s.cams0, s.pts0, p.obs_cam, p.obs_pt, s.uv, self.lm,
                                      device=self.device, dtype=torch.float32)
        return np.asarray(res.x), res.iterations, res.converged

    def warm(self) -> None:
        """The first fit builds the bucket plan and captures the loop; then
        one pass over the catalog."""
        for j in [0] + list(range(len(self.scenes))):
            self._fit(j)

    def call(self, name: str = "qrbench.call") -> dict:
        j = self.order.next()
        with mark(self.tracing, name):
            t0 = time.perf_counter()
            x, iters, conv = self._fit(j)
            t1 = time.perf_counter()
        self.sample.offer((j, x))
        return {"start": t0, "end": t1, "item": j, "problems": 1, "converged": int(conv),
                "iterations": [iters], "loop_iters": iters, "x": x}

    loop_census = _EllipseCaller.loop_census

    def tsqr_shape(self):
        """(rows, columns, shards) of the step's TSQR: the bottom's 2·N + 9C
        rows, the 9C camera columns, one shard."""
        m2 = bal_scene.CAMERA * self.n_cams
        return 2 * len(self.pattern.obs_cam) + m2, m2, 1

    def release(self) -> None:
        from qrkit_tpu_torch import lm

        lm.clear_programs()
        getattr(self.bal, "_PLANS", []).clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, items, precision="float64"):
        """{catalog index: reference x ``[3P + 9C]``}."""
        s = bal_lm.LMSettings(**self.config["lm"])
        p = self.pattern
        return {j: bal_lm.fit(self.scenes[j].cams0, self.scenes[j].pts0, p.obs_cam, p.obs_pt,
                              self.scenes[j].uv, s, precision, self.device)[0]
                for j in sorted(set(items))}

    def checks(self, records) -> dict:
        ref = self.reference([r["item"] for r in records] + [j for j, _ in self.sample.items])
        p, lim, dev = self.pattern, self.config["limits"], self.device
        cost = lambda x, j: bal_lm.cost64(x, p.obs_cam, p.obs_pt, self.scenes[j].uv,  # noqa: E731
                                          self.n_cams, dev)
        ref_cost = {j: cost(x, j) for j, x in ref.items()}
        gaps = [abs(cost(r["x"], r["item"]) - ref_cost[r["item"]]) / ref_cost[r["item"]]
                if np.all(np.isfinite(r["x"])) else float("inf") for r in records]
        image = lambda x: bal_lm.image_points(x, p.obs_cam, p.obs_pt, self.n_cams, dev)  # noqa: E731
        proj = [float(np.linalg.norm(image(x) - image(ref[j]), axis=1).max())
                if np.all(np.isfinite(x)) else float("inf") for j, x in self.sample.items]
        return {"cost_gap": (worst(gaps), lim["cost_gap"]),
                "proj_gap": (worst(proj), lim["proj_gap"])}


class Control(Caller):
    """The control: the reference in bfloat16 in the program's place."""

    def setup_program(self) -> None:
        self.settings = bal_lm.LMSettings(**self.config["lm"])

    def _fit(self, j: int):
        s, p = self.scenes[j], self.pattern
        x, iters, conv, _ = bal_lm.fit(s.cams0, s.pts0, p.obs_cam, p.obs_pt, s.uv,
                                       self.settings, "bfloat16", self.device)
        return x, iters, conv

    def release(self) -> None:
        pass
