"""Structure-plan persistence (counterpart of ``qrkit_tpu/persist.py``).

The analysis result is a static, hashable
:class:`~qrkit_tpu_torch.plan.StructurePlan`; this module writes it (and the
row and column orderings) as JSON, so a job can skip re-analysis on
restart.  The format is the reference package's (``_VERSION = 1``): a file
written by either package loads in the other.
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from .plan import BlockInfo, StructurePlan
from .sparse import Permutation

__all__ = ["plan_to_json", "plan_from_json", "save_analysis", "load_analysis"]

_VERSION = 1


def plan_to_json(plan: StructurePlan) -> str:
    return json.dumps(
        {
            "version": _VERSION,
            "nrows": plan.nrows,
            "ncols": plan.ncols,
            "nnz_q_estimate": plan.nnz_q_estimate,
            "blocks": [b.astuple() for b in plan.blocks],
        }
    )


def plan_from_json(text: str) -> StructurePlan:
    d = json.loads(text)
    if d.get("version") != _VERSION:
        raise ValueError(f"unsupported plan version {d.get('version')!r}")
    return StructurePlan(
        d["nrows"], d["ncols"], tuple(BlockInfo(*b) for b in d["blocks"]), d["nnz_q_estimate"]
    )


def save_analysis(
    path: str, plan: StructurePlan, row_perm: Optional[Permutation] = None,
    col_perm: Optional[Permutation] = None,
):
    d = json.loads(plan_to_json(plan))
    if row_perm is not None:
        d["row_perm"] = row_perm.indices.tolist()
    if col_perm is not None:
        d["col_perm"] = col_perm.indices.tolist()
    with open(path, "w") as f:
        json.dump(d, f)


def load_analysis(path: str) -> Tuple[StructurePlan, Optional[Permutation], Optional[Permutation]]:
    with open(path) as f:
        d = json.load(f)
    plan = plan_from_json(json.dumps(d))
    rp = Permutation(np.asarray(d["row_perm"])) if "row_perm" in d else None
    cp = Permutation(np.asarray(d["col_perm"])) if "col_perm" in d else None
    return plan, rp, cp
