"""Read a cell's correctness numbers over many seeds in one process: the
program's (``--side program``) or the control's (``--side control``: the
plain reference one precision step below the configuration's, in the
program's place)::

    python3 -m qrbench.control --workload <name> --side control --seeds 1 2 3 --calls 16

Each seed makes the cell's inputs as a run does, makes ``--calls`` calls
of its entry (untimed) and prints one JSON line: the seed, each compared
number with its limit, and whether all are within.  The limits of the
configuration files were set from these readings (``PERF.md``).  No
benchmark run calls this module.
"""
from __future__ import annotations

import argparse
import json
import sys


def readings(workload: str, side: str, seed: int, calls: int, device="cuda",
             config=None, mix=None, bench=None) -> dict:
    from . import registry

    bench = bench or registry.benchmark()
    _, config_file, mix_file = registry.cell(bench, workload)
    config, mix = config or config_file, mix or mix_file
    mod = registry.module("callers", mix["caller"])
    caller = (mod.Control if side == "control" else mod.Caller)(config, mix, seed, device)
    caller.warm()
    records = [caller.call() for _ in range(calls)]
    caller.release()
    checks = caller.checks(records)
    return {"workload": workload, "side": side, "seed": seed, "calls": calls,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
            "within": all(v <= lim for v, lim in checks.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", choices=("program", "control"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=16)
    args = p.parse_args(argv)
    from . import registry
    from .run import steady_process

    threads = registry.cell(registry.benchmark(), args.workload)[1].get("host_threads")
    steady_process(threads)
    import torch

    if threads is not None:
        torch.set_num_threads(int(threads))
    if not torch.cuda.is_available():
        print("qrbench.control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, args.side, seed, args.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
