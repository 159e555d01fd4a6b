"""Readings that the correctness limits are set from: the program against
the reference (the lower readings) and the control, the reference
computed in TF32 and put in the program's place, against the reference
(the upper readings), seed by seed in one process.

    python3 -m ocm_bench.control --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 1.5]

Each seed's program reading drives the cell's own set-up and a short
window of ``--seconds`` at the cell's size (each frame of the pool is
answered at least once), then the cell's comparison.  Prints one JSON
line a seed and a summary line: per number the largest program reading,
the smallest control reading and the limit in ``cells/<workload>.json``.
A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import sys


def _ints(text: str) -> list:
    return [int(v) for v in text.split(",") if v]


def readings(cell: dict, seed: int, seconds: float, device: str = "cuda",
             control: bool = False) -> dict:
    """The cell's numbers for one seed: the program's, or with
    ``control`` the TF32 reference's in the program's place."""
    import torch

    drv = importlib.import_module(
        f"ocm_bench.drivers.{cell['traffic']['kind']}")
    ctx = {"cfg": cell["cfg"], "traffic": cell["traffic"], "seed": seed,
           "device": device, "mark": lambda name: None,
           "limits": cell["limits"]}
    state = drv.setup(ctx)
    record = drv.window(ctx, state, seconds)
    kept = drv.release(state)
    del state
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return drv.check(ctx, kept, record, tf32=control)


def main(argv=None) -> int:
    from ocm_bench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=1.5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(run.HOST_THREADS)
    cell = run.load_cell(args.workload)
    lower, upper = {}, {}
    for seed, control in ([(s, False) for s in args.seeds]
                          + [(s, True) for s in args.control_seeds]):
        numbers = readings(cell, seed, args.seconds, control=control)
        side = upper if control else lower
        for k, v in numbers.items():
            side.setdefault(k, []).append(v)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control" if control else "program",
                          "numbers": numbers}), flush=True)
    summary = {k: {"lower": max(lower.get(k, [0.0])),
                   "upper": min(upper.get(k, [math.inf])),
                   "limit": cell["limits"][k]}
               for k in cell["limits"]}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
