"""Readings that the limits of ``portbench/limits/<cell>.json`` are set
from: the program's numbers on many seeds, and the control's.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... \\
        --control-seeds 21 22 23

For each of ``--seeds`` it makes the cell's pool of inputs at the cell's
own size, runs the program once on each (after one warm-up call), and
compares with the reference (``run.judge``).  For each of
``--control-seeds`` it puts the control in the program's place: the
reference computed a step below the configuration's precision (float32
with every DFT input rounded to TF32, and the TX output too) and compares
it the same way.  One JSON line per seed and side, with the numbers and
whether the cell's limits pass them; the control has to fail.  Needs a
CUDA card.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import generate, program, spec  # noqa: E402
from portbench.run import judge, phy_of  # noqa: E402


def readings(cell, seed: int, device, control: bool) -> dict:
    phy = phy_of(cell)
    pool = [generate.build(cell.kind, cell.mix, phy, seed, i, device)
            for i in range(cell.mix["pool"])]
    if control:
        kept = [(i, cell.kind.reference(cell.mix, phy, inp, "tf32"))
                for i, inp in enumerate(pool)]
    else:
        entry = program.entry(cell, phy)
        entry(pool[0])
        kept = [(i, entry(inp)) for i, inp in enumerate(pool)]
    numbers, failed = judge(cell, phy, pool, kept)
    passes = all(v <= cell.limits[k] for k, v in numbers.items())
    return {"side": "control" if control else "program", "seed": seed,
            "numbers": numbers, "failed": failed, "passes_limits": passes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            out = readings(cell, seed, "cuda", control)
            out["seconds"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
