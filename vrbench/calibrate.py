"""The readings that the check's limits are set from, in one process:

    python3 -m vrbench.calibrate --workload <name> --seeds <n,n,...> --seconds <s> [--control <k>]

For each seed a whole run of the cell (set-up, a window of ``--seconds`` at
the cell's own load, the check) prints its readings, the program's, and for
the first ``--control`` seeds also the control's: the reference computed in
bfloat16 in the program's place, compared on the same framebuffer states.
A sound program reads 0 on every number; the control has to read above
the limits (vrbench.check.LIMITS). Not run by the benchmark's own runs.
"""

import argparse
import json
import sys
import time

from .cell import load_cell
from .run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read the program's and the control's numbers.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = run_cell(cell, seed, args.seconds, False, control=k < args.control,
                       t0=time.perf_counter())
        line = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                "program": {k: v["value"] for k, v in res["check"].items()},
                "control": res.get("control"), "attempted": res["attempted"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "device": res["device"]}
        print("CALIBRATE " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
