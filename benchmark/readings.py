"""The readings that the limits of ``correct`` are set from, for many
seeds in one process: the program's (the lower readings) or, with
``--control``, the control's (the upper readings: the reference computed
in fp8 in the program's place).  The benchmark's own runs never run the
control.

    python3 benchmark/readings.py --workload <name> --seconds <s> \
        --seeds 1,2,3 [--control]

Prints one JSON line a seed: {"seed", "control", "correct", "checks"}.
"""

from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run.main(["--workload", args.workload, "--seed", str(seed),
                         "--seconds", str(args.seconds), "--trace", "0"],
                        control=args.control)
        if line is None:
            return 2
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": line["correct"],
                          "checks": line["checks"],
                          "info": line.get("info", {}),
                          "metrics": line["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
