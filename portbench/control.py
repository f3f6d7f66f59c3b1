"""Run a cell with its control in the program's place.

  python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 3

The control is the configuration's reference computed in the precision
below the one it states (`control_entry` of reference/<config>.py). Its
runs have to come out not correct: the readings of each seed's compared
numbers, printed here, are the upper ends the limits were set below.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness


def control_entry(cell) -> str:
    return f"portbench.reference.{cell.config['name']}:control_entry"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = harness.resolve(harness.load_spec(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False,
                               entry=control_entry(cell))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": out.correct, "attempted": out.attempted,
                          "failed": out.failed, "checks": out.checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
