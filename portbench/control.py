"""The control: the plain reference, weakened, in the port's place.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

runs a cell once per seed with its queries answered by the reference
comparing only the first bytes of each pattern (``reference.truncated``),
and prints each run's compared numbers.  The check has to find every run
not correct: a comparison that passes this control could not tell an
approximate answer from an exact one.  The benchmark's own runs never run
it.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness, manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        line = harness.run(cell, seed, args.seconds, False, entry="control")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "checked_answers": line["checked_answers"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
