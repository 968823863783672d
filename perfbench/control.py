"""Reads the numbers that set each limit: the program's, the control's
and a planted fault's, one cell at its own size, several seeds in one
process. Not part of a benchmark run.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--fault <name>]

For each seed it runs the cell as a benchmark run does, with a window
of one sample, on the first card, and prints one JSON line: the numbers compared for the
program and, without --fault, for the control (the plain reference one
precision below the configuration's, in the program's place). --fault
plants one of perfbench/faults.py's faults under the program.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import faults, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    a = p.parse_args(argv)
    for seed in a.seeds:
        t = time.perf_counter()
        ctx = faults.FAULTS[a.fault]() if a.fault else contextlib.nullcontext()
        with ctx:
            result, prog, ctrl = run.run_cell(
                os.getcwd(), a.workload, seed, 0.0, False, "cuda:0", t,
                control=a.fault is None)
        line = {"seed": seed, "fault": a.fault, "correct": result["correct"],
                "program": {n: v for n, v, _l in prog}}
        if ctrl is not None:
            line["control"] = {n: v for n, v, _l in ctrl}
            line["control_correct"] = all(v <= lim for _n, v, lim in ctrl)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
