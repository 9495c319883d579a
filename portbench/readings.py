"""The readings that the check's limits are set from:

    python3 -m portbench.readings --workload <name> --seeds <a,b,...> [--seconds 3]

For each seed, in this one process, a run of the cell with a short window
at the cell's own load, the check's numbers of the program, and beside
them those of the control: the plain reference in the program's place at
the next lower precision, on the same sampled queries. Prints a JSON line
a seed, then a summary line: each number's largest program reading (the
lower reading) and smallest control reading (the upper one).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .cell import load_cell, load_manifest, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.readings", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = load_cell(load_manifest(Path.cwd()), args.workload)
    prog: dict[str, list[float]] = {}
    ctrl: dict[str, list[float]] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(cell, seed, args.seconds, False, control=True)
        line = {"workload": cell.name, "seed": seed, "correct": r["correct"],
                "program": r.get("numbers"), "control": r.get("control")}
        print(json.dumps(line), flush=True)
        for name, v in (r.get("numbers") or {}).items():
            prog.setdefault(name, []).append(v)
        for name, v in (r.get("control") or {}).items():
            if name != "precision":
                ctrl.setdefault(name, []).append(v)
    print(json.dumps({"workload": cell.name, "seeds": len(args.seeds.split(",")),
                      "lower": {k: max(v) for k, v in prog.items()},
                      "upper": {k: min(v) for k, v in ctrl.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
