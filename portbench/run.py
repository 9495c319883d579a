"""The command line of one run: ``python3 -m portbench --workload <name>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout.

Prints the result as one JSON object on the last line of standard output,
and the numbers the check compared, each beside its limit, as the last
lines of standard error. Exits with 2, printing no result, without the
CUDA cards the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

__all__ = ["main"]


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = _args(argv)
    from .cell import NoDevice, load_cell, load_manifest, run_cell

    cell = load_cell(load_manifest(Path.cwd()), args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except (NoDevice, ImportError) as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["check"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
