"""Sets of runs of one cell, to read how widely its metrics spread:

    python3 -m portbench.sets --workload <name> --seeds <a,b,...> --sets 2 \\
        --seconds <s> [--trace-seeds <x,y,...>] --out <dir>

Runs ``python3 -m portbench`` once per seed in each set (a new process each,
one after another, the same seeds in every set), then once per traced
seed with ``--trace 1``. Every run's last line goes to
``<dir>/<workload>.jsonl``; printed: each metric's median and spread (the
distance between the quartiles over the median) per set, and every run's
``correct``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from .stats import spread


def _run(workload, seed, seconds, trace, log):
    cmd = [sys.executable, "-m", "portbench", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t
    log.write(f"== {' '.join(cmd[1:])} rc {p.returncode} wall {wall:.1f} s\n{p.stderr}\n")
    try:
        line = json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        line = None
    return {"seed": seed, "trace": trace, "rc": p.returncode, "wall_s": wall, "result": line}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.sets", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    with open(out / f"{args.workload}.log", "a") as log, \
            open(out / f"{args.workload}.jsonl", "a") as jl:
        plan = [(k, s, 0) for k in range(args.sets) for s in seeds]
        plan += [(-1, int(s), 1) for s in args.trace_seeds.split(",") if s]
        for k, s, trace in plan:
            r = dict(_run(args.workload, s, args.seconds, trace, log), set=k)
            jl.write(json.dumps(r) + "\n")
            jl.flush()
            runs.append(r)
            res = r["result"] or {}
            print(f"set {k} seed {s} trace {trace} rc {r['rc']} wall {r['wall_s']:.1f} s "
                  f"correct {res.get('correct')} "
                  + " ".join(f"{m}={v['value']!r}" for m, v in res.get("metrics", {}).items())
                  + " | " + " ".join(f"{c}={v['value']!r}" for c, v in res.get("check", {}).items()),
                  flush=True)
    for k in range(args.sets):
        vals: dict[str, list[float]] = {}
        for r in runs:
            if r["set"] == k and r["result"]:
                for m, v in r["result"]["metrics"].items():
                    vals.setdefault(m, []).append(v["value"])
        for m, v in sorted(vals.items()):
            if len(v) >= 2:
                print(f"set {k} {m}: median {statistics.median(v)!r} spread {spread(v)!r} "
                      f"over {len(v)} runs", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
