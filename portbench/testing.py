"""Small versions of the cells for the CPU tests: the same configurations,
traffic and limits files with the data and the batches cut so that one run
takes seconds on the CPU. The program then runs its kernels' plain
versions."""

from __future__ import annotations

import json
from pathlib import Path

from .cell import BENCH_DIR, load_cell, load_manifest, run_cell

__all__ = ["SMALL", "REPO", "small_cell", "run_small"]

REPO = BENCH_DIR.parent
#: overrides by configuration: rows, cells, batches (where the traffic has
#: them) and the check's sample
SMALL = {
    "ivfpq-1m128d": {"configs": {"data": {"n": 20_000}, "index": {"kwargs": {"nlist": 64}}},
                     "traffic": {"batch": 200, "pool": 2_000}, "limits": {"sample": 256}},
    "knngraph-1m32d": {"configs": {"data": {"n": 3_000}},
                       "traffic": {"batch": 200, "pool": 2_000}, "limits": {"sample": 256}},
}


def small_cell(name: str, root: Path = REPO, bench_dir: Path = BENCH_DIR, overrides=None):
    """The workload ``name`` of ``root``'s manifest at its small size."""
    manifest = load_manifest(root)
    w = {w["name"]: w for w in manifest["workloads"]}[name]
    over = dict(overrides or SMALL[w["config"]])
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    over["traffic"] = {k: v for k, v in over.get("traffic", {}).items() if k in traffic}
    return load_cell(manifest, name, bench_dir, over)


def run_small(name: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False,
              **kw) -> dict:
    """One CPU run of the small ``name`` (no card is looked for)."""
    return run_cell(small_cell(name), seed, seconds, trace, device="cpu",
                    log=lambda msg: None, **kw)
