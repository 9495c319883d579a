"""Small versions of the cells for the CPU tests: the same configurations,
traffic and limits files with the data and the batches cut so that one run
takes seconds on the CPU. The program then runs its kernels' plain
versions.

A configuration's cut is the file ``small/<config>.json``, found by name:
overrides of its configuration, traffic (where the traffic has the key)
and limits files, ``{"configs": ..., "traffic": ..., "limits": ...}``."""

from __future__ import annotations

import json
from pathlib import Path

from .cell import BENCH_DIR, load_cell, load_manifest, run_cell

__all__ = ["REPO", "small_cell", "run_small"]

REPO = BENCH_DIR.parent


def small_cell(name: str, root: Path = REPO, bench_dir: Path = BENCH_DIR):
    """The workload ``name`` of ``root``'s manifest at its small size."""
    manifest = load_manifest(root)
    w = {w["name"]: w for w in manifest["workloads"]}[name]
    path = bench_dir / "small" / f"{w['config']}.json"
    if not path.exists():
        raise FileNotFoundError(f"configuration {w['config']!r} has no CPU size: add {path} "
                                "(overrides of its configs, traffic and limits files)")
    over = json.loads(path.read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    over["traffic"] = {k: v for k, v in over.get("traffic", {}).items() if k in traffic}
    return load_cell(manifest, name, bench_dir, over)


def run_small(name: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False,
              **kw) -> dict:
    """One CPU run of the small ``name`` (no card is looked for)."""
    return run_cell(small_cell(name), seed, seconds, trace, device="cpu",
                    log=lambda msg: None, **kw)
