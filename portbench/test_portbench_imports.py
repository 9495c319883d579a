"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names; the reference loads nothing of the
program either (CPU)."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.testing import REPO

_PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
HARNESS = """
import annsearch_tpu_torch
import portbench, portbench.cell, portbench.run, portbench.check, portbench.data
import portbench.roofline, portbench.stats, portbench.trace, portbench.testing
from portbench.cell import BENCH_DIR, load_reader
for p in sorted((BENCH_DIR / "metrics").glob("*.py")):
    load_reader(p.stem)
"""
REFERENCE = "import portbench.reference, portbench.reference.exact"


def _top_level_modules(imports: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", _PROBE.format(imports=imports)], cwd=REPO,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _top_level_modules(HARNESS)
    assert "annsearch_tpu_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "annsearch_tpu"}


def test_reference_loads_neither_jax_nor_the_program():
    mods = _top_level_modules(REFERENCE)
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "annsearch_tpu", "annsearch_tpu_torch"}


def test_the_names_are_compared_whole():
    from portbench.cell import FORBIDDEN, forbidden_modules

    assert "annsearch_tpu_torch" not in FORBIDDEN
    sys.modules["annsearch_tpu.fake_for_test"] = sys.modules["json"]
    try:
        assert forbidden_modules() == ["annsearch_tpu.fake_for_test"]
    finally:
        del sys.modules["annsearch_tpu.fake_for_test"]
