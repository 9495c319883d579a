"""The comparison passes the program and fails the control: the plain
reference in the program's place at the next lower precision (TF32 for the
float32 graph, int4 rows for the int8 IVF-PQ codes), on the same sampled
queries, at a size a CPU test holds. On the card, ``python3 -m
portbench.readings`` reads both at the cells' own sizes."""

from __future__ import annotations

import pytest

from portbench import check
from portbench.testing import REPO, run_small, small_cell
from portbench.cell import load_manifest

CELLS = [w["name"] for w in load_manifest(REPO)["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload):
    r = run_small(workload, control=True)
    assert r["correct"], r["check"]
    limits = small_cell(workload).limits["limits"]
    ok, out = check.judge(r["control"], limits)
    assert not ok, out
