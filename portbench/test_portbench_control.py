"""The comparison passes the program and fails the control: the plain
reference in the program's place at the next lower precision (TF32 for the
float32 graph, int4 rows for the int8 IVF-PQ codes), on the same sampled
queries, at a size a CPU test holds. On the card, ``python3 -m
portbench.readings`` reads both at the cells' own sizes.

Under ``"euclidean"`` the numbers are those of the arithmetic the limits
were set from: the squared distances as the reference formed them before
it read the configuration's metric, held here bit for bit."""

from __future__ import annotations

import pytest
import torch

from portbench import check, stats
from portbench.testing import REPO, run_small, small_cell
from portbench.cell import load_manifest
from portbench.reference import LOWER_PRECISION
from portbench.reference.exact import int4_rows, round_tf32

CELLS = [w["name"] for w in load_manifest(REPO)["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload):
    r = run_small(workload, control=True)
    assert r["correct"], r["check"]
    limits = small_cell(workload).limits["limits"]
    ok, out = check.judge(r["control"], limits)
    assert not ok, out


def _euclidean_numbers(q, x, ids, dists, exclude):
    """``check.compare``'s numbers by the squared-distance formulas alone
    (one block of queries, as the small cells' samples are)."""
    x64, q64 = x.double(), q.double()
    d = (q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :] - 2.0 * (q64 @ x64.T)
    if exclude is not None:
        d.scatter_(1, exclude[:, None].long(), float("inf"))
    t_d, t_ids = torch.topk(d, ids.shape[1], dim=1, largest=False, sorted=True)
    diff = x[ids.long().clamp(0, x.shape[0] - 1)].double() - q64[:, None, :]
    d_of = (diff * diff).sum(-1)
    scale = t_d[:, -1:].clamp_min(1e-30)
    return {
        "miss": 1.0 - stats.recall(t_ids, ids),
        "dist_err": float(((dists.double() - d_of).abs() / scale).max()),
        "gap": float(((d_of - t_d) / scale).max()),
        "bad": float(check._bad_rows(ids, dists, x.shape[0], exclude)),
    }


def _euclidean_control(q, x, k, precision, exclude):
    xs = round_tf32(x) if precision == "tf32" else int4_rows(x.float())
    xn = ((x if precision == "tf32" else xs).float() ** 2).sum(1)
    qb = q.float()
    qs = round_tf32(qb) if precision == "tf32" else qb
    d = (qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * (qs @ xs.T)
    if exclude is not None:
        d.scatter_(1, exclude[:, None].long(), float("inf"))
    v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return i, v


@pytest.mark.parametrize("workload", CELLS)
def test_euclidean_numbers_are_kept_bit_for_bit(workload, monkeypatch):
    seen, real = [], check.compare

    def spy(q, x, ids, dists, exclude=None, metric="euclidean"):
        seen.append((q, x, ids, dists, exclude, metric))
        return real(q, x, ids, dists, exclude, metric)

    monkeypatch.setattr(check, "compare", spy)
    r = run_small(workload, control=True)
    q, x, ids, dists, exclude, metric = seen[0]
    assert metric == "euclidean" and r["numbers"] == _euclidean_numbers(q, x, ids, dists,
                                                                        exclude)
    prec = LOWER_PRECISION[small_cell(workload).cfg["precision"]]
    c_ids, c_d = _euclidean_control(q, x, ids.shape[1], prec, exclude)
    assert r["control"] == dict(_euclidean_numbers(q, x, c_ids, c_d, exclude), precision=prec)
