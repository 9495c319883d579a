"""A run with the timed path broken underneath comes out not correct: the
facade's functions are wrapped so that an answer is altered where it is
produced, half of each batch is left out, or a build returns its state
unchanged (CPU, small sizes; no card is looked for)."""

from __future__ import annotations

import pytest
import torch

import annsearch_tpu_torch as at
from portbench.cell import load_manifest
from portbench.testing import REPO, run_small, small_cell


def _altered(ids, dists):
    ids = ids.clone()
    ids[:, 0] = (ids[:, 0] + 1) % (int(ids.max()) + 1)
    return ids, dists


def _half_left_out(ids, dists):
    ids, dists = ids.clone(), dists.clone()
    h = ids.shape[0] // 2
    ids[h:], dists[h:] = ids[: ids.shape[0] - h], dists[: ids.shape[0] - h]
    return ids, dists


def _wrap_answers(fn, fault):
    def faulty(*a, **kw):
        ids, dists = fn(*a, **kw)
        return fault(ids, dists)
    return faulty


def _unchanged_build(fn):
    """The build returns the graph it starts from: random neighbours."""
    def faulty(x, *a, **kw):
        index = fn(x, *a, **kw)
        g = torch.Generator().manual_seed(0)
        ids = torch.randint(0, index.n, index.knn_ids.shape, generator=g).to(index.knn_ids)
        d = ((x[ids.long()] - x[:, None, :]) ** 2).sum(-1)
        d, order = d.sort(dim=1)
        index.knn_ids, index.knn_dists = torch.gather(ids, 1, order), d
        return index
    return faulty


def _cases():
    out = []
    for w in load_manifest(REPO)["workloads"]:
        cell = small_cell(w["name"])
        pattern = cell.traffic["pattern"]
        answer_fn = cell.cfg["query" if pattern == "query" else "self_query"]["fn"]
        for fault in ("altered", "half"):
            out.append((w["name"], answer_fn, fault))
        if pattern == "build":
            out.append((w["name"], cell.cfg["index"]["build"], "unchanged"))
    return out


@pytest.mark.parametrize("workload,fn,fault", _cases())
def test_a_broken_path_is_not_correct(monkeypatch, workload, fn, fault):
    orig = getattr(at, fn)
    if fault == "unchanged":
        monkeypatch.setattr(at, fn, _unchanged_build(orig))
    else:
        monkeypatch.setattr(at, fn, _wrap_answers(
            orig, {"altered": _altered, "half": _half_left_out}[fault]))
    r = run_small(workload)
    assert not r["correct"], r["check"]
