"""A run with the timed path broken underneath comes out not correct: the
facade's functions are wrapped so that an answer is altered where it is
produced, half of each batch is left out, a build that holds a kNN graph
returns it unchanged from its random start, or a build is handed the rows
in another order, so that every id it returns names the wrong row (CPU,
small sizes; no card is looked for)."""

from __future__ import annotations

import pytest
import torch

import annsearch_tpu_torch as at
from portbench.cell import load_cell, load_manifest
from portbench.testing import REPO, run_small


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


def _permuted_build(fn):
    """The build is handed the rows in a seeded permuted order."""
    def faulty(x, *a, **kw):
        perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(0))
        return fn(x[perm.to(x.device)], *a, **kw)
    return faulty


def _holds_knn_graph(cfg) -> bool:
    """Whether the configuration's build returns an index that holds
    ``knn_ids``: read from an index built of 64 random rows."""
    build = getattr(at, cfg["index"]["build"])
    x = torch.randn(64, cfg["data"]["dim"], generator=torch.Generator().manual_seed(0))
    return hasattr(build(x, **cfg["index"].get("kwargs", {}), device="cpu"), "knn_ids")


def _cases():
    out = []
    manifest = load_manifest(REPO)
    for w in manifest["workloads"]:
        cell = load_cell(manifest, w["name"])
        pattern = cell.traffic["pattern"]
        answer_fn = cell.cfg["query" if pattern == "query" else "self_query"]["fn"]
        for fault in ("altered", "half"):
            out.append((w["name"], answer_fn, fault))
        if pattern == "build":
            build_fn = cell.cfg["index"]["build"]
            out.append((w["name"], build_fn, "permuted"))
            if _holds_knn_graph(cell.cfg):
                out.append((w["name"], build_fn, "unchanged"))
    return out


@pytest.mark.parametrize("workload,fn,fault", _cases())
def test_a_broken_path_is_not_correct(monkeypatch, workload, fn, fault):
    orig = getattr(at, fn)
    if fault == "unchanged":
        monkeypatch.setattr(at, fn, _unchanged_build(orig))
    elif fault == "permuted":
        monkeypatch.setattr(at, fn, _permuted_build(orig))
    else:
        monkeypatch.setattr(at, fn, _wrap_answers(
            orig, {"altered": _altered, "half": _half_left_out}[fault]))
    r = run_small(workload)
    assert not r["correct"], r["check"]
