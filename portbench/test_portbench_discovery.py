"""The harness finds a configuration, a traffic mix, a limits file, a CPU
size and a metric that are new files, with no edit to a file that is there,
and judges a cosine configuration in cosine distance (CPU); and on a card
every cell of the manifest reports every metric it lists."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import check
from portbench.cell import load_cell, load_manifest, run_cell
from portbench.testing import REPO, small_cell

NEW_METRIC = '''"""calls_in_window: calls completed in the window (a test's metric)."""


def start(ctx):
    ctx.cache["started"] = True


def read(ctx):
    return float(ctx.calls) if ctx.cache.get("started") else None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    return bench


def test_new_files_are_found_by_name(tmp_path):
    bench = _copy(tmp_path)
    before = _digests(bench)
    cfg = json.loads((bench / "configs" / "knngraph-1m32d.json").read_text())
    cfg.update(name="tiny32", data=dict(cfg["data"], n=2_000))
    (bench / "configs" / "tiny32.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "q64.json").write_text(json.dumps(
        {"pattern": "query", "batch": 64, "pool": 640}))
    (bench / "limits" / "tiny32.q64.json").write_text(json.dumps(
        {"sample": 128, "limits": {"miss": 0.01, "bad": 0}}))
    (bench / "metrics" / "calls_in_window.py").write_text(NEW_METRIC)
    manifest = load_manifest(REPO)
    manifest["configs"].append({"name": "tiny32", "source": "a test",
                                "file": "portbench/configs/tiny32.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "tiny32.q64", "config": "tiny32", "traffic": "q64",
                                  "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                                  "source": "program_counter", "layer": "test", "moves": "qps",
                                  "workloads": ["tiny32.q64"]})
    manifest["end_to_end"][0]["workloads"].append("tiny32.q64")      # qps
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    for p, d in before.items():
        assert _digests(bench)[p] == d, f"{p} changed"

    cell = load_cell(load_manifest(tmp_path), "tiny32.q64", bench)
    assert cell.cfg["data"]["n"] == 2_000 and cell.traffic["batch"] == 64
    assert [m["name"] for m in cell.per_layer] == ["calls_in_window"]
    assert {m["name"] for m in cell.end_to_end} == {"qps", "index_bytes_per_vec", "setup_s"}
    r = run_cell(cell, 5, 0.5, False, device="cpu", log=lambda m: None)
    assert set(r["metrics"]) == {"qps", "index_bytes_per_vec", "setup_s"} and r["correct"]
    r = run_cell(cell, 5, 0.5, True, device="cpu", log=lambda m: None)
    assert r["metrics"]["calls_in_window"]["value"] >= 1 and r["correct"]
    assert list(r)[-1] == "check"


#: a cosine HNSW configuration in NYTimes-256-angular's shape, cut to a CPU
#: size by its own ``small/`` file
COSINE_CFG = {
    "name": "tinycos", "source": "a test",
    "data": {"generator": "clusters", "n": 290_000, "dim": 256, "n_clusters": 100,
             "structure_seed": 42},
    "queries": {"noise_std": 0.05}, "metric": "cosine", "k": 10, "precision": "float32",
    "index": {"build": "build_hnsw_index",
              "kwargs": {"dist_metric": "cosine", "m": 16, "ef_construction": 100}},
    "query": {"fn": "query_hnsw_index", "kwargs": {"ef_search": 64}},
    "self_query": {"fn": "query_hnsw_self", "kwargs": {}, "includes_self": True},
}


def test_a_cosine_configuration_is_new_files_alone(tmp_path):
    bench = _copy(tmp_path)
    before = _digests(bench)
    (bench / "configs" / "tinycos.json").write_text(json.dumps(COSINE_CFG))
    (bench / "small" / "tinycos.json").write_text(json.dumps(
        {"configs": {"data": {"n": 2_000}}, "traffic": {"batch": 64, "pool": 640},
         "limits": {"sample": 128}}))
    (bench / "traffic" / "q60k.json").write_text(json.dumps(
        {"pattern": "query", "batch": 60_000, "pool": 240_000}))
    limits = {"miss": 0.02, "dist_err": 5e-4, "bad": 0}
    for cell in ("tinycos.q60k", "tinycos.build"):
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(
            {"sample": 4_096, "limits": limits}))
    manifest = load_manifest(REPO)
    manifest["configs"].append({"name": "tinycos", "source": "a test",
                                "file": "portbench/configs/tinycos.json", "reduced": [],
                                "why": "a test"})
    for traffic in ("q60k", "build"):
        manifest["workloads"].append({"name": f"tinycos.{traffic}", "config": "tinycos",
                                      "traffic": traffic, "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] in ("qps", "build_rows_per_s"):
            m["workloads"].append("tinycos.q60k" if m["name"] == "qps" else "tinycos.build")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    for p, d in before.items():
        assert _digests(bench)[p] == d, f"{p} changed"

    for name in ("tinycos.q60k", "tinycos.build"):
        cell = small_cell(name, tmp_path, bench)
        assert cell.cfg["metric"] == "cosine" and cell.cfg["data"]["n"] == 2_000
        r = run_cell(cell, 2**31 + 21, 0.5, False, device="cpu", control=True,
                     log=lambda m: None)
        assert r["correct"], r["check"]
        # the exact fallback answers: under squared euclidean the distances
        # of the rows named would be off by orders of magnitude
        assert r["numbers"]["miss"] == 0.0 and r["numbers"]["dist_err"] < 2e-4
        ok, out = check.judge(r["control"], limits)
        assert not ok and r["control"]["precision"] == "tf32", out


def test_a_configuration_without_a_cpu_size_names_the_file(tmp_path):
    bench = _copy(tmp_path)
    (bench / "small" / "knngraph-1m32d.json").unlink()
    with pytest.raises(FileNotFoundError, match="small/knngraph-1m32d.json"):
        small_cell("knngraph-1m32d.q10k", REPO, bench)


def test_an_unknown_metric_is_refused(tmp_path):
    bench = _copy(tmp_path)
    cfg = json.loads((bench / "configs" / "knngraph-1m32d.json").read_text())
    (bench / "configs" / "knngraph-1m32d.json").write_text(json.dumps(
        dict(cfg, metric="manhattan")))
    with pytest.raises(ValueError, match="manhattan"):
        load_cell(load_manifest(REPO), "knngraph-1m32d.build", bench)


def test_a_traffic_key_the_harness_does_not_read_is_refused(tmp_path):
    bench = _copy(tmp_path)
    (bench / "traffic" / "q10k.json").write_text(json.dumps(
        {"pattern": "query", "batch": 64, "pool": 640, "clients": 4}))
    with pytest.raises(ValueError, match="clients"):
        load_cell(load_manifest(REPO), "ivfpq-1m128d.q10k", bench)


def _expected(manifest, name, trace):
    cell = load_cell(manifest, name)
    return {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in load_manifest(REPO)["workloads"]])
def test_every_cell_reports_its_metrics_on_a_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", workload, "--seed", str(2**31 + 99),
         "--seconds", "3", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=1200, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(r["metrics"]) == _expected(load_manifest(REPO), workload, trace)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
