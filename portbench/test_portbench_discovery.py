"""The harness finds a configuration, a traffic mix, a limits file and a
metric that are new files, with no edit to a file that is there (CPU); and
on a card every cell of the manifest reports every metric it lists."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.cell import load_cell, load_manifest, run_cell
from portbench.testing import REPO

NEW_METRIC = '''"""calls_in_window: calls completed in the window (a test's metric)."""


def start(ctx):
    ctx.cache["started"] = True


def read(ctx):
    return float(ctx.calls) if ctx.cache.get("started") else None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", bench, ignore=shutil.ignore_patterns("__pycache__"))
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


def test_a_traffic_key_the_harness_does_not_read_is_refused(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", bench, ignore=shutil.ignore_patterns("__pycache__"))
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
