"""The program's stage spans (``utils/profiling``): off, a stage costs one
flag test and changes nothing; on, the IVF, cluster-scan and fallback paths
record their stages, nesting, call ids and counts, each count held to one
made by hand; under a ``torch.profiler`` the stages are nested
``user_annotation`` events; the device intervals' arithmetic on fake
events; and the benchmark's readers of the spans on a hand-made snapshot
(CPU)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from annsearch_tpu_torch.models import ivf_base
from annsearch_tpu_torch.models.kmeans import expand_probes_to_segments
from annsearch_tpu_torch.models.quantised.ivf import IvfPqIndex
from annsearch_tpu_torch.ops.ivf_scan import build_probe_lists_from_pairs
from annsearch_tpu_torch.ops.probe_device import device_probe_shapes
from annsearch_tpu_torch.ops.topk import blocked_query_topk
from annsearch_tpu_torch.utils import profiling
from annsearch_tpu_torch.utils.dist import Dist


@pytest.fixture(autouse=True)
def _clean():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _clusters(n, d, seed, sizes=None):
    """Gaussian clusters; ``sizes`` skews them so that some cells split."""
    g = np.random.default_rng(seed)
    sizes = sizes or [n // 8] * 8
    cents = g.uniform(-4, 4, (len(sizes), d))
    x = np.concatenate([c + 0.4 * g.standard_normal((s, d)) for c, s in zip(cents, sizes)])
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def pq_index():
    """An IVF-PQ index whose approximate tier is the fused scan (m = dim,
    segments of 256 rows)."""
    x = _clusters(4000, 32, 0)
    return IvfPqIndex(x, "euclidean", nlist=16, m=32, max_iters=5, device="cpu"), x


@pytest.fixture(scope="module")
def split_index():
    """An IVF-PQ index with cells split into several 128-row segments."""
    x = _clusters(3000, 32, 1, sizes=[1500, 600, 300, 300, 150, 150])
    return IvfPqIndex(x, "euclidean", nlist=8, m=32, max_iters=5, seg_size=128,
                      device="cpu"), x


def _raise(*a, **k):
    raise AssertionError("called while tracing is off")


def test_tracing_off_is_one_flag_test_and_changes_nothing(pq_index, split_index, monkeypatch):
    idx, x = pq_index
    sidx, sx = split_index
    q, sq = torch.as_tensor(x[:300]), torch.as_tensor(sx[:200])
    calls = [lambda: idx.query(q, 10, nprobe=4, approx=True),
             lambda: sidx.query(sq, 10, nprobe=3),
             lambda: blocked_query_topk(q, torch.as_tensor(x), 5, Dist.EUCLIDEAN)]
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _raise)
        m.setattr(torch.cuda, "Event", _raise)
        m.setattr(ivf_base, "_lane_counts", _raise)
        assert profiling.stage("ivf.query", q) is profiling._OFF
        off = [c() for c in calls]
        assert profiling.snapshot() == {}
    profiling.enable()
    on = [c() for c in calls]
    assert set(profiling.snapshot()) >= {"ivf.query", "ivf.cluster_scan", "topk.exact"}
    for (i0, d0), (i1, d1) in zip(off, on):
        assert torch.equal(i0, i1) and torch.equal(d0, d1)


def test_approx_query_records_its_stages(pq_index, monkeypatch):
    idx, x = pq_index
    monkeypatch.setattr(torch.cuda, "Event", _raise)       # no event on the CPU
    nq, nprobe = 300, 4
    profiling.enable()
    idx.query(torch.as_tensor(x[:nq]), 10, nprobe=nprobe, approx=True)
    snap = profiling.snapshot()
    assert set(snap) == {"ivf.query", "ivf.route", "ivf.lists", "ivf.scan", "ivf.merge"}
    parents = {n: s["parent"] for n, s in snap.items()}
    assert parents == {"ivf.query": None, "ivf.route": "ivf.query", "ivf.lists": "ivf.query",
                       "ivf.scan": "ivf.query", "ivf.merge": "ivf.scan"}
    assert len({s["call"] for s in snap.values()}) == 1
    assert all(s["calls"] == 1 and s["device_ns"] is None and s["device_self_ns"] is None
               for s in snap.values())
    # segments probed: nprobe scaled by segments per cell
    nseg = int(idx.seg_offsets.shape[0])
    nprobe_seg = min(nseg, max(nprobe, nprobe * nseg // idx.nlist))
    maxq, rows = device_probe_shapes(nq, nprobe_seg, nseg, 1)
    assert snap["ivf.lists"]["counts"] == {"pairs": nq * nprobe_seg, "slots": rows * maxq}
    assert snap["ivf.query"]["counts"] == {"queries": nq}
    q = snap["ivf.query"]
    children = sum(snap[n]["host_ns"] for n in ("ivf.route", "ivf.lists", "ivf.scan"))
    assert q["host_self_ns"] == q["host_ns"] - children >= 0
    assert snap["ivf.scan"]["host_self_ns"] == (snap["ivf.scan"]["host_ns"]
                                                - snap["ivf.merge"]["host_ns"])
    # a second call takes the next id and adds up
    idx.query(torch.as_tensor(x[:nq]), 10, nprobe=nprobe, approx=True)
    snap2 = profiling.snapshot()
    assert snap2["ivf.merge"]["call"] == q["call"] + 1 and snap2["ivf.lists"]["calls"] == 2
    assert snap2["ivf.lists"]["counts"]["pairs"] == 2 * nq * nprobe_seg


def test_exact_tier_with_split_cells_counts_its_pad_lanes(split_index):
    idx, x = split_index
    assert idx._seg_s_max() > 1
    nq, nprobe = 200, 3
    q = torch.as_tensor(x[::15][:nq])
    profiling.enable()
    idx.query(q, 10, nprobe=nprobe)
    snap = profiling.snapshot()
    assert set(snap) == {"ivf.query", "ivf.route", "ivf.host_lists", "ivf.cluster_scan",
                         "ivf.merge"}
    assert snap["ivf.host_lists"]["parent"] == "ivf.query"
    assert snap["ivf.merge"]["parent"] == "ivf.cluster_scan"
    assert len({s["call"] for s in snap.values()}) == 1
    # the lists the scan took, rebuilt, and its lanes counted one slot at a time
    probes = ivf_base.route_to_cells(q, idx.centroids, nprobe, idx.metric).numpy()
    qs, segs = expand_probes_to_segments(probes, np.asarray(idx._cluster_ptr))
    cids, lists, _ = build_probe_lists_from_pairs(qs, segs, int(idx.seg_offsets.shape[0]), nq)
    sizes = idx.seg_counts.tolist()
    cap, pad = idx.seg_size, 0
    for r in range(lists.shape[0]):
        for j in range(lists.shape[1]):
            real = int(lists[r, j]) < nq and int(cids[r]) < len(sizes)
            pad += cap - sizes[int(cids[r])] if real else cap
    assert snap["ivf.cluster_scan"]["counts"] == {"lanes": lists.size * cap, "pad_lanes": pad}
    assert 0 < pad < lists.size * cap


@pytest.mark.parametrize("selector,chunk", [("exact", 16384), ("approx", 16384), ("bins", 2048)])
def test_exact_fallback_counts_its_steps(selector, chunk):
    g = torch.Generator().manual_seed(3)
    nq, n = 2100, 20000
    q, x = torch.randn(nq, 4, generator=g), torch.randn(n, 4, generator=g)
    profiling.enable()
    blocked_query_topk(q, x, 5, Dist.EUCLIDEAN, selector=selector)
    snap = profiling.snapshot()
    assert snap["topk.exact"]["counts"] == {"steps": -(-nq // 1024) * -(-n // chunk)}
    assert snap["topk.exact"]["parent"] is None
    blocked_query_topk(q, x, 5, Dist.EUCLIDEAN, selector="fused")      # K2: no stage
    assert profiling.snapshot()["topk.exact"]["calls"] == 1


@pytest.mark.parametrize("k", [10, 40])
def test_certified_fallback_counts_its_rescans(k):
    """Stage ``topk.certified``: its queries and the queries two of whose
    first k K2 ids share a column class (counted here from K2's plain
    version by hand)."""
    from annsearch_tpu_torch.ops.flat_scan_fused import flat_topk_fused_plain, fused_shapes

    g = np.random.default_rng(5)
    q = torch.tensor(g.integers(-4, 5, (300, 8)) / 8, dtype=torch.float32)
    x = torch.tensor(g.integers(-4, 5, (6000, 8)) / 8, dtype=torch.float32)
    B = fused_shapes(6000, k + 1)[1]
    _, ids = flat_topk_fused_plain(q, x, k + 1, Dist.EUCLIDEAN, passes=6)
    collide = sum(len({c % B for c in row[:k]}) < k for row in ids.tolist())
    profiling.enable()
    blocked_query_topk(q, x, k, Dist.EUCLIDEAN, selector="certified")
    snap = profiling.snapshot()
    assert snap["topk.certified"]["counts"] == {"queries": 300, "rescanned": collide}
    assert snap["topk.certified"]["parent"] is None and "topk.exact" not in snap
    assert 0 < collide < 300


def test_exact_fallback_of_an_index_counts_its_steps(monkeypatch):
    """A small batch to the flat binary index's exact tier takes the exact
    fallback (``BaseIndex._exact_query_small``)."""
    import annsearch_tpu_torch as at

    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    x = torch.randn(17000, 8, generator=torch.Generator().manual_seed(4))
    idx = at.build_exhaustive_index_binary(x, n_bits=64, device="cpu")
    profiling.enable()
    idx.query(x[:1500], 3, rerank="exact")
    snap = profiling.snapshot()
    assert snap["topk.exact"]["counts"] == {"steps": 2 * 2}
    assert snap["topk.exact"]["parent"] is None


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"}


@pytest.mark.parametrize("tracing", [False, True])
def test_stages_nest_in_a_profiler_trace(pq_index, tmp_path, tracing):
    idx, x = pq_index
    if tracing:
        profiling.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        idx.query(torch.as_tensor(x[:200]), 10, nprobe=4, approx=True)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    ann = _annotations(tmp_path / "t.json")
    assert {"ivf.query", "ivf.route", "ivf.lists", "ivf.scan", "ivf.merge"} <= set(ann)

    def inside(a, b):
        return ann[b][0] <= ann[a][0] and ann[a][1] <= ann[b][1]

    assert inside("ivf.merge", "ivf.scan")
    assert all(inside(n, "ivf.query") for n in ("ivf.route", "ivf.lists", "ivf.scan"))
    assert ann["ivf.route"][1] <= ann["ivf.lists"][0] and ann["ivf.lists"][1] <= ann["ivf.scan"][0]
    assert bool(profiling.snapshot()) == tracing


class _FakeEvent:
    """A CUDA timing event on a fake clock: recorded at the next tick, done
    when the test says."""

    made, clock, done = 0, 0, True

    def __init__(self, enable_timing=False):
        type(self).made += 1

    def record(self, stream):
        type(self).clock += 10
        self.t = type(self).clock

    def query(self):
        return type(self).done

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e-6          # ms: one tick is 10 ns


def test_device_intervals_resolve_without_a_synchronise(monkeypatch):
    monkeypatch.setattr(profiling, "_stream", lambda dev: "stream")
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(_FakeEvent, "done", False)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    profiling.enable()

    def call():
        with profiling.stage("outer", "dev"):            # ticks 1, 6
            with profiling.stage("a", "dev"):            # ticks 2, 3
                pass
            with profiling.stage("b", "dev"):            # ticks 4, 5
                pass

    call()
    snap = profiling.snapshot()
    assert snap["outer"]["device_ns"] is None and snap["a"]["calls"] == 1
    _FakeEvent.done = True
    snap = profiling.snapshot()
    assert snap["outer"]["device_ns"] == 50 and snap["outer"]["device_self_ns"] == 30
    assert snap["a"]["device_ns"] == snap["a"]["device_self_ns"] == 10
    for _ in range(200):
        call()
    snap = profiling.snapshot()
    assert snap["outer"]["calls"] == 201 and snap["outer"]["device_ns"] == 201 * 50
    assert snap["b"]["device_self_ns"] == 201 * 10
    assert _FakeEvent.made == 6                          # the pool's events, reused


#: the readers of the spans, each with its value on the hand-made snapshot
READERS = {
    "ivf_route_ms_per_call": 0.5, "ivf_lists_ms_per_call": 1.25, "ivf_merge_ms_per_call": 0.75,
    "ivf_slot_use_pct": 40.0, "ivf_host_lists_ms_per_call": 20.0,
    "cluster_scan_ms_per_call": 2.5, "cluster_scan_pad_pct": 87.5,
    "fallback_steps_per_call": 620.0, "fallback_host_ms_per_step": 0.125,
    "fallback_rescan_pct": 5.0,
}


def _stat(host_ms=0.0, device_ms=None, self_ms=None, **counts):
    return {"calls": 4, "host_ns": host_ms * 4e6, "host_self_ns": host_ms * 4e6,
            "device_ns": None if device_ms is None else device_ms * 4e6,
            "device_self_ns": None if self_ms is None else self_ms * 4e6,
            "counts": counts, "parent": None, "call": 4}


SNAPSHOT = {
    "ivf.route": _stat(device_ms=0.5), "ivf.merge": _stat(device_ms=0.75),
    "ivf.lists": _stat(device_ms=1.25, pairs=400, slots=1000),
    "ivf.host_lists": _stat(host_ms=20.0),
    "ivf.cluster_scan": _stat(device_ms=3.25, self_ms=2.5, lanes=8000, pad_lanes=7000),
    "topk.exact": _stat(host_ms=77.5, steps=2480),
    "topk.certified": _stat(queries=40000, rescanned=2000),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_takes_its_value_from_the_snapshot(name, monkeypatch):
    from portbench.cell import load_reader

    r = load_reader(name)
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    ctx = SimpleNamespace(cache={}, calls=4)
    r.start(ctx)
    assert profiling._rec.on
    assert r.read(ctx) == pytest.approx(READERS[name])
    assert not profiling._rec.on
    # a program without the stage recorder gives the reader nothing to read
    monkeypatch.delattr(profiling, "snapshot")
    ctx = SimpleNamespace(cache={}, calls=4)
    r.start(ctx)
    assert r.read(ctx) is None
