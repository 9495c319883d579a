"""The benchmark's arithmetic on inputs worked by hand (CPU)."""

from __future__ import annotations

import statistics

import pytest
import torch

from portbench import check, data, roofline, stats
from portbench.reference import control_knn, distances_of, exact_knn
from portbench.reference.exact import int4_rows, round_tf32
from portbench.trace import WINDOW_MARK, read_chrome_trace, short_name


def test_rate_and_spread():
    assert stats.rate(30_000, 1.5) == 20_000
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    vals = [10, 11, 12, 13, 14, 15]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / q2)
    # quartiles 10.75 and 14.25 about the median 12.5
    assert stats.spread(vals) == pytest.approx(3.5 / 12.5)


def test_recall_counts_a_repeated_id_once():
    truth = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    found = torch.tensor([[4, 3, 9, 9], [5, 5, 5, 5]])
    # row 0: {3, 4} of 4; row 1: {5} once of 4
    assert stats.recall(truth, found) == pytest.approx((2 / 4 + 1 / 4) / 2)


def test_union_idle_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.union_length(iv, 0, 10) == 3 + 1 + 1
    assert stats.idle_gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.idle_gaps([], 0, 4) == [(0, 4)]
    assert stats.idle_pct(2.5, 10.0) == 75.0


def test_top_by_total():
    pairs = [("a", 1.0), ("b", 3.0), ("a", 2.5), ("c", 0.5)]
    assert stats.top_by_total(pairs, 2) == [["a", 3.5], ["b", 3.0]]


def test_held_bytes_counts_each_storage_once():
    class Index:
        pass

    ix = Index()
    ix.a = torch.zeros(10, dtype=torch.float32)               # 40 B
    ix.view = ix.a[2:5]                                       # same storage
    ix.parts = [torch.zeros(4, dtype=torch.int64), ix.a]      # 32 B more
    ix.table = {"t": torch.zeros(3, dtype=torch.int8)}        # 3 B more
    ix.n = 7
    assert stats.held_bytes(ix, "cpu") == 40 + 32 + 3
    assert stats.held_bytes(ix, "meta") == 0


def test_roofline_counts():
    # one multiply-add is two operations; the larger time sets the bound
    assert roofline.least_time(2e12, 1e9, 1e12, 1e12) == (2.0, "operations")
    assert roofline.least_time(1e9, 3e12, 1e12, 1e12) == (3.0, "bytes")
    assert roofline.share_pct(1e12, 0.0, 4.0, 1e12, 1e12) == 25.0
    flop, nbytes = roofline.flat_self_knn_work(1000, 32, 15)
    assert flop == 2 * 1000 * 1000 * 32
    assert nbytes == 1000 * (32 * 4 + 4) + 1000 * 15 * 8
    flop, nbytes = roofline.flat_query_work(10, 1000, 32, 15)
    assert flop == 2 * 10 * 1000 * 32
    assert nbytes == 1000 * 132 + 10 * 32 * 4 + 10 * 15 * 8
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_flop_s"] == 989e12 and peaks["hbm_byte_s"] == 3.35e12
    assert roofline.peaks_for("no such card") is None


def test_ivf_probe_work_counts_real_rows_of_probed_cells():
    cents = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    x = torch.tensor([[0.1, 0.0], [0.0, 0.2], [9.0, 0.0], [0.0, 9.5], [0.0, 11.0], [0.3, 0.3]])
    sizes = roofline.nearest_centroid_sizes(x, cents, block=4)
    assert sizes.tolist() == [3, 1, 2]
    q = torch.tensor([[1.0, 0.0], [0.0, 8.0]])
    # nprobe 2: query 0 probes cells 0 and 1 (4 rows), query 1 cells 2 and 0 (5 rows)
    flop, nbytes = roofline.ivf_probe_work(q, cents, sizes, 2, 1, 10)
    assert flop == 2 * (4 + 5) * 2
    # every cell probed by someone: 6 rows of 2 code bytes and a 4 B norm
    assert nbytes == 6 * (2 + 4) + 2 * 2 * 4 + 2 * 10 * 8
    # under cosine the angle alone ranks cells: (1, 1.5) lies nearer (1, 0)
    # but at the smaller angle to (0, 5)
    cents = torch.tensor([[1.0, 0.0], [0.0, 5.0]])
    x = torch.tensor([[1.0, 1.5], [2.0, 0.1]])
    assert roofline.nearest_centroid_sizes(x, cents).tolist() == [2, 0]
    assert roofline.nearest_centroid_sizes(x, cents, metric="cosine").tolist() == [1, 1]
    sizes = torch.tensor([3, 1])
    assert roofline.ivf_probe_work(x[:1], cents, sizes, 1, 1, 1)[0] == 2 * 3 * 2
    assert roofline.ivf_probe_work(x[:1], cents, sizes, 1, 1, 1, "cosine")[0] == 2 * 1 * 2


def _trace_events():
    return [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW_MARK, "ts": 100, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 150, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 155, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void ivf_scan_kernel<signed char, 1>(CUtensorMap, int*)",
         "ts": 90, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void flat_extract_kernel(float const*)", "ts": 130,
         "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 180, "dur": 40},
        {"ph": "X", "cat": "gpu_user_annotation", "name": WINDOW_MARK, "ts": 100, "dur": 100},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 120},
    ]


def test_timeline_from_a_chrome_trace():
    t = read_chrome_trace(_trace_events())
    assert (t.lo, t.hi) == (100, 200)
    assert t.window_s == pytest.approx(100e-6)
    # clipped: kernel 100-120, extract 130-150, copy 180-200
    assert t.busy_s == pytest.approx(60e-6)
    assert t.device_s(lambda n: n.startswith("ivf_scan_kernel")) == pytest.approx(20e-6)
    b = t.breakdown()
    # equal totals go by name
    assert b["device_ops"] == [["Memcpy DtoH", pytest.approx(20e-6)],
                               ["flat_extract_kernel", pytest.approx(20e-6)],
                               ["ivf_scan_kernel<signed char, 1>", pytest.approx(20e-6)]]
    # gaps 120-130 (no host op) and 150-180 (mid 165: sort covers, nonzero ended)
    assert dict(map(tuple, b["idle_gaps"])) == {
        "aten::sort": pytest.approx(30e-6), "host: no recorded operation": pytest.approx(10e-6)}
    with pytest.raises(RuntimeError):
        read_chrome_trace(_trace_events()[1:])


def test_short_name():
    assert short_name("void ivf_scan_kernel<a, (b)1>(CUtensorMap, int)") == "ivf_scan_kernel<a, (b)1>"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert short_name("(anonymous namespace)::flat_scan_kernel<2, 3, true>") == (
        "flat_scan_kernel<2, 3, true>")


def test_exact_knn_and_distances_by_hand():
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0], [3.0, 3.0]])
    q = torch.tensor([[0.0, 0.1], [3.0, 2.0]])
    ids, d = exact_knn(q, x, 2)
    assert ids.tolist() == [[0, 1], [3, 1]]
    assert d[0].tolist() == pytest.approx([0.01, 1.01])
    assert d[1].tolist() == pytest.approx([1.0, 8.0])
    ids, d = exact_knn(x[:2], x, 2, exclude=torch.tensor([0, 1]))
    assert ids.tolist() == [[1, 2], [0, 2]]
    # id 9 is clamped to the last row
    assert distances_of(q, x, torch.tensor([[2, 3], [0, 9]])).flatten().tolist() == pytest.approx(
        [3.61, 17.41, 13.0, 1.0])


def test_control_precisions():
    # 1 + 2**-11 is below TF32's last bit and rounds to 1; 1 + 2**-10 stays
    t = torch.tensor([1.0 + 2**-11 - 2**-20, 1.0 + 2**-10, -3.0])
    assert round_tf32(t).tolist() == [1.0, 1.0 + 2**-10, -3.0]
    x = torch.tensor([[7.0, -0.6], [3.2, 1.0], [-7.0, 0.2]])
    # scales 1.0 and 1/7: codes round to the nearest step
    assert int4_rows(x).flatten().tolist() == pytest.approx([7.0, -4 / 7, 3.0, 1.0, -7.0, 1 / 7])
    with pytest.raises(ValueError):
        control_knn(x, x, 1, "float64")


def test_compare_and_judge():
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0], [3.0, 3.0]])
    q = torch.tensor([[0.0, 0.1], [3.0, 2.0]])
    ids, d = exact_knn(q, x, 2)
    n = check.compare(q, x, ids, d.float())
    assert n["miss"] == 0.0 and n["bad"] == 0.0
    assert n["dist_err"] < 1e-6 and abs(n["gap"]) < 1e-6
    # the second answer of query 1 swapped for row 2: a miss of one in four;
    # its true distance 9 lies 1 over the reference's 8, which is k-th
    wrong = torch.tensor([[0, 1], [3, 2]])
    n = check.compare(q, x, wrong, d.float())
    assert n["miss"] == 0.25 and n["gap"] == pytest.approx(1 / 8)
    assert n["dist_err"] == pytest.approx(1 / 8)
    # a repeated id, an id past the data and a descending row are bad rows
    assert check.compare(q, x, torch.tensor([[0, 0], [3, 9]]), d.float())["bad"] == 2
    assert check.compare(q, x, ids, d.flip(1).float())["bad"] == 2
    ok, out = check.judge({"miss": 0.1, "bad": 0.0, "gap": 5.0}, {"miss": 0.1, "bad": 0})
    assert ok and out == {"miss": {"value": 0.1, "limit": 0.1}, "bad": {"value": 0.0, "limit": 0}}
    assert not check.judge({"miss": float("nan")}, {"miss": 1.0})[0]
    assert not check.judge({"miss": 0.2}, {"miss": 0.1})[0]


def test_cosine_exact_knn_and_distances_by_hand():
    # row 3 is zero: at distance 1 from every query
    x = torch.tensor([[2.0, 0.0], [1.0, 3.0], [-1.0, 1.0], [0.0, 0.0]])
    q = torch.tensor([[1.0, 0.0], [1.0, 2.0]])
    ids, d = exact_knn(q, x, 3, metric="cosine")
    assert ids.tolist() == [[0, 1, 3], [1, 0, 2]]
    assert d[0].tolist() == pytest.approx([0.0, 1 - 10**-0.5, 1.0], abs=1e-15)
    assert d[1].tolist() == pytest.approx([1 - 7 / 50**0.5, 1 - 5**-0.5, 1 - 10**-0.5],
                                          abs=1e-15)
    assert distances_of(q, x, torch.tensor([[2, 3], [3, 9]]), metric="cosine").flatten(
        ).tolist() == pytest.approx([1 + 2**-0.5, 1.0, 1.0, 1.0], abs=1e-15)
    # a zero query, too, lies at distance 1
    assert distances_of(torch.zeros(1, 2), x, torch.tensor([[0]]), metric="cosine").item() == 1.0
    with pytest.raises(ValueError, match="manhattan"):
        exact_knn(q, x, 1, metric="manhattan")


def test_cosine_controls():
    x = torch.tensor([[3.0, 4.0 * (1 + 2**-11)], [7.0, -0.6], [0.0, 0.0]])
    q = torch.tensor([[3.0, 4.0]])
    # TF32: normalised in f32, operands rounded, 1 − product with TF32 off
    xs = round_tf32(x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-30))
    qs = round_tf32(q / 5.0)
    ids, d = control_knn(q, x, 3, "tf32", metric="cosine")
    assert ids.tolist() == [[0, 1, 2]]
    assert d[0].tolist() == (1.0 - qs @ xs.T)[0].tolist()
    assert d[0, 2].item() == 1.0
    # int4: the rows stored first (codes of per-dimension scales), then normalised
    r = int4_rows(x)
    want = 1.0 - (q / 5.0) @ (r / torch.linalg.vector_norm(r, dim=1, keepdim=True)
                               .clamp_min(1e-30)).T
    ids, d = control_knn(q, x, 3, "int4", metric="cosine")
    assert d[0].tolist() == pytest.approx(sorted(want[0].tolist()), abs=1e-7)
    assert ids.tolist() == [want[0].argsort().tolist()]


def test_compare_under_cosine():
    g = torch.Generator().manual_seed(0)
    # rows of unequal norms: squared euclidean ranks them otherwise
    x = torch.randn(500, 8, generator=g) * torch.rand(500, 1, generator=g).mul(9.0).add(0.5)
    q = torch.randn(40, 8, generator=g)
    ids, d = exact_knn(q, x, 10, metric="cosine")
    n = check.compare(q, x, ids, d.float(), metric="cosine")
    assert n["miss"] == 0.0 and n["bad"] == 0.0
    assert n["dist_err"] < 1e-6 and abs(n["gap"]) < 1e-6
    e_ids, e_d = exact_knn(q, x, 10)
    n = check.compare(q, x, e_ids, distances_of(q, x, e_ids, "cosine").float(), metric="cosine")
    assert n["miss"] > 0.3 and n["gap"] > 0.1
    # the same answers read under euclidean are exact
    assert check.compare(q, x, e_ids, e_d.float())["miss"] == 0.0


@pytest.mark.parametrize("kind", ["clusters", "lowrank"])
def test_data_repeats_from_a_seed(kind):
    spec = {"generator": kind, "n": 1_000, "dim": 32, "n_clusters": 5, "intrinsic_dim": 8,
            "structure_seed": 42}
    a = data.make_data(spec, 2**31 + 5, "cpu")
    assert a.shape == (1_000, 32) and a.dtype == torch.float32
    assert torch.equal(a, data.make_data(spec, 2**31 + 5, "cpu"))
    assert not torch.equal(a, data.make_data(spec, 2**31 + 6, "cpu"))
    q, rows = data.noisy_subsample(a, 100, 0.05, 7)
    assert rows.unique().numel() == 100
    assert (q - a[rows]).std().item() == pytest.approx(0.05, rel=0.1)
    with pytest.raises(ValueError):
        data.noisy_subsample(a, 1_001, 0.05, 7)


def test_clusters_differ_by_seed_in_coordinate_order_alone():
    a = data.clusters(2_000, 16, 4, 42, 1, "cpu")
    b = data.clusters(2_000, 16, 4, 42, 2, "cpu")
    assert not torch.equal(a, b)
    # the same rows, coordinates in another order: every distance is kept
    assert torch.equal(a.sort(dim=1).values, b.sort(dim=1).values)
    da = ((a[:50, None].double() - a[None].double()) ** 2).sum(-1)
    db = ((b[:50, None].double() - b[None].double()) ** 2).sum(-1)
    assert torch.allclose(da, db, rtol=1e-12, atol=0.0)


def test_lowrank_lies_near_its_subspace():
    x = data.lowrank(4_000, 32, 8, 6, 42, 3, "cpu").double()
    s = torch.linalg.svdvals(x - x.mean(0))
    # eight directions carry the clusters; the rest only σ 0.01 of noise
    assert s[8] / s[7] < 0.05
    assert s[8] / (4_000 ** 0.5) == pytest.approx(0.01, rel=0.2)


def _answers_of(call: int, width: int, k: int):
    """Answers that name their call and row: id ``1000·row + call``."""
    ids = (torch.arange(width)[:, None] * 1000 + call).repeat(1, k)
    return ids, ids.double()


def _reservoir(seed: int, width: int = 50, calls: int = 400, k: int = 3):
    from portbench.cell import SLOTS, Reservoir

    r = Reservoir(seed, width, 4 * SLOTS)
    r.prepare(_answers_of(-1, width, k))
    for i in range(calls):
        r.offer(i, _answers_of(i, width, k))
    return r.answers()


def test_reservoir_holds_a_seeded_sample_of_every_call():
    from portbench.cell import SLOTS

    calls, rows, ids, dists = _reservoir(7)
    assert ids.shape == dists.shape == (4 * SLOTS, 3)
    # each row held is the answer its call gave at that row, none twice
    assert torch.equal(ids[:, 0], rows * 1000 + calls)
    assert ids[:, 0].unique().numel() == ids.shape[0]
    # the same seed, the same sample; another seed, another
    assert torch.equal(_reservoir(7)[2], ids) and not torch.equal(_reservoir(8)[2], ids)
    # drawn over the whole window: as many blocks from each half of the calls
    early = [int((_reservoir(s)[0] < 200).sum()) // 4 for s in range(20)]
    assert 0.4 < sum(early) / (20 * SLOTS) < 0.6


def test_reservoir_fills_from_a_first_call():
    from portbench.cell import SLOTS

    calls, rows, ids, _ = _reservoir(3, width=10_000, calls=1)
    assert ids.shape[0] == 4 * SLOTS and (calls == 0).all() and rows.unique().numel() == 4 * SLOTS
