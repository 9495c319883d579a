"""The rest of the single-chip package against the JAX package:
``StreamingExhaustiveIndex``, ``validate_index``, ``vectors_original_order``
(and ``BaseIndex.load``), the device data generators, ``utils/profiling``
and the export lists.

Tolerances: streaming and exhaustive scans take f32-grade products in both
packages, on data scaled by 1/8 (see the verify notes: the identity's f32
rounding grows with the norms), so ids agree on ≥ 99.9% of slots and
distances within 1e-4·(1 + |d|); the port's stream against the port's own
exhaustive index agrees on ids except where two distances tie. Rows
carried across by ``save`` / ``load`` come back bit for bit. The device
generators cannot repeat the JAX stream: they are held to their layout,
their determinism and the distribution's moments."""

import os

import numpy as np
import pytest
import torch

import annsearch_tpu
import annsearch_tpu.models as jmodels
import annsearch_tpu_torch
import annsearch_tpu_torch.models as tmodels
from annsearch_tpu.models.streaming import StreamingExhaustiveIndex as JStreaming
from annsearch_tpu.utils.validation import validate_index as jvalidate
from annsearch_tpu_torch.models.exhaustive import ExhaustiveIndex
from annsearch_tpu_torch.models.streaming import StreamingExhaustiveIndex
from annsearch_tpu_torch.utils import profiling
from annsearch_tpu_torch.utils.data import (
    generate_clustered_data,
    generate_clustered_data_device,
    subsample_with_noise,
    subsample_with_noise_device,
)
from annsearch_tpu_torch.utils.validation import validate_index

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sdata():
    x, _ = generate_clustered_data(1000, 24, 8, seed=5)
    x = x / np.float32(8)
    return x, subsample_with_noise(x, 120, seed=5)


def _close(tn, td, jn, jd):
    tn, td = np.asarray(tn), np.asarray(td)
    jn, jd = np.asarray(jn), np.asarray(jd)
    assert tn.shape == jn.shape and (tn == jn).mean() >= 0.999
    assert np.all(np.abs(td - jd) <= 1e-4 * (1.0 + np.abs(jd)))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_streaming_against_jax(sdata, metric):
    """Chunks of 300 rows (a ragged last one of 100) against the JAX
    stream at chunk 300, and against the port's exhaustive index."""
    x, q = sdata
    ti, td = StreamingExhaustiveIndex(x, metric, device="cpu").query(q, 10, chunk_rows=300)
    ji, jd = JStreaming(x, metric).query(q, 10, chunk_rows=300)
    _close(ti, td, ji, jd)
    ei, ed = ExhaustiveIndex(x, metric, device="cpu").query(q, 10)
    assert (ti == ei).float().mean() >= 0.999
    assert torch.allclose(td, ed, rtol=1e-5, atol=1e-5)
    assert ti.dtype == torch.int64 and (td.diff(dim=1) >= 0).all()


def test_streaming_from_a_vec_file(sdata, tmp_path):
    """``write`` then a fresh index on the path: the memmap route answers as
    the array route; each package reads the other's file."""
    x, q = sdata
    path = str(tmp_path / "db" / "rows")
    t = StreamingExhaustiveIndex.write(path, x, device="cpu")
    assert isinstance(t._x, np.memmap) and (t.n, t.dim) == x.shape
    assert t.memory_usage_bytes() == 0
    a = t.query(q, 7, chunk_rows=256)
    b = StreamingExhaustiveIndex(x, device="cpu").query(q, 7, chunk_rows=256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    j = JStreaming(path)
    _close(*a, *j.query(q, 7, chunk_rows=256))
    JStreaming.write(str(tmp_path / "jrows"), x)
    c = StreamingExhaustiveIndex(str(tmp_path / "jrows"), device="cpu").query(q, 7)
    assert torch.equal(c[0], a[0])
    with pytest.raises(ValueError):
        t.query(q[:, :5], 3)


def test_streaming_generate_knn_and_k_clamp(sdata):
    x = sdata[0][:300]
    s = StreamingExhaustiveIndex(x, device="cpu")
    ids, d = s.generate_knn(5, chunk_rows=128)
    assert ids.shape == (300, 5) and (ids[:, 0] == torch.arange(300)).all()
    ids, d = s.query(x[:4], 1000)
    assert ids.shape == (4, 300) and torch.equal(torch.sort(ids[0]).values, torch.arange(300))


class _Stub:
    """An index whose answers are the exact top-k with one wrong column on
    every third query row (built from the rows in original order)."""

    def __init__(self, x, metric, as_tensor):
        self.x, self.as_tensor = x, as_tensor
        self.metric = annsearch_tpu_torch.utils.Dist(metric) if as_tensor else \
            annsearch_tpu.utils.Dist(metric)

    def vectors_original_order(self):
        return torch.as_tensor(self.x) if self.as_tensor else self.x

    def query(self, q, k):
        q = np.asarray(q)
        d = ((q[:, None, :].astype(np.float64) - self.x[None]) ** 2).sum(-1)
        ids = np.argsort(d, axis=1, kind="stable")[:, :k]
        ids[::3, -1] = (ids[::3, -1] + 1) % self.x.shape[0]
        return (torch.as_tensor(ids) if self.as_tensor else ids), None


def test_validate_index_equals_jax(sdata):
    """The same ``default_rng(seed)`` sample and the same recall: on stubs
    with planted errors the two functions return the same value; on an
    exhaustive index both read 1.0."""
    x = sdata[0]
    for n_samples, k, seed in ((200, 10, 42), (5000, 4, 7)):
        r_t = validate_index(_Stub(x, "euclidean", True), k=k, seed=seed, n_samples=n_samples)
        r_j = jvalidate(_Stub(x, "euclidean", False), k=k, seed=seed, n_samples=n_samples)
        assert r_t == pytest.approx(r_j, abs=1e-12) and r_t < 1.0
    assert validate_index(ExhaustiveIndex(x, device="cpu"), k=10) == 1.0


def test_validate_index_on_a_carried_graph(sdata, tmp_path):
    """A JAX HNSW index carried across by its npz: the port's walk scores
    within 0.01 of the JAX walk on the same sample."""
    x = sdata[0]
    j = jmodels.HnswIndex(x, m=8, seed=0)
    j.save(str(tmp_path / "h.npz"))
    t = tmodels.HnswIndex.load(str(tmp_path / "h.npz"), device="cpu")
    kw = dict(k=10, n_samples=300, exact_fallback=False, ef_search=40)
    assert abs(validate_index(t, **kw) - jvalidate(j, **kw)) <= 0.01


def _builders():
    """(name, JAX constructor) for every class with its own
    ``vectors_original_order`` in the JAX package, and ``BaseIndex``'s."""
    return [
        ("ExhaustiveIndex", lambda x, m: jmodels.ExhaustiveIndex(x, m)),
        ("LSHIndex", lambda x, m: jmodels.LSHIndex(x, m, num_tables=2, bits_per_hash=6)),
        ("ExhaustiveIndexBinary", lambda x, m: jmodels.ExhaustiveIndexBinary(x, m, n_bits=64)),
        ("IvfIndex", lambda x, m: jmodels.IvfIndex(x, m, nlist=8)),
        ("AnnoyIndex", lambda x, m: jmodels.AnnoyIndex(x, m, n_trees=2, leaf=32)),
        ("BallTreeIndex", lambda x, m: jmodels.BallTreeIndex(x, m, leaf=32)),
        ("NNDescentIndex", lambda x, m: jmodels.NNDescentIndex(x, m, k=5)),
        ("HnswIndex", lambda x, m: jmodels.HnswIndex(x, m, m=4)),
        ("KmknnIndex", lambda x, m: jmodels.KmknnIndex(x, m, nlist=8)),
        ("ExhaustiveSq8Index", lambda x, m: jmodels.ExhaustiveSq8Index(x, m)),
        ("VamanaIndex", lambda x, m: jmodels.VamanaIndex(x, m, r_degree=8)),
    ]


@pytest.mark.parametrize("name,build", _builders(), ids=[b[0] for b in _builders()])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_vectors_original_order_equals_jax(sdata, tmp_path, name, build, metric):
    """Each JAX index saved and loaded into the port (through its
    ``interop`` loader, or ``BaseIndex.load``): the port's rows in original
    order are the JAX package's, bit for bit, on the index's device; row i
    is the row ``query`` returns as id i."""
    x = sdata[0][:400]
    j = build(x, metric)
    p = str(tmp_path / f"{name}.npz")
    j.save(p)
    t = getattr(tmodels, name).load(p, device="cpu")
    v = t.vectors_original_order()
    assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
    assert torch.equal(v, torch.as_tensor(np.array(j.vectors_original_order())))
    if name != "ExhaustiveIndexBinary":
        ids, _ = t.query(v[:20], 1, **({"budget": 1.0} if name == "BallTreeIndex" else {}))
        assert (ids[:, 0] == torch.arange(20)).float().mean() >= 0.9


def test_exhaustive_load_round_trip(sdata, tmp_path):
    """``BaseIndex.load`` reads the port's own npz and the JAX package's."""
    x, q = sdata
    for metric in ("euclidean", "cosine"):
        a = ExhaustiveIndex(x, metric, device="cpu")
        a.save(str(tmp_path / "e"))
        b = ExhaustiveIndex.load(str(tmp_path / "e.npz"), device="cpu")
        assert b.metric == a.metric and (b.n, b.dim) == (1000, 24)
        assert torch.equal(a.query(q, 5)[0], b.query(q, 5)[0])
        jmodels.ExhaustiveIndex(x, metric).save(str(tmp_path / "j"))
        c = ExhaustiveIndex.load(str(tmp_path / "j"), device="cpu")
        assert torch.equal(c.query(q, 5)[0], a.query(q, 5)[0])


def test_generate_clustered_data_device():
    """Shapes, dtypes, the sentinel layout (rows 0..n−1 of the unpadded
    call, a zero last row), one seed one draw, another seed another, and
    the moments of the JAX distribution: centres in [−7.5, 7.5], per-cluster
    spread in [0.5, 2.5], every cluster present."""
    x, lab = generate_clustered_data_device(20_000, 16, 5, seed=3, device="cpu")
    xs, lab_s = generate_clustered_data_device(20_000, 16, 5, seed=3, sentinel=True,
                                               device="cpu")
    assert x.shape == (20_000, 16) and x.dtype == torch.float32 and lab.dtype == torch.int32
    assert xs.shape == (20_001, 16) and torch.equal(xs[:-1], x) and not xs[-1].any()
    assert torch.equal(lab, lab_s)
    y, _ = generate_clustered_data_device(20_000, 16, 5, seed=4, device="cpu")
    assert not torch.equal(x, y)
    counts = torch.bincount(lab.long(), minlength=5)
    assert (counts > 20_000 * 0.5 / (5 * 2.5) * 0.5).all()
    for c in range(5):
        rows = x[lab == c]
        assert rows.mean(0).abs().max() < 7.5 + 0.2
        assert 0.45 < rows.std(0).mean() < 2.6


def test_subsample_with_noise_device():
    x, _ = generate_clustered_data_device(5000, 8, 4, seed=1, sentinel=True, device="cpu")
    q = subsample_with_noise_device(x, 300, seed=2, n_rows=5000)
    assert q.shape == (300, 8) and torch.equal(q, subsample_with_noise_device(x, 300, seed=2,
                                                                              n_rows=5000))
    d = torch.cdist(q, x[:5000]).min(dim=1).values
    assert (d < 0.05 * 8 ** 0.5 * 4).all()                 # each query is a noisy row
    assert subsample_with_noise_device(x[:50], 300).shape == (50, 8)


def test_profiling(capsys, tmp_path):
    t = profiling.Timer(verbose=True)
    for _ in range(2):
        with t.span("a"):
            pass
    with t.span("b"):
        sum(range(1000))
    assert t.counts == {"a": 2, "b": 1} and t.totals["a"] >= 0
    assert t.report().splitlines()[0].split()[0] in ("a", "b")
    with profiling.span("one"):
        pass
    out = capsys.readouterr().out
    assert "[a]" in out and "[one]" in out
    with profiling.span("quiet", verbose=False):
        pass
    assert capsys.readouterr().out == ""
    assert profiling.force(torch.tensor([2.5, 1.0])) == 2.5
    assert profiling.force(torch.zeros(0)) == 0.0 and profiling.force(np.ones(3)) == 1.0
    with profiling.device_trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages() and os.listdir(tmp_path / "tr")


def test_export_lists_equal_the_jax_package():
    assert annsearch_tpu_torch.__all__ == annsearch_tpu.__all__
    assert tmodels.__all__ == jmodels.__all__
    for name in tmodels.__all__:
        assert isinstance(getattr(tmodels, name), type)
    assert annsearch_tpu_torch.validate_index is validate_index
