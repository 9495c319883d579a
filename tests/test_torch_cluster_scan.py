"""Parity of the port's cluster scan (``ops/ivf_scan.py``) with the JAX
package's ``ivf_cluster_scan``, mode by mode and under both metrics, on
index state carried over from JAX-built indexes: the same cells, norms,
centroids, codebooks and host-built task lists go through both.

On the CPU the JAX scan scores in float32 and decodes PQ tiles in f32, as
the port always does, so the distances differ only by the order of the f32
sums: within 1e-4·(1 + |d|). Ids agree up to ties: where they differ, the
two packages' distances at that rank agree within the same tolerance. sq8
scores in integer space and agrees bit for bit under the euclidean metric.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models.ivf import IvfIndex as JIvf
from annsearch_tpu.models.ivf_base import route_to_cells as j_route
from annsearch_tpu.models.kmeans import expand_probes_to_segments as j_expand
from annsearch_tpu.models.kmeans import SegmentLayout
from annsearch_tpu.models.quantised import ivf as jqivf
from annsearch_tpu.ops.ivf_scan import build_probe_lists_from_pairs as j_lists
from annsearch_tpu.ops.ivf_scan import ivf_cluster_scan as j_scan
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu.utils.dist import normalise as j_normalise
from annsearch_tpu_torch.ops.ivf_scan import ivf_cluster_scan as t_scan
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist, _sqrt_f32

torch.set_num_threads(2)

K, NPROBE = 10, 3

# (index mode → how the JAX index is built); the scan modes each serves
BUILDS = {
    "f32": (JIvf, {}),
    "bf16": (jqivf.IvfIndexBf16, {}),
    "sq8": (jqivf.IvfSq8Index, {}),
    "i8dec_residual": (jqivf.IvfPqIndex, {"m": 64}),
    "pq_residual": (jqivf.IvfPqIndex, {"m": 16}),
}
SCAN_MODES = [("f32", "f32"), ("bf16", "bf16"), ("sq8", "sq8"),
              ("i8dec_residual", "i8dec_residual"), ("i8dec_residual", "i8dec"),
              ("pq_residual", "pq_residual"), ("pq_residual", "pq")]


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


@pytest.fixture(scope="module")
def data64():
    # scaled by 1/8: near a match ‖q‖² + ‖x‖² − 2q·x cancels, and its f32
    # rounding (one ulp of the norms) would exceed a relative tolerance
    x, _ = generate_clustered_data(1500, 64, 6, seed=8)
    s = np.float32(0.125)
    return x * s, subsample_with_noise(x, 30, seed=9) * s


@pytest.fixture(scope="module")
def carried(data64):
    """{(index mode, metric): (JAX index, scoring queries, host task lists)}
    over a layout with split cells (seg_size 200: no multiple of 128)."""
    x, q = data64
    cache = {}

    def get(index_mode, metric):
        if (index_mode, metric) not in cache:
            cls, kw = BUILDS[index_mode]
            j = cls(x, metric, nlist=5, seg_size=200, **kw)
            assert j.mode == index_mode and j._seg_s_max() > 1
            qj = jnp.asarray(q)
            if metric == "cosine":
                qj = j_normalise(qj)
            probes = j_route(qj, j.centroids, NPROBE, j.metric)
            layout = SegmentLayout(None, np.asarray(j.seg_offsets), np.asarray(j.seg_counts),
                                   None, j._cluster_ptr, j.seg_size, None)
            qs, segs = j_expand(np.asarray(probes), layout)
            lists = j_lists(qs, segs, len(np.asarray(j.seg_offsets)), len(q))
            cache[index_mode, metric] = (j, j._encode_queries(qj), lists)
        return cache[index_mode, metric]

    return get


def _both(j, q_enc, lists, mode, metric, k=K, **kw):
    cb = j._codebooks()
    if mode == "pq":        # the residual index's codes, scored without centroids
        cb = j.codebooks
    want = j_scan(
        q_enc, *(jnp.asarray(a) for a in lists), j.storage, j.store_sqnorms,
        j.seg_offsets, j.seg_counts, j._scan_seg_centroids(), k,
        JDist.COSINE if metric == "cosine" else JDist.EUCLIDEAN, j.seg_size, mode,
        codebooks=cb,
    )
    got = t_scan(
        _t(q_enc), *(_t(a) for a in lists), _t(j.storage), _t(j.store_sqnorms),
        _t(j.seg_offsets), _t(j.seg_counts), _t(j._scan_seg_centroids()), k,
        Dist.COSINE if metric == "cosine" else Dist.EUCLIDEAN, j.seg_size, mode,
        codebooks=None if cb is None else _t(cb), **kw,
    )
    return got, (np.asarray(want[0]), np.asarray(want[1]))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("index_mode,mode", SCAN_MODES, ids=[m for _, m in SCAN_MODES])
def test_cluster_scan_matches_jax(carried, index_mode, mode, metric):
    j, q_enc, lists = carried(index_mode, metric)
    (gd, gi), (wd, wi) = _both(j, q_enc, lists, mode, metric)
    assert gd.shape == (q_enc.shape[0], K) and gi.dtype == torch.int64
    assert torch.all(gd[:, 1:] >= gd[:, :-1])
    gd, gi = gd.numpy(), gi.numpy()
    if mode == "sq8" and metric == "euclidean":
        np.testing.assert_array_equal(gd, wd)      # integer space: exact
    tol = 1e-4 * (1.0 + np.abs(wd))
    assert np.all(np.abs(gd - wd) <= tol)          # also where ids swap at a tie
    assert (gi == wi).mean() >= 0.98


@pytest.mark.parametrize("index_mode,mode", [("f32", "f32"), ("pq_residual", "pq_residual"),
                                             ("i8dec_residual", "i8dec_residual")])
def test_cluster_scan_does_not_depend_on_the_row_batch(carried, index_mode, mode):
    """One task row per step, three, and all at once give the same
    answer."""
    j, q_enc, lists = carried(index_mode, "euclidean")
    per_row = 4 * (3 * lists[1].shape[1] * j.seg_size + 4 * j.seg_size * 64)
    outs = [_both(j, q_enc, lists, mode, "euclidean", step_bytes=b)[0]
            for b in (1, 3 * per_row, 1 << 30)]
    for d, i in outs[1:]:
        assert torch.equal(d, outs[0][0]) and torch.equal(i, outs[0][1])


def test_cluster_scan_pads_past_the_candidates(carried):
    """k beyond the gathered candidates (tasks per query × cell cap):
    (+inf, 0) fills the tail, as in the JAX package; masked lanes before it
    read +inf."""
    j, q_enc, lists = carried("f32", "euclidean")
    width = lists[2].shape[1] * j.seg_size
    (gd, gi), (wd, wi) = _both(j, q_enc, lists, "f32", "euclidean", k=width + 100)
    assert gd.shape == (q_enc.shape[0], width + 100)
    np.testing.assert_array_equal(np.isinf(gd.numpy()), np.isinf(wd))
    assert np.isinf(wd[:, width:]).all() and (gi.numpy()[:, width:] == 0).all()
    fin = np.isfinite(wd)
    assert fin.any() and np.all(
        np.abs(gd.numpy()[fin] - wd[fin]) <= 1e-4 * (1.0 + np.abs(wd[fin])))


def test_cluster_scan_refuses_the_binary_modes():
    """The binary modes refuse what they cannot take: float storage or
    hamming queries (the words are int32 bit patterns; a float cast would
    lose bits) and rabitq without ``aux``; an unknown mode is refused."""
    z, w = torch.zeros((1, 8)), torch.zeros((1, 8), dtype=torch.int32)
    for mode in ("hamming", "binary_asym", "rabitq"):
        with pytest.raises(ValueError, match="int32 words"):
            t_scan(w, z, z, z, z, z, z, z, z, 1, Dist.EUCLIDEAN, 8, mode, aux=z[0])
    with pytest.raises(ValueError, match="int32 words"):
        t_scan(z, z, z, z, w, z, z, z, z, 1, Dist.EUCLIDEAN, 8, "hamming")
    with pytest.raises(ValueError, match="aux"):
        t_scan(z, z, z, z, w, z, z, z, z, 1, Dist.EUCLIDEAN, 8, "rabitq")
    with pytest.raises(ValueError, match="unknown"):
        t_scan(z, z, z, z, z, z, z, z, z, 1, Dist.EUCLIDEAN, 8, "f16")


@pytest.mark.parametrize("mode", ["hamming", "binary_asym", "rabitq"])
def test_cluster_scan_binary_modes_match_jax(mode):
    """On packed words (int32 bit patterns of the JAX package's uint32
    words) each binary mode gives the JAX scan's ids and distances
    (integers for ``hamming``; the f32 sums of the others within 1e-4·(1 +
    |d|))."""
    rng = np.random.default_rng(9)
    n, cap, w, nq = 300, 128, 2, 12
    words = rng.integers(0, 2**32, (n + cap, w), dtype=np.uint64).astype(np.uint32)
    offs = np.array([0, 100, 200], np.int32)
    counts = np.array([100, 100, 100], np.int32)
    cents = rng.standard_normal((3, 64)).astype(np.float32)
    sn = np.abs(rng.standard_normal(n + cap)).astype(np.float32)
    aux = np.abs(rng.standard_normal(n + cap)).astype(np.float32) * 6
    fq = np.repeat(np.arange(nq), 2)
    fc = rng.integers(0, 3, 2 * nq)
    lists = j_lists(fq, fc, 3, nq)
    queries = {"hamming": rng.integers(0, 2**32, (nq, w), dtype=np.uint64).astype(np.uint32),
               "binary_asym": rng.standard_normal((nq, 64)).astype(np.float32),
               "rabitq": rng.standard_normal((nq, 64)).astype(np.float32)}
    qv = queries[mode]
    wd, wi = j_scan(jnp.asarray(qv), *(jnp.asarray(a) for a in lists), jnp.asarray(words),
                    jnp.asarray(sn), jnp.asarray(offs), jnp.asarray(counts),
                    jnp.asarray(cents), 7, JDist.EUCLIDEAN, cap, mode, aux=jnp.asarray(aux))
    qt = torch.tensor(qv.view(np.int32) if mode == "hamming" else qv)
    gd, gi = t_scan(qt, *(_t(a) for a in lists), torch.tensor(words.view(np.int32)),
                    torch.tensor(sn), torch.tensor(offs), torch.tensor(counts),
                    torch.tensor(cents), 7, Dist.EUCLIDEAN, cap, mode, aux=torch.tensor(aux))
    wd = np.asarray(wd)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert np.all(np.abs(gd.numpy() - wd) <= 1e-4 * (1.0 + np.abs(wd)))


def test_cluster_scan_k_cell_matches_jax(carried):
    """``k_cell`` (LSH's per-cell width under a wider final k): each cell
    keeps its top 3, the merge takes 12, as the JAX scan does."""
    j, q_enc, lists = carried("f32", "euclidean")
    args = (j.storage, j.store_sqnorms, j.seg_offsets, j.seg_counts, j._scan_seg_centroids())
    wd, wi = j_scan(q_enc, *(jnp.asarray(a) for a in lists), *args, 12, JDist.EUCLIDEAN,
                    j.seg_size, "f32", k_cell=3)
    gd, gi = t_scan(_t(q_enc), *(_t(a) for a in lists), *(_t(a) for a in args), 12,
                    Dist.EUCLIDEAN, j.seg_size, "f32", k_cell=3)
    assert gd.shape == (q_enc.shape[0], 12)
    np.testing.assert_array_equal(np.isinf(gd.numpy()), np.isinf(np.asarray(wd)))
    fin = np.isfinite(np.asarray(wd))
    assert np.all(np.abs(gd.numpy()[fin] - np.asarray(wd)[fin])
                  <= 1e-4 * (1.0 + np.abs(np.asarray(wd)[fin])))
    assert (gi.numpy() == np.asarray(wi)).mean() >= 0.98
    full, _ = t_scan(_t(q_enc), *(_t(a) for a in lists), *(_t(a) for a in args), 12,
                     Dist.EUCLIDEAN, j.seg_size, "f32")
    assert (full.numpy() <= gd.numpy()).all() and (full.numpy() != gd.numpy()).any()


def test_cluster_scan_roots_are_ieee():
    """F16: the cluster scan takes its square roots as the f64 root rounded
    once (``utils.dist._sqrt_f32``: IEEE, as the JAX package's and the
    card's), where torch's CPU ``sqrt`` of f32 misrounds about 0.6% of its
    inputs by an ulp. SQ8 codes under cosine have integer norms and dots,
    exact in f32; every row's squared norm here is an integer whose torch
    ``sqrt`` is off, and the distances equal the JAX scan's bit for bit."""
    rng = np.random.default_rng(5)
    ints = torch.arange(1000, 60000, dtype=torch.float32)
    off = ints[torch.sqrt(ints) != _sqrt_f32(ints)].numpy()
    n, cap, d, nq = 300, 128, 64, 12

    def row_of(norm):   # int8 codes with this squared norm, greedily
        x, left = np.zeros(d, np.int64), int(norm)
        for i in range(d):
            v = min(127, int(np.sqrt(left)))
            x[i], left = v * rng.choice((-1, 1)), left - v * v
        assert left == 0
        return x

    rows = np.stack([row_of(rng.choice(off)) for _ in range(n + cap)]).astype(np.int8)
    sn = (rows.astype(np.int64) ** 2).sum(1).astype(np.float32)
    offs, counts = np.array([0, 100, 200], np.int32), np.array([100, 100, 100], np.int32)
    cents = np.zeros((3, d), np.float32)
    lists = j_lists(np.repeat(np.arange(nq), 2), rng.integers(0, 3, 2 * nq), 3, nq)
    q = rng.integers(-127, 128, (nq, d)).astype(np.float32)
    args = (rows, sn, offs, counts, cents)
    wd, wi = j_scan(jnp.asarray(q), *(jnp.asarray(a) for a in lists),
                    *(jnp.asarray(a) for a in args), 60, JDist.COSINE, cap, "sq8")
    gd, gi = t_scan(torch.tensor(q), *(_t(a) for a in lists), *(torch.tensor(a) for a in args),
                    60, Dist.COSINE, cap, "sq8")
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert (gi.numpy() == np.asarray(wi)).mean() >= 0.98   # ties may order apart
