"""Parity of the port's task-list inversion with the JAX package's: the same
probes give identical integers, so each task row of the port is the JAX
package's row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models.kmeans import segment_layout
from annsearch_tpu.ops import probe_device as jpd
from annsearch_tpu_torch.ops import probe_device as tpd

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "nq,nprobe,nseg,s_max",
    [(1, 1, 8, 1), (7, 4, 8, 3), (25, 4, 8, 1), (25, 22, 300, 1),
     (1000, 1, 1424, 1), (30000, 22, 1424, 1), (30000, 4, 300, 3)],
)
def test_device_probe_shapes_identical(nq, nprobe, nseg, s_max):
    assert tpd.device_probe_shapes(nq, nprobe, nseg, s_max) == jpd.device_probe_shapes(
        nq, nprobe, nseg, s_max
    )


def _compare(probes: np.ndarray, nseg: int):
    nq, T = probes.shape
    maxq, R = jpd.device_probe_shapes(nq, T, nseg, 1)
    got = tpd.build_probe_lists_device(torch.as_tensor(probes), nseg, maxq, R)
    want = jpd.build_probe_lists_device(jnp.asarray(probes, jnp.int32), nseg, maxq, R)
    for name, g, w in zip(("cluster_ids", "lists", "gather_map"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    return got, (maxq, R)


def test_inversion_identical_random_probes():
    rng = np.random.default_rng(0)
    nseg, nq, T = 40, 300, 5
    probes = np.stack([rng.choice(nseg, T, replace=False) for _ in range(nq)])
    (cids, lists, gmap), (maxq, _) = _compare(probes, nseg)
    # every (query, probe) pair lands in a row of its segment, in its column
    flat = gmap.numpy()
    rows, cols = flat // maxq, flat % maxq
    assert (cids.numpy()[rows] == probes).all()
    assert (lists.numpy()[rows, cols] == np.arange(nq)[:, None]).all()


def test_inversion_identical_with_sentinel_probes():
    """Expansion sentinels (segment id nseg) become task rows of the
    sentinel segment, as in the JAX package."""
    rng = np.random.default_rng(1)
    nseg, nq, T = 16, 64, 6
    probes = rng.integers(0, nseg, (nq, T))
    probes[rng.random((nq, T)) < 0.3] = nseg
    _compare(probes, nseg)


def test_inversion_identical_on_split_cell_layout():
    """Routing to segments of a layout with split cells: duplicated
    segment centroids, nearest-first probes as the router sorts them."""
    rng = np.random.default_rng(2)
    nlist, d, nq = 6, 8, 200
    a = rng.choice(nlist, 1500, p=np.array([6, 1, 1, 3, 1, 1]) / 13)
    layout = segment_layout(a, nlist, 128)
    assert layout.nseg > nlist                      # some cells are split
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    seg_cents = cents[layout.seg_cluster]
    q = rng.standard_normal((nq, d)).astype(np.float32)
    dist = ((q[:, None, :] - seg_cents[None]) ** 2).sum(-1)
    probes = np.argsort(dist, axis=1, kind="stable")[:, :7]
    _compare(probes, layout.nseg)


def test_inversion_at_main_path_scale():
    """30k queries × 22 segment probes over 1,424 segments."""
    rng = np.random.default_rng(3)
    nseg, nq, T = 1424, 30000, 22
    w = rng.random(nseg) ** 2
    probes = np.stack(
        [rng.choice(nseg, T, replace=False, p=w / w.sum()) for _ in range(200)]
    )[rng.integers(0, 200, nq)]
    _compare(probes, nseg)


# -- the host builders of the cluster scan's task lists --------------------------


def _split_layout(seed=2):
    """A layout with split cells (up to 4 segments) and an empty cell."""
    rng = np.random.default_rng(seed)
    nlist = 7
    a = rng.choice(nlist, 1500, p=np.array([6, 1, 0, 3, 1, 1, 1]) / 13)
    layout = segment_layout(a, nlist, 128)
    spc = np.diff(layout.cluster_ptr)
    assert spc.max() >= 3 and spc.min() == 0
    return layout, nlist


@pytest.mark.parametrize("nq,nprobe", [(1, 1), (40, 3), (300, 7)])
def test_expand_probes_to_segments_identical(nq, nprobe):
    from annsearch_tpu.models.kmeans import expand_probes_to_segments as j_expand
    from annsearch_tpu_torch.models.kmeans import expand_probes_to_segments as t_expand

    layout, nlist = _split_layout()
    rng = np.random.default_rng(nq)
    probes = np.stack([rng.choice(nlist, nprobe, replace=False) for _ in range(nq)])
    want = j_expand(probes, layout)
    got = t_expand(probes, layout.cluster_ptr)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "nq,nprobe,maxq_cap",
    [(1, 1, None), (40, 3, None), (300, 7, None), (300, 7, 16), (2000, 4, 64),
     (70000, 1, None)],       # more than 2¹⁶ queries: int32 lists
)
def test_host_probe_lists_identical(nq, nprobe, maxq_cap):
    """Integer for integer, dtypes included: split and empty cells, skewed
    probes, ``maxq_cap`` chunking of popular segments."""
    from annsearch_tpu.models.kmeans import expand_probes_to_segments as j_expand
    from annsearch_tpu.ops.ivf_scan import build_probe_lists_from_pairs as j_lists
    from annsearch_tpu_torch.ops.ivf_scan import build_probe_lists_from_pairs as t_lists

    layout, nlist = _split_layout()
    rng = np.random.default_rng(nq + nprobe)
    w = np.array([8, 1, 1, 4, 1, 1, 1], float)
    probes = np.stack([rng.choice(nlist, nprobe, replace=False, p=w / w.sum())
                       for _ in range(min(nq, 500))])[rng.integers(0, min(nq, 500), nq)]
    qs, segs = j_expand(probes, layout)
    want = j_lists(qs, segs, layout.nseg, nq, maxq_cap)
    got = t_lists(qs, segs, layout.nseg, nq, maxq_cap)
    for name, g, w_ in zip(("cluster_ids", "lists", "gather_map"), got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape, name
        np.testing.assert_array_equal(g, w_, err_msg=name)
    if maxq_cap is not None:
        assert got[1].shape[1] <= maxq_cap      # popular segments are chunked
        assert len(set(got[0][got[0] < layout.nseg].tolist())) < (got[0] < layout.nseg).sum()


def test_host_probe_lists_without_tasks():
    from annsearch_tpu.ops.ivf_scan import build_probe_lists_from_pairs as j_lists
    from annsearch_tpu_torch.ops.ivf_scan import build_probe_lists_from_pairs as t_lists

    empty = np.zeros(0, np.int32)
    for g, w in zip(t_lists(empty, empty, 5, 3), j_lists(empty, empty, 5, 3)):
        np.testing.assert_array_equal(g, w)
