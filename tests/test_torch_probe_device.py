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
