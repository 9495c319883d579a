"""Parity of the port's cluster → segment probe expansion with the JAX
package's: the dense expansion (``expand_probes_device``) and the compact
pair lists (``route_pair_stats`` → ``compact_probe_shapes`` →
``build_probe_lists_compact``) give identical integers for identical
probes, on a layout with split cells and empty cells."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models.kmeans import segment_layout
from annsearch_tpu.ops import probe_device as jpd
from annsearch_tpu_torch.ops import probe_device as tpd

torch.set_num_threads(2)


def _layout(seed, nlist=12, n=3000):
    """Skewed cells: some split into several 128-row segments, at least two
    empty (they own no segment)."""
    rng = np.random.default_rng(seed)
    w = rng.random(nlist) ** 3
    w[[3, 7]] = 0
    a = rng.choice(nlist, n, p=w / w.sum())
    layout = segment_layout(a, nlist, 128)
    ptr = np.asarray(layout.cluster_ptr)
    assert np.diff(ptr).max() > 1 and (np.diff(ptr) == 0).sum() >= 2
    return layout, ptr


def _probes(rng, nq, nprobe, nlist):
    return np.stack([rng.choice(nlist, nprobe, replace=False) for _ in range(nq)])


def _assert_identical(got, want, names):
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("seed,nq,nprobe", [(0, 40, 3), (1, 1, 12), (2, 200, 5)])
def test_dense_expansion_identical(seed, nq, nprobe):
    layout, ptr = _layout(seed)
    rng = np.random.default_rng(seed + 10)
    probes = _probes(rng, nq, nprobe, len(ptr) - 1)
    s_max = int(np.diff(ptr).max())
    got = tpd.expand_probes_device(torch.as_tensor(probes), torch.as_tensor(ptr),
                                   s_max, layout.nseg)
    want = jpd.expand_probes_device(jnp.asarray(probes, jnp.int32),
                                    jnp.asarray(ptr, jnp.int32), s_max, layout.nseg)
    _assert_identical([got], [want], ["seg_probes"])
    # and the dense inversion of it, as the exact tier runs it
    maxq, R = jpd.device_probe_shapes(nq, nprobe, layout.nseg, s_max)
    _assert_identical(
        tpd.build_probe_lists_device(got, layout.nseg, maxq, R),
        jpd.build_probe_lists_device(want, layout.nseg, maxq, R),
        ("cluster_ids", "lists", "gather_map"),
    )


@pytest.mark.parametrize(
    "total,qmax,nseg",
    [(0, 0, 8), (1, 1, 8), (97, 13, 40), (5000, 60, 300), (330_000, 130, 520),
     (20_000_000, 2000, 1424)],
)
def test_compact_probe_shapes_identical(total, qmax, nseg):
    assert tpd.compact_probe_shapes(total, qmax, nseg) == jpd.compact_probe_shapes(
        total, qmax, nseg
    )


@pytest.mark.parametrize("seed,nq,nprobe", [(0, 40, 3), (1, 1, 12), (2, 200, 5), (3, 64, 1)])
def test_compact_lists_identical(seed, nq, nprobe):
    layout, ptr = _layout(seed)
    rng = np.random.default_rng(seed + 20)
    probes = _probes(rng, nq, nprobe, len(ptr) - 1)
    tp, tptr = torch.as_tensor(probes), torch.as_tensor(ptr)
    jp, jptr = jnp.asarray(probes, jnp.int32), jnp.asarray(ptr, jnp.int32)

    stats = tpd.route_pair_stats(tp, tptr)
    _assert_identical([stats], [jpd.route_pair_stats(jp, jptr)], ["stats"])
    total, qmax = stats.tolist()
    shapes = tpd.compact_probe_shapes(total, qmax, layout.nseg)
    P, T_g, maxq, R = shapes
    got = tpd.build_probe_lists_compact(tp, tptr, P, T_g, layout.nseg, maxq, R)
    want = jpd.build_probe_lists_compact(jp, jptr, P, T_g, layout.nseg, maxq, R)
    _assert_identical(got, want, ("cluster_ids", "lists", "gather_map"))

    # every real pair lands in a row of its segment, in its query's column
    cids, lists, gmap = (t.numpy() for t in got)
    for qi in range(nq):
        segs = np.concatenate([np.arange(ptr[c], ptr[c + 1]) for c in probes[qi]])
        lanes = gmap[qi, : len(segs)]
        assert (gmap[qi, len(segs):] == -1).all()
        np.testing.assert_array_equal(cids[lanes // maxq], segs)
        assert (lists[lanes // maxq, lanes % maxq] == qi).all()
