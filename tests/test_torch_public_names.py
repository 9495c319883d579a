"""Every module of the JAX package that declares ``__all__`` has its
counterpart in the port, whose ``__all__`` holds the JAX one's names,
``parallel`` included (its ``__all__`` is the JAX one, in order), except
what ROADMAP's "Not to port" list leaves out: the Pallas kernel modules
(their kernels are ``csrc/``), the bf16 and packed layouts of the TPU walk
and rerank, and the jnp dtype table. The two benchmark metrics the port
gained run the JAX package's cases (``tests/test_data_metrics.py``) on
both packages."""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

import annsearch_tpu as ja
import annsearch_tpu_torch as ta

#: modules of the JAX package with no counterpart (ROADMAP, not to port)
NOT_PORTED_MODULES = {"ops.flat_scan_pallas", "ops.ivf_scan_pallas"}
#: names of JAX ``__all__`` lists with no counterpart (ROADMAP, not to port)
NOT_PORTED_NAMES = {
    "models.base": {"DTYPE_BYTES"},
    "ops.graph": {"nav_hl_split", "pack_neighbor_table", "neighbor_pack_bytes"},
    "ops.rerank": {"rerank_exact_split"},
}


def _modules(pkg) -> dict[str, object]:
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[info.name[len(pkg.__name__) + 1:]] = importlib.import_module(info.name)
    return out


JAX_MODULES = {name: mod for name, mod in _modules(ja).items() if hasattr(mod, "__all__")}


def test_the_walk_reads_every_subpackage():
    assert {"", "models", "models.quantised", "models.binary", "ops", "utils",
            "parallel"} <= set(JAX_MODULES)
    assert len(JAX_MODULES) >= 35


@pytest.mark.parametrize("name", sorted(JAX_MODULES), ids=lambda n: n or "root")
def test_the_port_holds_the_jax_public_names(name):
    if name in NOT_PORTED_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module(f"annsearch_tpu_torch.{name}")
        return
    tmod = importlib.import_module(f"annsearch_tpu_torch.{name}" if name else "annsearch_tpu_torch")
    want = [n for n in JAX_MODULES[name].__all__ if n not in NOT_PORTED_NAMES.get(name, ())]
    missing = [n for n in want if n not in getattr(tmod, "__all__", ()) or not hasattr(tmod, n)]
    assert not missing, f"{name or 'root'} lacks {missing}"


def test_parallel_all_is_the_jax_list():
    import annsearch_tpu.parallel as jpar
    import annsearch_tpu_torch.parallel as tpar

    assert tpar.__all__ == jpar.__all__ and len(tpar.__all__) == 15


def test_mean_distance_ratio_on_both_packages():
    from annsearch_tpu.utils.metrics import calculate_mean_distance_ratio as jratio
    from annsearch_tpu_torch.utils import calculate_mean_distance_ratio as tratio

    true = np.array([[1.0, 2.0], [1.0, 1.0]])
    approx = np.array([[1.5, 2.5], [1.0, 1.0]])
    for fn in (jratio, tratio):
        assert abs(fn(true, approx, 2) - ((4.0 / 3.0) + 1.0) / 2) < 1e-9
    assert tratio(torch.as_tensor(true), torch.as_tensor(approx), 2) == jratio(true, approx, 2)
    zero = np.zeros((2, 2))
    assert np.isnan(tratio(zero, approx, 2)) and np.isnan(jratio(zero, approx, 2))


def test_cluster_purity_on_both_packages():
    from annsearch_tpu.utils.metrics import calculate_cluster_purity as jpurity
    from annsearch_tpu_torch.utils import calculate_cluster_purity as tpurity

    knn = np.array([[0, 1], [0, 2], [3, 0]])
    labels = np.array([0, 0, 0, 1])
    for fn in (jpurity, tpurity):
        assert abs(fn(knn, labels) - (1 + 1 + 0.5) / 3) < 1e-9
    rng = np.random.default_rng(0)
    g, lab = rng.integers(0, 50, (40, 7)), rng.integers(0, 4, 50)
    assert tpurity(torch.as_tensor(g), torch.as_tensor(lab)) == pytest.approx(jpurity(g, lab))


def test_binariser_state_and_store_file_size(tmp_path):
    from annsearch_tpu_torch.models.binary import Binariser, MmapVectorStore

    b = Binariser.from_state(64, "simhash", projections=np.ones((8, 64), np.float32),
                             device="cpu")
    st = b.state()
    assert st["n_bits"] == 64 and st["mode"] == "simhash" and "mean" not in st
    again = Binariser.from_state(**st, device="cpu")
    assert torch.equal(again.projections, b.projections)
    store = MmapVectorStore.write(str(tmp_path / "rows"), np.zeros((10, 4), np.float32),
                                  device="cpu")
    assert store.file_size_bytes() == 10 * 4 * 4
