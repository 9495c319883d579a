"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present. On a
machine with a card and without JAX, run them with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(``tests/conftest.py`` configures JAX for the rest of the suite). Distances
agree within 1e-4·(1 + |d|) (the f32 dot sums run in another order) and
≥ 99.9% of ids agree (orders can swap near-ties); end to end, where
routing also runs on another device, ≥ 99% of ids."""

import numpy as np
import pytest
import torch

from annsearch_tpu_torch.ops import ivf_scan_fused as tsf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


def _tasks(gen, dev, R=96, maxq=64, seg=512, d=128, nseg=12, nq=300):
    """Sentinel rows (cnt 0), partial rows (cnt below and above kb), pad
    query slots."""
    cells = torch.randint(-127, 128, (nseg + 1, seg, -(-d // 16) * 16),
                          generator=gen, device=dev, dtype=torch.int8)
    cells[:, :, d:] = 0
    cells[-1] = 0
    scales = torch.rand(d, generator=gen, device=dev) * 0.02 + 0.005
    sn = ((cells[:, :, :d].float() * scales) ** 2).sum(-1)
    queries = torch.randn(nq + 1, d, generator=gen, device=dev)
    queries[-1] = 0
    cents = torch.randn(nseg + 1, d, generator=gen, device=dev) * 0.3
    cents[-1] = 0
    task_seg = torch.randint(0, nseg, (R,), generator=gen, device=dev)
    cnt = torch.full((R,), seg, device=dev)
    cnt[1::5] = torch.randint(1, seg, (len(range(1, R, 5)),), generator=gen, device=dev)
    cnt[2] = 5
    cnt[3::7] = 0
    task_seg[3::7] = nseg
    lists = torch.randint(0, nq + 1, (R, maxq), generator=gen, device=dev)
    return (lists.int(), task_seg.int(), cnt.int(), queries, cents, scales, cells, sn)


def _assert_close(kd, ki, pd, pi):
    torch.cuda.synchronize()
    assert torch.all((kd - pd).abs() <= 1e-4 * (1.0 + pd.abs()))
    assert (ki == pi).float().mean().item() >= 0.999


@pytest.mark.parametrize(
    "shape,kb",
    [
        (dict(), 16),
        (dict(maxq=36), 8),                 # slots past maxq in the last block
        (dict(d=40), 16),                   # columns padded to 48
        (dict(seg=128, maxq=32), 128),      # one chunk, kb = 128
        (dict(R=384, maxq=256, seg=1024), 16),   # main-path shapes
    ],
)
def test_k1a_matches_plain(dev, shape, kb):
    gen = torch.Generator(device=dev).manual_seed(0)
    args = _tasks(gen, dev, **shape)
    kd, ki = tsf.ivf_cell_scan(*args, kb)
    pd, pi = tsf.ivf_cell_scan_plain(*args, kb)
    _assert_close(kd, ki, pd, pi)
    cnt = args[2]
    assert (kd[cnt == 0] == np.float32(3e38)).all() and (ki[cnt == 0] == 0).all()


def test_k1a_counts_its_launches(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    args = _tasks(gen, dev, R=8)
    before = tsf.ivf_cell_scan.launches
    tsf.ivf_cell_scan(*args, 16)
    tsf.ivf_cell_scan_plain(*args, 16)
    assert tsf.ivf_cell_scan.launches == before + 1


def test_k1a_rejects_what_it_cannot_take(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    args = list(_tasks(gen, dev, R=8))
    bad_dtype = args.copy()
    bad_dtype[6] = args[6].float()
    with pytest.raises(ValueError, match="cells"):
        tsf.ivf_cell_scan(*bad_dtype, 16)
    strided = args.copy()
    strided[0] = torch.cat([args[0], args[0]], 1)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tsf.ivf_cell_scan(*strided, 16)
    with pytest.raises(ValueError, match="kb"):
        tsf.ivf_cell_scan(*args, 129)
    mixed = args.copy()
    mixed[3] = args[3].cpu()
    with pytest.raises(ValueError, match="queries_x"):
        tsf.ivf_cell_scan(*mixed, 16)


def test_main_path_on_the_card_matches_the_cpu(dev, tmp_path):
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.models.quantised.ivf import IvfPqIndex
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    # scaled by 1/8: near a match, qadd + sn − 2·dots cancels, and its f32
    # rounding (different on the two devices) grows with the norms
    x, _ = generate_clustered_data(20000, 128, 20, seed=5)
    q = subsample_with_noise(x, 500, seed=5) * np.float32(0.125)
    x = x * np.float32(0.125)
    cpu = at.build_ivf_pq_index(x, nlist=32, m=128, seed=1, device="cpu")
    path = str(tmp_path / "ivfpq.npz")
    cpu.save(path)
    gpu = IvfPqIndex.load(path, device=dev)
    before = tsf.ivf_cell_scan.launches
    gi, gd = gpu.query(q, 10, nprobe=6, approx=True)
    assert tsf.ivf_cell_scan.launches == before + 1
    ci, cd = cpu.query(q, 10, nprobe=6, approx=True)
    # routing and scan sums run in other orders on the two devices
    assert (gi.cpu() == ci).float().mean().item() >= 0.99
    same = gi.cpu() == ci
    assert torch.all((gd.cpu() - cd).abs()[same] <= 1e-4 * (1.0 + cd.abs()[same]))
