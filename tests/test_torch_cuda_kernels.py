"""The port's CUDA kernels (K1a, K1b-l2, K1b-cos, K1d-i8dec, K1c-f32,
K1d-f32, K1c-bf16, K1d-bf16, K1c-sq8, K1d-sq8, their fold-1 and wide-row
instances, K1-exact-i8, K1a-bf16, K1-bf16-decode and K2, its wide rows
included) against their plain PyTorch
versions, on the card, and the IVF, graph, HNSW, Vamana, tree, LSH, kMkNN,
flat quantised and binary paths on the card against the CPU. The kernels sum bf16 cross terms of a mantissa split on the tensor
cores (int8 products in int32 for sq8); the cases cover each variant's term
count, and rows whose query terms are held whole or come a stage at a time.

Marked ``cuda``: each test skips where no CUDA device is present. On a
machine with a card and without JAX, run them with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(``tests/conftest.py`` configures JAX for the rest of the suite). Distances
agree within 1e-4·(1 + |d|) (the tensor cores and the plain version's f32
matmul sum the same products in other orders) and
≥ 99.9% of ids agree (orders can swap near-ties); end to end, where
routing also runs on another device, ≥ 99% of ids. The sq8 kernels agree
bit for bit: their dots are sums of integers below 2²⁴, and their square
roots and quotients IEEE-rounded on both sides. The fold's selection (a
sort network in registers) equals the plain version's kb rounds bit for
bit on exact integer distances, their (3e38, m) tail included."""

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
        (dict(R=16, maxq=40, seg=256, d=1280), 16),   # query terms per column block
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


def _f32_tasks(gen, dev, R=96, maxq=64, seg=512, d=128, nseg=12, nq=300):
    """f32 cells (padded to 16 columns), sentinel rows (cnt 0), rows shorter
    than kb, partial rows, pad query slots."""
    dp = -(-d // 16) * 16
    cells = torch.zeros((nseg + 1, seg, dp), device=dev)
    cells[:-1, :, :d] = torch.randn((nseg, seg, d), generator=gen, device=dev)
    sn = (cells * cells).sum(-1)
    queries = torch.randn(nq + 1, d, generator=gen, device=dev)
    queries[-1] = 0
    task_seg = torch.randint(0, nseg, (R,), generator=gen, device=dev)
    cnt = torch.full((R,), seg, device=dev)
    cnt[1::5] = torch.randint(1, seg, (len(range(1, R, 5)),), generator=gen, device=dev)
    cnt[2] = 5
    cnt[3::7] = 0
    task_seg[3::7] = nseg
    lists = torch.randint(0, nq + 1, (R, maxq), generator=gen, device=dev)
    return (lists.int(), task_seg.int(), cnt.int(), queries, cells, sn)


@pytest.mark.parametrize("exact", [True, False], ids=["K1c-f32", "K1d-f32"])
@pytest.mark.parametrize("cosine", [False, True], ids=["l2", "cos_plain"])
@pytest.mark.parametrize(
    "shape,kb",
    [
        (dict(), 24),
        (dict(maxq=36, d=64), 16),          # slots past maxq in the last block
        (dict(d=40), 8),                    # columns padded to 48
        (dict(seg=128, maxq=32), 128),      # one chunk, kb = 128
        (dict(R=256, maxq=256, seg=1024, d=64), 24),   # the exact tier's shapes
        (dict(R=64, maxq=64, seg=2048, d=384), 16),    # twelve column blocks
        (dict(R=32, maxq=40, seg=256, d=512), 16),     # query terms per column block
    ],
)
def test_f32_kernels_match_plain(dev, shape, kb, cosine, exact):
    gen = torch.Generator(device=dev).manual_seed(3)
    args = _f32_tasks(gen, dev, **shape)
    wrapper = tsf.ivf_cell_scan_f32_exact if exact else tsf.ivf_cell_scan_f32_fold
    kd, ki = wrapper(*args, kb, cosine=cosine)
    pd, pi = tsf.ivf_cell_scan_f32_plain(*args, kb, cosine, exact=exact)
    _assert_close(kd, ki, pd, pi)
    cnt = args[2]
    assert (kd[cnt == 0] == np.float32(3e38)).all() and (ki[cnt == 0] == 0).all()
    if exact:   # sentinel entries agree exactly: (3e38, lane 0) past cnt
        assert (kd[2, :, 5:] == np.float32(3e38)).all() and (ki[2, :, 5:] == 0).all()
        assert torch.equal(kd == np.float32(3e38), pd == np.float32(3e38))


def test_f32_kernels_count_and_reject(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    args = list(_f32_tasks(gen, dev, R=8))
    for wrapper in (tsf.ivf_cell_scan_f32_exact, tsf.ivf_cell_scan_f32_fold):
        before = wrapper.launches
        wrapper(*args, 16)
        assert wrapper.launches == before + 1
        bad = args.copy()
        bad[4] = args[4].to(torch.int8)
        with pytest.raises(ValueError, match="cells"):
            wrapper(*bad, 16)
        with pytest.raises(ValueError, match="kb"):
            wrapper(*args, 129)


def test_kmeans_builds_agree_on_the_card(dev):
    from annsearch_tpu_torch.models import kmeans
    from annsearch_tpu_torch.utils.data import generate_clustered_data

    x, _ = generate_clustered_data(100_000, 64, 50, seed=6)
    xt = torch.as_tensor(x, device=dev)
    a = kmeans.train_centroids(xt, 256, seed=3, max_iters=10)
    b = kmeans.train_centroids(xt, 256, seed=3, max_iters=10)
    assert torch.equal(a, b)


def test_ivf_f32_on_the_card_matches_the_cpu(dev, tmp_path):
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.models.ivf import IvfIndex
    from annsearch_tpu_torch.utils.data import generate_data

    # scaled by 1/8, as in the IVF-PQ test: the approximate tier's distances
    # come from the ‖q‖² + ‖x‖² − 2q·x identity, whose f32 rounding grows
    # with the norms
    x, _ = generate_data("lowrank", 20000, 64, 12, seed=5, intrinsic_dim=16)
    x = x * np.float32(0.125)
    q = x[:300] + np.float32(0.05 / 8)
    cpu = at.build_ivf_index(x, nlist=40, seed=1, device="cpu")
    path = str(tmp_path / "ivf.npz")
    cpu.save(path)
    gpu = IvfIndex.load(path, device=dev)
    assert gpu._seg_s_max() > 1                       # the compact path runs
    for kw, wrapper in ((dict(nprobe=4), tsf.ivf_cell_scan_f32_exact),
                        (dict(nprobe=4, approx=True), tsf.ivf_cell_scan_f32_fold),
                        (dict(nprobe=1, certify=True), tsf.ivf_cell_scan_f32_exact)):
        before = wrapper.launches
        gi, gd = gpu.query(q, 15, **kw)
        assert wrapper.launches > before
        ci, cd = cpu.query(q, 15, **kw)
        assert (gi.cpu() == ci).float().mean().item() >= 0.99
        same = gi.cpu() == ci
        assert torch.all((gd.cpu() - cd).abs()[same] <= 1e-4 * (1.0 + cd.abs()[same]))


def _quant_tasks(gen, dev, mode, R=96, maxq=64, seg=512, d=128, nseg=12, nq=300):
    """bf16 cells (random normal) or int8 cells and int8 query codes (as
    f32), with the task layout of :func:`_f32_tasks`."""
    lists, task_seg, cnt, queries, cells, _ = _f32_tasks(gen, dev, R, maxq, seg, d, nseg, nq)
    if mode == "sq8":
        codes = torch.randint(-128, 128, cells.shape, generator=gen, device=dev,
                              dtype=torch.int8)
        codes[:, :, d:] = 0
        codes[-1] = 0
        cells = codes
        queries = torch.randint(-128, 128, queries.shape, generator=gen, device=dev).float()
        queries[-1] = 0
    else:
        cells = cells.to(torch.bfloat16)
    return lists, task_seg, cnt, queries, cells, (cells.float() ** 2).sum(-1)


@pytest.mark.parametrize("mode", ["bf16", "sq8"])
@pytest.mark.parametrize("exact", [True, False], ids=["K1c", "K1d"])
@pytest.mark.parametrize("cosine", [False, True], ids=["l2", "cos"])
@pytest.mark.parametrize(
    "shape,kb",
    [
        (dict(), 16),
        (dict(maxq=36, d=40), 8),           # slots past maxq; columns padded to 48
        (dict(seg=128, maxq=32), 128),      # one chunk, kb = 128
        (dict(R=128, maxq=256, seg=1024, d=256), 24),   # the 1M × 256d shapes
        (dict(R=32, maxq=40, seg=256, d=1000), 16),     # 8 to 16 column blocks
        (dict(R=16, maxq=40, seg=256, d=1920), 16),     # query terms per column block
    ],
)
def test_quantised_kernels_match_plain(dev, shape, kb, cosine, exact, mode):
    gen = torch.Generator(device=dev).manual_seed(5)
    args = _quant_tasks(gen, dev, mode, **shape)
    wrapper = getattr(tsf, f"ivf_cell_scan_{mode}_{'exact' if exact else 'fold'}")
    plain = getattr(tsf, f"ivf_cell_scan_{mode}_plain")
    kd, ki = wrapper(*args, kb, cosine=cosine)
    pd, pi = plain(*args, kb, cosine, exact=exact)
    torch.cuda.synchronize()
    if mode == "sq8":
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
    else:
        _assert_close(kd, ki, pd, pi)
    cnt = args[2]
    assert (kd[cnt == 0] == np.float32(3e38)).all() and (ki[cnt == 0] == 0).all()
    assert torch.equal(kd == np.float32(3e38), pd == np.float32(3e38))


@pytest.mark.parametrize("kind", ["bf16", "sq8"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_quantised_tiers_launch_only_their_kernel(dev, tmp_path, kind, metric):
    """Each tier of IvfIndexBf16 / IvfSq8Index launches its own kernel once
    per batch and no other, and answers as the same index on the CPU."""
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.models.quantised import ivf as qivf
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 96, 20, seed=7)
    q = subsample_with_noise(x, 400, seed=7)
    cpu = getattr(at, f"build_ivf_{kind}_index")(x, nlist=32, dist_metric=metric, seed=1,
                                                  device="cpu")
    # the approximate tier's distances come from the ‖q‖² + ‖x‖² − 2q·x
    # identity: f32 sums of d = 96 terms in another order differ by up to
    # about d ulps of its terms, 2⁻¹⁶ of ‖q‖² + max‖x‖², however small the
    # distance (as chip_smoke.py's kernel checks allow)
    scale = 0.0
    if metric == "euclidean":
        scale = torch.as_tensor((q * q).sum(1) + (x * x).sum(1).max())[:, None] * 2.0 ** -16
    path = str(tmp_path / f"{kind}.npz")
    cpu.save(path)
    gpu = (qivf.IvfIndexBf16 if kind == "bf16" else qivf.IvfSq8Index).load(path, device=dev)
    names = [f"ivf_cell_scan_{m}_{s}" for m in ("f32", "bf16", "sq8") for s in ("exact", "fold")]
    names.append("ivf_cell_scan")
    for approx, own in ((False, f"ivf_cell_scan_{kind}_exact"), (True, f"ivf_cell_scan_{kind}_fold")):
        before = {n: getattr(tsf, n).launches for n in names}
        gi, gd = gpu.query(q, 10, nprobe=4, approx=approx)
        after = {n: getattr(tsf, n).launches for n in names}
        assert {n for n in names if after[n] != before[n]} == {own}
        assert after[own] == before[own] + 1
        ci, cd = cpu.query(q, 10, nprobe=4, approx=approx)
        assert (gi.cpu() == ci).float().mean().item() >= 0.99
        same = gi.cpu() == ci
        if kind == "sq8" and metric == "euclidean":
            assert torch.equal(gd.cpu()[same], cd[same])
        else:
            tol = 1e-4 * (1.0 + cd.abs()) + scale
            assert torch.all((gd.cpu() - cd).abs()[same] <= tol[same])


# -- K1b-l2, K1b-cos, K1d-i8dec and the IVF-PQ / IVF-OPQ tiers --------------------

I8_VARIANTS = [
    # (wrapper, its keywords, the plain version's keywords, takes cent_x)
    ("ivf_cell_scan_split", {}, {"q_split": True}, True),
    ("ivf_cell_scan_cos", {"q_split": False}, {"cosine": True, "q_split": False}, True),
    ("ivf_cell_scan_cos", {"q_split": True}, {"cosine": True, "q_split": True}, True),
    ("ivf_cell_scan_i8dec", {"cosine": False, "q_split": False},
     {"cosine": False, "q_split": False}, False),
    ("ivf_cell_scan_i8dec", {"cosine": False, "q_split": True},
     {"cosine": False, "q_split": True}, False),
    ("ivf_cell_scan_i8dec", {"cosine": True, "q_split": False},
     {"cosine": True, "q_split": False}, False),
    ("ivf_cell_scan_i8dec", {"cosine": True, "q_split": True},
     {"cosine": True, "q_split": True}, False),
]
I8_IDS = ["K1b-l2", "K1b-cos-nq_t1", "K1b-cos-nq_t2", "K1d-i8dec-l2-nq_t1",
          "K1d-i8dec-l2-nq_t2", "K1d-i8dec-cos-nq_t1", "K1d-i8dec-cos-nq_t2"]


def _i8_args(gen, dev, cosine, cents, **shape):
    """K1a's task inputs; under cosine unit queries and sn = ‖c + dec‖²."""
    lists, task_seg, cnt, queries, cent_x, scales, cells, sn = _tasks(gen, dev, **shape)
    if cosine:
        queries = queries / queries.norm(dim=1, keepdim=True).clamp_min(1e-30)
        d = queries.shape[1]
        dec = cells[:, :, :d].float() * scales
        if cents:
            dec = dec + cent_x[:, None, :]
        sn = (dec * dec).sum(-1)
    return [lists, task_seg, cnt, queries, cent_x, scales, cells, sn]


@pytest.mark.parametrize("wrapper,kw,plain_kw,cents", I8_VARIANTS, ids=I8_IDS)
@pytest.mark.parametrize(
    "shape,kb",
    [
        (dict(), 16),
        (dict(maxq=36, d=40), 8),           # slots past maxq; columns padded to 48
        (dict(seg=128, maxq=32), 128),      # one chunk, kb = 128
        (dict(R=384, maxq=256, seg=1024), 16),   # main-path shapes
        (dict(R=16, maxq=40, seg=256, d=640), 16),   # two terms: per column block
    ],
)
def test_i8dec_kernels_match_plain(dev, shape, kb, wrapper, kw, plain_kw, cents):
    gen = torch.Generator(device=dev).manual_seed(6)
    args = _i8_args(gen, dev, plain_kw.get("cosine", False), cents, **shape)
    plain_args = list(args)
    if not cents:
        plain_args[4] = None
        del args[4]
    fn = getattr(tsf, wrapper)
    before = fn.launches
    kd, ki = fn(*args, kb, **kw)
    assert fn.launches == before + 1
    pd, pi = tsf.ivf_cell_scan_plain(*plain_args, kb, **plain_kw)
    _assert_close(kd, ki, pd, pi)
    cnt = args[2]
    assert (kd[cnt == 0] == np.float32(3e38)).all() and (ki[cnt == 0] == 0).all()
    assert torch.equal(kd == np.float32(3e38), pd == np.float32(3e38))


def test_i8dec_kernels_reject_what_they_cannot_take(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    args = _i8_args(gen, dev, False, True, R=8)
    bad = list(args)
    bad[6] = args[6].float()
    for fn in (tsf.ivf_cell_scan_split, tsf.ivf_cell_scan_cos):
        with pytest.raises(ValueError, match="cells"):
            fn(*bad, 16)
        with pytest.raises(ValueError, match="kb"):
            fn(*args, 129)
    no_cent = args[:4] + args[5:]
    with pytest.raises(ValueError, match="scales"):
        tsf.ivf_cell_scan_i8dec(*no_cent[:4], no_cent[4][:-1].contiguous(), *no_cent[5:], 16)


FUSED = ["ivf_cell_scan", "ivf_cell_scan_split", "ivf_cell_scan_cos", "ivf_cell_scan_i8dec",
         "ivf_cell_scan_bf16_residual"] + [
    f"ivf_cell_scan_{m}_{s}" for m in ("f32", "bf16", "sq8") for s in ("exact", "fold")]


@pytest.mark.parametrize("kind", ["pq", "opq"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_ivf_pq_tiers_launch_only_their_kernel(dev, tmp_path, kind, metric):
    """m = dim: each approximate query launches its own kernel once (K1a,
    K1b-l2 or K1b-cos) and no other; the exact tier launches none (the
    cluster scan); all answer as the same index on the CPU."""
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.models.quantised import ivf as qivf
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 128, 20, seed=5)
    q = subsample_with_noise(x, 500, seed=5) * np.float32(0.125)
    x = x * np.float32(0.125)
    cpu = getattr(at, f"build_ivf_{kind}_index")(x, nlist=32, m=128, dist_metric=metric,
                                                 seed=1, device="cpu")
    path = str(tmp_path / "index.npz")
    cpu.save(path)
    gpu = (qivf.IvfPqIndex if kind == "pq" else qivf.IvfOpqIndex).load(path, device=dev)
    cos = metric == "cosine"
    for kw, own in ((dict(approx=True), "ivf_cell_scan_cos" if cos else "ivf_cell_scan"),
                    (dict(approx=True, q_split=True),
                     "ivf_cell_scan_cos" if cos else "ivf_cell_scan_split"),
                    (dict(), None)):
        before = {n: getattr(tsf, n).launches for n in FUSED}
        gi, gd = gpu.query(q, 10, nprobe=6, **kw)
        after = {n: getattr(tsf, n).launches for n in FUSED}
        assert {n for n in FUSED if after[n] != before[n]} == ({own} if own else set())
        if own:
            assert after[own] == before[own] + 1
        ci, cd = cpu.query(q, 10, nprobe=6, **kw)
        assert (gi.cpu() == ci).float().mean().item() >= 0.99
        same = gi.cpu() == ci
        # OPQ rotates the queries with a matmul, whose f32 sums differ by an
        # ulp between the devices; where such a value sits on a bf16 rounding
        # boundary the one-term query flips by a whole bf16 step (2⁻⁸
        # relative), so that tier is held to 2⁻⁸·(1 + |d|)
        rel = 2.0 ** -8 if kind == "opq" and kw == dict(approx=True) else 1e-4
        assert torch.all((gd.cpu() - cd).abs()[same] <= rel * (1.0 + cd.abs()[same]))


@pytest.mark.parametrize("kind,m", [("pq", 32), ("opq", 16)])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_pq_residual_on_the_card_matches_the_cpu(dev, tmp_path, kind, m, metric):
    """m ≠ dim: the cluster scan on the card (no fused launch) against the
    CPU, on one saved index."""
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.models.quantised import ivf as qivf
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 128, 20, seed=8)
    q = subsample_with_noise(x, 500, seed=8) * np.float32(0.125)
    x = x * np.float32(0.125)
    cpu = getattr(at, f"build_ivf_{kind}_index")(x, nlist=32, m=m, dist_metric=metric,
                                                 seed=1, device="cpu")
    path = str(tmp_path / "index.npz")
    cpu.save(path)
    gpu = (qivf.IvfPqIndex if kind == "pq" else qivf.IvfOpqIndex).load(path, device=dev)
    before = {n: getattr(tsf, n).launches for n in FUSED}
    gi, gd = gpu.query(q, 10, nprobe=6)
    assert {n: getattr(tsf, n).launches for n in FUSED} == before
    ci, cd = cpu.query(q, 10, nprobe=6)
    assert (gi.cpu() == ci).float().mean().item() >= 0.99
    same = gi.cpu() == ci
    assert torch.all((gd.cpu() - cd).abs()[same] <= 1e-4 * (1.0 + cd.abs()[same]))
    # built on the card itself, the index answers with a like recall
    own = getattr(at, f"build_ivf_{kind}_index")(x, nlist=32, m=m, dist_metric=metric,
                                                 seed=1, device=dev)
    ti, _ = at.build_exhaustive_index(x, metric, device=dev).query(q, 10)
    r_own = at.calculate_recall(ti, own.query(q, 10, nprobe=6)[0], 10)
    r_cpu = at.calculate_recall(ti, gi, 10)
    assert abs(r_own - r_cpu) <= 0.05, (r_own, r_cpu)


# -- K2, the fused flat top-k ---------------------------------------------------


def _flat_inputs(gen, dev, nq, n, d, grid, cosine):
    if grid:     # multiples of 1/8: every product and sum exact in f32 and bf16
        q = torch.randint(-16, 17, (nq, d), generator=gen, device=dev).float() / 8
        x = torch.randint(-16, 17, (n, d), generator=gen, device=dev).float() / 8
        return q, x
    q = torch.randn(nq, d, generator=gen, device=dev)
    x = torch.randn(n, d, generator=gen, device=dev)
    if cosine:
        q, x = q / q.norm(dim=1, keepdim=True), x / x.norm(dim=1, keepdim=True)
    return q, x


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("nq,n,d,k,cosine,passes,depth,n_valid,block_db", [
    (50, 700, 32, 10, False, 6, 2, None, 128),      # the JAX test's shapes
    (50, 700, 32, 10, True, 3, 2, None, 128),
    (50, 700, 32, 10, False, 1, 1, None, 128),
    (10, 150, 32, 5, False, 3, 2, 100, 128),        # n_valid short of n
    (4, 40, 32, 20, False, 3, 2, None, 128),        # k past the rows, n < 128
    (300, 5000, 100, 10, True, 1, 1, 4500, 2048),   # d no multiple of 32
    (129, 3001, 30, 8, False, 6, 2, None, 2048),    # d no multiple of 4: padded
    (1000, 50000, 128, 60, True, 6, 2, None, 2048), # kb 64
    (200, 20000, 512, 8, False, 6, 2, None, 2048),  # the wide scan (query terms a stage at a time)
    (200, 20000, 512, 8, True, 3, 1, None, 2048),   # two terms, wide
    (300, 5000, 64, 10, False, 1, 2, None, 2048),   # one term, depth 2
    (1000, 50000, 128, 16, False, 3, 2, 49000, 2048),
    (4097, 200001, 32, 15, False, 6, 2, 199990, 2048),
    (65, 14341, 32, 10, False, 1, 2, None, 2048),   # nq past 64; 8 tiles in stages of 7
    (191, 14341, 32, 10, True, 1, 1, 9000, 2048),   # n_valid inside a stage
    (300, 30001, 64, 10, False, 6, 2, 29999, 2048), # two chunks a tile, k16 steps by ldmatrix
    (200, 20000, 512, 8, False, 1, 2, None, 2048),  # one term at d 512: wgmma, two stages
    (200, 20000, 160, 8, False, 3, 2, None, 2048),  # two terms at d 160: three stages
    (200, 20000, 160, 8, True, 6, 1, None, 2048),   # the narrowest wide rows, three terms
    (300, 9000, 32, 100, False, 6, 1, None, 128),   # kb 128, depth 1 (B 128)
    (300, 9000, 32, 100, False, 3, 2, 8000, 128),   # kb 128, depth 2
    (129, 30000, 32, 40, True, 6, 2, None, 2048),   # kb 64
    # the wide scan at the embedding widths: n_valid inside a tile, kb 16 /
    # 64 / 128, a unit of tiles cut by the database's end, nq short of a block
    (300, 20000, 256, 16, False, 6, 2, 19_990, 2048),
    (300, 20000, 256, 60, True, 6, 1, None, 2048),
    (200, 20000, 384, 100, False, 6, 2, 15_000, 2048),
    (200, 20000, 384, 16, True, 3, 1, 18_001, 2048),
    (200, 20000, 768, 16, True, 3, 2, None, 2048),
    (200, 20000, 768, 60, False, 6, 2, 19_999, 2048),
    (200, 12000, 960, 60, False, 6, 2, 11_111, 2048),
    (200, 20000, 960, 16, True, 1, 1, None, 2048),
    (129, 9000, 160, 100, False, 6, 2, 8000, 128),  # kb 128 at B 128
    (65, 5000, 512, 10, False, 1, 2, 4321, 2048),   # one term, one partial query block
])
def test_k2_matches_plain(dev, grid, nq, n, d, k, cosine, passes, depth, n_valid, block_db):
    """K2 against its plain version, each term count (``passes`` 1, 3, 6):
    bit for bit on grid inputs; on Gaussian inputs distances within
    1e-4·(1 + |d|) (the tensor cores and the matmul sum the same cross
    terms in different orders) and ≥ 99.9% of ids (near-ties may swap)."""
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.dist import Dist

    gen = torch.Generator(device=dev).manual_seed(n + d)
    q, x = _flat_inputs(gen, dev, nq, n, d, grid, cosine)
    metric = Dist.COSINE if cosine else Dist.EUCLIDEAN
    kw = dict(n_valid=n_valid, passes=passes, depth=depth, block_db=block_db)
    before = ff.flat_topk_fused.launches
    kd, ki = ff.flat_topk_fused(q, x, k, metric, **kw)
    assert ff.flat_topk_fused.launches == before + 1
    pd, pi = ff.flat_topk_fused_plain(q, x, k, metric, **kw)
    torch.cuda.synchronize()
    if grid:
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
    else:
        finite = torch.isfinite(pd)
        assert torch.equal(torch.isfinite(kd), finite)
        assert torch.all((kd - pd).abs()[finite] <= 1e-4 * (1.0 + pd.abs()[finite]))
        assert (ki == pi).float().mean().item() >= 0.999
    if n_valid is not None:
        assert ki.max() < n_valid


@pytest.mark.parametrize("depth,n_valid,passes", [(2, None, 6), (1, 2_150_000, 6),
                                                  (2, 2_199_000, 1)])
def test_k2_runs_of_tiles_match_plain(dev, depth, n_valid, passes):
    """Past 65,534 database tiles (here B 32, 68,751 tiles) the kernel scans
    runs of tiles and merges each run's bins into the earlier runs': on grid
    inputs, full of exact ties, the result is the plain version's bit for
    bit (one term: six tiles a stage, so a run ends inside a stage; the
    second run's 3,217 tiles end on half a pair)."""
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.dist import Dist

    gen = torch.Generator(device=dev).manual_seed(31)
    q, x = _flat_inputs(gen, dev, 100, 2_200_001, 16, True, False)
    kw = dict(n_valid=n_valid, passes=passes, depth=depth, block_db=32)
    assert ff.fused_shapes(x.shape[0], 10, 32)[1] == 32
    kd, ki = ff.flat_topk_fused(q, x, 10, Dist.EUCLIDEAN, **kw)
    pd, pi = ff.flat_topk_fused_plain(q, x, 10, Dist.EUCLIDEAN, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.parametrize("depth,n_valid,passes", [(2, 2_150_000, 6), (1, None, 3)])
def test_k2_wide_runs_of_tiles_match_plain(dev, depth, n_valid, passes):
    """The wide scan past 65,534 database tiles (B 32, 68,751 tiles of
    256-column rows): its runs' bins merged, on grid inputs the plain
    version's bit for bit (the second run's 3,217 tiles end inside a unit of
    four)."""
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.dist import Dist

    gen = torch.Generator(device=dev).manual_seed(32)
    q, x = _flat_inputs(gen, dev, 100, 2_200_001, 256, True, False)
    kw = dict(n_valid=n_valid, passes=passes, depth=depth, block_db=32)
    assert ff.scan_plan(256, passes)[0] == 1
    kd, ki = ff.flat_topk_fused(q, x, 10, Dist.EUCLIDEAN, **kw)
    pd, pi = ff.flat_topk_fused_plain(q, x, 10, Dist.EUCLIDEAN, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_mma_sync_keeps_24_bits_of_the_largest_term(dev):
    """What the scans' f32 grade rests on: one ``mma.sync`` bf16 → f32 sums
    its 16 exact products and C aligned to the largest term, keeping every
    term down to 2⁻²³ of it (the f32 result then chopped to 24 bits), so
    six cross terms of a three-way split sum to f32 grade. On random
    operands the error stays within the result's last bit plus 17·2⁻²⁵ of
    the largest term."""
    from annsearch_tpu_torch.ops._cuda import mma_sync_once

    ks = list(range(1, 24))
    a = torch.zeros(2 * len(ks), 16, 16, device=dev)
    b = torch.zeros(2 * len(ks), 16, 8, device=dev)
    c = torch.zeros(2 * len(ks), 16, 8, device=dev)
    for p, k in enumerate(ks):
        a[p, 0, 0], a[p, 0, 1], b[p, 0, 0], b[p, 1, 0] = 1.0, 2.0 ** -k, 1.0, 1.0
        q = len(ks) + p      # beside C = 1
        a[q, 0, 0], b[q, 0, 0], c[q, 0, 0] = 2.0 ** -k, 1.0, 1.0
    d = mma_sync_once(a.bfloat16(), b.bfloat16(), c)[:, 0, 0].double().cpu()
    want = torch.tensor([1.0 + 2.0 ** -k for k in ks] * 2, dtype=torch.float64)
    assert torch.equal(d, want)
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(2048, 16, 16, generator=g, device=dev).bfloat16()
    b = torch.randn(2048, 16, 8, generator=g, device=dev).bfloat16()
    c = torch.randn(2048, 16, 8, generator=g, device=dev)
    d = mma_sync_once(a, b, c).double()
    terms = a.double()[:, :, :, None] * b.double()[:, None, :, :]
    big = torch.maximum(terms.abs().amax(2), c.double().abs())
    ulp = (torch.nextafter(d.float(), torch.tensor(float("inf"), device=dev)).double() - d).abs()
    assert torch.all((d - terms.sum(2) - c.double()).abs() <= ulp + 17 * 2.0 ** -25 * big)


def test_wgmma_keeps_24_bits_of_the_largest_term(dev):
    """The same for one ``wgmma.mma_async.m64n64k16`` as K2's scan issues it
    (A from registers, B through its 64-byte-swizzled descriptor): every
    term down to 2⁻²³ of the largest counts exactly, and on random operands
    the error stays within the result's last bit plus 17·2⁻²⁵ of the largest
    term. The random case also holds the operand layouts: a wrong swizzle or
    fragment map misses by whole products."""
    from annsearch_tpu_torch.ops._cuda import wgmma_once

    ks = list(range(1, 24))
    a = torch.zeros(2 * len(ks), 64, 16, device=dev)
    b = torch.zeros(2 * len(ks), 16, 64, device=dev)
    c = torch.zeros(2 * len(ks), 64, 64, device=dev)
    for p, k in enumerate(ks):
        a[p, 0, 0], a[p, 0, 1], b[p, 0, 0], b[p, 1, 0] = 1.0, 2.0 ** -k, 1.0, 1.0
        q = len(ks) + p      # beside C = 1
        a[q, 0, 0], b[q, 0, 0], c[q, 0, 0] = 2.0 ** -k, 1.0, 1.0
    d = wgmma_once(a.bfloat16(), b.bfloat16(), c)[:, 0, 0].double().cpu()
    want = torch.tensor([1.0 + 2.0 ** -k for k in ks] * 2, dtype=torch.float64)
    assert torch.equal(d, want)
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(256, 64, 16, generator=g, device=dev).bfloat16()
    b = torch.randn(256, 16, 64, generator=g, device=dev).bfloat16()
    c = torch.randn(256, 64, 64, generator=g, device=dev)
    d = wgmma_once(a, b, c).double()
    terms = a.double()[:, :, :, None] * b.double()[:, None, :, :]
    big = torch.maximum(terms.abs().amax(2), c.double().abs())
    ulp = (torch.nextafter(d.float(), torch.tensor(float("inf"), device=dev)).double() - d).abs()
    assert torch.all((d - terms.sum(2) - c.double()).abs() <= ulp + 17 * 2.0 ** -25 * big)


def _extract_bins(gen, dev, rows, width, kb, case):
    """Bins as the scan leaves them, on exact values: [rows, width] values
    at most 3e38 and int32 columns, distinct where filled, (3e38, 0) where
    not. ``case``: "ties" (small integers, many equal), "tail" (each row
    fewer finite bins than kb, some none), "zeros" (±0 and negative values,
    columns 0 among them), "late" (no bin at column 0: a merge of runs
    leaves 3e38 bins with later columns, so the tail's m is not 0)."""
    vals = torch.randint(-20, 21, (rows, width), generator=gen, device=dev).float()
    cols = torch.stack([torch.randperm(1 << 20, generator=gen, device=dev)[:width] + 1
                        for _ in range(rows)]).int()     # distinct, and never 0
    empty = torch.rand(rows, width, generator=gen, device=dev) < 0.2
    if case == "tail":
        keep = torch.randint(0, kb, (rows, 1), generator=gen, device=dev)
        rank = torch.rand(rows, width, generator=gen, device=dev).argsort(1).argsort(1)
        empty = rank >= keep
        empty[::5] = True                     # all-empty rows
    if case == "zeros":
        vals = torch.randint(-2, 3, (rows, width), generator=gen, device=dev).float() * 0.5
        vals[vals == 0] = torch.where(torch.rand_like(vals[vals == 0]) < 0.5, -0.0, 0.0)
        cols[:, 0] = 0
    vals[empty] = 3e38
    if case != "late":
        cols[empty] = 0
    qadd = torch.randint(0, 50, (rows,), generator=gen, device=dev).float()
    return vals, cols, qadd


@pytest.mark.parametrize("case", ["ties", "tail", "zeros", "late"])
@pytest.mark.parametrize("width,kb", [(32, 8), (64, 16), (256, 100), (2048, 16),
                                      (2560, 64), (4096, 128), (4096, 8)])
def test_k2_extraction_is_the_rounds_bit_for_bit(dev, width, kb, case):
    """K2's extraction (a bitonic sort of each warp's 512 keys, then a tree
    of merges) against the plain kb rounds, distances and columns equal in
    every slot, the (3e38 + qadd, m) tail of short and empty rows
    included."""
    from annsearch_tpu_torch.ops import flat_scan_fused as ff

    gen = torch.Generator(device=dev).manual_seed(width + kb)
    vals, cols, qadd = _extract_bins(gen, dev, 300, width, kb, case)
    before = ff.flat_extract.launches
    kd, ki = ff.flat_extract(vals, cols, qadd, kb)
    assert ff.flat_extract.launches == before + 1
    pd, pi = ff._extract_plain(vals, cols, qadd, kb)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_k2_plans_agree_with_the_library(dev):
    """The wrapper's scan plan (which scan, tiles a stage or unit, stages,
    shared memory) is the C entry's for every row width and term count, so
    ``scan_plan`` says which scan the library runs."""
    import ctypes

    from annsearch_tpu_torch.ops import _cuda
    from annsearch_tpu_torch.ops import flat_scan_fused as ff

    lib = _cuda.load_library()
    out = (ctypes.c_int * 5)()
    for dk in range(32, 1088, 32):
        for terms, passes in ((1, 1), (2, 3), (3, 6)):
            assert lib.annsearch_flat_scan_plan(dk, terms, ctypes.addressof(out)) == 0
            assert tuple(out) == ff.scan_plan(dk, passes), (dk, terms)


def test_k2_counts_the_wide_scan(dev):
    """Rows whose query terms do not stay in shared memory take the wide
    scan (the terms a stage at a time), chosen by shape as ``scan_plan``
    says; the plan's route is the kernel a profiler trace names."""
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.dist import Dist

    gen = torch.Generator(device=dev).manual_seed(5)
    for d, passes, wide in ((160, 6, 1), (160, 3, 0), (160, 1, 0), (192, 3, 0), (224, 3, 1),
                            (416, 1, 0), (448, 1, 1), (128, 6, 0)):
        assert ff.scan_plan(d, passes)[0] == wide
        q, x = _flat_inputs(gen, dev, 10, 3000, d, True, False)
        before = ff.flat_topk_fused.launches
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            kd, ki = ff.flat_topk_fused(q, x, 8, Dist.EUCLIDEAN, passes=passes)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        assert ff.flat_topk_fused.launches == before + 1
        assert any("flat_scan_wide_kernel" in n for n in names) == bool(wide), (d, passes)
        assert any("flat_scan_kernel" in n for n in names) == (not wide), (d, passes)
        pd, pi = ff.flat_topk_fused_plain(q, x, 8, Dist.EUCLIDEAN, passes=passes)
        torch.cuda.synchronize()
        assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_stages_time_the_ivf_paths_on_the_card(dev, monkeypatch):
    """With tracing on, the IVF-PQ fused tier's and cluster scan's stages
    take device intervals from their CUDA events, a child's within its
    parent's, resolved after the caller's synchronise with none of their
    own."""
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.utils import profiling
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    def no_sync(*a, **k):
        raise AssertionError("a stage synchronised")

    x, _ = generate_clustered_data(20000, 128, 20, seed=6)
    q = torch.as_tensor(subsample_with_noise(x, 2000, seed=6), device=dev)
    idx = at.build_ivf_pq_index(x, nlist=32, m=128, seed=1, device=dev)
    idx.query(q, 10, nprobe=6, approx=True)
    profiling.reset()
    profiling.enable()
    try:
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", no_sync)
            idx.query(q, 10, nprobe=6, approx=True)
            idx.query(q, 10, nprobe=6)
        torch.cuda.synchronize()
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    for name in ("ivf.query", "ivf.route", "ivf.lists", "ivf.scan", "ivf.cluster_scan",
                 "ivf.merge"):
        assert snap[name]["device_ns"] > 0 and snap[name]["device_self_ns"] >= 0, name
    assert snap["ivf.query"]["calls"] == 2
    inner = sum(snap[n]["device_ns"] for n in snap if snap[n]["parent"] == "ivf.query")
    assert inner <= snap["ivf.query"]["device_ns"]
    assert snap["ivf.query"]["device_self_ns"] == snap["ivf.query"]["device_ns"] - inner


def test_k2_slabs_and_refusals(dev):
    """More queries than one slab of bins scratch: one launch per slab, the
    same result as query by query; shapes the kernel does not take raise."""
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.dist import Dist

    gen = torch.Generator(device=dev).manual_seed(3)
    q, x = _flat_inputs(gen, dev, 20000, 3000, 16, True, False)
    slab = ff.slab_rows(2048)
    before = ff.flat_topk_fused.launches
    kd, ki = ff.flat_topk_fused(q, x, 8, Dist.EUCLIDEAN, passes=6)
    assert ff.flat_topk_fused.launches == before + -(-20000 // slab)
    pd, pi = ff.flat_topk_fused(q[slab - 3 : slab + 5], x, 8, Dist.EUCLIDEAN, passes=6)
    assert torch.equal(kd[slab - 3 : slab + 5], pd) and torch.equal(ki[slab - 3 : slab + 5], pi)
    with pytest.raises(ValueError, match="multiple of 32"):
        ff.flat_topk_fused(q[:4], x, 8, Dist.EUCLIDEAN, block_db=1000)
    with pytest.raises(ValueError, match="4096"):
        ff.flat_topk_fused(q[:4], torch.zeros((9000, 16), device=dev), 8, Dist.EUCLIDEAN,
                           block_db=4096)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_nndescent_on_the_card_matches_the_cpu(dev, metric):
    """The exact graph build (K2) and both query paths on the card against
    the CPU's (K2's plain version) on one data set."""
    from annsearch_tpu_torch.models.graph import NNDescentIndex
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 32, 12, seed=6)
    q = subsample_with_noise(x, 400, seed=6) * np.float32(0.125)
    x = x * np.float32(0.125)
    before = ff.flat_topk_fused.launches
    gpu = NNDescentIndex(x, metric, k=10, seed=2, device=dev)
    assert ff.flat_topk_fused.launches > before
    cpu = NNDescentIndex(x, metric, k=10, seed=2, device="cpu")
    assert (gpu.knn_ids.cpu() == cpu.knn_ids).float().mean().item() >= 0.999
    same = gpu.knn_ids.cpu() == cpu.knn_ids
    assert torch.all((gpu.knn_dists.cpu() - cpu.knn_dists).abs()[same] <= 1e-4)
    gi, gd = gpu.query(q, 10, exact_fallback=False)
    ci, cd = cpu.query(q, 10, exact_fallback=False)
    assert torch.equal(gpu.router_ids.cpu(), cpu.router_ids)
    assert (gpu.nav_graph.cpu() == cpu.nav_graph).float().mean().item() >= 0.99
    assert (gi.cpu() == ci).float().mean().item() >= 0.98
    fi, _ = gpu.query(q, 10, exact_fallback=True)
    ei, _ = cpu.query(q, 10, exact_fallback=True)
    assert (fi.cpu() == ei).float().mean().item() >= 0.999


def test_certified_fallback_on_the_card_answers_as_exact(dev, monkeypatch):
    """An NN-descent index of 200,000 × 32d LowRank rows answers 2,000 noisy
    queries at k 15 through its exact fallback, on the card
    ``selector="certified"`` (K2 and the rescan of colliding classes), as
    ``"exact"`` (cuBLAS fp32 and ``torch.topk``) does on the same rows. The
    two round differently, so ids may differ, or swap ranks, only at
    near-ties: an id one returns and the other does not lies, in float64,
    within the identity's f32 rounding (8 ulps of ‖q‖² + max‖x‖², about
    1e-3 here) of the other's k-th distance; the distances returned are
    those of the ids returned, ascending."""
    from annsearch_tpu_torch.models.graph import NNDescentIndex
    from annsearch_tpu_torch.ops.topk import blocked_query_topk
    from annsearch_tpu_torch.utils import profiling
    from annsearch_tpu_torch.utils.data import generate_data, subsample_with_noise
    from annsearch_tpu_torch.utils.dist import Dist

    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    x, _ = generate_data("lowrank", 200000, 32, 12, seed=7, intrinsic_dim=16)
    q = torch.as_tensor(subsample_with_noise(x, 2000, seed=7), device=dev)
    idx = NNDescentIndex(x, "euclidean", k=15, seed=1, device=dev)
    profiling.reset()
    profiling.enable()
    try:
        ids, d = idx.query(q, 15)
        counts = profiling.snapshot()["topk.certified"]["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    ed, ei = blocked_query_topk(q, idx.vectors, 15, Dist.EUCLIDEAN, x_sqnorm=idx.sqnorms,
                                selector="exact")
    assert counts["queries"] == 2000 and counts["rescanned"] > 0
    x64, q64 = idx.vectors.double(), q.double()
    dc = ((q64[:, None, :] - x64[ids]) ** 2).sum(-1)
    de = ((q64[:, None, :] - x64[ei]) ** 2).sum(-1)
    tol = (2.0**-20 * (q64.pow(2).sum(1) + x64.pow(2).sum(1).max()))[:, None]
    extra = ~(ids[:, :, None] == ei[:, None, :]).any(-1)
    missed = ~(ei[:, :, None] == ids[:, None, :]).any(-1)
    assert (dc <= de.max(1, keepdim=True).values + tol)[extra].all()
    assert (de >= dc.max(1, keepdim=True).values - tol)[missed].all()
    assert ((d.double() - dc).abs() <= tol).all()
    assert (d[:, 1:] >= d[:, :-1]).all() and (~extra).float().mean().item() >= 0.995


@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("n_valid", [None, 5500])
def test_certified_through_ties_on_the_card_equals_the_plain_version(dev, k, n_valid):
    """Grid rows past K2's 2,048 classes, where most queries tie at the k-th
    rank and some classes collide (the CPU test's inputs, which the JAX
    ``"exact"`` selector answers alike): on the card ``"certified"`` (K2's
    scan, extraction and run merge, and the rescan on cuBLAS) gives the
    answer of its plain version on the CPU bit for bit, so K2 orders tied
    bins by column there too. Every distance of the grid is exact in f32."""
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.ops.topk import blocked_query_topk
    from annsearch_tpu_torch.utils import profiling
    from annsearch_tpu_torch.utils.dist import Dist

    rng = np.random.default_rng(13)
    q = torch.tensor(rng.integers(-4, 5, (300, 8)) / 8, dtype=torch.float32)
    x = torch.tensor(rng.integers(-4, 5, (6000, 8)) / 8, dtype=torch.float32)
    pd, pi = blocked_query_topk(q, x, k, Dist.EUCLIDEAN, n_valid=n_valid, selector="certified")
    ff.flat_topk_fused.launches = 0
    profiling.reset()
    profiling.enable()
    try:
        cd, ci = blocked_query_topk(q.to(dev), x.to(dev), k, Dist.EUCLIDEAN, n_valid=n_valid,
                                    selector="certified")
        torch.cuda.synchronize()
        counts = profiling.snapshot()["topk.certified"]["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    assert ff.flat_topk_fused.launches > 0 and counts["rescanned"] > 0
    assert torch.equal(ci.cpu(), pi) and torch.equal(cd.cpu(), pd)
    full = ((q.double()[:, None, :] - x.double()[None, : n_valid or 6000]) ** 2).sum(-1)
    full, _ = full.sort(dim=1)
    assert (full[:, k - 1] == full[:, k]).sum().item() > 150


# -- K1-fold1, K1-exact-i8 and wide rows ------------------------------------------


def _dense_args(gen, dev, mode, **shape):
    args = list(_f32_tasks(gen, dev, **shape))
    if mode == "bf16":
        args[4] = args[4].to(torch.bfloat16)
    elif mode == "sq8":   # small codes: integer sums stay below 2^24 at any width here
        args[4] = torch.randint(-8, 9, args[4].shape, generator=gen, device=dev,
                                dtype=torch.int8)
        args[4][..., args[3].shape[1]:] = 0
        args[3] = torch.randint(-8, 9, args[3].shape, generator=gen, device=dev).float()
        args[3][-1] = 0
    args[5] = (args[4].float() ** 2).sum(-1)
    return args


@pytest.mark.parametrize("wrapper,cents,kw", [
    ("ivf_cell_scan", True, {}), ("ivf_cell_scan_split", True, {}),
    ("ivf_cell_scan_cos", True, {"q_split": True}),
    ("ivf_cell_scan_i8dec", False, {"cosine": True}),
], ids=["K1a", "K1b-l2", "K1b-cos", "K1d-i8dec"])
def test_i8dec_fold1_matches_plain(dev, wrapper, cents, kw):
    gen = torch.Generator(device=dev).manual_seed(20)
    cosine = wrapper == "ivf_cell_scan_cos" or kw.get("cosine", False)
    args = _i8_args(gen, dev, cosine, cents, R=192, maxq=64, seg=1024)
    plain_args = list(args)
    if not cents:
        plain_args[4] = None
        del args[4]
    fn = getattr(tsf, wrapper)
    before = fn.launches
    kd, ki = fn(*args, 16, fold_depth=1, **kw)
    assert fn.launches == before + 1
    pd, pi = tsf.ivf_cell_scan_plain(*plain_args, 16, cosine=cosine,
                                     q_split=wrapper == "ivf_cell_scan_split" or kw.get(
                                         "q_split", False), fold_depth=1)
    _assert_close(kd, ki, pd, pi)
    assert torch.equal(kd == np.float32(3e38), pd == np.float32(3e38))


@pytest.mark.parametrize("mode", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("cosine,d", [(False, 128), (True, 128), (False, 640)],
                         ids=["l2", "cos", "l2-wide"])
def test_dense_fold1_matches_plain(dev, mode, cosine, d):
    gen = torch.Generator(device=dev).manual_seed(21)
    args = _dense_args(gen, dev, mode, R=192, maxq=64, seg=1024, d=d)
    fn = getattr(tsf, f"ivf_cell_scan_{mode}_fold")
    kd, ki = fn(*args, 16, cosine=cosine, fold_depth=1)
    pd, pi = getattr(tsf, f"ivf_cell_scan_{mode}_plain")(*args, 16, cosine, exact=False,
                                                          fold_depth=1)
    if mode == "sq8":
        torch.cuda.synchronize()
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
    else:
        _assert_close(kd, ki, pd, pi)


@pytest.mark.parametrize("cents,cosine,q_split", [
    (True, False, False), (True, False, True), (True, True, False), (True, True, True),
    (False, False, False), (False, True, True),
], ids=["residual-l2", "residual-l2-nq_t2", "residual-cos", "residual-cos-nq_t2",
        "i8dec-l2", "i8dec-cos-nq_t2"])
@pytest.mark.parametrize("shape,kb", [(dict(), 16), (dict(R=384, maxq=256, seg=1024), 16),
                                      (dict(seg=128, maxq=32), 128),
                                      (dict(R=16, maxq=40, seg=256, d=1280), 16)])
def test_i8_exact_matches_plain(dev, cents, cosine, q_split, shape, kb):
    gen = torch.Generator(device=dev).manual_seed(22)
    args = _i8_args(gen, dev, cosine, cents, **shape)
    if not cents:
        args[4] = None
    before = tsf.ivf_cell_scan_i8_exact.launches
    kd, ki = tsf.ivf_cell_scan_i8_exact(*args, kb, cosine=cosine, q_split=q_split)
    assert tsf.ivf_cell_scan_i8_exact.launches == before + 1
    pd, pi = tsf.ivf_cell_scan_plain(*args, kb, cosine=cosine, q_split=q_split, exact=True)
    _assert_close(kd, ki, pd, pi)
    assert torch.equal(kd == np.float32(3e38), pd == np.float32(3e38))
    assert (kd[2, :, 5:] == np.float32(3e38)).all() and (ki[2, :, 5:] == 0).all()


@pytest.mark.parametrize("d", [640, 4224, 8192])
@pytest.mark.parametrize("mode,exact", [("f32", True), ("f32", False), ("bf16", False),
                                        ("sq8", True)])
def test_wide_rows_match_plain(dev, d, mode, exact):
    """F6: wide padded rows, the query terms formed per column block (f32
    from 640 columns, the others past a few thousand)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    args = _dense_args(gen, dev, mode, R=24, maxq=16, seg=256, d=d, nq=40)
    fn = getattr(tsf, f"ivf_cell_scan_{mode}_{'exact' if exact else 'fold'}")
    kd, ki = fn(*args, 16)
    pd, pi = getattr(tsf, f"ivf_cell_scan_{mode}_plain")(*args, 16, False, exact=exact)
    if mode == "sq8":
        torch.cuda.synchronize()
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
    else:   # sums of d products: the tolerance grows with √d
        torch.cuda.synchronize()
        assert torch.all((kd - pd).abs() <= 1e-4 * (1.0 + pd.abs()) * (d / 128) ** 0.5)
        assert (ki == pi).float().mean().item() >= 0.99
    wide = _i8_args(gen, dev, False, True, R=24, maxq=16, seg=256, d=d, nq=40)
    kd, ki = tsf.ivf_cell_scan(*wide, 16)
    pd, pi = tsf.ivf_cell_scan_plain(*wide, 16)
    torch.cuda.synchronize()
    assert (ki == pi).float().mean().item() >= 0.99


# -- the tree, LSH and kMkNN paths on the card --------------------------------------


def test_forest_and_ball_on_the_card_match_the_cpu(dev, tmp_path, monkeypatch):
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.models import trees
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 32, 20, seed=8)
    x = x * np.float32(0.125)
    q = subsample_with_noise(x, 400, seed=8)
    cpu = at.build_annoy_index(x, n_trees=8, seed=0, device="cpu")
    cpu.save(str(tmp_path / "annoy"))
    gpu = trees.AnnoyIndex.load(str(tmp_path / "annoy.npz"), device=dev)
    before = tsf.ivf_cell_scan_f32_fold.launches
    gi, gd = gpu.query(q, 10, n_probes=4, exact_fallback=False)
    assert tsf.ivf_cell_scan_f32_fold.launches > before
    ci, cd = cpu.query(q, 10, n_probes=4, exact_fallback=False)
    assert (gi.cpu() == ci).float().mean().item() >= 0.99
    monkeypatch.setattr(trees, "_BALL_FUSED_MIN_CELLS", 1)
    bc = at.build_balltree_index(x, device="cpu")
    bc.save(str(tmp_path / "ball"))
    bg = trees.BallTreeIndex.load(str(tmp_path / "ball"), device=dev)
    before = tsf.ivf_cell_scan_f32_fold.launches
    gi, _ = bg.query(q, 10, budget=0.05, exact_fallback=False)
    assert tsf.ivf_cell_scan_f32_fold.launches == before + 1
    ci, _ = bc.query(q, 10, budget=0.05, exact_fallback=False)
    assert (gi.cpu() == ci).float().mean().item() >= 0.99


def test_lsh_and_kmknn_on_the_card_match_the_cpu(dev, tmp_path):
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.models.kmknn import KmknnIndex
    from annsearch_tpu_torch.models.lsh import LSHIndex
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 32, 20, seed=9)
    x = x * np.float32(0.125)
    q = subsample_with_noise(x, 400, seed=9)
    for bits in (16, 7):             # the cluster scan; the fused scan (seg 256)
        cpu = at.build_lsh_index(x, bits_per_hash=bits, device="cpu")
        cpu.save(str(tmp_path / "lsh"))
        gpu = LSHIndex.load(str(tmp_path / "lsh.npz"), device=dev)
        before = tsf.ivf_cell_scan_f32_fold.launches
        gi, _ = gpu.query(q, 10, exact_fallback=False)
        assert (tsf.ivf_cell_scan_f32_fold.launches > before) == (cpu.seg_size % 128 == 0)
        ci, _ = cpu.query(q, 10, exact_fallback=False)
        assert (gi.cpu() == ci).float().mean().item() >= 0.99
    km = at.build_kmknn_index(x, seed=0, device="cpu")
    km.save(str(tmp_path / "km"))
    kg = KmknnIndex.load(str(tmp_path / "km.npz"), device=dev)
    gi, gd = kg.query(q, 10, exact_fallback=False)
    ti, td = at.build_exhaustive_index(x, device=dev).query(q, 10)
    kth = td[:, -1:]
    assert torch.all(gd <= kth + 1e-4 * (1 + kth))
    assert (gi == ti).float().mean().item() >= 0.999


# -- HNSW, Vamana (K2 builds) and the flat quantised scans on the card -------------


@pytest.mark.parametrize("kk", [51, 65])
def test_k2_at_hnsw_widths_matches_plain(dev, kk):
    """K2 at the base graph's widths on HNSW's workload (150,000 × 32d, 25
    clusters, seed 42; ``benchmarks/bench_hnsw_profile.py``) and its slab,
    the first 16,384 rows against all: kk 51 (build_k 50 at m 16, kb 64)
    and 65 (m 32, kb 128; ``blocked_query_topk`` sends that width to the
    bins selector, the JAX rule, but the kernel takes it). Clustered rows
    hold many near-ties, so a rank agrees where both give the same id or
    where the f64 distances of the two ids lie within twice the plain
    version's own largest f64 error (``chip_smoke.py``'s rule); distances
    within 1e-4·(1 + |d|) beyond the two versions' f64 errors, the kernel's
    error at most twice the plain's."""
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.data import generate_clustered_data
    from annsearch_tpu_torch.utils.dist import Dist

    x_np, _ = generate_clustered_data(150_000, 32, 25, seed=42)
    x = torch.as_tensor(x_np, device=dev)
    sn = (x * x).sum(1)
    q = x[:16384]
    kd, ki = ff.flat_topk_fused(q, x, kk, Dist.EUCLIDEAN, x_sqnorm=sn, passes=6)
    pd, pi = ff.flat_topk_fused_plain(q, x, kk, Dist.EUCLIDEAN, x_sqnorm=sn, passes=6)
    torch.cuda.synchronize()
    assert kd.shape == (16384, kk)
    finite = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), finite)

    def f64(ids):
        ids = ids.clamp(0, x.shape[0] - 1)
        q64 = q.double()
        dot = (q64[:, None] * x[ids].double()).sum(2)
        return (q64 * q64).sum(1)[:, None] + sn[ids].double() - 2.0 * dot

    tk, tp = f64(ki), f64(pi)
    err_k = (kd.double() - tk).abs()[finite].max().item()
    err_p = (pd.double() - tp).abs()[finite].max().item()
    assert err_k <= 2.0 * err_p, (err_k, err_p)
    same = (ki == pi) | ((tk - tp).abs() <= 2.0 * err_p)
    assert same[finite].float().mean().item() >= 0.999
    tol = 1e-4 * (1.0 + pd.abs()[finite]) + err_k + err_p
    assert torch.all((kd - pd).abs()[finite] <= tol)


@pytest.mark.parametrize("kind", ["hnsw", "vamana"])
def test_graph_builds_on_the_card_match_the_cpu(dev, kind):
    """An HNSW or Vamana build of 20,000 rows (past EXACT_LAYER_MAX: the base
    graph by K2) on the card against the CPU's (K2's plain version): the
    same layers, and recall within 0.01 of each other."""
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 32, 12, seed=4)
    x = x * np.float32(0.125)
    q = subsample_with_noise(x, 400, seed=4)
    build = at.build_hnsw_index if kind == "hnsw" else at.build_vamana_index
    before = ff.flat_topk_fused.launches
    gpu = build(x, seed=0, device=dev)
    assert ff.flat_topk_fused.launches > before
    cpu = build(x, seed=0, device="cpu")
    truth, _ = at.build_exhaustive_index(x, device="cpu").query(q, 10)
    gi, _ = gpu.query(q, 10, exact_fallback=False)
    ci, _ = cpu.query(q, 10, exact_fallback=False)
    assert abs(at.calculate_recall(truth, gi.cpu(), 10)
               - at.calculate_recall(truth, ci, 10)) <= 0.01
    if kind == "hnsw":
        assert [len(a[0]) for a in gpu.layers] == [len(b[0]) for b in cpu.layers]
    else:
        assert gpu.medoid == cpu.medoid


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_flat_sq8_on_the_card_is_integer_space(dev, metric):
    """ExhaustiveSq8Index on the card: distances equal an int64 numpy
    computation over the same codes (cosine: its IEEE f32 steps), bit for
    bit; and the scan on those codes on the CPU, bit for bit."""
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 256, 20, seed=3)
    q = subsample_with_noise(x, 300, seed=3)
    gpu = at.build_exhaustive_sq8_index(x, metric, device=dev)
    gi, gd = gpu.query(q, 10)
    qc = gpu.quantiser.encode(gpu._prep_queries(q)).cpu().numpy().astype(np.int64)
    c = gpu.codes.cpu().numpy().astype(np.int64)
    ids = gi.cpu().numpy()
    dots = np.take_along_axis(qc @ c.T, ids, 1)
    qs, cs = (qc * qc).sum(1)[:, None], (c * c).sum(1)[ids]
    if metric == "cosine":
        den = np.sqrt(qs.astype(np.float32)) * np.sqrt(cs.astype(np.float32))
        ref = np.where(den > 0, np.float32(1) - dots.astype(np.float32) / den, np.float32(1))
    else:
        ref = (qs + cs - 2 * dots).astype(np.float32)
    np.testing.assert_array_equal(gd.cpu().numpy(), ref)
    # the scan on the same codes on both devices (under cosine each device
    # normalises rows and queries with its own sums, so its codes may differ)
    from annsearch_tpu_torch.ops.quantised import chunked_topk_sq8
    from annsearch_tpu_torch.utils.dist import Dist

    qi = torch.as_tensor(qc.astype(np.int8))
    codes, sqn = gpu.codes.cpu(), gpu.code_sqnorms.cpu()
    cd, ci = chunked_topk_sq8(qi, codes, sqn, 10, Dist(metric))
    kd, ki = chunked_topk_sq8(qi.to(dev), gpu.codes, gpu.code_sqnorms, 10, Dist(metric))
    assert torch.equal(ki.cpu(), ci) and torch.equal(kd.cpu(), cd)
    assert torch.equal(ki, gi) and torch.equal(kd, gd)


def test_flat_bf16_on_the_card_returns_f32_sums(dev):
    """ExhaustiveIndexBf16 on the card sums its bf16 products in f32: the
    distances are f32, most of them not bf16 values, and within 1e-5 of the
    terms of the CPU's."""
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 256, 20, seed=2)
    q = subsample_with_noise(x, 300, seed=2)
    gi, gd = at.query_exhaustive_bf16_index(
        q, at.build_exhaustive_bf16_index(x, device=dev), 10, True)
    ci, cd = at.query_exhaustive_bf16_index(
        q, at.build_exhaustive_bf16_index(x, device="cpu"), 10, True)
    assert gd.dtype == torch.float32
    assert (gd != gd.bfloat16().float()).float().mean().item() > 0.9
    assert (gi.cpu() == ci).float().mean().item() >= 0.999
    terms = float((torch.as_tensor(q) ** 2).sum(1).max() + (torch.as_tensor(x) ** 2).sum(1).max())
    same = gi.cpu() == ci
    assert torch.all((gd.cpu() - cd).abs()[same] <= 1e-5 * (cd.abs()[same] + terms))


# -- the binary family: K1a-bf16 (RaBitQ) and K1d-bf16 on ±1 cells (Hamming) ----------


def _rabitq_tasks(gen, dev, R=96, maxq=64, seg=512, d=128, nseg=12, nq=300, short=False):
    """K1a's task inputs over RaBitQ's estimator cells: ±1 rows scaled by a
    per-row multiplier (some 0: rows on their centroid) in bf16, sn the
    squared distances to the centroid, unit scales. ``short``: most rows
    hold fewer valid rows than 128, so fewer survivors than kb are finite."""
    lists, task_seg, cnt, queries, cents, _, _, _ = _tasks(gen, dev, R, maxq, seg, d, nseg, nq)
    if short:
        cnt[cnt > 0] = torch.randint(1, 200, (int((cnt > 0).sum()),), generator=gen,
                                     device=dev, dtype=torch.int32)
    sign = torch.randint(0, 2, (nseg + 1, seg, d), generator=gen, device=dev) * 2.0 - 1.0
    dist = torch.rand((nseg + 1, seg), generator=gen, device=dev) * 3.0
    corr = torch.rand((nseg + 1, seg), generator=gen, device=dev) * 8.0 + 2.0
    corr[:, ::37] = 0.0
    mult = torch.where(corr > 1e-6, dist / corr.clamp_min(1e-12), 0.0)
    cells = (sign * mult[:, :, None]).to(torch.bfloat16)
    cells[-1] = 0
    sn = dist ** 2
    sn[-1] = 0
    return [lists, task_seg, cnt, queries, cents, torch.ones(d, device=dev), cells, sn]


@pytest.mark.parametrize("sel", ["exact", "fold1", "fold2"])
@pytest.mark.parametrize(
    "shape,kb",
    [
        (dict(), 16),
        (dict(maxq=36, d=64), 8),            # slots past maxq; RaBitQ at d 64
        (dict(seg=128, maxq=32), 128),       # one chunk, kb = 128
        (dict(R=256, maxq=128, seg=1024, d=128), 16),   # phase 18's widths
        (dict(R=256, maxq=128, seg=1024, d=128), 32),
        (dict(R=256, maxq=128, seg=1024, d=128), 64),
        (dict(R=256, maxq=128, seg=1024, d=128), 128),  # phase 18's kb
        (dict(R=96, maxq=64, seg=1024, d=128, short=True), 128),   # the rounds' tail
        (dict(R=64, maxq=64, seg=512, d=256), 16),      # d 256: four steps a chunk
        (dict(R=16, maxq=40, seg=256, d=1536), 16),     # query terms per column block
    ],
)
def test_k1a_bf16_matches_plain(dev, shape, kb, sel):
    """Two query terms (RaBitQ's q_split=True), the only count it takes."""
    gen = torch.Generator(device=dev).manual_seed(21)
    args = _rabitq_tasks(gen, dev, **shape)
    kw = dict(exact=sel == "exact", fold_depth=2 if sel == "fold2" else 1)
    before = tsf.ivf_cell_scan_bf16_residual.launches
    kd, ki = tsf.ivf_cell_scan_bf16_residual(*args, kb, **kw)
    assert tsf.ivf_cell_scan_bf16_residual.launches == before + 1
    pd, pi = tsf.ivf_cell_scan_plain(*args, kb, q_split=True, exact=kw["exact"],
                                     fold_depth=kw["fold_depth"])
    _assert_close(kd, ki, pd, pi)
    cnt = args[2]
    assert (kd[cnt == 0] == np.float32(3e38)).all() and (ki[cnt == 0] == 0).all()
    assert torch.equal(kd == np.float32(3e38), pd == np.float32(3e38))


@pytest.mark.parametrize("sel", ["exact", "fold1", "fold2"])
@pytest.mark.parametrize("residual,cosine,q_split", [
    (True, False, False), (True, True, False), (True, True, True),
    (False, False, False), (False, False, True), (False, True, False), (False, True, True),
])
@pytest.mark.parametrize("shape", [dict(), dict(R=16, maxq=40, seg=256, d=1536)],
                         ids=["d128", "wide"])
def test_bf16_decode_matches_plain(dev, sel, residual, cosine, q_split, shape):
    """K1-bf16-decode, each of its 21 launchers (at d 128 with the query
    terms whole, at d 1,536 a stage at a time): bf16 cells under mode
    i8dec or the residual's cosine or one-term prologue, against the plain
    version; under cosine unit queries (sn the cells' squared norms, as a
    cosine index keeps them)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    lists, task_seg, cnt, queries, cents, _, cells, sn = _rabitq_tasks(gen, dev, **shape)
    scales = torch.rand(queries.shape[1], generator=gen, device=dev) + 0.5
    if cosine:
        queries = queries / queries.norm(dim=1, keepdim=True).clamp_min(1e-30)
        sn = (cells.float() ** 2).sum(-1)
    args = (lists, task_seg, cnt, queries, cents if residual else None, scales, cells, sn)
    kw = dict(cosine=cosine, q_split=q_split, exact=sel == "exact",
              fold_depth=2 if sel == "fold2" else 1)
    before = tsf.ivf_cell_scan_bf16_decode.launches
    kd, ki = tsf.ivf_cell_scan_bf16_decode(*args, 16, **kw)
    assert tsf.ivf_cell_scan_bf16_decode.launches == before + 1
    pd, pi = tsf.ivf_cell_scan_plain(*args, 16, **kw)
    _assert_close(kd, ki, pd, pi)
    assert (kd[cnt == 0] == np.float32(3e38)).all() and (ki[cnt == 0] == 0).all()


def test_bf16_decode_refuses_the_k1a_bf16_case(dev):
    """The residual l2 scan with two query terms over bf16 cells is
    K1a-bf16's: the K1-bf16-decode wrapper refuses it, and
    ``fused_ivf_scan`` routes it to K1a-bf16."""
    gen = torch.Generator(device=dev).manual_seed(24)
    args = _rabitq_tasks(gen, dev, R=8)
    with pytest.raises(ValueError, match="K1a-bf16"):
        tsf.ivf_cell_scan_bf16_decode(*args, 16, q_split=True)


def _selection_tasks(gen, dev, R=64, maxq=64, seg=1024, d=64, nseg=8, nq=200):
    """Task inputs on which kernel and plain version compute the same
    distances exactly: ±1 bf16 cells (multiplier 1, sn = d), integer
    queries in [-2, 2], zero centroids and unit scales, so every query term,
    dot and distance is a small integer, and distances tie often. Rows of
    every length, many of them shorter than 128 (the rounds' tail), some
    empty."""
    cells = (torch.randint(0, 2, (nseg + 1, seg, d), generator=gen, device=dev) * 2.0
             - 1.0).to(torch.bfloat16)
    cells[-1] = 0
    sn = torch.full((nseg + 1, seg), float(d), device=dev)
    sn[-1] = 0
    queries = torch.randint(-2, 3, (nq + 1, d), generator=gen, device=dev).float()
    queries[-1] = 0
    task_seg = torch.randint(0, nseg, (R,), generator=gen, device=dev)
    cnt = torch.randint(0, seg + 1, (R,), generator=gen, device=dev)
    cnt[::3] = torch.randint(0, 130, (len(range(0, R, 3)),), generator=gen, device=dev)
    cnt[5::9] = 0
    task_seg[5::9] = nseg
    lists = torch.randint(0, nq + 1, (R, maxq), generator=gen, device=dev)
    return (lists.int(), task_seg.int(), cnt.int(), queries,
            torch.zeros(nseg + 1, d, device=dev), torch.ones(d, device=dev), cells, sn)


@pytest.mark.parametrize("fold_depth", [1, 2])
@pytest.mark.parametrize("kb", [8, 16, 32, 64, 100, 128])
def test_fold_selection_is_the_rounds_bit_for_bit(dev, kb, fold_depth):
    """The fold's selection (a bitonic sort of the survivors in registers)
    against the plain version's kb rounds, ids and distances equal in every
    slot, the (3e38, m) tail of short rows included: K1a-bf16 and, over the
    same cells, K1d-bf16 (the selection is shared by every fold
    instance)."""
    gen = torch.Generator(device=dev).manual_seed(40 + kb)
    args = _selection_tasks(gen, dev)
    kd, ki = tsf.ivf_cell_scan_bf16_residual(*args, kb, fold_depth=fold_depth)
    pd, pi = tsf.ivf_cell_scan_plain(*args, kb, q_split=True, fold_depth=fold_depth)
    torch.cuda.synchronize()
    assert torch.equal(pd, pd.round()) and (pd == np.float32(3e38)).any()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    lists, task_seg, cnt, queries, _, _, cells, sn = args
    kd, ki = tsf.ivf_cell_scan_bf16_fold(lists, task_seg, cnt, queries, cells, sn, kb,
                                         fold_depth=fold_depth)
    pd, pi = tsf.ivf_cell_scan_bf16_plain(lists, task_seg, cnt, queries, cells, sn, kb, False,
                                          exact=False, fold_depth=fold_depth)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


#: the exact wrappers of the edge-case test: dense cells of each type, and the
#: int8-decode prologues with centroids (K1a's) and without (K1d-i8dec's)
EXACT_KINDS = ["f32", "bf16", "sq8", "i8-residual", "i8dec"]
#: per segment of the "entrants" case: the keys that enter its lists in chunk 1
ENTRANTS = (0, 1, 2, 31, 32, 33, 128)


def _edge_sn(case, nseg, seg, seed):
    """Row norms that are the distances themselves (every query is zero, so
    ``l2`` gives ``max(0 + sn − 0, 0) = sn`` exactly on both sides)."""
    rng = np.random.default_rng(seed)
    if case == "entrants":   # chunk 0 fills the lists; chunk 1 brings m keys below them
        sn = np.full((nseg, seg), 5000.0, dtype=np.float32)
        for s in range(nseg):
            m = ENTRANTS[s % len(ENTRANTS)]
            sn[s, :128] = 1000 + rng.permutation(128)
            sn[s, 128 + rng.permutation(128)[:m]] = 500 + rng.permutation(m)
        return sn
    sn = rng.integers(0, 10 if case != "fltmax" else 40, (nseg, seg)).astype(np.float32)
    if case == "equal":
        sn[:] = 7.0
    elif case == "fltmax":
        sn[rng.random(sn.shape) < 0.3] = np.finfo(np.float32).max
        sn[rng.random(sn.shape) < 0.05] = np.float32(3e38)
    elif case == "inf":
        sn[rng.random(sn.shape) < 0.2] = np.inf
    return sn


def _selection_reference(dist, cnt, kb):
    """The exact selection's contract on CPU tensors ``dist [R, maxq, seg]``:
    the kb smallest (value, lane) pairs over the valid lanes whose value is
    at most FLT_MAX (an inf or NaN distance never enters), then (3e38, 0)."""
    lane = torch.arange(dist.shape[-1])
    ok = (lane < cnt.long()[:, None, None]) & (dist <= np.finfo(np.float32).max)
    vals, idx = torch.sort(torch.where(ok, dist, float("inf")), dim=-1, stable=True)
    vals, idx = vals[..., :kb], idx[..., :kb].int()
    real = vals != float("inf")
    return torch.where(real, vals, np.float32(3e38)), torch.where(real, idx, 0)


@pytest.mark.parametrize("case", ["ties", "equal", "entrants", "fltmax", "inf"])
@pytest.mark.parametrize("kb", [8, 24, 128])
@pytest.mark.parametrize("kind", EXACT_KINDS)
def test_exact_selection_edge_cases_bit_for_bit(dev, kind, kb, case):
    """Every exact wrapper on distances it computes exactly (zero queries,
    distances = sn): many ties, every lane equal, chunks in which 0, 1, 2,
    31, 32, 33 and 128 keys enter a list, FLT_MAX and 3e38 on valid lanes,
    inf on valid lanes; rows of 0, 1, kb − 1, kb, 200 and a whole segment
    of valid lanes; 40 query slots (the second block's slots past maxq are
    not written). Bit for bit against the selection's contract, and against
    the plain version where the two agree (F15: the plain version lets inf
    in and ranks values above 3e38 after the lanes it masks)."""
    nseg, seg, d, maxq, R = 7, 1024, 32, 40, 28
    gen = torch.Generator(device=dev).manual_seed(kb)
    sn = torch.zeros((nseg + 1, seg), device=dev)
    sn[:-1] = torch.tensor(_edge_sn(case, nseg, seg, kb), device=dev)
    task_seg = (torch.arange(R, device=dev) % nseg).int()
    cnt = torch.tensor([seg, 0, 1, kb - 1, kb, 200, seg - 37] * 4, device=dev).int()[:R]
    lists = torch.randint(0, 51, (R, maxq), generator=gen, device=dev).int()
    queries = torch.zeros((51, d), device=dev)
    if kind in ("f32", "bf16", "sq8"):
        cells = torch.randn((nseg + 1, seg, d), generator=gen, device=dev)
        cells = {"f32": cells, "bf16": cells.to(torch.bfloat16),
                 "sq8": (cells * 40).to(torch.int8)}[kind]
        out = getattr(tsf, f"ivf_cell_scan_{kind}_exact")(lists, task_seg, cnt, queries,
                                                           cells, sn, kb)
        plain = getattr(tsf, f"ivf_cell_scan_{kind}_plain")(lists, task_seg, cnt, queries,
                                                             cells, sn, kb, False, exact=True)
    else:
        cells = torch.randint(-127, 128, (nseg + 1, seg, d), generator=gen, device=dev,
                              dtype=torch.int8)
        cents = torch.zeros((nseg + 1, d), device=dev) if kind == "i8-residual" else None
        a = (lists, task_seg, cnt, queries, cents, torch.ones(d, device=dev), cells, sn, kb)
        out = tsf.ivf_cell_scan_i8_exact(*a)
        plain = tsf.ivf_cell_scan_plain(*a, exact=True)
    torch.cuda.synchronize()
    kd, ki = (t.cpu() for t in out)
    dist = sn.cpu()[task_seg.long().cpu()][:, None, :].expand(R, maxq, seg)
    rd, ri = _selection_reference(dist, cnt.cpu(), kb)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32)) and torch.equal(ki, ri)
    if case in ("ties", "equal", "entrants"):
        pd, pi = (t.cpu() for t in plain)
        assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_k1a_bf16_rejects_what_it_cannot_take(dev):
    gen = torch.Generator(device=dev).manual_seed(22)
    args = _rabitq_tasks(gen, dev, R=8)
    bad = list(args)
    bad[6] = args[6].to(torch.int8)
    with pytest.raises(ValueError, match="cells"):
        tsf.ivf_cell_scan_bf16_residual(*bad, 16)
    with pytest.raises(ValueError, match="kb"):
        tsf.ivf_cell_scan_bf16_residual(*args, 129)


@pytest.mark.parametrize("n_bits", [64, 256, 200])
def test_k1d_bf16_on_pm1_cells_is_four_times_hamming(dev, n_bits):
    """The Hamming tier's kernel: over ±1 bf16 cells with sn = n_bits and ±1
    queries, every distance is 4·hamming exactly, equal to the plain
    version and to an int64 popcount of the codes."""
    from annsearch_tpu_torch.ops.binary import pack_bits, unpack_pm1

    gen = torch.Generator(device=dev).manual_seed(n_bits)
    R, maxq, seg, nseg, nq = 64, 64, 512, 10, 300
    bits = torch.randint(0, 2, ((nseg + 1) * seg, n_bits), generator=gen, device=dev).bool()
    codes = pack_bits(bits)
    pm = unpack_pm1(codes, n_bits).reshape(nseg + 1, seg, n_bits)
    dp = -(-n_bits // 16) * 16
    cells = torch.nn.functional.pad(pm, (0, dp - n_bits)).contiguous()
    cells[-1] = 0
    sn = torch.full((nseg + 1, seg), float(n_bits), device=dev)
    qbits = torch.randint(0, 2, (nq, n_bits), generator=gen, device=dev).bool()
    q_codes = pack_bits(qbits)
    queries = torch.cat([unpack_pm1(q_codes, n_bits, torch.float32),
                         torch.zeros(1, n_bits, device=dev)])
    lists = torch.randint(0, nq, (R, maxq), generator=gen, device=dev).int()
    task_seg = torch.randint(0, nseg, (R,), generator=gen, device=dev).int()
    cnt = torch.full((R,), seg, dtype=torch.int32, device=dev)
    cnt[3::7] = 100
    kd, ki = tsf.ivf_cell_scan_bf16_fold(lists, task_seg, cnt, queries, cells, sn, 16)
    pd, pi = tsf.ivf_cell_scan_bf16_plain(lists, task_seg, cnt, queries, cells, sn, 16,
                                          False, exact=False)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    real = kd < 1e38
    assert torch.equal(kd[real], kd[real].round())
    rows = task_seg.long()[:, None, None] * seg + ki.long()
    qc = q_codes.cpu().numpy().view(np.uint32)[lists.long().cpu().numpy()]    # [R, maxq, w]
    xc = codes.cpu().numpy().view(np.uint32)[rows.cpu().numpy()]             # [R, maxq, kb, w]
    ham = np.unpackbits(np.bitwise_xor(qc[:, :, None, :], xc).view(np.uint8),
                        axis=-1).sum(-1).astype(np.int64)
    np.testing.assert_array_equal(kd.cpu().numpy()[real.cpu().numpy()],
                                  4 * ham[real.cpu().numpy()])


@pytest.mark.parametrize("kind", ["ivf_binary", "rabitq"])
def test_binary_indexes_on_the_card_match_the_cpu(dev, kind):
    """IvfIndexBinary's Hamming tier (K1d-bf16) and IvfIndexRaBitQ's fused
    estimator (K1a-bf16) on the card against the same index state on the
    CPU: the path's kernel launches, ids on ≥ 99%, Hamming distances equal;
    squared estimates within 2⁻¹¹·(1 + d_k²), d_k the row's k-th; the exact
    rerank's ids on ≥ 99%. The returned estimates are
    ``_rescore_estimator``'s, which rounds the unit query residual, rotated
    on each device by its own f32 product, to one bf16 term: a component
    that rounds apart (at most 2 a slot here) moves d² by about
    2·sn·qd·2⁻⁸·|qu_i|/‖R·u‖₁. On an H100 the largest |gd² − cd²| / (1 +
    d_k²) on this data is 1.5e-4, a third of the limit; the distances
    themselves are no fit for a 1e-4·(1 + |d|) test, as a square root near
    0 magnifies the same gap (0.07 of 1 + |d| on this data)."""
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch import interop
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 128, 20, seed=4)
    q = subsample_with_noise(x, 500, seed=4)
    if kind == "ivf_binary":
        gpu = at.build_ivf_index_binary(x, nlist=64, n_bits=256, device=dev)
        wrapper, load, extra = "ivf_cell_scan_bf16_fold", interop.ivf_binary_from_jax_arrays, {
            "n_bits": gpu.n_bits, "bin_mode": gpu.bin_mode}
    else:
        gpu = at.build_exhaustive_index_rabitq(x, device=dev)
        wrapper, load, extra = "ivf_cell_scan_bf16_residual", (
            interop.exhaustive_rabitq_from_jax_arrays), {}
    arrays = {k: v for k, v in gpu._save_arrays().items()}
    meta = {n: getattr(gpu, n) for n in ("n", "dim", "nlist", "seg_size")}
    meta.update(extra, metric=gpu.metric.value, fast_scan=True)
    cpu = load(arrays, meta, device="cpu")
    fn = getattr(tsf, wrapper)
    before = fn.launches
    gi, gd = gpu.query(q, 10, nprobe=8)
    assert fn.launches > before
    ci, cd = cpu.query(q, 10, nprobe=8)
    same = gi.cpu() == ci
    assert same.float().mean().item() >= 0.99
    if kind == "ivf_binary":
        assert torch.equal(gd.cpu()[same], cd[same])
    else:
        gap = ((gd.cpu().double() ** 2 - cd.double() ** 2).abs()
               / (1.0 + cd[:, -1:].double() ** 2))[same]
        in_d = ((gd.cpu() - cd).abs() / (1.0 + cd.abs()))[same]
        print(f"rabitq: largest |gd² − cd²| / (1 + d_k²) {gap.max().item():.4e} "
              f"(limit {2.0 ** -11:.4e}); largest |gd − cd| / (1 + |cd|) "
              f"{in_d.max().item():.4e}")
        assert gap.max().item() <= 2.0 ** -11
    gi, gd = gpu.query(q, 10, nprobe=8, rerank="exact", exact_fallback=False)
    ci, cd = cpu.query(q, 10, nprobe=8, rerank="exact", exact_fallback=False)
    assert (gi.cpu() == ci).float().mean().item() >= 0.99


def test_forced_nndescent_build_on_the_card_matches_the_cpu(dev, monkeypatch):
    """The approximate build (``BRUTE_BUILD_FLOP_BUDGET`` patched to 0) of
    20,000 rows on the card and on the CPU: each draws its own stream on
    its device, so the graphs are held to recall@10 against one exact
    truth, at least 0.95 each and within 0.01 of each other."""
    import annsearch_tpu_torch as at
    import annsearch_tpu_torch.models.graph as tmg
    from annsearch_tpu_torch.utils.data import generate_clustered_data

    x, _ = generate_clustered_data(20000, 32, 20, seed=6)
    monkeypatch.setattr(tmg, "BRUTE_BUILD_FLOP_BUDGET", 0)
    gpu = tmg.NNDescentIndex(x, k=10, seed=1, device=dev)
    cpu = tmg.NNDescentIndex(x, k=10, seed=1, device="cpu")
    monkeypatch.undo()
    truth, _ = at.build_exhaustive_index(x, device="cpu").query(x, 11)
    truth = truth[:, 1:]
    rg = at.calculate_recall(truth, gpu.knn_ids[:, :10].cpu().long(), 10)
    rc = at.calculate_recall(truth, cpu.knn_ids[:, :10].long(), 10)
    assert rg >= 0.95 and rc >= 0.95 and abs(rg - rc) <= 0.01, (rg, rc)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_streaming_on_the_card_equals_the_cpu(dev, metric):
    """StreamingExhaustiveIndex on the card against the CPU (chunks of
    3,000 rows, a ragged last one): ids ≥ 99.9% equal, distances within
    1e-4·(1 + |d|)."""
    from annsearch_tpu_torch.models.streaming import StreamingExhaustiveIndex
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    x, _ = generate_clustered_data(20000, 64, 12, seed=8)
    x = x * np.float32(0.125)
    q = subsample_with_noise(x, 500, seed=8)
    gi, gd = StreamingExhaustiveIndex(x, metric, device=dev).query(q, 10, chunk_rows=3000)
    ci, cd = StreamingExhaustiveIndex(x, metric, device="cpu").query(q, 10, chunk_rows=3000)
    assert gi.device.type == "cuda"
    assert (gi.cpu() == ci).float().mean() >= 0.999
    assert torch.all((gd.cpu() - cd).abs() <= 1e-4 * (1.0 + cd.abs()))


# -- K1's scan on wgmma: every instance at the edges of its plan ---------------------

#: (task shape, kb): seg 128 to 2,048; d 32 to 4,224 (whole query terms, then a
#: stage at a time); maxq not a multiple of 32; rows of cnt 0 and partial last
#: chunks (``_tasks``); d 40 (dp 48: not a multiple of sq8's 32-column k step)
EDGE_SHAPES = [
    (dict(R=40, maxq=36, seg=128, d=32), 8),
    (dict(R=24, maxq=70, seg=256, d=64), 128),
    (dict(R=24, maxq=33, seg=1024, d=128), 16),
    (dict(R=12, maxq=40, seg=2048, d=256), 24),
    (dict(R=16, maxq=64, seg=1024, d=40), 64),
    (dict(R=8, maxq=36, seg=256, d=4224), 16),
]
EDGE_IDS = ["seg128-d32", "seg256-d64-kb128", "seg1024-d128", "seg2048-d256", "d40",
            "d4224"]


def _edge_call(kind, gen, dev, shape, kb):
    """(kernel call, plain call) of one K1 instance kind on ``_tasks``-style
    inputs of ``shape``."""
    if kind.startswith(("f32", "bf16", "sq8")):
        mode, sel, epi = kind.split("-")
        args = (_f32_tasks(gen, dev, **shape) if mode == "f32"
                else _quant_tasks(gen, dev, mode, **shape))
        wrapper = getattr(tsf, f"ivf_cell_scan_{mode}_{'exact' if sel == 'exact' else 'fold'}")
        plain = getattr(tsf, f"ivf_cell_scan_{mode}_plain")
        cos = epi == "cos"
        depth = 1 if sel == "fold1" else 2
        if sel == "exact":
            return (lambda: wrapper(*args, kb, cosine=cos),
                    lambda: plain(*args, kb, cos, exact=True))
        return (lambda: wrapper(*args, kb, cosine=cos, fold_depth=depth),
                lambda: plain(*args, kb, cos, exact=False, fold_depth=depth))
    if kind.startswith("k1a_bf16"):
        args = list(_rabitq_tasks(gen, dev, **shape))
        pad = -args[6].shape[-1] % 16   # repack_blocks pads rows to 16 columns
        args[6] = torch.nn.functional.pad(args[6], (0, pad)).contiguous()
        exact = kind.endswith("exact")
        return (lambda: tsf.ivf_cell_scan_bf16_residual(*args, kb, exact=exact),
                lambda: tsf.ivf_cell_scan_plain(*args, kb, q_split=True, exact=exact))
    cosine = kind in ("cos", "i8dec_cos", "exact_i8_cos")
    cents = not kind.startswith("i8dec")
    args = _i8_args(gen, dev, cosine, cents, **shape)
    plain_args = list(args)
    if not cents:
        plain_args[4] = None
        del args[4]
    split = kind in ("split", "cos", "i8dec_cos", "exact_i8_cos")
    call = {
        "k1a": lambda: tsf.ivf_cell_scan(*args, kb),
        "split": lambda: tsf.ivf_cell_scan_split(*args, kb),
        "cos": lambda: tsf.ivf_cell_scan_cos(*args, kb, q_split=True),
        "i8dec_l2": lambda: tsf.ivf_cell_scan_i8dec(*args, kb),
        "i8dec_cos": lambda: tsf.ivf_cell_scan_i8dec(*args, kb, cosine=True, q_split=True),
        "exact_i8": lambda: tsf.ivf_cell_scan_i8_exact(*args, kb),
        "exact_i8_cos": lambda: tsf.ivf_cell_scan_i8_exact(*args, kb, cosine=True,
                                                           q_split=True),
    }[kind]
    exact = kind.startswith("exact")
    return call, lambda: tsf.ivf_cell_scan_plain(*plain_args, kb, cosine=cosine,
                                                  q_split=split, exact=exact)


EDGE_KINDS = ["f32-exact-l2", "f32-fold-cos", "f32-fold1-l2", "bf16-exact-l2", "bf16-fold-cos",
              "sq8-exact-cos", "sq8-fold-l2", "sq8-fold1-cos", "k1a", "split", "cos",
              "i8dec_l2", "i8dec_cos", "exact_i8", "exact_i8_cos", "k1a_bf16_fold",
              "k1a_bf16_exact"]


@pytest.mark.parametrize("shape,kb", EDGE_SHAPES, ids=EDGE_IDS)
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_wgmma_scan_edges_match_plain(dev, kind, shape, kb):
    """Every kind of K1 instance on the wgmma scan against its plain
    version at the edges of its plan: one chunk to sixteen, whole query
    terms and terms a stage at a time, the last block's slots past maxq,
    rows of no valid row and partial last chunks, kb 8 to 128; sq8 bit for
    bit (integer sums), the rest at 1e-4·(1 + |d|) and 99.9% of ids."""
    gen = torch.Generator(device=dev).manual_seed(31)
    call, plain = _edge_call(kind, gen, dev, shape, kb)
    kd, ki = call()
    pd, pi = plain()
    torch.cuda.synchronize()
    if kind.startswith("sq8"):
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
    else:
        _assert_close(kd, ki, pd, pi)
    assert torch.equal(kd == np.float32(3e38), pd == np.float32(3e38))


def test_k1_plans_agree_with_the_library(dev):
    """``ivf_scan_fused.scan_plan`` (the query terms whole or a stage at a
    time, stages, bytes a stage, shared memory) is the C entry's for every
    cell kind, term count, selection, kb and row width, so the route counts
    that ``chip_smoke.py`` predicts from shapes are the library's; and every
    launch moves ``scan_routes`` by one on its plan's route."""
    import ctypes

    from annsearch_tpu_torch.ops import _cuda

    lib = _cuda.load_library()
    out = (ctypes.c_int * 4)()
    for cell_bytes, terms, int8 in ((4, 3, 0), (2, 3, 0), (2, 1, 0), (2, 2, 0), (1, 1, 1),
                                    (1, 1, 0), (1, 2, 0)):
        for sel in (0, 1, 2):
            for kb in (8, 24, 128):
                for dp in (16, 48, 64, 128, 256, 400, 1024, 2048, 4224, 8192):
                    assert lib.annsearch_ivf_scan_plan(cell_bytes, terms, int8, sel, dp, kb,
                                                       ctypes.addressof(out)) == 0
                    assert tuple(out) == tsf.scan_plan(cell_bytes, terms, bool(int8), sel, dp,
                                                       kb), (cell_bytes, terms, sel, kb, dp)
    gen = torch.Generator(device=dev).manual_seed(32)
    for d, wide in ((64, 0), (4224, 1)):
        args = _f32_tasks(gen, dev, R=4, maxq=8, seg=256, d=d)
        before = tsf.scan_routes()
        tsf.ivf_cell_scan_f32_exact(*args, 16)
        after = tsf.scan_routes()
        assert (after[0] - before[0], after[1] - before[1]) == ((0, 1) if wide else (1, 0))
        assert tsf.scan_plan(4, 3, False, 0, args[4].shape[2], 16)[0] == wide
