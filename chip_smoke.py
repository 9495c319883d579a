"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the CUDA kernels from ``annsearch_tpu_torch/csrc``.
Phase 2 holds K1a against its plain PyTorch version; phase 2b holds
K1c-f32 and K1d-f32 against theirs at seg 1024, d 64 and 128, maxq 64 and
256, both epilogues, with sentinel and short task rows.
Phase 3 drives the IVF-PQ main path through the port's facade: nlist 1024,
m = 128 (int8 fast-scan mode) over 1M × 128d Gaussian-cluster data, 30k
queries at nprobe 16, recall@10 against an exact scan of the first 2,000.
Phase 4 drives the plain IVF exact tier (K1c-f32) on the recall-1.0
workload of ``benchmarks/bench_exact_tier.py``: 500k × 64d lowrank data,
nlist 500, 15k queries at nprobe 22, k 15, with f32 queries, f64 queries
and certified queries against f32 and f64 ground truths; it also builds the
index twice from one seed and checks that the builds agree.
Phase 5 drives the cosine IVF index on phase 3's data (nlist 1024,
nprobe 16): the approximate tier (K1d-f32) and the exact tier, recall@10
on the first 1,000 queries; and the euclidean exact tier beside IVF-PQ.

Each kernel is timed and checked on the task inputs its path gave it (its
last launch there). The line before the last lists each kernel's launches
on its path, its error against the plain version, both times and its
bound; the last line of standard output is ``{"ok": true, "device":
{...}}``. Any failure exits non-zero. The script needs a CUDA card and
refuses to run without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N, D, NCLUST, NQ, K, NQ_GT = 1_000_000, 128, 100, 30_000, 10, 2_000
NLIST, M, NPROBE, SEED = 1024, 128, 16, 42
RECALL_MIN = 0.90
# phase 4: benchmarks/bench_exact_tier.py
EX_N, EX_D, EX_NQ, EX_K, EX_NLIST, EX_NPROBE = 500_000, 64, 15_000, 15, 500, 22
# phase 5: benchmarks/bench_ivf_1m_cosine.py at nprobe 16
COS_NQ_GT = 1_000

#: H100 SXM peaks (NVIDIA data sheet, dense): device memory, fp32 on the
#: CUDA cores, bf16 on the tensor cores
HBM_BYTES_S, FP32_FLOP_S, BF16_FLOP_S = 3.35e12, 67e12, 989e12
BIG = np.float32(3e38)


def _cuda_ms(fn, reps: int = 7) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after a warm-up,
    by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _wall_ms(fn, reps: int = 3):
    """Median wall milliseconds of ``fn()`` (ending in a synchronise) over
    ``reps`` runs after a warm-up, and the last result."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, out


class _Recorder:
    """Stands in for a kernel wrapper: records the arguments of each call
    and calls through; its ``launches`` is the wrapper's own count."""

    def __init__(self, fn, store: dict, name: str):
        self.fn, self.store, self.name = fn, store, name

    def __call__(self, *a, **kw):
        self.store[self.name] = (a, kw)
        return self.fn(*a, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, v):
        self.fn.launches = v


class _Capture:
    """Inside the block, the named kernel wrappers of
    ``annsearch_tpu_torch.ops.ivf_scan_fused`` record the arguments of
    their last call (the path's own task inputs)."""

    def __init__(self, *names):
        from annsearch_tpu_torch.ops import ivf_scan_fused as tsf

        self.tsf, self.names, self.args = tsf, names, {}

    def __enter__(self):
        self.orig = {n: getattr(self.tsf, n) for n in self.names}
        for n, fn in self.orig.items():
            setattr(self.tsf, n, _Recorder(fn, self.args, n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.tsf, n, fn)


def _agree(name, kd, ki, pd, pi, scale=None) -> float:
    """Kernel vs plain: distances within 1e-4·(1 + |d|), plus 2⁻¹⁶ of
    ``scale [R, maxq]`` where given, ≥ 99.9% of ids, sentinel entries
    exactly. Returns the largest distance error."""
    torch.cuda.synchronize()
    tol = 1e-4 * (1.0 + pd.abs())
    if scale is not None:
        tol = tol + 2.0 ** -16 * scale[..., None]
    ok_d = bool(((kd - pd).abs() <= tol).all())
    id_agree = (ki == pi).float().mean().item()
    sent = pd == BIG
    ok_s = bool(torch.equal(kd == BIG, sent)) and bool((ki[sent] == pi[sent]).all())
    err = (kd - pd).abs().max().item()
    print(f"  {name}: max |d| err {err:.3e}, ids agree {id_agree:.6f}, "
          f"sentinel entries {int(sent.sum())} {'equal' if ok_s else 'DIFFER'}",
          flush=True)
    if not (ok_d and ok_s) or id_agree < 0.999:
        raise AssertionError(
            f"{name} disagrees with its plain version (1e-4·(1+|d|) on "
            "distances, ≥ 99.9% of ids, sentinel entries exactly)"
        )
    return err


def _bound(args, kb, cell_bytes, peak, seg_bytes=0) -> tuple[float, str, float]:
    """Least time of a scan on these task inputs: this run's work (real
    query slots × valid rows × d multiply-adds) over ``peak``, and the
    bytes (each input read once: task lists, queries, the valid rows of
    each scanned segment with their norms, ``seg_bytes`` more per scanned
    segment; the outputs written once) over the memory rate. Returns (ms,
    what bounds it, multiply-adds)."""
    lists, task_seg, cnt, queries_x = args[:4]
    nq, d = queries_x.shape[0] - 1, queries_x.shape[1]
    real = (lists < nq).sum(dim=1).double()
    macs = float((real * cnt.double()).sum()) * d
    live = cnt > 0
    seg_rows = torch.zeros(int(task_seg.max()) + 1, dtype=torch.float64,
                           device=cnt.device)
    seg_rows[task_seg[live].long()] = cnt[live].double()
    nbytes = (lists.numel() * 4 + task_seg.numel() * 8 + queries_x.numel() * 4
              + float(seg_rows.sum()) * (d * cell_bytes + 4)
              + int((seg_rows > 0).sum()) * seg_bytes
              + lists.numel() * kb * 8)
    t_ops, t_bytes = 2 * macs / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    print(f"  bound: {macs:.4e} multiply-adds of this run's data → {t_ops:.4f} ms at "
          f"{peak / 1e12:.0f} TFLOP/s; {nbytes / 1e9:.4f} GB → {t_bytes:.4f} ms",
          flush=True)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", macs


def _l2_scale(a, kw):
    """Per (task row, slot), a bound on the terms of the l2 identity
    ``qadd + sn − 2·dots`` (2|dots| ≤ qadd + sn): f32 sums taken in two
    orders differ by a few ulps of it, however small the distance. None
    under cos_plain, whose terms are ≤ 1."""
    if kw.get("cosine"):
        return None
    lists, task_seg, _, queries_x = a[:4]
    sn = a[-2]
    qn = queries_x.norm(dim=1)[lists.long()]
    if len(a) == 9:     # K1a: qadd = ‖q − c‖² ≤ (‖q‖ + ‖c‖)²
        qn = qn + a[4].norm(dim=1)[task_seg.long()][:, None]
    return qn * qn + sn.max(dim=1).values[task_seg.long()][:, None]


def _kernel_entry(name, wrapper, plain, call, cell_bytes, peak, seg_bytes=0):
    """Check ``wrapper`` against ``plain`` on the captured call, time both,
    and return the kernel's JSON entry (launches filled in by the caller)."""
    a, kw = call
    kb = next(v for v in a if isinstance(v, int))
    cells = next(t for t in a[4:] if torch.is_tensor(t) and t.ndim == 3)
    err = _agree(name, *wrapper(*a, **kw), *plain(*a, **kw), scale=_l2_scale(a, kw))
    ms = _cuda_ms(lambda: wrapper(*a, **kw))
    plain_ms = _cuda_ms(lambda: plain(*a, **kw), reps=5)
    bound_ms, bound_by, macs = _bound(a, kb, cell_bytes, peak, seg_bytes)
    print(f"  {name} on its path's tasks (R={a[0].shape[0]}, maxq={a[0].shape[1]}, "
          f"seg={cells.shape[1]}, dp={cells.shape[2]}, kb={kb}): kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{2 * macs / ms / 1e9:.2f} TFLOP/s of this run's work; the kernel "
          f"computes all {a[0].numel() * cells.shape[1] * cells.shape[2]:.4e} "
          "slot × lane × column multiply-adds", flush=True)
    return {"name": name, "route": "cuda",
            "source": "annsearch_tpu_torch/csrc/ivf_scan.cu",
            "replaces": "annsearch_tpu/ops/ivf_scan_pallas.py:130",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# -- phase 2 / 2b: kernels against their plain versions -----------------------


def _k1a_inputs(gen: torch.Generator, dev):
    """Task inputs at the main path's shapes: seg 1024, d 128, maxq 256,
    kb 16, 384 task rows, among them rows with cnt == 0 and partial rows."""
    R, maxq, seg, d, nseg, nq = 384, 256, 1024, 128, 200, 4096
    cells = torch.randint(-127, 128, (nseg + 1, seg, d), generator=gen,
                          device=dev, dtype=torch.int8)
    cells[-1] = 0
    scales = torch.rand(d, generator=gen, device=dev) * 0.02 + 0.005
    sn = ((cells.float() * scales) ** 2).sum(-1)
    queries = torch.randn(nq + 1, d, generator=gen, device=dev) * 1.5
    queries[-1] = 0
    cents = torch.randn(nseg + 1, d, generator=gen, device=dev) * 0.5
    cents[-1] = 0
    task_seg = torch.randint(0, nseg, (R,), generator=gen, device=dev)
    cnt = torch.full((R,), seg, device=dev)
    cnt[::7] = torch.randint(1, seg, (len(range(0, R, 7)),), generator=gen, device=dev)
    cnt[3::11] = 0
    task_seg[3::11] = nseg
    lists = torch.randint(0, nq + 1, (R, maxq), generator=gen, device=dev)
    return (lists.int(), task_seg.int(), cnt.int(), queries, cents, scales,
            cells, sn, 16)


def _f32_inputs(gen: torch.Generator, dev, d: int, maxq: int, R=192, seg=1024,
                nseg=150, nq=4096):
    """f32 task inputs: rows with cnt == 0, rows shorter than kb (cnt 5)
    and partial rows."""
    cells = torch.zeros((nseg + 1, seg, d), device=dev)
    cells[:-1] = torch.randn((nseg, seg, d), generator=gen, device=dev)
    sn = (cells * cells).sum(-1)
    queries = torch.randn(nq + 1, d, generator=gen, device=dev)
    queries[-1] = 0
    task_seg = torch.randint(0, nseg, (R,), generator=gen, device=dev)
    cnt = torch.full((R,), seg, device=dev)
    cnt[::7] = torch.randint(1, seg, (len(range(0, R, 7)),), generator=gen, device=dev)
    cnt[5::13] = 5
    cnt[3::11] = 0
    task_seg[3::11] = nseg
    lists = torch.randint(0, nq + 1, (R, maxq), generator=gen, device=dev)
    return lists.int(), task_seg.int(), cnt.int(), queries, cells, sn


def phase_kernels(dev) -> None:
    from annsearch_tpu_torch.ops import ivf_scan_fused as tsf

    gen = torch.Generator(device=dev).manual_seed(SEED)
    args = _k1a_inputs(gen, dev)
    _agree("K1a (R=384, maxq=256, seg=1024, d=128, kb=16)",
           *tsf.ivf_cell_scan(*args), *tsf.ivf_cell_scan_plain(*args))
    print(f"  K1a {_cuda_ms(lambda: tsf.ivf_cell_scan(*args)):.3f} ms, plain "
          f"{_cuda_ms(lambda: tsf.ivf_cell_scan_plain(*args), reps=5):.3f} ms",
          flush=True)

    for d in (64, 128):
        for maxq in (64, 256):
            t = _f32_inputs(gen, dev, d, maxq)
            for exact, kb in ((True, 24), (False, 16)):
                wrapper = tsf.ivf_cell_scan_f32_exact if exact else tsf.ivf_cell_scan_f32_fold
                for cosine in (False, True):
                    name = (f"{'K1c' if exact else 'K1d'}-f32 {'cos_plain' if cosine else 'l2'} "
                            f"(R=192, maxq={maxq}, seg=1024, d={d}, kb={kb})")
                    _agree(name, *wrapper(*t, kb, cosine=cosine),
                           *tsf.ivf_cell_scan_f32_plain(*t, kb, cosine, exact=exact))
                    ms = _cuda_ms(lambda: wrapper(*t, kb, cosine=cosine), reps=5)
                    pms = _cuda_ms(lambda: tsf.ivf_cell_scan_f32_plain(
                        *t, kb, cosine, exact=exact), reps=5)
                    print(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms", flush=True)


# -- phase 3: the IVF-PQ main path --------------------------------------------


def phase_ivf_pq(dev, x, q, ti):
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
    from annsearch_tpu_torch.ops.probe_device import device_probe_shapes

    torch.cuda.synchronize()
    t0 = time.time()
    index = at.build_ivf_pq_index(x, nlist=NLIST, m=M, seed=SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0

    tsf.ivf_cell_scan.launches = 0
    with _Capture("ivf_cell_scan") as cap:
        ms, (ids, dists) = _wall_ms(lambda: index.query(q, K, nprobe=NPROBE, approx=True))
    launches = tsf.ivf_cell_scan.launches

    recall = at.calculate_recall(ti, ids[:NQ_GT], K)
    nseg = int(index.seg_offsets.shape[0])
    nprobe_seg = min(nseg, max(NPROBE, -(-NPROBE * nseg) // NLIST))
    maxq, R = device_probe_shapes(NQ, nprobe_seg, nseg, 1)
    print(f"  build {build_s:.2f} s, nseg {nseg}, nprobe_seg {nprobe_seg}, "
          f"maxq {maxq}, R {R}, query {ms:.1f} ms (median of 3) = "
          f"{NQ / ms * 1e3:.0f} QPS, recall@10 {recall:.4f}, K1a launches {launches}",
          flush=True)

    # the result: shape, finite ascending distances that match an f32
    # recomputation from the index's own reconstructions
    if ids.shape != (NQ, K) or dists.shape != (NQ, K):
        raise AssertionError(f"bad result shapes {ids.shape} {dists.shape}")
    if not torch.isfinite(dists).all() or (dists.diff(dim=1) < -1e-3).any():
        raise AssertionError("distances not finite and ascending")
    if ids.min() < 0 or ids.max() >= N:
        raise AssertionError("ids out of range")
    # bound: the bf16 query term carries a relative error ≤ 2⁻⁹ per
    # component, so |Δdist| ≤ 2⁻⁸·‖q−c‖·‖x−c‖ (c = the row's centroid),
    # plus f32 rounding
    owner = torch.empty(N, dtype=torch.long, device=dev)
    owner[index.original_ids] = index._owner_clusters()
    recon = index.vectors_original_order()[ids[:256]]
    cent = index.centroids[owner[ids[:256]]]
    d_ref = ((q[:256, None, :] - recon) ** 2).sum(-1)
    tol = (2.0 ** -8) * (q[:256, None, :] - cent).norm(dim=-1) * (
        recon - cent
    ).norm(dim=-1) + 1e-3 * (1.0 + d_ref)
    worst = ((dists[:256] - d_ref).abs() / tol).max().item()
    print(f"  distances vs f32 recomputation: worst |err|/bound {worst:.3f}", flush=True)
    if worst > 1.0:
        raise AssertionError("returned distances disagree with the index")
    if recall < RECALL_MIN:
        raise AssertionError(f"recall@10 {recall:.4f} < {RECALL_MIN}")
    if launches == 0:
        raise AssertionError("the IVF-PQ path never launched the K1a kernel")
    # bf16 × int8 products are exact in bf16 MMA: the bound takes the bf16
    # tensor-core peak, and the fp32 CUDA-core peak (where K1a runs now)
    # is printed beside it
    # (K1a also reads each scanned segment's centroid row, d floats)
    entry = _kernel_entry("ivf_scan_k1a", tsf.ivf_cell_scan, tsf.ivf_cell_scan_plain,
                          cap.args["ivf_cell_scan"], 1, BF16_FLOP_S, D * 4)
    fp32_ms = _bound(cap.args["ivf_cell_scan"][0], 16, 1, FP32_FLOP_S, D * 4)[0]
    print(f"  K1a bound at the fp32 CUDA-core peak: {fp32_ms:.4f} ms", flush=True)
    entry["launches"] = launches
    return entry, recall


# -- phase 4: the plain IVF exact tier ----------------------------------------


def phase_exact_tier(dev) -> dict:
    from annsearch_tpu_torch.models.exhaustive import ExhaustiveIndex
    from annsearch_tpu_torch.models.ivf import IvfIndex
    from annsearch_tpu_torch.models.ivf_base import _cert_flags, route_to_cells
    from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
    from annsearch_tpu_torch.ops.probe_device import compact_probe_shapes, route_pair_stats
    from annsearch_tpu_torch.utils.data import generate_data
    from annsearch_tpu_torch.utils.metrics import calculate_recall

    t0 = time.time()
    x, _ = generate_data("lowrank", EX_N, EX_D, 12, seed=42, intrinsic_dim=16)
    rng = np.random.default_rng(0)
    qi = rng.choice(EX_N, size=EX_NQ, replace=False)
    q = x[qi] + (0.05 * rng.standard_normal((EX_NQ, EX_D))).astype(np.float32)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    print(f"  data {EX_N}x{EX_D} lowrank + {EX_NQ} queries in {time.time() - t0:.1f} s",
          flush=True)

    t0 = time.time()
    exact = ExhaustiveIndex(x64, device=dev)
    gt32, _ = exact.query(q, EX_K)              # fp32, TF32 off
    gt64, gd64 = exact.query(q64, EX_K)         # 2k pool + host f64 rescore
    torch.cuda.synchronize()
    print(f"  ground truths (f32, f64) in {time.time() - t0:.1f} s", flush=True)
    del exact

    builds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        builds.append(IvfIndex(x64, nlist=EX_NLIST, seed=42, device=dev))
        torch.cuda.synchronize()
        print(f"  build {len(builds)}: {time.time() - t0:.2f} s", flush=True)
    first, index = builds
    same = (torch.equal(first.seg_counts, index.seg_counts)
            and torch.equal(first.centroids, index.centroids))
    print(f"  two builds from one seed agree: {same}", flush=True)
    if not same:
        raise AssertionError("two IvfIndex builds from one seed differ")
    del first, builds

    qd = torch.as_tensor(q, device=dev)
    nseg = int(index.seg_offsets.shape[0])
    s_max = index._seg_s_max()
    probes = route_to_cells(qd, index.centroids, EX_NPROBE, index.metric)
    total, qmax = route_pair_stats(probes, index._cluster_ptr_dev()).tolist()
    P, _, maxq, R = compact_probe_shapes(total, qmax, nseg)
    print(f"  nseg {nseg}, s_max {s_max}, pairs {total}, P {P}, maxq {maxq}, R {R}",
          flush=True)

    # each query kind's own K1c-f32 launches (a warm-up and 3 timed runs)
    counts = {}

    def run(kind, fn):
        tsf.ivf_cell_scan_f32_exact.launches = 0
        out = _wall_ms(fn)
        counts[kind] = tsf.ivf_cell_scan_f32_exact.launches
        return out

    with _Capture("ivf_cell_scan_f32_exact") as cap:
        ms32, (ids32, d32) = run("f32", lambda: index.query(q, EX_K, nprobe=EX_NPROBE))
    ms64, (ids64, d64) = run("f64", lambda: index.query(q64, EX_K, nprobe=EX_NPROBE))
    msc, (idsc, dc) = run(
        "certified", lambda: index.query(q, EX_K, nprobe=EX_NPROBE, certify=True))
    launches = counts["f32"]

    _, flags = _cert_flags(
        qd, index.centroids, index._cell_radii(), d32[:, EX_K - 1],
        torch.full((EX_NQ,), EX_NPROBE, device=dev), index.metric,
    )
    xd = torch.as_tensor(x, device=dev)
    # the tier's promise, apart from routing: exact within the probed cells
    within = calculate_recall(_probed_truth(index, xd, qd, probes, EX_K), ids32, EX_K)
    print(f"  f32 queries vs an f64 scan of their probed cells: recall@15 {within:.6f}",
          flush=True)
    rec = {}
    for name, ids, ms in (("f32 queries", ids32, ms32), ("f64 queries", ids64, ms64),
                          ("certified f32 queries", idsc, msc)):
        rec[name] = (calculate_recall(gt32, ids, EX_K), calculate_recall(gt64, ids, EX_K))
        print(f"  {name}: {ms:.1f} ms (median of 3), recall@15 vs f32 GT "
              f"{rec[name][0]:.6f}, vs f64 GT {rec[name][1]:.6f}", flush=True)
    print(f"  the certificate re-probed {int(flags.sum())} of {EX_NQ} queries; "
          f"K1c-f32 launches over 4 batches each: f32 {counts['f32']}, f64 "
          f"{counts['f64']}, certified {counts['certified']}", flush=True)

    sweep = {}
    for npr in (32, 48, 64):
        ms, (ids, _) = _wall_ms(lambda: index.query(q, EX_K, nprobe=npr))
        sweep[npr] = calculate_recall(gt64, ids, EX_K)
        print(f"  f32 queries at nprobe {npr}: {ms:.1f} ms, recall@15 vs f64 GT "
              f"{sweep[npr]:.6f}", flush=True)
    ref = ((qd[:, None, :] - xd[ids32]) ** 2).sum(-1)
    worst = ((d32 - ref).abs() / (1e-5 * (1.0 + ref))).max().item()
    kth_ok = bool((dc[:, -1].double() <= gd64[:, -1] * (1 + 1e-5) + 1e-6).all())
    print(f"  distances vs f32 recomputation: worst |err| / 1e-5(1+d) {worst:.3f}; "
          f"certified 15th distance ≤ f64 GT's: {kth_ok}", flush=True)
    # at nprobe 22 the plain tier's recall is set by routing over the
    # port's balanced cells (PERF.md §7): exact within the probed cells,
    # a floor against the f64 truth; ≥ 0.999 against it from nprobe 32
    if within < 0.999 or rec["f32 queries"][1] < 0.99:
        raise AssertionError("exact tier recall@15 below 0.999 within its probed "
                             "cells or below 0.99 against the f64 GT at nprobe 22")
    if sweep[32] < 0.999:
        raise AssertionError("exact tier recall@15 vs the f64 GT < 0.999 at nprobe 32")
    if rec["certified f32 queries"][1] < 0.9999:
        raise AssertionError("certified recall@15 vs the f64 GT < 0.9999")
    if not kth_ok:
        raise AssertionError("a certified 15th distance exceeds the f64 GT's")
    if worst > 1.0:
        raise AssertionError("exact-tier distances disagree with an f32 recomputation")
    if s_max <= 1 or launches == 0:
        raise AssertionError("the compact path or the K1c-f32 kernel did not run")
    entry = _kernel_entry(
        "ivf_scan_f32_exact", tsf.ivf_cell_scan_f32_exact,
        lambda *a, **kw: tsf.ivf_cell_scan_f32_plain(*a, exact=True, **kw),
        cap.args["ivf_cell_scan_f32_exact"], 4, FP32_FLOP_S,
    )
    entry["launches"] = launches
    return entry


def _probed_truth(index, xd, qd, probes, k, block=1024):
    """Top-k ids of an f64 scan of each query's probed cells (f64, so that
    the ‖q‖² + ‖x‖² − 2q·x identity adds no rank flips of its own)."""
    owner = torch.empty(index.n, dtype=torch.long, device=xd.device)
    owner[index.original_ids] = index._owner_clusters()
    x64 = xd.double()
    xn = (x64 * x64).sum(1)
    out = []
    for s in range(0, qd.shape[0], block):
        qb = qd[s : s + block].double()
        d = (qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * qb @ x64.T
        probed = torch.zeros((d.shape[0], index.nlist), dtype=torch.bool, device=xd.device)
        probed.scatter_(1, probes[s : s + block], True)
        d = torch.where(probed[:, owner], d, float("inf"))
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out)


# -- phase 5: the IVF index at 1M x 128d, cosine and euclidean ----------------


def phase_ivf_1m(dev, x, q, ti_euc, pq_recall) -> dict:
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
    from annsearch_tpu_torch.utils.dist import normalise

    torch.cuda.synchronize()
    t0 = time.time()
    cos = at.build_ivf_index(x, nlist=NLIST, dist_metric="cosine", seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"  cosine build {time.time() - t0:.2f} s, nseg {cos.seg_offsets.shape[0]}, "
          f"s_max {cos._seg_s_max()}", flush=True)
    ti, _ = at.build_exhaustive_index(x, "cosine", device=dev).query(q[:COS_NQ_GT], K)

    tsf.ivf_cell_scan_f32_fold.launches = 0
    with _Capture("ivf_cell_scan_f32_fold") as cap:
        ms_a, (ia, _) = _wall_ms(lambda: cos.query(q, K, nprobe=NPROBE, approx=True))
    fold_launches = tsf.ivf_cell_scan_f32_fold.launches
    before = tsf.ivf_cell_scan_f32_exact.launches
    ms_e, (ie, de) = _wall_ms(lambda: cos.query(q, K, nprobe=NPROBE))
    exact_launches = tsf.ivf_cell_scan_f32_exact.launches - before
    ra = at.calculate_recall(ti, ia[:COS_NQ_GT], K)
    re_ = at.calculate_recall(ti, ie[:COS_NQ_GT], K)
    print(f"  cosine approx (K1d-f32): {ms_a:.1f} ms (median of 3), recall@10 {ra:.4f}, "
          f"launches {fold_launches}; exact (K1c-f32): {ms_e:.1f} ms, recall@10 "
          f"{re_:.4f}, launches {exact_launches}", flush=True)
    qn, xn = normalise(q[:512]), normalise(x)
    ref = 1.0 - (qn[:, None, :] * xn[ie[:512]]).sum(-1)
    err = (de[:512] - ref).abs().max().item()
    print(f"  cosine exact distances vs f32 recomputation: max |err| {err:.3e}", flush=True)
    if min(ra, re_) < RECALL_MIN:
        raise AssertionError(f"cosine IVF recall@10 {ra:.4f} / {re_:.4f} < {RECALL_MIN}")
    if fold_launches == 0 or exact_launches == 0:
        raise AssertionError("a cosine IVF tier did not launch its kernel")
    if err > 1e-5:
        raise AssertionError("cosine exact distances disagree with 1 − q·x")
    entry = _kernel_entry(
        "ivf_scan_f32_fold", tsf.ivf_cell_scan_f32_fold,
        lambda *a, **kw: tsf.ivf_cell_scan_f32_plain(*a, exact=False, **kw),
        cap.args["ivf_cell_scan_f32_fold"], 4, FP32_FLOP_S,
    )
    entry["launches"] = fold_launches
    del cos

    euc = at.build_ivf_index(x, nlist=NLIST, seed=SEED, device=dev)
    ms, (ids, _) = _wall_ms(lambda: euc.query(q, K, nprobe=NPROBE))
    r = at.calculate_recall(ti_euc, ids[:NQ_GT], K)
    print(f"  euclidean IvfIndex exact tier at nprobe {NPROBE}: {ms:.1f} ms, recall@10 "
          f"{r:.4f} (IVF-PQ approx: {pq_recall:.4f})", flush=True)
    return entry


def phase_kmeans_sums(dev) -> None:
    """One Lloyd iteration's cluster sums at 250k × 128 rows, k 1024: the
    fixed-order sum against ``index_add_`` (float atomics), beside the
    iteration's assignment step."""
    from annsearch_tpu_torch.models import kmeans
    from annsearch_tpu_torch.utils.dist import sq_norms

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(250_000, 128, generator=gen, device=dev)
    c = x[torch.randperm(250_000, generator=gen, device=dev)[:1024]]
    xs = sq_norms(x)
    a, _ = kmeans._assign_chunked(x, c, xs)
    fixed = _cuda_ms(lambda: kmeans.cluster_sums(x, a, 1024))
    atomic = _cuda_ms(lambda: (torch.zeros_like(c).index_add_(0, a, x),
                               torch.bincount(a, minlength=1024)))
    assign = _cuda_ms(lambda: kmeans._assign_chunked(x, c, xs))
    print(f"  cluster sums at 250k x 128, k 1024: fixed order {fixed:.3f} ms, "
          f"index_add_ {atomic:.3f} ms; the assignment step {assign:.3f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    t_start = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls must be off for the f32 references")
    dev = torch.device("cuda:0")

    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.ops import _cuda
    from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

    def phase(name):
        print(f"phase {name} (at {time.time() - t_start:.1f} s)", flush=True)

    phase("1: build the kernels")
    t0 = time.time()
    _cuda.load_library()
    print(f"  kernels built/loaded in {time.time() - t0:.1f} s", flush=True)
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip(), flush=True)

    phase("2/2b: kernels against their plain versions")
    phase_kernels(dev)

    phase("3: IVF-PQ 1M x 128d, nprobe 16")
    t0 = time.time()
    x_np, _ = generate_clustered_data(N, D, NCLUST, seed=SEED)
    q_np = subsample_with_noise(x_np, NQ, seed=SEED)
    x = torch.as_tensor(x_np, device=dev)
    q = torch.as_tensor(q_np, device=dev)
    del x_np, q_np
    ti, _ = at.build_exhaustive_index(x, device=dev).query(q[:NQ_GT], K)
    print(f"  data {N}x{D} + {NQ} queries and the exact scan in "
          f"{time.time() - t0:.1f} s", flush=True)
    k1a, pq_recall = phase_ivf_pq(dev, x, q, ti)

    phase("4: IvfIndex exact tier, 500k x 64d lowrank, nprobe 22, k 15")
    exact = phase_exact_tier(dev)

    phase("5: IvfIndex 1M x 128d, cosine approx and exact, euclidean exact")
    fold = phase_ivf_1m(dev, x, q, ti, pq_recall)
    del x, q

    phase("k-means cluster sums")
    phase_kmeans_sums(dev)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"total {time.time() - t_start:.1f} s", flush=True)

    print(smi, flush=True)
    print(json.dumps({"kernels": [k1a, exact, fold]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
