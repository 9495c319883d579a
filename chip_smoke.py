"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the CUDA kernels from ``annsearch_tpu_torch/csrc``. Phase 2
holds each kernel against its plain PyTorch version at the main path's
shapes and times both. Phase 3 drives the main path through the port's
facade: IVF-PQ (nlist 1024, m = 128, int8 fast-scan mode) over 1M × 128d
Gaussian-cluster data, 30k queries at nprobe 16, scored as recall@10
against an exact scan of the first 2,000 queries.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists each kernel's launches on the main path, its error
against the plain version, and both times. Any failure exits non-zero. The
script needs a CUDA card and refuses to run without one.
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


def phase_kernels(dev) -> list[dict]:
    from annsearch_tpu_torch.ops.ivf_scan_fused import (
        ivf_cell_scan, ivf_cell_scan_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    args = _k1a_inputs(gen, dev)
    kd, ki = ivf_cell_scan(*args)
    pd, pi = ivf_cell_scan_plain(*args)
    torch.cuda.synchronize()
    ok_d = ((kd - pd).abs() <= 1e-4 * (1.0 + pd.abs())).all().item()
    id_agree = (ki == pi).float().mean().item()
    max_abs_err = (kd - pd).abs().max().item()
    print(f"K1a vs plain: max |d| err {max_abs_err:.3e}, ids agree "
          f"{id_agree:.6f}, sentinel rows {(args[2] == 0).sum().item()}, "
          f"partial rows {((args[2] > 0) & (args[2] < 1024)).sum().item()}",
          flush=True)
    if not ok_d or id_agree < 0.999:
        raise AssertionError(
            "K1a disagrees with its plain version (tolerance 1e-4·(1+|d|) on "
            "distances, ≥ 99.9% of ids)"
        )
    ms = _cuda_ms(lambda: ivf_cell_scan(*args))
    plain_ms = _cuda_ms(lambda: ivf_cell_scan_plain(*args))
    print(f"K1a {ms:.3f} ms, plain {plain_ms:.3f} ms (R=384, maxq=256, "
          "seg=1024, d=128, kb=16)", flush=True)
    return [{
        "name": "ivf_scan_k1a",
        "route": "cuda",
        "source": "annsearch_tpu_torch/csrc/ivf_scan.cu",
        "replaces": "annsearch_tpu/ops/ivf_scan_pallas.py:130",
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]


def phase_main_path(dev) -> dict:
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.ops.ivf_scan_fused import ivf_cell_scan
    from annsearch_tpu_torch.ops.probe_device import device_probe_shapes
    from annsearch_tpu_torch.utils.data import (
        generate_clustered_data, subsample_with_noise,
    )

    t0 = time.time()
    x_np, _ = generate_clustered_data(N, D, NCLUST, seed=SEED)
    q_np = subsample_with_noise(x_np, NQ, seed=SEED)
    x = torch.as_tensor(x_np, device=dev)
    q = torch.as_tensor(q_np, device=dev)
    print(f"data {N}x{D} + {NQ} queries in {time.time() - t0:.1f} s", flush=True)

    ivf_cell_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    index = at.build_ivf_pq_index(x, nlist=NLIST, m=M, seed=SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0

    exact = at.build_exhaustive_index(x, device=dev)
    ti, td = exact.query(q[:NQ_GT], K)
    del exact

    ids, dists = index.query(q, K, nprobe=NPROBE, approx=True)  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.time()
        ids, dists = index.query(q, K, nprobe=NPROBE, approx=True)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    launches = ivf_cell_scan.launches

    recall = at.calculate_recall(ti, ids[:NQ_GT], K)
    nseg = int(index.seg_offsets.shape[0])
    nprobe_seg = min(nseg, max(NPROBE, -(-NPROBE * nseg) // NLIST))
    maxq, R = device_probe_shapes(NQ, nprobe_seg, nseg, 1)
    qps = NQ / float(np.median(times))
    print(f"build {build_s:.2f} s, nseg {nseg}, nprobe_seg {nprobe_seg}, "
          f"maxq {maxq}, R {R}, query {np.median(times) * 1e3:.1f} ms "
          f"(median of 3) = {qps:.0f} QPS, recall@10 {recall:.4f}, "
          f"K1a launches {launches}", flush=True)

    # the result: shape, dtype, finite ascending distances that match an
    # f32 recomputation from the index's own reconstructions
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
    print(f"distances vs f32 recomputation: worst |err|/bound {worst:.3f}",
          flush=True)
    if worst > 1.0:
        raise AssertionError("returned distances disagree with the index")
    if recall < RECALL_MIN:
        raise AssertionError(f"recall@10 {recall:.4f} < {RECALL_MIN}")
    if launches == 0:
        raise AssertionError("the main path never launched the K1a kernel")
    return {"ivf_scan_k1a": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
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

    from annsearch_tpu_torch.ops import _cuda

    t0 = time.time()
    _cuda.load_library()
    print(f"kernels built/loaded in {time.time() - t0:.1f} s", flush=True)
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip(), flush=True)

    kernels = phase_kernels(dev)
    launches = phase_main_path(dev)
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
