"""Fused IVF cell scan (port of ``annsearch_tpu.ops.ivf_scan_pallas``,
variant K1a: int8 residual cells, ``l2`` epilogue, depth-2 fold, one bf16
query term).

``ivf_cell_scan`` is the kernel's wrapper. On CUDA tensors it launches the
hand-written kernel ``csrc/ivf_scan.cu``, which replaces the Pallas
``_scan_kernel`` / ``_scan_body`` (launched by ``_fused_cell_scan``); on CPU
tensors it runs ``ivf_cell_scan_plain``, the same computation in plain
PyTorch. There is no fallback between the two.

On the H100 the scan is bound by its multiply-adds, about R·maxq·seg·d
(1.3e11 at the 1M×128d main path, nprobe 16), which this first kernel does
on the CUDA cores: each block stages a segment's int8 rows in shared memory
once for 8 query slots, and the fold and the top-kb extraction stay in
registers, so the [maxq, seg] distance tile never reaches device memory.
See the kernel source for the layout.

``fused_ivf_scan`` is the host side around it: per task row, the segment
and its valid-row count; after it, the lane → storage-row remap, the
gather-map regroup per query and the final top-k.
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, fp32_matmul

__all__ = [
    "fused_eligible",
    "repack_blocks",
    "ivf_cell_scan",
    "ivf_cell_scan_plain",
    "fused_ivf_scan",
]

LANES = 128
#: finite "masked" value of the scan (ranks after every real distance)
BIG = 3.0e38
#: the kernel reads int8 rows in 16-byte vectors: cells pad d to this
_D_ALIGN = 16
#: widest padded row the kernel's shared-memory tile takes
_D_MAX = 384
#: task rows per step of the plain version (bounds its [rows, maxq, seg] tiles)
_PLAIN_ROWS = 64


def fused_eligible(mode: str, seg_size: int, dim_w: int, k: int) -> bool:
    """Whether the fused scan handles this index. Only the K1a variant is
    ported: int8 residual cells. The f32, bf16, sq8 and i8dec modes wait
    for kernels K1b–K1d (ROADMAP Queue 2)."""
    return (
        mode == "i8dec_residual"
        and seg_size % LANES == 0
        and seg_size >= LANES
        and k <= LANES
        and -(-dim_w // _D_ALIGN) * _D_ALIGN <= _D_MAX
    )


def repack_blocks(
    storage: torch.Tensor, sqnorms: torch.Tensor, seg_offsets: torch.Tensor,
    seg_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather the segmented storage into block-aligned tiles
    ``cells [nseg+1, seg, dp]`` and ``sn [nseg+1, seg]`` (+1 = the zero
    sentinel block of task rows that scan nothing). ``dp`` is ``d`` rounded
    up to 16 with zero columns, which add nothing to the dots."""
    idx = seg_offsets.long()[:, None] + torch.arange(seg_size, device=storage.device)
    d = storage.shape[1]
    dp = -(-d // _D_ALIGN) * _D_ALIGN
    cells = torch.zeros(
        (idx.shape[0] + 1, seg_size, dp), dtype=storage.dtype, device=storage.device
    )
    cells[:-1, :, :d] = storage[idx]
    sn = torch.zeros((idx.shape[0] + 1, seg_size), device=storage.device)
    sn[:-1] = sqnorms[idx].float()
    return cells, sn


def _query_terms(lists, task_seg, queries_x, cent_x, scales, dp):
    """Per-slot query residual norm ``qadd [R, maxq]`` and bf16 query term
    ``qk [R, maxq, dp]`` (as f32) — the kernel's prologue."""
    qr = queries_x[lists.long()] - cent_x[task_seg.long()][:, None, :]
    qadd = (qr * qr).sum(dim=-1)
    qk = (qr * scales).to(torch.bfloat16).float()
    if dp > qk.shape[-1]:
        qk = torch.nn.functional.pad(qk, (0, dp - qk.shape[-1]))
    return qadd, qk


def _fold_extract(dist: torch.Tensor, kb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth-2 stride-class fold of ``dist [..., seg]`` and kb rounds of the
    lexicographic (value, lane) minimum."""
    seg = dist.shape[-1]
    li = torch.arange(LANES, device=dist.device).expand(dist.shape[:-1] + (LANES,))
    vals, idx = dist[..., :LANES], li
    vals2 = torch.full_like(vals, BIG)
    idx2 = torch.zeros_like(idx)
    for c in range(1, seg // LANES):
        nv = dist[..., c * LANES : (c + 1) * LANES]
        ni = c * LANES + li
        upd = nv < vals
        lose_v = torch.where(upd, vals, nv)
        lose_i = torch.where(upd, idx, ni)
        vals = torch.where(upd, nv, vals)
        idx = torch.where(upd, ni, idx)
        upd2 = lose_v < vals2
        vals2 = torch.where(upd2, lose_v, vals2)
        idx2 = torch.where(upd2, lose_i, idx2)
    vals = torch.cat([vals, vals2], dim=-1)
    idx = torch.cat([idx, idx2], dim=-1)
    out_d, out_i = [], []
    for _ in range(kb):
        v = vals.min(dim=-1, keepdim=True).values
        hit = vals == v
        l_of_v = torch.where(hit, idx, seg).min(dim=-1, keepdim=True).values
        out_d.append(v)
        out_i.append(l_of_v)
        vals = torch.where(hit & (idx == l_of_v), BIG, vals)
    return torch.cat(out_d, dim=-1), torch.cat(out_i, dim=-1).int()


def ivf_cell_scan_plain(
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K1a kernel, chunked over task rows to
    bound memory. Arguments and result as :func:`ivf_cell_scan`."""
    R, maxq = lists.shape
    seg, dp = cells.shape[1], cells.shape[2]
    out_d = torch.empty((R, maxq, kb), device=lists.device)
    out_i = torch.empty((R, maxq, kb), dtype=torch.int32, device=lists.device)
    lane = torch.arange(seg, device=lists.device)
    for r0 in range(0, R, _PLAIN_ROWS):
        rs = slice(r0, r0 + _PLAIN_ROWS)
        s = task_seg[rs].long()
        qadd, qk = _query_terms(lists[rs], task_seg[rs], queries_x, cent_x, scales, dp)
        # bf16 query term × int8 cells: every product is exact in f32, and
        # the sums are f32 (fp32 batched matmul with TF32 off)
        with fp32_matmul():
            dots = torch.bmm(qk, cells[s].float().transpose(1, 2))
        dist = torch.clamp(qadd[:, :, None] + sn[s][:, None, :] - 2.0 * dots, min=0.0)
        dist = torch.where(lane < cnt[rs].long()[:, None, None], dist, BIG)
        out_d[rs], out_i[rs] = _fold_extract(dist, kb)
    return out_d, out_i


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.ndim != ndim or t.device != device:
        raise ValueError(
            f"{name}: expected {ndim}-D {dtype} on {device}, got "
            f"{t.ndim}-D {t.dtype} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def ivf_cell_scan(
    lists: torch.Tensor,      # [R, maxq] int32 query ids (pad = nq, a zero row)
    task_seg: torch.Tensor,   # [R] int32 segment block of each task row
    cnt: torch.Tensor,        # [R] int32 valid rows of that block (0 = skip)
    queries_x: torch.Tensor,  # [nq+1, d] f32 queries, last row zero
    cent_x: torch.Tensor,     # [nseg+1, d] f32 segment centroids, last zero
    scales: torch.Tensor,     # [d] f32 int8 decode scales
    cells: torch.Tensor,      # [nseg+1, seg, dp] int8 (repack_blocks)
    sn: torch.Tensor,         # [nseg+1, seg] f32 reconstruction sq norms
    kb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per task row and query slot, the kb best ``(distance, lane)`` of the
    row's segment: ``out_d [R, maxq, kb]`` f32, ``out_i [R, maxq, kb]``
    int32. CUDA tensors launch the kernel (or raise); CPU tensors run the
    plain version."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb
        )
    from ._cuda import load_library

    dev = lists.device
    for name, t, dtype, ndim in (
        ("lists", lists, torch.int32, 2), ("task_seg", task_seg, torch.int32, 1),
        ("cnt", cnt, torch.int32, 1), ("queries_x", queries_x, torch.float32, 2),
        ("cent_x", cent_x, torch.float32, 2), ("scales", scales, torch.float32, 1),
        ("cells", cells, torch.int8, 3), ("sn", sn, torch.float32, 2),
    ):
        _check(name, t, dtype, ndim, dev)
    R, maxq = lists.shape
    nsegp, seg, dp = cells.shape
    d = queries_x.shape[1]
    if (
        task_seg.shape[0] != R or cnt.shape[0] != R
        or cent_x.shape[1] != d or scales.shape[0] != d
        or sn.shape != (nsegp, seg)
        or seg % LANES or not 0 < kb <= LANES
        or dp % _D_ALIGN or not d <= dp <= _D_MAX
    ):
        raise ValueError(
            f"ivf_cell_scan: unsupported shapes R={R} maxq={maxq} seg={seg} "
            f"d={d} dp={dp} kb={kb}"
        )
    out_d = torch.empty((R, maxq, kb), dtype=torch.float32, device=dev)
    out_i = torch.empty((R, maxq, kb), dtype=torch.int32, device=dev)
    err = load_library().annsearch_ivf_scan_k1a(
        lists.data_ptr(), task_seg.data_ptr(), cnt.data_ptr(),
        queries_x.data_ptr(), cent_x.data_ptr(), scales.data_ptr(),
        cells.data_ptr(), sn.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        R, maxq, seg, d, dp, kb, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ivf_scan_k1a launch failed: cudaError {err}")
    ivf_cell_scan.launches += 1
    return out_d, out_i


#: kernel launches since the last reset (plain-version calls do not count)
ivf_cell_scan.launches = 0


def fused_ivf_scan(
    queries: torch.Tensor,       # [nq, d] f32
    cluster_ids: torch.Tensor,   # [R] segment ids (pad = nseg)
    probe_lists: torch.Tensor,   # [R, maxq] query ids (pad = nq)
    gather_map: torch.Tensor,    # [nq, T] flat scan lanes (pad = -1)
    cells: torch.Tensor,         # [nseg+1, seg, dp] int8
    sn: torch.Tensor,            # [nseg+1, seg] f32
    seg_offsets: torch.Tensor,   # [nseg] (maps lanes back to sorted rows)
    seg_counts: torch.Tensor,    # [nseg]
    seg_centroids: torch.Tensor, # [nseg, d] f32
    k: int,
    metric: Dist,
    mode: str,
    scales: torch.Tensor,        # [d] f32 decode scales
    kb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan of the task lists; ``(best_d, best_i)`` of shape
    ``[nq, k]`` ascending, ``best_i`` positions in the sorted storage."""
    if mode != "i8dec_residual" or metric != Dist.EUCLIDEAN:
        raise NotImplementedError(
            f"fused scan mode={mode!r} metric={metric.value!r}: only the "
            "euclidean i8dec_residual variant (K1a) is ported; see ROADMAP "
            "Queue 2 (K1b–K1d)"
        )
    nq, d = queries.shape
    nseg = seg_offsets.shape[0]
    dev = queries.device
    zero_row = torch.zeros((1, d), device=dev)
    queries_x = torch.cat([queries, zero_row])
    cent_x = torch.cat([seg_centroids.float(), zero_row])
    offs_x = torch.cat([seg_offsets.long(), torch.zeros(1, dtype=torch.long, device=dev)])
    cnts_x = torch.cat([seg_counts.int(), torch.zeros(1, dtype=torch.int32, device=dev)])

    cid = torch.clamp(cluster_ids.long(), max=nseg)
    qid = torch.clamp(probe_lists, max=nq).int().contiguous()
    cd, ci = ivf_cell_scan(
        qid, cid.int(), cnts_x[cid].contiguous(), queries_x, cent_x,
        scales.float().contiguous(), cells, sn, kb,
    )
    # lane → sorted-storage row; a sentinel lane of a short segment lands
    # in the padded trailing storage rows
    gi = offs_x[cid][:, None, None] + ci.long()

    # regroup per query; pad lanes (-1) read an appended (+inf, 0) row
    flat_d = torch.cat([cd.reshape(-1, kb), torch.full((1, kb), float("inf"), device=dev)])
    flat_i = torch.cat([gi.reshape(-1, kb), torch.zeros((1, kb), dtype=torch.long, device=dev)])
    gm = torch.where(gather_map < 0, flat_d.shape[0] - 1, gather_map)
    gd = flat_d[gm].reshape(nq, -1)
    gi2 = flat_i[gm].reshape(nq, -1)
    kk = min(k, gd.shape[1])
    # stable: equal distances keep task order, as lax.top_k keeps them
    order = torch.sort(gd, dim=-1, stable=True).indices[:, :kk]
    best_d = torch.gather(gd, 1, order)
    best_i = torch.gather(gi2, 1, order)
    if kk < k:
        best_d = torch.cat([best_d, torch.full((nq, k - kk), float("inf"), device=dev)], 1)
        best_i = torch.cat([best_i, torch.zeros((nq, k - kk), dtype=torch.long, device=dev)], 1)
    return best_d, best_i
