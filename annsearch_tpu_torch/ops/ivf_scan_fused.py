"""Fused IVF cell scan (port of ``annsearch_tpu.ops.ivf_scan_pallas``).

Three variants of the Pallas ``_scan_kernel`` / ``_scan_body`` (launched
by ``_fused_cell_scan``) are ported, each a hand-written kernel in
``csrc/ivf_scan.cu`` with a wrapper and a plain PyTorch version here:

* K1a, ``ivf_cell_scan``: int8 residual cells (``i8dec_residual``), ``l2``
  epilogue, depth-2 stride-class fold, one bf16 query term — the IVF-PQ
  main path;
* K1d-f32, ``ivf_cell_scan_f32_fold``: f32 cells, ``l2`` or ``cos_plain``,
  the same fold — ``IvfIndex.query(approx=True)``;
* K1c-f32, ``ivf_cell_scan_f32_exact``: f32 cells, ``l2`` or
  ``cos_plain``, exact per-segment selection — the recall-1.0 tier of
  ``IvfIndex.query(approx=False)``.

A wrapper launches its kernel on CUDA tensors (or raises) and runs the
plain version on CPU tensors; there is no fallback between the two. The
JAX package reaches f32 grade on a bf16 MXU with hi/lo mantissa splits
and the ``packed2`` lane layout; here the f32 dots are FP32 FFMA on the
CUDA cores.

On the H100 every variant is bound by its multiply-adds, about
R·maxq·seg·d (1.3e11 at the 1M×128d main path, nprobe 16), done on the
CUDA cores: each block stages a segment's rows in shared memory once for
8 query slots, and the selection stays in registers, so the [maxq, seg]
distance tile never reaches device memory. See the kernel source for the
layout.

``fused_ivf_scan`` is the host side around the kernels: per task row, the
segment and its valid-row count; after it, the lane → storage-row remap,
the gather-map regroup per query and the final top-k.
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, fp32_matmul

__all__ = [
    "fused_eligible",
    "repack_blocks",
    "ivf_cell_scan",
    "ivf_cell_scan_plain",
    "ivf_cell_scan_f32_exact",
    "ivf_cell_scan_f32_fold",
    "ivf_cell_scan_f32_plain",
    "fused_ivf_scan",
]

LANES = 128
#: finite "masked" value of the scan (ranks after every real distance)
BIG = 3.0e38
#: the kernel reads rows in 16-byte vectors: cells pad d to this
_D_ALIGN = 16
#: widest padded row the kernel's shared-memory tile takes (128 staged rows
#: of dp + 4 floats and 8 query rows of dp floats: 210,944 bytes at 384, of
#: the 232,448 a block may use)
_D_MAX = 384
#: task rows per step of the plain versions (bounds their [rows, maxq, seg]
#: tiles)
_PLAIN_ROWS = 64
#: storage modes with a ported fused kernel
_FUSED_MODES = ("i8dec_residual", "f32")


def fused_eligible(mode: str, seg_size: int, dim_w: int, k: int) -> bool:
    """Whether the fused scan handles this index: int8 residual cells (K1a)
    or f32 cells (K1c-f32, K1d-f32). The bf16, sq8 and i8dec modes wait for
    their K1c/K1d variants (ROADMAP Queue 2)."""
    return (
        mode in _FUSED_MODES
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
    up to 16 with zero columns, which add nothing to the dots. f32 cells
    stay f32 (no mantissa split)."""
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


# -- plain PyTorch versions ---------------------------------------------------


def _query_terms(lists, task_seg, queries_x, cent_x, scales, dp):
    """Per-slot query residual norm ``qadd [R, maxq]`` and bf16 query term
    ``qk [R, maxq, dp]`` (as f32) — K1a's prologue."""
    qr = queries_x[lists.long()] - cent_x[task_seg.long()][:, None, :]
    qadd = (qr * qr).sum(dim=-1)
    qk = (qr * scales).to(torch.bfloat16).float()
    return qadd, _pad_cols(qk, dp)


def _pad_cols(t: torch.Tensor, dp: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, dp - t.shape[-1])) if dp > t.shape[-1] else t


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


def _exact_extract(
    dist: torch.Tensor, kb: int, cnt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact selection from ``dist [rows, maxq, seg]``: the kb
    lexicographically smallest (value, lane) pairs (a stable sort), and
    (3e38, lane 0) in every slot at or past the row's ``cnt`` — the Pallas
    extraction sets each emitted lane to 3e38, so once the valid lanes are
    spent every round finds lane 0."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    vals, idx = vals[..., :kb], idx[..., :kb].int()
    past = torch.arange(kb, device=dist.device) >= cnt.long()[:, None, None]
    return torch.where(past, BIG, vals), torch.where(past, 0, idx)


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


def ivf_cell_scan_f32_plain(
    lists, task_seg, cnt, queries_x, cells, sn, kb: int, cosine: bool,
    exact: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1c-f32 (``exact``) and K1d-f32 (fold),
    chunked over task rows. Arguments and result as
    :func:`ivf_cell_scan_f32_exact`."""
    R, maxq = lists.shape
    seg, dp = cells.shape[1], cells.shape[2]
    out_d = torch.empty((R, maxq, kb), device=lists.device)
    out_i = torch.empty((R, maxq, kb), dtype=torch.int32, device=lists.device)
    lane = torch.arange(seg, device=lists.device)
    for r0 in range(0, R, _PLAIN_ROWS):
        rs = slice(r0, r0 + _PLAIN_ROWS)
        s = task_seg[rs].long()
        qk = queries_x[lists[rs].long()]
        # f32 × f32 dots summed in f32 (fp32 batched matmul, TF32 off)
        with fp32_matmul():
            dots = torch.bmm(_pad_cols(qk, dp), cells[s].transpose(1, 2))
        if cosine:
            dist = 1.0 - dots
        else:
            qadd = (qk * qk).sum(dim=-1)
            dist = torch.clamp(qadd[:, :, None] + sn[s][:, None, :] - 2.0 * dots, min=0.0)
        dist = torch.where(lane < cnt[rs].long()[:, None, None], dist, BIG)
        if exact:
            out_d[rs], out_i[rs] = _exact_extract(dist, kb, cnt[rs])
        else:
            out_d[rs], out_i[rs] = _fold_extract(dist, kb)
    return out_d, out_i


# -- kernel wrappers ----------------------------------------------------------


def _check_inputs(specs, device) -> None:
    """Each ``(name, tensor, dtype, ndim)`` lies on ``device``, has that
    type and rank, and is contiguous and 16-byte aligned."""
    for name, t, dtype, ndim in specs:
        if t.dtype != dtype or t.ndim != ndim or t.device != device:
            raise ValueError(
                f"{name}: expected {ndim}-D {dtype} on {device}, got "
                f"{t.ndim}-D {t.dtype} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _check_shapes(name, lists, task_seg, cnt, queries_x, cells, sn, kb) -> None:
    R, maxq = lists.shape
    nsegp, seg, dp = cells.shape
    d = queries_x.shape[1]
    if (
        task_seg.shape[0] != R or cnt.shape[0] != R
        or sn.shape != (nsegp, seg)
        or seg % LANES or not 0 < kb <= LANES
        or dp % _D_ALIGN or not d <= dp <= _D_MAX
    ):
        raise ValueError(
            f"{name}: unsupported shapes R={R} maxq={maxq} seg={seg} d={d} "
            f"dp={dp} kb={kb}"
        )


def _outputs(lists, kb):
    R, maxq = lists.shape
    return (
        torch.empty((R, maxq, kb), dtype=torch.float32, device=lists.device),
        torch.empty((R, maxq, kb), dtype=torch.int32, device=lists.device),
    )


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
    """K1a. Per task row and query slot, the kb best ``(distance, lane)``
    of the row's segment: ``out_d [R, maxq, kb]`` f32, ``out_i [R, maxq,
    kb]`` int32. CUDA tensors launch the kernel (or raise); CPU tensors run
    the plain version."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb
        )
    from ._cuda import load_library

    _check_inputs(
        (("lists", lists, torch.int32, 2), ("task_seg", task_seg, torch.int32, 1),
         ("cnt", cnt, torch.int32, 1), ("queries_x", queries_x, torch.float32, 2),
         ("cent_x", cent_x, torch.float32, 2), ("scales", scales, torch.float32, 1),
         ("cells", cells, torch.int8, 3), ("sn", sn, torch.float32, 2)),
        lists.device,
    )
    _check_shapes("ivf_cell_scan", lists, task_seg, cnt, queries_x, cells, sn, kb)
    d = queries_x.shape[1]
    if cent_x.shape[1] != d or scales.shape[0] != d:
        raise ValueError(f"ivf_cell_scan: cent_x / scales do not have d={d} columns")
    R, maxq = lists.shape
    _, seg, dp = cells.shape
    out_d, out_i = _outputs(lists, kb)
    err = load_library().annsearch_ivf_scan_k1a(
        lists.data_ptr(), task_seg.data_ptr(), cnt.data_ptr(),
        queries_x.data_ptr(), cent_x.data_ptr(), scales.data_ptr(),
        cells.data_ptr(), sn.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        R, maxq, seg, d, dp, kb, torch.cuda.current_stream(lists.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ivf_scan_k1a launch failed: cudaError {err}")
    ivf_cell_scan.launches += 1
    return out_d, out_i


#: kernel launches since the last reset (plain-version calls do not count)
ivf_cell_scan.launches = 0


def _launch_f32(name, lists, task_seg, cnt, queries_x, cells, sn, kb, cosine, exact):
    from ._cuda import load_library

    _check_inputs(
        (("lists", lists, torch.int32, 2), ("task_seg", task_seg, torch.int32, 1),
         ("cnt", cnt, torch.int32, 1), ("queries_x", queries_x, torch.float32, 2),
         ("cells", cells, torch.float32, 3), ("sn", sn, torch.float32, 2)),
        lists.device,
    )
    _check_shapes(name, lists, task_seg, cnt, queries_x, cells, sn, kb)
    R, maxq = lists.shape
    _, seg, dp = cells.shape
    out_d, out_i = _outputs(lists, kb)
    err = load_library().annsearch_ivf_scan_f32(
        lists.data_ptr(), task_seg.data_ptr(), cnt.data_ptr(),
        queries_x.data_ptr(), cells.data_ptr(), sn.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), R, maxq, seg, queries_x.shape[1],
        dp, kb, int(cosine), int(exact),
        torch.cuda.current_stream(lists.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out_d, out_i


def ivf_cell_scan_f32_exact(
    lists: torch.Tensor,      # [R, maxq] int32 query ids (pad = nq, a zero row)
    task_seg: torch.Tensor,   # [R] int32 segment block of each task row
    cnt: torch.Tensor,        # [R] int32 valid rows of that block (0 = skip)
    queries_x: torch.Tensor,  # [nq+1, d] f32 queries, last row zero
    cells: torch.Tensor,      # [nseg+1, seg, dp] f32 (repack_blocks)
    sn: torch.Tensor,         # [nseg+1, seg] f32 row sq norms
    kb: int,
    cosine: bool = False,     # epilogue cos_plain (1 − dot), else l2
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1c-f32: per task row and query slot, the kb lexicographically
    smallest ``(distance, lane)`` pairs of the row's segment, then
    (3e38, 0) past its valid rows; shapes as :func:`ivf_cell_scan`. CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    if not lists.is_cuda:
        return ivf_cell_scan_f32_plain(
            lists, task_seg, cnt, queries_x, cells, sn, kb, cosine, exact=True
        )
    out = _launch_f32("ivf_scan_f32_exact", lists, task_seg, cnt, queries_x,
                      cells, sn, kb, cosine, exact=True)
    ivf_cell_scan_f32_exact.launches += 1
    return out


ivf_cell_scan_f32_exact.launches = 0


def ivf_cell_scan_f32_fold(
    lists: torch.Tensor, task_seg: torch.Tensor, cnt: torch.Tensor,
    queries_x: torch.Tensor, cells: torch.Tensor, sn: torch.Tensor, kb: int,
    cosine: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1d-f32: as :func:`ivf_cell_scan_f32_exact`, with K1a's depth-2
    stride-class fold in place of the exact selection."""
    if not lists.is_cuda:
        return ivf_cell_scan_f32_plain(
            lists, task_seg, cnt, queries_x, cells, sn, kb, cosine, exact=False
        )
    out = _launch_f32("ivf_scan_f32_fold", lists, task_seg, cnt, queries_x,
                      cells, sn, kb, cosine, exact=False)
    ivf_cell_scan_f32_fold.launches += 1
    return out


ivf_cell_scan_f32_fold.launches = 0


# -- host side ----------------------------------------------------------------


def fused_ivf_scan(
    queries: torch.Tensor,       # [nq, d] f32
    cluster_ids: torch.Tensor,   # [R] segment ids (pad = nseg)
    probe_lists: torch.Tensor,   # [R, maxq] query ids (pad = nq)
    gather_map: torch.Tensor,    # [nq, T] flat scan lanes (pad = -1)
    cells: torch.Tensor,         # [nseg+1, seg, dp] int8 or f32
    sn: torch.Tensor,            # [nseg+1, seg] f32
    seg_offsets: torch.Tensor,   # [nseg] (maps lanes back to sorted rows)
    seg_counts: torch.Tensor,    # [nseg]
    seg_centroids: torch.Tensor, # [nseg, d] f32
    k: int,
    metric: Dist,
    mode: str,
    scales: torch.Tensor | None, # [d] f32 decode scales (i8dec_residual)
    kb: int,
    selection: str = "fold",     # "fold" or "exact" (f32 only)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan of the task lists; ``(best_d, best_i)`` of shape
    ``[nq, k]`` ascending, ``best_i`` positions in the sorted storage."""
    nq, d = queries.shape
    nseg = seg_offsets.shape[0]
    dev = queries.device
    zero_row = torch.zeros((1, d), device=dev)
    queries_x = torch.cat([queries.float(), zero_row])
    offs_x = torch.cat([seg_offsets.long(), torch.zeros(1, dtype=torch.long, device=dev)])
    cnts_x = torch.cat([seg_counts.int(), torch.zeros(1, dtype=torch.int32, device=dev)])
    cid = torch.clamp(cluster_ids.long(), max=nseg)
    qid = torch.clamp(probe_lists, max=nq).int().contiguous()
    task = (qid, cid.int(), cnts_x[cid].contiguous(), queries_x)

    if mode == "f32" and selection in ("fold", "exact"):
        scan = ivf_cell_scan_f32_exact if selection == "exact" else ivf_cell_scan_f32_fold
        cd, ci = scan(*task, cells, sn, kb, cosine=metric == Dist.COSINE)
    elif mode == "i8dec_residual" and metric == Dist.EUCLIDEAN and selection == "fold":
        cent_x = torch.cat([seg_centroids.float(), zero_row])
        cd, ci = ivf_cell_scan(*task, cent_x, scales.float().contiguous(), cells, sn, kb)
    else:
        raise NotImplementedError(
            f"fused scan mode={mode!r} metric={metric.value!r} "
            f"selection={selection!r}: the ported variants are K1a (euclidean "
            "i8dec_residual, fold), K1c-f32 and K1d-f32; see ROADMAP Queue 2 "
            "(K1b–K1d)"
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
