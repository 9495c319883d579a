"""Cluster-major IVF scan (port of ``annsearch_tpu.ops.ivf_scan``): the
host task-list builder and the scan composed of tensor operations.

The JAX package composes this scan of XLA operations (no Pallas kernel), so
here it is composed of PyTorch operations: per step, a batch of task rows
gathers its cells, decodes them (variant-specific), scores them against the
rows' query lists with one batched matmul, and keeps each (query, task)
pair's top k; a host-built gather map then regroups the lanes per
query for the final top-k. It serves what the fused kernels do not: the
PQ-coded modes (``pq``, ``pq_residual``), the exact tier of the int8-decode
modes, and every shape the fused scan's gate refuses (k > 128, a
``seg_size`` that is no multiple of 128).

Choices of the port, where the JAX package's depend on its hardware:

* every matmul is float32 with TF32 off. The JAX package scores the PQ and
  int8-decode modes at its DEFAULT precision (one bf16 pass on an
  accelerator, float32 on the CPU) and mode ``f32`` at HIGHEST; the card
  has real fp32 units, so all take the higher grade;
* PQ codes are decoded by a gather in f32 (``ops.quantised``), not by a
  one-hot matmul over bf16 codebooks;
* the per-cell selection is always the exact top-k
  (``torch.topk``): the JAX package's ``approx=True`` takes
  ``lax.approx_min_k`` there, an accelerator's partial-reduce selection with
  no counterpart here;
* rows per step follow a memory budget (``step_bytes``) instead of a fixed
  4: a Python loop of tiny launches would leave the card idle. Each row's
  result depends on that row alone, so the answer does not depend on the
  batch.

The binary modes score packed codes (int32 words, ``ops.binary``)
unpacked to ±1 per step: ``hamming`` (±1 query codes: ``(nbits − dot)/2``,
exact), ``binary_asym`` (``−dot`` of the bf16-rounded projected query) and
``rabitq`` (the RaBitQ estimator of the rotated, zero-padded query against
the segment's rotated centroid, ``aux`` the rows' ``‖R·u‖₁``). Their
products take the JAX package's DEFAULT precision, one bf16 operand pass
with f32 sums, here as f32 products of the bf16-rounded values (exact).
Hamming distances are small integers that tie at nearly every rank, so
the binary modes select each cell's top-k tie-exactly (``topk_smallest``,
``lax.top_k``'s order) and return the JAX package's ids; the other modes
keep ``torch.topk``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.dist import Dist, _sqrt_f32, fp32_matmul, sq_norms
from .binary import unpack_pm1
from .ivf_scan_fused import regroup_topk
from .quantised import pq_decode_tile
from .topk import topk_smallest

__all__ = ["ivf_cluster_scan", "build_probe_lists", "build_probe_lists_from_pairs"]

#: bytes of transients one scan step may hold (its distance tiles, decoded
#: cells and gathered queries)
_STEP_BYTES = 1 << 30
_MODES = ("f32", "bf16", "sq8", "i8dec", "i8dec_residual", "pq", "pq_residual")
_BINARY_MODES = ("hamming", "binary_asym", "rabitq")


def _next_pow2(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def build_probe_lists(
    probes: np.ndarray, nlist: int, nq: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-cluster query lists from ``[nq, nprobe]`` probe assignments: the
    pairs (q, probes[q, j]) in query-major order through
    :func:`build_probe_lists_from_pairs` (the JAX package's function of
    this name)."""
    probes = np.asarray(probes)
    flat_q = np.repeat(np.arange(probes.shape[0], dtype=np.int32), probes.shape[1])
    return build_probe_lists_from_pairs(flat_q, probes.reshape(-1), nlist, nq)


def build_probe_lists_from_pairs(
    flat_q: np.ndarray,
    flat_c: np.ndarray,
    nlist: int,
    nq: int,
    maxq_cap: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-cluster padded query lists from explicit (query, cluster) task
    pairs, on the host (numpy, vectorised), integer for integer the JAX
    package's lists.

    Returns ``(cluster_ids [ncl], lists [ncl, maxq], gather_map [nq, T])``
    over the clusters some query probes: ``lists`` is padded with ``nq``,
    ``cluster_ids`` to a power of two with ``nlist`` (a sentinel cluster
    with no rows), and ``gather_map[q, t]`` is the flat scan lane
    ``row·maxq + col`` of query ``q``'s t-th task, padded with -1. ``T`` is
    the most tasks of one query, rounded up to a power of two.

    A popular cluster would set ``maxq`` for every row; ``maxq_cap`` cuts
    its query list into several scan rows (the cell is then scanned once
    per row). It defaults to 4× the mean row occupancy.
    """
    flat_q = np.asarray(flat_q, dtype=np.int32)
    flat_c = np.asarray(flat_c, dtype=np.int64)
    order = np.argsort(flat_c, kind="stable")
    counts = np.bincount(flat_c, minlength=nlist)
    active = np.nonzero(counts)[0]
    if len(active) == 0:
        return (
            np.full(1, nlist, np.int32),
            np.full((1, 1), nq, np.int32),
            np.full((nq, 1), -1, np.int32),
        )
    acounts = counts[active]
    if maxq_cap is None:
        maxq_cap = _next_pow2(4 * max(1, int(acounts.mean())))
    maxq = min(_next_pow2(int(acounts.max())), _next_pow2(maxq_cap))

    nchunks = -(-acounts // maxq)          # rows per active cluster
    total_rows = int(nchunks.sum())
    ncl = _next_pow2(total_rows)

    # the JAX package's dtypes (the smallest that fit)
    q_dtype = np.uint16 if nq < 2**16 - 1 else np.int32
    c_dtype = np.uint16 if nlist < 2**16 - 1 else np.int32
    cluster_ids = np.full(ncl, nlist, dtype=c_dtype)
    cluster_ids[:total_rows] = np.repeat(active, nchunks).astype(c_dtype)
    lists = np.full((ncl, maxq), nq, dtype=q_dtype)

    qs = flat_q[order]
    # rank of each task within its cluster → (row, column)
    starts = np.concatenate([[0], np.cumsum(acounts)[:-1]])
    ranks = np.arange(len(qs)) - np.repeat(starts, acounts)
    row_base = np.concatenate([[0], np.cumsum(nchunks)[:-1]])
    rows = np.repeat(row_base, acounts) + ranks // maxq
    cols = ranks % maxq
    lists[rows, cols] = qs

    # each task's ordinal within its query: its column of the gather map
    qorder = np.argsort(flat_q, kind="stable")
    qcounts = np.bincount(flat_q, minlength=nq)
    qstarts = np.concatenate([[0], np.cumsum(qcounts)[:-1]])
    qranks = np.empty(len(flat_q), np.int32)
    qranks[qorder] = (np.arange(len(flat_q)) - np.repeat(qstarts, qcounts)).astype(np.int32)
    T = _next_pow2(max(int(qcounts.max()), 1))
    gather_map = np.full((nq, T), -1, np.int32)
    gather_map[qs, qranks[order]] = (rows * maxq + cols).astype(np.int32)
    return cluster_ids, lists, gather_map


def _step_rows(step_bytes: int, maxq: int, cap: int, d: int) -> int:
    """Task rows one step may hold: about three ``[maxq, cap]`` f32 tiles
    (dots, distances, the selection's copy), two ``[cap, d]`` cell tiles
    (gathered, decoded) and the ``[maxq, d]`` queries per row."""
    per_row = 4 * (3 * maxq * cap + 2 * cap * d + 2 * maxq * d)
    return max(1, step_bytes // per_row)


def ivf_cluster_scan(
    queries: torch.Tensor,      # [nq, d] scoring-space queries (f32, or int8 codes)
    cluster_ids: torch.Tensor,  # [ncl] scanned segments (pad = nlist)
    probe_lists: torch.Tensor,  # [ncl, maxq] query ids (pad = nq)
    gather_map: torch.Tensor,   # [nq, T] flat scan lanes (pad = -1)
    storage: torch.Tensor,      # [n_pad, d] f32 / bf16 / int8, or [n_pad, m] uint8 codes
    sqnorms: torch.Tensor,      # [n_pad] ‖row‖² in the scoring space (f32 or int32)
    offsets: torch.Tensor,      # [nlist] segment starts in the sorted storage
    counts: torch.Tensor,       # [nlist] segment sizes
    centroids: torch.Tensor,    # [nlist, d] f32 (the residual modes)
    k: int,
    metric: Dist,
    cap: int,
    mode: str,
    codebooks: torch.Tensor | None = None,  # [m, 256, ds] (pq modes) or [d] scales (i8dec modes)
    k_cell: int | None = None,
    aux: torch.Tensor | None = None,        # [n_pad] rabitq: the rows' ‖R·u‖₁
    approx: bool = False,
    precision=None,
    s_rows: int = 4,
    *,
    step_bytes: int = _STEP_BYTES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan the task rows; ``(best_d, best_i) [nq, k]`` ascending, ``best_i``
    positions in the sorted storage, padded with (+inf, 0) where a query has
    fewer than k candidates. ``storage`` and ``sqnorms`` carry at least
    ``cap`` trailing pad rows. Each (query, task) pair keeps its exact top
    ``min(k_cell, cap)``: ``k_cell`` defaults to ``k``; LSH keeps its
    caller's k per cell under a wider final k, since a row appears at most
    once per cell. The binary modes take ``storage`` as int32 words
    (``hamming``: ``queries`` too; ``binary_asym`` / ``rabitq``: f32
    queries of ``w·32`` columns), ``sqnorms`` ``‖x − c‖`` for ``rabitq``.

    The parameters up to ``s_rows`` are the JAX function's, in its order.
    ``approx`` (its ``approx_min_k`` per-cell selection), ``precision``
    (the scan is f32 grade) and ``s_rows`` (scan rows per ``lax.scan``
    step) are accepted and ignored; ``step_bytes``, keyword-only, bounds
    the bytes of one step's tensors instead."""
    del approx, precision, s_rows
    if mode not in _MODES + _BINARY_MODES:
        raise ValueError(f"unknown cluster scan mode {mode!r}")
    if mode in _BINARY_MODES and (storage.dtype != torch.int32
                                  or (mode == "hamming" and queries.dtype != torch.int32)):
        raise ValueError(f"cluster scan mode {mode!r} takes int32 words (the bit patterns "
                         "of uint32 codes)")
    if mode == "rabitq" and aux is None:
        raise ValueError("cluster scan mode 'rabitq' takes aux, the rows' ‖R·u‖₁")
    nq, dq = queries.shape
    nlist = offsets.shape[0]
    dev = queries.device
    kc = min(k_cell if k_cell is not None else k, cap)
    ncl, maxq = probe_lists.shape
    residual = mode.endswith("_residual") or mode == "rabitq"
    cosine = metric == Dist.COSINE
    binary = mode in _BINARY_MODES
    nbits = storage.shape[1] * 32 if binary else 0

    # hamming queries are words: kept as they are (a float cast would lose
    # their bits); the sentinel row's zero words are a query of all −1
    qf = queries if mode == "hamming" else queries.float()
    # sq8: integer dots and norms, exact in f32 while they stay below 2²⁴
    # (d ≤ 1023 at |code| ≤ 128), in f64 above
    acc = torch.float64 if mode == "sq8" and dq * (1 << 14) >= (1 << 24) else torch.float32
    if binary:
        q_sq = qf.new_zeros(nq, dtype=torch.float32)
    else:
        q_sq = (qf.double() ** 2).sum(dim=-1).float() if mode == "sq8" else sq_norms(qf)
    queries_x = torch.cat([qf, qf.new_zeros((1, dq))])
    q_sq = torch.cat([q_sq, q_sq.new_zeros(1)])
    offsets_x = torch.cat([offsets.long(), torch.zeros(1, dtype=torch.long, device=dev)])
    counts_x = torch.cat([counts.long(), torch.zeros(1, dtype=torch.long, device=dev)])
    if residual:
        centroids_x = torch.cat([centroids.float(), centroids.new_zeros((1, centroids.shape[1]))])
    cid = torch.clamp(cluster_ids.long(), max=nlist)
    qid = torch.clamp(probe_lists.long(), max=nq)
    lane = torch.arange(cap, device=dev)

    flat_d = torch.empty((ncl * maxq, kc), device=dev)
    flat_i = torch.empty((ncl * maxq, kc), dtype=torch.long, device=dev)
    S = _step_rows(step_bytes, maxq, cap, max(dq, storage.shape[1], nbits))
    for r0 in range(0, ncl, S):
        c = cid[r0 : r0 + S]                          # [s]
        q_ids = qid[r0 : r0 + S]                      # [s, maxq]
        starts = offsets_x[c]
        rows = starts[:, None] + lane[None, :]        # [s, cap]
        cells = storage[rows]                         # [s, cap, w]
        sn = sqnorms[rows].float()                    # [s, cap]
        qg = queries_x[q_ids]                         # [s, maxq, d]

        if mode in ("pq", "pq_residual", "i8dec", "i8dec_residual"):
            if mode.startswith("i8dec"):
                dec = cells.float() * codebooks       # the [d] decode scales
            else:
                dec = pq_decode_tile(cells.reshape(-1, cells.shape[-1]), codebooks)
                dec = dec.reshape(cells.shape[0], cap, -1)
            rsn = _sqrt_f32(torch.clamp(sn, min=1e-12))[:, None, :]
            if residual and cosine:
                cent = centroids_x[c]
                num = _dots(qg, dec) + (qg * cent[:, None, :]).sum(dim=-1)[:, :, None]
                d = 1.0 - num / rsn
            elif residual:
                qr = qg - centroids_x[c][:, None, :]
                qr_sq = (qr * qr).sum(dim=-1)
                d = torch.clamp(qr_sq[:, :, None] + sn[:, None, :] - 2.0 * _dots(qr, dec), min=0.0)
            elif cosine:
                d = 1.0 - _dots(qg, dec) / rsn
            else:
                d = torch.clamp(
                    q_sq[q_ids][:, :, None] + sn[:, None, :] - 2.0 * _dots(qg, dec), min=0.0
                )
        elif binary:
            # pad bits are 0 on both sides: over w·32 lanes the ±1 identity
            # is the exact Hamming distance, and a projected query's zero
            # pad columns add nothing
            x_pm = unpack_pm1(cells.reshape(-1, cells.shape[-1]), nbits, torch.float32)
            x_pm = x_pm.reshape(cells.shape[0], cap, nbits)
            if mode == "hamming":
                q_pm = unpack_pm1(qg.reshape(-1, dq), nbits, torch.float32)
                d = (nbits - _dots(q_pm.reshape(qg.shape[0], maxq, nbits), x_pm)) * 0.5
            elif mode == "binary_asym":
                d = -_dots(qg.to(torch.bfloat16).float(), x_pm)
            else:  # rabitq: the unbiased estimator (its reference's, non-squared)
                rqr = qg - centroids_x[c][:, None, :]
                q_dist = _sqrt_f32((rqr * rqr).sum(dim=-1))                   # [s, maxq]
                qru = rqr / torch.clamp(q_dist, min=1e-12)[:, :, None]
                inner = _dots(qru.to(torch.bfloat16).float(), x_pm)
                corr = aux[rows][:, None, :]                                  # [s, 1, cap]
                est = torch.where(
                    corr > 1e-6,
                    torch.clamp(inner / torch.clamp(corr, min=1e-12), -1.0, 1.0),
                    0.0,
                )
                snr, qd = sn[:, None, :], q_dist[:, :, None]
                d = _sqrt_f32(torch.clamp(snr ** 2 + qd ** 2 - 2.0 * snr * qd * est, min=0.0))
        elif mode == "sq8":
            dots = _dots(qg.to(acc), cells.to(acc)).float()
            if cosine:
                denom = _sqrt_f32(q_sq[q_ids])[:, :, None] * _sqrt_f32(sn)[:, None, :]
                d = torch.where(denom > 0, 1.0 - dots / denom, 1.0)
            else:
                d = torch.clamp(q_sq[q_ids][:, :, None] + sn[:, None, :] - 2.0 * dots, min=0.0)
        else:  # f32 / bf16 dense rows (bf16: the query rounded to bf16 too)
            lhs = qg.to(torch.bfloat16).float() if mode == "bf16" else qg
            dots = _dots(lhs, cells.float())
            if cosine:
                d = 1.0 - dots
            else:
                d = torch.clamp(q_sq[q_ids][:, :, None] + sn[:, None, :] - 2.0 * dots, min=0.0)

        d = torch.where(lane[None, None, :] < counts_x[c][:, None, None], d, float("inf"))
        if binary:
            vals, idx = topk_smallest(d.reshape(-1, cap), kc)
        else:
            vals, idx = torch.topk(d.reshape(-1, cap), kc, dim=-1, largest=False, sorted=True)
        out = slice(r0 * maxq, r0 * maxq + vals.shape[0])
        flat_d[out] = vals
        flat_i[out] = starts.repeat_interleave(maxq)[:, None] + idx

    return regroup_topk(flat_d, flat_i, gather_map, k)


def _dots(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``[s, maxq, d] × [s, cap, d] → [s, maxq, cap]``, TF32 off."""
    with fp32_matmul():
        return torch.bmm(lhs, rhs.transpose(1, 2))
