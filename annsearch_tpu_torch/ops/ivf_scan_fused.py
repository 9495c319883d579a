"""Fused IVF cell scan (port of ``annsearch_tpu.ops.ivf_scan_pallas``).

Every variant of the Pallas ``_scan_kernel`` / ``_scan_body`` (launched
by ``_fused_cell_scan``) is ported, each an instance of one hand-written
kernel template in ``csrc/ivf_scan.cu`` with a wrapper and a plain PyTorch
version here:

* K1a, ``ivf_cell_scan``: int8 residual cells (``i8dec_residual``), ``l2``
  epilogue, depth-2 stride-class fold, one bf16 query term — the IVF-PQ
  main path;
* K1b-l2, ``ivf_cell_scan_split``: the same with two bf16 query terms
  (``q_split=True``: the hi/lo mantissa split of the scaled residual);
* K1b-cos, ``ivf_cell_scan_cos``: int8 residual cells, ``cos_renorm``
  (``qadd = q·c``, the reconstruction renormalised by ``rsqrt(sn)``), one
  or two query terms — cosine IVF-PQ and IVF-OPQ;
* K1d-i8dec, ``ivf_cell_scan_i8dec``: mode ``i8dec`` (int8 decode cells
  with no centroids), ``l2`` or ``cos_renorm``, one or two query terms. No
  index sets this mode; ``fused_ivf_scan(mode="i8dec")`` reaches it;
* K1d-f32 / K1c-f32, ``ivf_cell_scan_f32_fold`` / ``_exact``: f32 cells,
  ``l2`` or ``cos_plain``, the fold or the exact per-segment selection —
  ``IvfIndex.query(approx=True)`` and its recall-1.0 default tier;
* K1d-bf16 / K1c-bf16, ``ivf_cell_scan_bf16_fold`` / ``_exact``: bf16
  cells, ``l2`` or ``cos_plain`` — ``IvfIndexBf16``. The fold scores the
  query rounded to bf16 (the JAX package's single bf16 pass); the exact
  selection scores the f32 query, where the JAX package splits it into
  hi/lo bf16 terms to carry about 16 of its bits through the MXU: the
  kernel splits it in three, which hold all 24 (three exact passes);
* K1d-sq8 / K1c-sq8, ``ivf_cell_scan_sq8_fold`` / ``_exact``: int8 cells
  and int8 query codes, ``l2`` or ``cos_qnorm`` — ``IvfSq8Index``. The
  kernel sums the integer products in int32 on the tensor cores; every
  sum is an integer below 2²⁴, so the dots, and the ``l2`` distances,
  equal the JAX package's bit for bit;
* K1-fold1: every fold wrapper takes ``fold_depth`` 1 (one survivor per
  stride class, 128 in all) or 2 (the default, 256), the Pallas
  ``fold_depth``. The IVF indexes pass it as a keyword where the JAX
  package reads ``ANNSEARCH_IVF_FOLD1``;
* K1a-bf16, ``ivf_cell_scan_bf16_residual``: K1a's residual prologue and
  ``l2`` epilogue over bf16 cells, two bf16 query terms (``q_split``), the
  fold at either depth or the exact selection — RaBitQ's fused
  estimator, whose cells are ±1 sign rows scaled by ``‖x−c‖ / ‖R·u‖₁`` in
  bf16 (the Pallas body casts any cell type to bf16; the int8 launchers
  take int8 cells only);
* K1-bf16-decode, ``ivf_cell_scan_bf16_decode``: bf16 cells under the rest
  of the int8-decode modes, as the Pallas body computes them — mode
  ``i8dec`` (``l2`` or ``cos_renorm``), ``i8dec_residual`` under
  ``cos_renorm``, and its ``l2`` with one query term; one or two terms,
  any selection. No index routes to them; ``fused_ivf_scan`` does;
* K1-exact-i8, ``ivf_cell_scan_i8_exact``: the int8-decode prologues with
  the exact selection (``selection="exact"`` over ``i8dec`` /
  ``i8dec_residual`` cells). No index routes to it, as in the JAX
  package: the exact tier of those modes is the cluster scan;
* rows of any width: a block holds its 32 slots' query terms whole in
  shared memory where the block fits (:func:`scan_plan`: at two blocks an
  SM while they fit, else at one); past it the kernel's producer warp
  brings them a stage at a time beside the cells, copied from a pre-pass
  that forms each query's terms once (the residual prologue's, which
  depend on the segment, it forms itself; ``csrc/ivf_scan.cu``), so
  ``fused_eligible`` is the JAX package's rule, with no width limit.

A wrapper launches its kernel on CUDA tensors (or raises) and runs the
plain version on CPU tensors; there is no fallback between the two. The
kernels take their products on the tensor cores as the Pallas kernel takes
them on the MXU: bf16 terms of a mantissa split (``wgmma``, f32 sums),
int8 × int8 for SQ8 (int32 sums). f32 cells are split in three on both
sides and summed over six cross terms, where the JAX package keeps two
terms (about 16 mantissa bits) and the ``packed2`` lane layout: three terms
hold all 24 bits, and the tensor cores sum each 16-column step to 24 bits
of its largest term, so f32 rows are scored at f32 grade (the plain
versions' fp32 matmul; the card's error against f64 is no larger than the
FFMA loop's it replaced, PERF.md §6).

On the H100 every variant is bound by its multiply-adds, about
R·maxq·seg·d (1.3e11 at the 1M×128d main path, nprobe 16), times its
passes, at the tensor cores' rate: each block streams a segment's rows
through a TMA ring once for 32 query slots, its consumer warpgroups
convert them in registers into the terms the products take, and the
selection stays in registers (the fold) or in shared memory (the exact
selection's sorted lists of kb keys, each chunk merged by what enters
them), so the [maxq, seg] distance tile never reaches device memory. Every
launch is counted by its route (:func:`scan_routes`). See the kernel
source for the layout.

``fused_ivf_scan`` is the host side around the kernels: per task row, the
segment and its valid-row count; after it, the lane → storage-row remap,
the gather-map regroup per query and the final top-k, or with ``groups``
a top-k per group of task lanes (K1-groups: the forests' per-tree merge,
host tensor code in both packages).

Not ported: the ``packed2`` lane layout (f32 rows take six cross terms of
a three-way split, each its own product), the ``interpret`` plumbing and
``ANNSEARCH_NO_PALLAS``.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from ..utils.dist import Dist, _sqrt_f32, fp32_matmul, mantissa_split

__all__ = [
    "fused_eligible",
    "fold_kb",
    "repack_blocks",
    "ivf_cell_scan",
    "ivf_cell_scan_split",
    "ivf_cell_scan_cos",
    "ivf_cell_scan_i8dec",
    "ivf_cell_scan_i8_exact",
    "ivf_cell_scan_bf16_residual",
    "ivf_cell_scan_bf16_decode",
    "ivf_cell_scan_plain",
    "ivf_cell_scan_f32_exact",
    "ivf_cell_scan_f32_fold",
    "ivf_cell_scan_f32_plain",
    "ivf_cell_scan_bf16_exact",
    "ivf_cell_scan_bf16_fold",
    "ivf_cell_scan_bf16_plain",
    "ivf_cell_scan_sq8_exact",
    "ivf_cell_scan_sq8_fold",
    "ivf_cell_scan_sq8_plain",
    "fused_ivf_scan",
    "regroup_topk",
    "scan_plan",
    "scan_routes",
]

LANES = 128
#: finite "masked" value of the scan (ranks after every real distance)
BIG = 3.0e38
#: the kernel reads rows in 16-byte vectors: cells pad d to this
_D_ALIGN = 16
#: task rows per step of the plain versions (bounds their [rows, maxq, seg]
#: tiles)
_PLAIN_ROWS = 64
#: the scan's plan (``csrc/ivf_scan.cu::plan_of``): a stage's head (two
#: boxes of 128 rows × 64 bytes of cells and the chunk's 128 norms, rounded
#: up to the 512-byte swizzle atom), a block of query terms (64 bytes of K
#: of 32 slots), the dynamic shared memory of a block when two share an SM
#: and of one alone, the stages of the ring, the exact distance tile (floats)
_STAGE_HEAD, _QBLOCK = 33 * 512, 2048
_TWO_BLOCKS, _ONE_BLOCK, _MAX_STAGES = 115_200, 231_424, 4
_TILE = 32 * (LANES + 4)
#: storage modes with a ported fused kernel
_FUSED_MODES = ("i8dec", "i8dec_residual", "f32", "bf16", "sq8")
#: of them, the int8-decode modes: scaled query terms, ``q_split``
_I8DEC_MODES = ("i8dec", "i8dec_residual")


def fused_eligible(mode: str, seg_size: int, dim_w: int, k: int) -> bool:
    """Whether the fused scan handles this index: int8 decode cells (K1a,
    K1b, K1d-i8dec), or f32, bf16 or sq8 cells (K1c / K1d), in segments of
    a multiple of 128 rows, k ≤ 128, rows of any width (the JAX package's
    rule); the PQ-coded modes keep the cluster scan."""
    del dim_w  # any width: the kernel stages wide query rows in column blocks
    return (
        mode in _FUSED_MODES
        and seg_size % LANES == 0
        and seg_size >= LANES
        and k <= LANES
    )


def fold_kb(k: int) -> int:
    """Candidates a fold keeps per (task row, query slot) for a final top-k:
    k rounded up to a power of two in [8, 128] (the tree and LSH indexes'
    rule)."""
    return min(LANES, max(8, 1 << (max(k, 8) - 1).bit_length()))


def scan_plan(
    cell_bytes: int, query_terms: int, int8: bool, sel: int, dp: int, kb: int,
) -> tuple[int, int, int, int]:
    """The K1 scan's plan of one launch, as ``csrc/ivf_scan.cu::plan_of``
    makes it (the C entry ``annsearch_ivf_scan_plan`` gives the same):
    ``(wide, stages, bytes a stage, dynamic shared memory)``. The 32 slots'
    query terms are held whole in shared memory with as many ring stages (4
    down to 2) as keep two blocks an SM, else at one block an SM; past that
    (``wide``) the producer warp brings them a stage at a time beside the
    cells (:func:`_query_scratch`). ``cell_bytes`` 4 (f32), 2 (bf16) or 1 (int8); ``query_terms`` 1
    to 3; ``int8``: sq8's int8 products; ``sel`` 0 (exact) or the fold's
    depth; ``dp`` the cells' padded width."""
    cols = 128 // cell_bytes
    es = 1 if int8 else 2
    qstage = cols // (32 if int8 else 16) // 2
    dk = -(-dp // cols) * cols
    surv = 0 if sel == 0 else 32 * sel * LANES * 8
    exact = _TILE * 4 + 32 * kb * 8 + 8 * 32 * 8 if sel == 0 else 0
    for wide in (0, 1):
        q_bytes = 0 if wide else query_terms * (dk * es // 64) * _QBLOCK
        stage = _STAGE_HEAD + (query_terms * qstage * _QBLOCK if wide else 0)
        for cap in (_TWO_BLOCKS, _ONE_BLOCK):
            for stages in range(_MAX_STAGES, 1, -1):
                smem = 512 + max(q_bytes + stages * stage, surv) + exact
                if smem <= cap:
                    return wide, stages, stage, smem
    raise ValueError(f"no K1 plan fits shared memory at dp={dp}, kb={kb}")


def scan_routes() -> tuple[int, int]:
    """K1 launches since the kernel library was loaded, by the plan's route:
    ``(query terms held whole, a stage at a time)``. Every K1 launch runs
    the ``wgmma`` scan; no instance keeps ``mma.sync``."""
    import ctypes

    from ._cuda import load_library

    out = (ctypes.c_int * 7)()
    load_library().annsearch_ivf_scan_last_launch(ctypes.addressof(out))
    return out[5], out[6]


def _query_scratch(cells, queries_x, terms, int8, residual, sel, kb):
    """The wide rows' query terms, ``[nq+1, terms, dk]`` bf16 (int8 codes
    for sq8), which the kernel's pre-pass forms once per launch where the
    plan holds the query terms a stage at a time and the prologue is not
    the residual's (whose terms the producer forms per segment); else
    None."""
    nbytes = cells.element_size()
    if residual or not scan_plan(nbytes, terms, int8, sel, cells.shape[2], kb)[0]:
        return None
    cols = 128 // nbytes
    dk = -(-cells.shape[2] // cols) * cols
    return torch.empty(queries_x.shape[0] * terms * dk * (1 if int8 else 2), dtype=torch.uint8,
                       device=cells.device)


def _tail(stream, cells, queries_x, scratch):
    """The K1 entries' trailing arguments: the stream, the blocks of
    ``cells``, the rows of ``queries_x``, the query-term scratch and its
    bytes."""
    return (stream, cells.shape[0], queries_x.shape[0],
            0 if scratch is None else scratch.data_ptr(), 0 if scratch is None else scratch.numel())


def repack_blocks(
    storage: torch.Tensor, sqnorms: torch.Tensor, seg_offsets: torch.Tensor,
    seg_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather the segmented storage into block-aligned tiles
    ``cells [nseg+1, seg, dp]`` and ``sn [nseg+1, seg]`` (+1 = the zero
    sentinel block of task rows that scan nothing). ``dp`` is ``d`` rounded
    up to 16 with zero columns, which add nothing to the dots. Cells keep
    the storage's type (f32, bf16 or int8: no mantissa split), ``sn`` is
    f32."""
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


def _bf16_terms(v: torch.Tensor, q_split: bool) -> torch.Tensor:
    """The scaled query as the int8-decode kernels score it (f32): the sum
    of the one or, with ``q_split``, two bf16 terms of its mantissa split.
    ``hi + lo`` is exact in f32 and so is its product with an int8 cell, so
    one f32 value gives the sum of the kernel's two passes up to the order
    of the f32 sums."""
    terms = mantissa_split(v, 2 if q_split else 1)
    return terms[0].float() if len(terms) == 1 else terms[0].float() + terms[1].float()


def _query_terms(lists, task_seg, queries_x, cent_x, scales, dp, cosine, q_split):
    """Per-slot ``qadd [R, maxq]`` and query term ``qk [R, maxq, dp]`` (as
    f32): the prologue of the int8-decode kernels. ``cent_x`` None is mode
    ``i8dec`` (no centroids)."""
    qg = queries_x[lists.long()]
    if cent_x is None:
        qadd = torch.zeros(lists.shape, device=lists.device) if cosine else (qg * qg).sum(dim=-1)
    elif cosine:
        qadd = (qg * cent_x[task_seg.long()][:, None, :]).sum(dim=-1)
    else:
        qg = qg - cent_x[task_seg.long()][:, None, :]
        qadd = (qg * qg).sum(dim=-1)
    return qadd, _pad_cols(_bf16_terms((qg * scales).contiguous(), q_split), dp)


def _pad_cols(t: torch.Tensor, dp: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, dp - t.shape[-1])) if dp > t.shape[-1] else t


def _fold_extract(
    dist: torch.Tensor, kb: int, depth: int = 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stride-class fold of ``dist [..., seg]`` at ``depth`` 1 (each class
    keeps its minimum) or 2 (its minimum and runner-up), then kb rounds of
    the lexicographic (value, lane) minimum over the survivors."""
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
        if depth == 2:
            upd2 = lose_v < vals2
            vals2 = torch.where(upd2, lose_v, vals2)
            idx2 = torch.where(upd2, lose_i, idx2)
    if depth == 2:
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
    """Exact selection from ``dist [rows, maxq, seg]``, the kernels'
    contract: the kb lexicographically smallest (value, lane) pairs over the
    valid lanes (below the row's ``cnt``) whose value is at most FLT_MAX (a
    stable sort: -0 ranks as +0 and keeps its sign; an inf or NaN distance
    never enters), then (3e38, lane 0) in every slot past them — the Pallas
    extraction sets each emitted lane to 3e38, so once the entrants are
    spent every round finds lane 0."""
    lane = torch.arange(dist.shape[-1], device=dist.device)
    enters = (lane < cnt.long()[:, None, None]) & (dist <= torch.finfo(torch.float32).max)
    vals, idx = torch.sort(torch.where(enters, dist, float("inf")), dim=-1, stable=True)
    vals, idx = vals[..., :kb], idx[..., :kb].int()
    past = torch.arange(kb, device=dist.device) >= enters.sum(-1, keepdim=True)
    return torch.where(past, BIG, vals), torch.where(past, 0, idx)


def ivf_cell_scan_plain(
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb: int,
    cosine: bool = False, q_split: bool = False, fold_depth: int = 2,
    exact: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the int8-decode kernels, chunked over task
    rows to bound memory: K1a as it stands, K1b-l2 with ``q_split``,
    K1b-cos with ``cosine`` (``cos_renorm``), K1d-i8dec with ``cent_x``
    None; the fold at ``fold_depth``, or with ``exact`` K1-exact-i8's exact
    selection; with bf16 ``cells``, K1a-bf16 (a bf16 term × a bf16 cell is
    exact in f32 too; the two terms' sum times a bf16 cell rounds once,
    2⁻²⁴ of the product, where the kernel takes two exact products).
    Arguments and result as :func:`ivf_cell_scan`."""
    R, maxq = lists.shape
    seg, dp = cells.shape[1], cells.shape[2]
    out_d = torch.empty((R, maxq, kb), device=lists.device)
    out_i = torch.empty((R, maxq, kb), dtype=torch.int32, device=lists.device)
    lane = torch.arange(seg, device=lists.device)
    for r0 in range(0, R, _PLAIN_ROWS):
        rs = slice(r0, r0 + _PLAIN_ROWS)
        s = task_seg[rs].long()
        qadd, qk = _query_terms(lists[rs], task_seg[rs], queries_x, cent_x, scales,
                                dp, cosine, q_split)
        # bf16 query terms × int8 (or bf16) cells: exact products in f32 (but
        # the two-term sum times a bf16 cell, rounded once), f32 sums (fp32
        # batched matmul with TF32 off)
        with fp32_matmul():
            dots = torch.bmm(qk, cells[s].float().transpose(1, 2))
        if cosine:  # cos_renorm: IEEE square root and quotient, as the kernel
            rsn = 1.0 / _sqrt_f32(torch.clamp(sn[s][:, None, :], min=1e-12))
            dist = 1.0 - (dots + qadd[:, :, None]) * rsn
        else:
            dist = torch.clamp(qadd[:, :, None] + sn[s][:, None, :] - 2.0 * dots, min=0.0)
        dist = torch.where(lane < cnt[rs].long()[:, None, None], dist, BIG)
        if exact:
            out_d[rs], out_i[rs] = _exact_extract(dist, kb, cnt[rs])
        else:
            out_d[rs], out_i[rs] = _fold_extract(dist, kb, fold_depth)
    return out_d, out_i


def _dense_plain(
    lists, task_seg, cnt, queries_x, cells, sn, kb: int, epilogue: str,
    exact: bool, bf16_query: bool = False, fold_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dense-cell variants (f32, bf16 and
    int8 cells), chunked over task rows: the query as it is (or rounded to
    bf16), f32 dots, the epilogue in the JAX package's order of operations,
    then the exact selection or the fold."""
    R, maxq = lists.shape
    seg, dp = cells.shape[1], cells.shape[2]
    out_d = torch.empty((R, maxq, kb), device=lists.device)
    out_i = torch.empty((R, maxq, kb), dtype=torch.int32, device=lists.device)
    lane = torch.arange(seg, device=lists.device)
    for r0 in range(0, R, _PLAIN_ROWS):
        rs = slice(r0, r0 + _PLAIN_ROWS)
        s = task_seg[rs].long()
        qg = queries_x[lists[rs].long()]
        qk = qg.to(torch.bfloat16).float() if bf16_query else qg
        # dots of f32 (or exact bf16 / int8) values summed in f32 (fp32
        # batched matmul, TF32 off)
        with fp32_matmul():
            dots = torch.bmm(_pad_cols(qk, dp), cells[s].float().transpose(1, 2))
        snr = sn[s][:, None, :]
        if epilogue == "l2":
            qadd = (qg * qg).sum(dim=-1)
            dist = torch.clamp(qadd[:, :, None] + snr - 2.0 * dots, min=0.0)
        elif epilogue == "cos_plain":
            dist = 1.0 - dots
        else:  # cos_qnorm: IEEE square roots and quotients, as the kernel
            q_sq = (qg * qg).sum(dim=-1)
            qadd = torch.where(q_sq > 0, 1.0 / _sqrt_f32(torch.clamp(q_sq, min=1e-12)), 0.0)
            rsn = 1.0 / _sqrt_f32(torch.clamp(snr, min=1e-12))
            dist = 1.0 - dots * qadd[:, :, None] * rsn
        dist = torch.where(lane < cnt[rs].long()[:, None, None], dist, BIG)
        if exact:
            out_d[rs], out_i[rs] = _exact_extract(dist, kb, cnt[rs])
        else:
            out_d[rs], out_i[rs] = _fold_extract(dist, kb, fold_depth)
    return out_d, out_i


def ivf_cell_scan_f32_plain(
    lists, task_seg, cnt, queries_x, cells, sn, kb: int, cosine: bool,
    exact: bool, fold_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1c-f32 (``exact``) and K1d-f32 (the fold
    at ``fold_depth``). Arguments and result as
    :func:`ivf_cell_scan_f32_exact`."""
    return _dense_plain(lists, task_seg, cnt, queries_x, cells, sn, kb,
                        "cos_plain" if cosine else "l2", exact, fold_depth=fold_depth)


def ivf_cell_scan_bf16_plain(
    lists, task_seg, cnt, queries_x, cells, sn, kb: int, cosine: bool,
    exact: bool, fold_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1c-bf16 (``exact``: the f32 query) and
    K1d-bf16 (fold: the query rounded to bf16) over bf16 ``cells``."""
    return _dense_plain(lists, task_seg, cnt, queries_x, cells, sn, kb,
                        "cos_plain" if cosine else "l2", exact, bf16_query=not exact,
                        fold_depth=fold_depth)


def ivf_cell_scan_sq8_plain(
    lists, task_seg, cnt, queries_x, cells, sn, kb: int, cosine: bool,
    exact: bool, fold_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1c-sq8 (``exact``) and K1d-sq8 (fold):
    int8 ``cells``, ``queries_x`` the int8 query codes as f32, epilogue
    ``l2`` or ``cos_qnorm``."""
    return _dense_plain(lists, task_seg, cnt, queries_x, cells, sn, kb,
                        "cos_qnorm" if cosine else "l2", exact, fold_depth=fold_depth)


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
        or dp % _D_ALIGN or not d <= dp
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


def _sel(fold_depth: int) -> int:
    """The C entries' ``sel`` of a fold: its depth, 1 or 2 (0 is exact)."""
    if fold_depth not in (1, 2):
        raise ValueError(f"fold_depth must be 1 or 2, got {fold_depth}")
    return fold_depth


def _launch_i8dec(name, entry, lists, task_seg, cnt, queries_x, cent_x, scales,
                  cells, sn, kb, flags=(), cell_dtype=torch.int8, terms=1, residual=True,
                  cents_arg=False):
    """Validate and launch one int8-decode variant (``cent_x`` None: no
    centroids, and the entry takes none unless ``cents_arg``, which passes a
    null pointer); ``flags`` are its trailing int arguments (the last is
    ``sel``), ``cell_dtype`` the type its entry takes (bf16 for K1a-bf16 and
    K1-bf16-decode), ``terms`` its query terms, ``residual`` whether its
    prologue is the residual's."""
    from ._cuda import load_library

    specs = [("lists", lists, torch.int32, 2), ("task_seg", task_seg, torch.int32, 1),
             ("cnt", cnt, torch.int32, 1), ("queries_x", queries_x, torch.float32, 2),
             ("scales", scales, torch.float32, 1), ("cells", cells, cell_dtype, 3),
             ("sn", sn, torch.float32, 2)]
    if cent_x is not None:
        specs.append(("cent_x", cent_x, torch.float32, 2))
    _check_inputs(specs, lists.device)
    _check_shapes(name, lists, task_seg, cnt, queries_x, cells, sn, kb)
    d = queries_x.shape[1]
    if scales.shape[0] != d or (cent_x is not None and cent_x.shape[1] != d):
        raise ValueError(f"{name}: cent_x / scales do not have d={d} columns")
    R, maxq = lists.shape
    _, seg, dp = cells.shape
    out_d, out_i = _outputs(lists, kb)
    tensors = [lists, task_seg, cnt, queries_x]
    tensors += [scales] if cent_x is None and not cents_arg else [cent_x, scales]
    tensors += [cells, sn, out_d, out_i]
    scratch = _query_scratch(cells, queries_x, terms, False, residual, flags[-1], kb)
    err = getattr(load_library(), entry)(
        *(None if t is None else t.data_ptr() for t in tensors), R, maxq, seg, d, dp, kb, *flags,
        *_tail(torch.cuda.current_stream(lists.device).cuda_stream, cells, queries_x, scratch),
    )
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out_d, out_i


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
    fold_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1a. Per task row and query slot, the kb best ``(distance, lane)``
    of the row's segment: ``out_d [R, maxq, kb]`` f32, ``out_i [R, maxq,
    kb]`` int32; ``fold_depth`` 1 is K1-fold1. CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
            fold_depth=fold_depth,
        )
    out = _launch_i8dec("ivf_cell_scan", "annsearch_ivf_scan_k1a", lists, task_seg,
                        cnt, queries_x, cent_x, scales, cells, sn, kb, (_sel(fold_depth),))
    ivf_cell_scan.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls do not count)
ivf_cell_scan.launches = 0


def ivf_cell_scan_split(
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb: int,
    fold_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1b-l2: K1a with two bf16 query terms (``q_split=True``): the scaled
    residual keeps about 16 mantissa bits where K1a keeps 8. Arguments and
    result as :func:`ivf_cell_scan`."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb, q_split=True,
            fold_depth=fold_depth,
        )
    out = _launch_i8dec("ivf_cell_scan_split", "annsearch_ivf_scan_k1b_l2", lists,
                        task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
                        (_sel(fold_depth),), terms=2)
    ivf_cell_scan_split.launches += 1
    return out


ivf_cell_scan_split.launches = 0


def ivf_cell_scan_cos(
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb: int,
    q_split: bool = False, fold_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1b-cos: int8 residual cells under cosine. ``qk = q·scales`` (one
    bf16 term, or two with ``q_split``), ``qadd = q·c``, ``sn`` the squared
    norm of the reconstruction ``c + dec``; distance ``1 − (dots + qadd) /
    sqrt(max(sn, 1e-12))``. Arguments and result as :func:`ivf_cell_scan`."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
            cosine=True, q_split=q_split, fold_depth=fold_depth,
        )
    out = _launch_i8dec("ivf_cell_scan_cos", "annsearch_ivf_scan_k1b_cos", lists,
                        task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
                        (int(q_split), _sel(fold_depth)), terms=1 + q_split, residual=False)
    ivf_cell_scan_cos.launches += 1
    return out


ivf_cell_scan_cos.launches = 0


def ivf_cell_scan_i8dec(
    lists, task_seg, cnt, queries_x, scales, cells, sn, kb: int,
    cosine: bool = False, q_split: bool = False, fold_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1d-i8dec: int8 decode cells with no centroids (mode ``i8dec``).
    ``qk = q·scales`` (one bf16 term, or two with ``q_split``); ``l2`` with
    ``qadd = ‖q‖²``, or ``cos_renorm`` with ``qadd = 0``. Arguments as
    :func:`ivf_cell_scan` without ``cent_x``; the same result."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, None, scales, cells, sn, kb,
            cosine=cosine, q_split=q_split, fold_depth=fold_depth,
        )
    out = _launch_i8dec("ivf_cell_scan_i8dec", "annsearch_ivf_scan_i8dec", lists,
                        task_seg, cnt, queries_x, None, scales, cells, sn, kb,
                        (int(cosine), int(q_split), _sel(fold_depth)), terms=1 + q_split,
                        residual=False)
    ivf_cell_scan_i8dec.launches += 1
    return out


ivf_cell_scan_i8dec.launches = 0


def ivf_cell_scan_i8_exact(
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb: int,
    cosine: bool = False, q_split: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1-exact-i8: the int8-decode prologues with the exact selection
    (K1c's sorted key lists): mode ``i8dec_residual`` with ``cent_x``
    (K1a's, K1b-l2's or K1b-cos's prologue), mode ``i8dec`` with ``cent_x``
    None (K1d-i8dec's); ``cosine`` takes ``cos_renorm``, ``q_split`` two
    bf16 query terms. Per task row and slot, the kb lexicographically
    smallest ``(distance, lane)`` pairs, then (3e38, 0) past the valid rows.
    Arguments and result as :func:`ivf_cell_scan`."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
            cosine=cosine, q_split=q_split, exact=True,
        )
    head = ("ivf_cell_scan_i8_exact",)
    tail = (lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb)
    terms = 1 + q_split
    if cent_x is None:
        out = _launch_i8dec(*head, "annsearch_ivf_scan_i8dec", *tail,
                            (int(cosine), int(q_split), 0), terms=terms, residual=False)
    elif cosine:
        out = _launch_i8dec(*head, "annsearch_ivf_scan_k1b_cos", *tail, (int(q_split), 0),
                            terms=terms, residual=False)
    else:
        entry = "annsearch_ivf_scan_k1b_l2" if q_split else "annsearch_ivf_scan_k1a"
        out = _launch_i8dec(*head, entry, *tail, (0,), terms=terms)
    ivf_cell_scan_i8_exact.launches += 1
    return out


ivf_cell_scan_i8_exact.launches = 0


def ivf_cell_scan_bf16_residual(
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb: int,
    fold_depth: int = 2, exact: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1a-bf16: K1a's prologue (``qr = q − c``, ``qadd = ‖qr‖²``, ``qk =
    qr·scales`` as two bf16 terms, K1b-l2's ``q_split``) and ``l2``
    epilogue over bf16 ``cells [nseg+1, seg, dp]``; the fold at
    ``fold_depth``, or with ``exact`` the exact selection. RaBitQ's
    estimator takes it with unit scales over its scaled ±1 rows. Other
    arguments and the result as :func:`ivf_cell_scan`."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
            q_split=True, fold_depth=fold_depth, exact=exact,
        )
    out = _launch_i8dec("ivf_cell_scan_bf16_residual", "annsearch_ivf_scan_k1a_bf16", lists,
                        task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
                        (0 if exact else _sel(fold_depth),),
                        cell_dtype=torch.bfloat16, terms=2)
    ivf_cell_scan_bf16_residual.launches += 1
    return out


ivf_cell_scan_bf16_residual.launches = 0


def ivf_cell_scan_bf16_decode(
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb: int,
    cosine: bool = False, q_split: bool = False, fold_depth: int = 2, exact: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1-bf16-decode: bf16 ``cells [nseg+1, seg, dp]`` under the
    int8-decode prologues and epilogues K1a-bf16 does not take, as the
    Pallas body takes any cell type: mode ``i8dec`` with ``cent_x`` None
    (``qk = q·scales``; ``l2`` with ``qadd = ‖q‖²``, or ``cos_renorm``),
    mode ``i8dec_residual`` with ``cent_x`` under ``cos_renorm`` (K1b-cos's
    prologue), or its ``l2`` with one query term (K1a's). ``q_split`` two
    bf16 query terms (the residual ``l2`` with two is K1a-bf16 and raises
    here); the fold at ``fold_depth``, or with ``exact`` the exact
    selection. Other arguments and the result as :func:`ivf_cell_scan`."""
    if not lists.is_cuda:
        return ivf_cell_scan_plain(
            lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
            cosine=cosine, q_split=q_split, fold_depth=fold_depth, exact=exact,
        )
    residual = cent_x is not None
    if residual and not cosine and q_split:
        raise ValueError("ivf_cell_scan_bf16_decode: the residual l2 scan with two query "
                         "terms is K1a-bf16 (ivf_cell_scan_bf16_residual)")
    out = _launch_i8dec("ivf_cell_scan_bf16_decode", "annsearch_ivf_scan_bf16_decode", lists,
                        task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
                        (int(residual), int(cosine), int(q_split),
                         0 if exact else _sel(fold_depth)),
                        cell_dtype=torch.bfloat16, terms=1 + q_split,
                        residual=residual and not cosine, cents_arg=True)
    ivf_cell_scan_bf16_decode.launches += 1
    return out


ivf_cell_scan_bf16_decode.launches = 0


def _launch_dense(name, entry, cell_dtype, lists, task_seg, cnt, queries_x,
                  cells, sn, kb, cosine, sel):
    from ._cuda import load_library

    # query terms: sq8's int8 codes, K1d-bf16's one bf16 term, else three
    int8 = cell_dtype == torch.int8
    terms = 1 if int8 or (cell_dtype == torch.bfloat16 and sel) else 3
    _check_inputs(
        (("lists", lists, torch.int32, 2), ("task_seg", task_seg, torch.int32, 1),
         ("cnt", cnt, torch.int32, 1), ("queries_x", queries_x, torch.float32, 2),
         ("cells", cells, cell_dtype, 3), ("sn", sn, torch.float32, 2)),
        lists.device,
    )
    _check_shapes(name, lists, task_seg, cnt, queries_x, cells, sn, kb)
    R, maxq = lists.shape
    _, seg, dp = cells.shape
    out_d, out_i = _outputs(lists, kb)
    scratch = _query_scratch(cells, queries_x, terms, int8, False, sel, kb)
    err = getattr(load_library(), entry)(
        lists.data_ptr(), task_seg.data_ptr(), cnt.data_ptr(),
        queries_x.data_ptr(), cells.data_ptr(), sn.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), R, maxq, seg, queries_x.shape[1],
        dp, kb, int(cosine), sel,
        *_tail(torch.cuda.current_stream(lists.device).cuda_stream, cells, queries_x, scratch),
    )
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out_d, out_i


def _dense_wrapper(name, entry, cell_dtype, plain, exact, doc):
    """The wrapper of one dense-cell variant: its kernel on CUDA tensors,
    ``plain`` on CPU tensors, and its own launch count. The fold wrappers
    take ``fold_depth``."""

    def launch(lists, task_seg, cnt, queries_x, cells, sn, kb, cosine, fold_depth):
        if not lists.is_cuda:
            return plain(lists, task_seg, cnt, queries_x, cells, sn, kb, cosine,
                         exact=exact, fold_depth=fold_depth)
        out = _launch_dense(name, entry, cell_dtype, lists, task_seg, cnt, queries_x,
                            cells, sn, kb, cosine, 0 if exact else _sel(fold_depth))
        wrapper.launches += 1
        return out

    if exact:
        def wrapper(lists, task_seg, cnt, queries_x, cells, sn, kb: int, cosine: bool = False):
            return launch(lists, task_seg, cnt, queries_x, cells, sn, kb, cosine, 2)
    else:
        def wrapper(lists, task_seg, cnt, queries_x, cells, sn, kb: int, cosine: bool = False,
                    fold_depth: int = 2):
            return launch(lists, task_seg, cnt, queries_x, cells, sn, kb, cosine, fold_depth)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    #: kernel launches since the last reset (plain-version calls do not count)
    wrapper.launches = 0
    return wrapper


_DENSE_ARGS = """

    Arguments: ``lists [R, maxq]`` int32 query ids (pad = nq, a zero row),
    ``task_seg [R]`` int32 segment block of each task row, ``cnt [R]``
    int32 valid rows of that block (0 = skip), ``queries_x [nq+1, d]`` f32
    (last row zero), ``cells [nseg+1, seg, dp]`` (:func:`repack_blocks`),
    ``sn [nseg+1, seg]`` f32 row squared norms, ``kb``, ``cosine`` (the
    mode's cosine epilogue, else ``l2``) and, for a fold, ``fold_depth``
    (1: K1-fold1). Returns ``out_d [R, maxq, kb]`` f32 and ``out_i [R,
    maxq, kb]`` int32 lanes. CUDA tensors launch the kernel (or raise); CPU
    tensors run the plain version."""

ivf_cell_scan_f32_exact = _dense_wrapper(
    "ivf_scan_f32_exact", "annsearch_ivf_scan_f32", torch.float32,
    ivf_cell_scan_f32_plain, True,
    "K1c-f32: per task row and query slot, the kb lexicographically "
    "smallest ``(distance, lane)`` pairs of the row's f32 segment, then "
    "(3e38, 0) past its valid rows; ``cos_plain`` under cosine." + _DENSE_ARGS,
)
ivf_cell_scan_f32_fold = _dense_wrapper(
    "ivf_scan_f32_fold", "annsearch_ivf_scan_f32", torch.float32,
    ivf_cell_scan_f32_plain, False,
    "K1d-f32: as K1c-f32, with K1a's stride-class fold in place of "
    "the exact selection." + _DENSE_ARGS,
)
ivf_cell_scan_bf16_exact = _dense_wrapper(
    "ivf_scan_bf16_exact", "annsearch_ivf_scan_bf16", torch.bfloat16,
    ivf_cell_scan_bf16_plain, True,
    "K1c-bf16: K1c-f32's exact selection over bf16 cells, scored with the "
    "f32 query (the JAX package's hi/lo query split carries about 16 of its "
    "bits; the kernel's three exact bf16 terms hold all 24, summed at f32 "
    "grade)." + _DENSE_ARGS,
)
ivf_cell_scan_bf16_fold = _dense_wrapper(
    "ivf_scan_bf16_fold", "annsearch_ivf_scan_bf16", torch.bfloat16,
    ivf_cell_scan_bf16_plain, False,
    "K1d-bf16: the fold over bf16 cells, scored with the query rounded to "
    "bf16 (one bf16 pass, as the JAX package); ``qadd`` is the f32 query's "
    "squared norm." + _DENSE_ARGS,
)
ivf_cell_scan_sq8_exact = _dense_wrapper(
    "ivf_scan_sq8_exact", "annsearch_ivf_scan_sq8", torch.int8,
    ivf_cell_scan_sq8_plain, True,
    "K1c-sq8: the exact selection over int8 cells, ``queries_x`` holding "
    "int8 query codes; ``l2`` in integer space, ``cos_qnorm`` under "
    "cosine." + _DENSE_ARGS,
)
ivf_cell_scan_sq8_fold = _dense_wrapper(
    "ivf_scan_sq8_fold", "annsearch_ivf_scan_sq8", torch.int8,
    ivf_cell_scan_sq8_plain, False,
    "K1d-sq8: as K1c-sq8, with the fold." + _DENSE_ARGS,
)


# -- host side ----------------------------------------------------------------


def fused_ivf_scan(
    queries: torch.Tensor,       # [nq, d] f32
    cluster_ids: torch.Tensor,   # [R] segment ids (pad = nseg)
    probe_lists: torch.Tensor,   # [R, maxq] query ids (pad = nq)
    gather_map: torch.Tensor,    # [nq, T] flat scan lanes (pad = -1)
    cells: torch.Tensor,         # [nseg+1, seg, dp] int8, bf16 or f32
    sn: torch.Tensor,            # [nseg+1, seg] f32
    seg_offsets: torch.Tensor,   # [nseg] (maps lanes back to sorted rows)
    seg_counts: torch.Tensor,    # [nseg]
    seg_centroids: torch.Tensor, # [nseg, d] f32
    k: int,
    metric: Dist,
    mode: str,
    scales: torch.Tensor | None, # [d] f32 decode scales (the i8dec modes)
    kb: int,
    selection: str = "fold",     # "fold" or "exact"
    q_split: bool = False,       # two bf16 query terms (the i8dec modes only)
    fold_depth: int = 2,         # survivors per stride class of the fold
    groups: int = 1,             # independent top-k runs of each query's lanes
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan of the task lists; ``(best_d, best_i)`` of shape
    ``[nq, k]`` ascending, ``best_i`` positions in the sorted storage.
    ``queries`` are the scoring-space queries: for mode ``sq8`` the int8
    query codes. ``q_split`` defaults to one bf16 query pass, what
    ``IvfBase`` resolves its ``None`` to for the int8-decode modes. Over
    bf16 cells the int8-decode modes take K1a-bf16 (``i8dec_residual``,
    ``l2``, ``q_split=True``) or K1-bf16-decode (every other mode, epilogue
    and term count).
    ``groups > 1`` is the forests' per-tree merge (see
    :func:`regroup_topk`): the result is then ``[nq, groups·k]``,
    group-major. Stage ``ivf.scan``, the merge its child."""
    if mode not in _FUSED_MODES or selection not in ("fold", "exact"):
        raise ValueError(
            f"fused scan mode={mode!r} selection={selection!r}: the fused scan "
            f"takes modes {_FUSED_MODES} with selection 'fold' or 'exact'; the "
            "PQ-coded modes belong to the cluster scan (ops/ivf_scan.py)"
        )
    with profiling.stage("ivf.scan", queries):
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
        cosine = metric == Dist.COSINE
        exact = selection == "exact"

        # the cosine epilogue: cos_plain for f32 / bf16 rows (stored
        # normalised), cos_qnorm for sq8 codes
        dense = {
            "f32": (ivf_cell_scan_f32_exact, ivf_cell_scan_f32_fold),
            "bf16": (ivf_cell_scan_bf16_exact, ivf_cell_scan_bf16_fold),
            "sq8": (ivf_cell_scan_sq8_exact, ivf_cell_scan_sq8_fold),
        }
        if mode in dense:
            if exact:
                cd, ci = dense[mode][0](*task, cells, sn, kb, cosine=cosine)
            else:
                cd, ci = dense[mode][1](*task, cells, sn, kb, cosine=cosine,
                                        fold_depth=fold_depth)
        else:
            sc = scales.float().contiguous()
            cent_x = None if mode == "i8dec" else torch.cat([seg_centroids.float(), zero_row])
            if cells.dtype == torch.bfloat16 and cent_x is not None and not cosine and q_split:
                cd, ci = ivf_cell_scan_bf16_residual(*task, cent_x, sc, cells, sn, kb,
                                                     fold_depth=fold_depth, exact=exact)
            elif cells.dtype == torch.bfloat16:
                cd, ci = ivf_cell_scan_bf16_decode(*task, cent_x, sc, cells, sn, kb,
                                                   cosine=cosine, q_split=q_split,
                                                   fold_depth=fold_depth, exact=exact)
            elif exact:
                cd, ci = ivf_cell_scan_i8_exact(*task, cent_x, sc, cells, sn, kb, cosine=cosine,
                                                q_split=q_split)
            elif mode == "i8dec":
                cd, ci = ivf_cell_scan_i8dec(*task, sc, cells, sn, kb, cosine=cosine,
                                             q_split=q_split, fold_depth=fold_depth)
            elif cosine:
                cd, ci = ivf_cell_scan_cos(*task, cent_x, sc, cells, sn, kb, q_split=q_split,
                                           fold_depth=fold_depth)
            elif q_split:
                cd, ci = ivf_cell_scan_split(*task, cent_x, sc, cells, sn, kb,
                                             fold_depth=fold_depth)
            else:
                cd, ci = ivf_cell_scan(*task, cent_x, sc, cells, sn, kb, fold_depth=fold_depth)
        # lane → sorted-storage row; a sentinel lane of a short segment lands
        # in the padded trailing storage rows
        gi = offs_x[cid][:, None, None] + ci.long()

        return regroup_topk(cd.reshape(-1, kb), gi.reshape(-1, kb), gather_map, k, groups)


def regroup_topk(
    flat_d: torch.Tensor,      # [lanes, kc] per (task row, slot) candidates
    flat_i: torch.Tensor,      # [lanes, kc] their sorted-storage positions
    gather_map: torch.Tensor,  # [nq, T] flat scan lanes (pad = -1)
    k: int,
    groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Regroup the scan lanes per query and take the final top-k: ``(best_d,
    best_i) [nq, k]`` ascending, padded with (+inf, 0) where a query has
    fewer than k candidates. Shared by the fused scan and the cluster
    scan.

    ``groups > 1`` (K1-groups, the forests' per-tree merge): each query's
    ``T`` gather lanes split into ``groups`` equal runs in the gather map's
    order (``T`` must divide), each run takes its own top-k, and the result
    is ``[nq, groups·k]``, group-major. The caller keeps one lane per probe
    in probe order, so that a run is one tree's probes. Stage
    ``ivf.merge``."""
    with profiling.stage("ivf.merge", flat_d):
        return _regroup(flat_d, flat_i, gather_map, k, groups)


def _regroup(flat_d, flat_i, gather_map, k, groups):
    dev = flat_d.device
    nq, T = gather_map.shape
    kb = flat_d.shape[1]
    if T % groups:
        raise ValueError(f"groups={groups} does not divide the {T} task lanes of a query")
    # pad lanes (-1) read an appended (+inf, 0) row
    flat_d = torch.cat([flat_d, torch.full((1, kb), float("inf"), device=dev)])
    flat_i = torch.cat([flat_i.long(), torch.zeros((1, kb), dtype=torch.long, device=dev)])
    gm = torch.where(gather_map < 0, flat_d.shape[0] - 1, gather_map.long())
    rows = nq * groups
    gd = flat_d[gm].reshape(rows, -1)
    gi2 = flat_i[gm].reshape(rows, -1)
    kk = min(k, gd.shape[1])
    # stable: equal distances keep task order, as lax.top_k keeps them
    order = torch.sort(gd, dim=-1, stable=True).indices[:, :kk]
    best_d = torch.gather(gd, 1, order)
    best_i = torch.gather(gi2, 1, order)
    if kk < k:
        best_d = torch.cat([best_d, torch.full((rows, k - kk), float("inf"), device=dev)], 1)
        best_i = torch.cat([best_i, torch.zeros((rows, k - kk), dtype=torch.long, device=dev)], 1)
    return best_d.reshape(nq, -1), best_i.reshape(nq, -1)
