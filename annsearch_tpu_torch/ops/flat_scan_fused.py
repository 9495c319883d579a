"""Fused flat top-k, kernel K2 (port of ``annsearch_tpu.ops.flat_scan_pallas``).

``flat_topk_fused`` scans the whole database for every query and keeps,
per query and per column class ``col mod B``, the best (``depth=1``) or the
best two (``depth=2``) ``(score, col)`` pairs with ``score = ‖x‖² − 2·q·x``
(``−2·q·x`` under cosine); after the last database tile it extracts ``kb``
minima in turn, ties to the lowest column. A true neighbour is lost only
when more than ``depth`` of the top-k share a class, so ``B`` (from
``block_db`` and ``n``) is part of the result, not a tuning knob.

A CUDA tensor goes to the hand-written kernels in ``csrc/flat_scan.cu`` (or
raises): a scan on ``wgmma`` fed by TMA, with the query terms held in
shared memory, or, for rows too wide for them to stay (:func:`scan_plan`),
the wide scan, which brings them a 32-column chunk at a time beside the
same chunk of four database tiles; then an extraction by a sort network.
A CPU tensor goes to ``flat_topk_fused_plain``, the same function in
tensor operations, which is also what the kernels are held against.

Grade of the dots. The Pallas kernel sums bf16 cross terms of a mantissa
split on the MXU; the port sums the same terms on the tensor cores:
``passes`` 1, 3 and 6 split both operands into 1, 2 and 3 bf16 terms
(``utils.dist.mantissa_split``) and sum the cross terms of
``utils.dist.CROSS`` (one, three and six products) into f32. Three terms
hold all 24 bits of each operand and the tensor cores keep 24 bits of the
largest term of each 16-column sum, so ``passes=6`` is f32 grade; two
terms carry about 16 bits, one is ``bf16_rne``. The split is made once
per call, here in tensor code, as the JAX package's ``_prep_parts`` makes
it outside its kernel. The plain version takes ``passes=6`` as one fp32
matmul (TF32 off), and sums the split's products where the split sets the
grade (``passes`` 1 and 3: the terms side by side in one f32 matmul). It
and the kernel sum in different orders, so they agree bit for bit only
where every product and partial sum is exact (inputs on a coarse grid);
elsewhere distances agree within rounding and near-ties may swap. No
lane-packed layout.
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, cross_packed, fp32_matmul, mantissa_split, sq_norms

__all__ = [
    "flat_topk_fused", "flat_topk_fused_plain", "flat_extract", "fused_shapes",
    "slab_rows", "scan_plan", "split_terms",
]

#: finite "masked" value of the scan (ranks after every real score)
BIG = 3.0e38
_DEF_B = 2048
#: query rows per step of the plain version (bounds its [rows, depth·B] bins)
_PLAIN_ROWS = 512
#: bytes of bins scratch per kernel launch: queries go through in slabs
_SCRATCH_BYTES = 512 * 1024 * 1024
#: the extraction kernel sorts depth·B bins in up to 8 warps × 512 keys
_MAX_BINS = 4096
#: the extraction keeps the 128 smallest keys: kb ≤ 128 (``fused_shapes``)
_MAX_KB = 128
#: db tiles one scan launch covers (a bin keeps its tile in 16 bits)
_RUN_TILES = 65_534
#: shared memory of the wide scan's bins: m1, m2 and the tiles of 16 pairs
#: for each of its 256 consumer threads
_WIDE_BINS = 3 * 16 * 256 * 4


def _pow2ceil(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def fused_shapes(n: int, k: int, block_db: int = _DEF_B) -> tuple[int, int]:
    """``(kb, B)`` of a scan: the extracted width ``min(pow2ceil(max(k, 8)),
    128)`` and the class count ``min(block_db, max(128, pow2ceil(n)))``."""
    return min(_pow2ceil(max(k, 8)), 128), min(block_db, max(128, _pow2ceil(n)))


def slab_rows(B: int, depth: int = 2) -> int:
    """Queries per kernel launch: as many as keep the bins (8 bytes each,
    ``depth·B`` a query) within the scratch budget, a multiple of 128
    (16,384 at ``B`` 2,048, depth 2)."""
    return max(128, _SCRATCH_BYTES // (depth * B * 8) // 128 * 128)


def split_terms(passes: int) -> int:
    """bf16 terms of each operand for ``passes`` (1, 3 or 6): 1, 2 or 3."""
    return 3 if passes >= 6 else (2 if passes >= 3 else 1)


def _cols(d: int) -> int:
    """dk: the kernels' row width, ``d`` rounded up to 32 columns."""
    return -(-d // 32) * 32


def scan_plan(d: int, passes: int = 1) -> tuple[int, int, int, int, int]:
    """``(wide, tiles a stage, stages, bytes a stage, dynamic shared
    memory)`` of the scan at row width ``d``, as
    ``csrc/flat_scan.cu::scan_plan`` sizes it for T terms and dk = d rounded
    up to 32 columns (nch chunks of 32): up to 1024 bytes of alignment
    slack, 1024 of barriers, the 128 queries' terms (2 × nch × T boxes of 64
    rows × 64 bytes), then the ring: a tile is nch × T boxes of 32 rows × 64
    bytes and its 32 norms, a stage an even number of tiles (as many as fit
    16 KiB, at least two: one product reads a pair) rounded up to 1024
    bytes, up to 8 stages in 227 KiB. Where two stages do not fit, ``wide``
    is 1: the wide scan, whose stage holds one 32-column chunk of T terms of
    a unit of 4 tiles (4 × 32 rows × 64 bytes each), of the 128 queries (2 ×
    64 rows × 64 bytes each) and the unit's 128 norms, rounded up to 1024
    bytes, up to 8 stages beside 48 KiB of bins."""
    return _plan(_cols(d), split_terms(passes))


def _stage_of(b: int) -> int:
    return -(-b // 1024) * 1024


def _plan(dk: int, t: int) -> tuple[int, int, int, int, int]:
    nch = dk // 32
    tile = nch * t * 2048 + 128
    fixed = 2048 + 2 * nch * t * 4096
    tps = max(2, 16384 // tile // 2 * 2)
    stages = (227 * 1024 - fixed) // _stage_of(tps * tile)
    if stages < 2:
        stage = _stage_of(t * (4 * 2048 + 2 * 4096) + 4 * 128)
        stages = min((227 * 1024 - 2048 - _WIDE_BINS) // stage, 8)
        return 1, 4, stages, stage, 2048 + _WIDE_BINS + stages * stage
    stages = min(stages, 8)
    return 0, tps, stages, _stage_of(tps * tile), fixed + stages * _stage_of(tps * tile)


def _prepare(q, x, metric, x_sqnorm, n_valid):
    """``(sn [n] or None, qadd [nq], n_valid)``: the row term of the score
    (None under cosine: zero) and the per-query term added at extraction."""
    n = x.shape[0]
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    if metric == Dist.EUCLIDEAN:
        sn = sq_norms(x) if x_sqnorm is None else x_sqnorm.float()
        return sn.contiguous(), sq_norms(q), n_valid
    return None, torch.zeros(q.shape[0], device=q.device), n_valid


def _finish(cd, ci, k: int, kb: int, metric, n_valid: int):
    """The clamps after the extraction: ``max(·, 0)`` (euclidean) or
    ``·0.5 + 1`` (cosine), ids clamped to ``n_valid − 1``, and columns of
    (inf, 0) past ``kb``."""
    nq = cd.shape[0]
    cd = torch.clamp(cd, min=0.0) if metric == Dist.EUCLIDEAN else cd * 0.5 + 1.0
    kk = min(k, kb)
    best_d = cd[:, :kk]
    best_i = torch.clamp(ci[:, :kk].long(), max=max(n_valid - 1, 0))
    if kk < k:
        best_d = torch.cat(
            [best_d, torch.full((nq, k - kk), float("inf"), device=cd.device)], dim=1)
        best_i = torch.cat(
            [best_i, torch.zeros((nq, k - kk), dtype=torch.long, device=cd.device)], dim=1)
    return best_d, best_i


def _scan_plain(q, x, sn, qadd, n_valid: int, B: int, depth: int, kb: int, terms: int):
    """The scan and the extraction in tensor operations:
    ``(cd [nq, kb] f32, ci [nq, kb] int32)`` before the clamps. The dots
    sum the cross terms of the ``terms``-way split in f32 (three terms:
    the f32 operands themselves)."""
    nq, n = q.shape[0], x.shape[0]
    dev = q.device
    if terms < 3:
        q, x = cross_packed(q, x, terms)
    rows = torch.arange(n, device=dev)
    sn = torch.zeros(n, device=dev) if sn is None else sn
    sn = torch.where(rows < n_valid, sn, BIG)
    out_d = torch.empty((nq, kb), device=dev)
    out_i = torch.empty((nq, kb), dtype=torch.int32, device=dev)
    lane = torch.arange(B, device=dev, dtype=torch.int32)
    for r0 in range(0, nq, _PLAIN_ROWS):
        qb = q[r0 : r0 + _PLAIN_ROWS]
        m1 = torch.full((qb.shape[0], B), BIG, device=dev)
        m2 = m1.clone()
        i1 = torch.zeros((qb.shape[0], B), dtype=torch.int32, device=dev)
        i2 = i1.clone()
        for base in range(0, n, B):
            w = min(B, n - base)
            with fp32_matmul():
                dots = qb @ x[base : base + w].T
            score = sn[base : base + w] - 2.0 * dots
            col = (base + lane[:w]).expand_as(score)
            a1, j1 = m1[:, :w], i1[:, :w]
            b1 = score < a1
            spill = torch.where(b1, a1, score)
            spi = torch.where(b1, j1, col)
            m1[:, :w] = torch.where(b1, score, a1)
            i1[:, :w] = torch.where(b1, col, j1)
            if depth == 2:
                a2 = m2[:, :w]
                b2 = spill < a2
                i2[:, :w] = torch.where(b2, spi, i2[:, :w])
                m2[:, :w] = torch.where(b2, spill, a2)
        vals = torch.cat([m1, m2], dim=1) if depth == 2 else m1
        idx = torch.cat([i1, i2], dim=1) if depth == 2 else i1
        sl = slice(r0, r0 + _PLAIN_ROWS)
        out_d[sl], out_i[sl] = _extract_plain(vals, idx, qadd[sl], kb)
    return out_d, out_i


def _extract_plain(vals, idx, qadd, kb: int):
    """The extraction in tensor operations: kb rounds of the lexicographic
    minimum (value, column) over each row's bins ``vals`` / ``idx`` [rows,
    width] (columns below 2³⁰), each writing (value + qadd, column) and
    setting the bins equal to the winner to 3e38. ``(d [rows, kb] f32, i
    [rows, kb] int32)``."""
    out_d = torch.empty((vals.shape[0], kb), device=vals.device)
    out_i = torch.empty((vals.shape[0], kb), dtype=torch.int32, device=vals.device)
    for t in range(kb):
        v = vals.min(dim=1, keepdim=True).values
        hit = vals == v
        low = torch.where(hit, idx, 2**30).min(dim=1, keepdim=True).values
        out_d[:, t] = (v + qadd[:, None])[:, 0]
        out_i[:, t] = low[:, 0]
        vals = torch.where(hit & (idx == low), BIG, vals)
    return out_d, out_i


def _terms_of(v: torch.Tensor, terms: int, dk: int) -> torch.Tensor:
    """``[terms, rows, dk]`` bf16: the mantissa split of ``v [rows, d]``
    with zero columns past d (the kernels' operands; dk a multiple of 32)."""
    out = torch.zeros((terms, v.shape[0], dk), dtype=torch.bfloat16, device=v.device)
    for i, t in enumerate(mantissa_split(v, terms)):
        out[i, :, : v.shape[1]] = t
    return out


def _scan_cuda(q, x, sn, qadd, n_valid: int, B: int, depth: int, kb: int, terms: int):
    """Launch K2 over slabs of queries; result as :func:`_scan_plain`."""
    from ._cuda import load_library

    nq, d = q.shape
    n = x.shape[0]
    if (depth not in (1, 2) or B % 32 or depth * B > _MAX_BINS
            or not 1 <= kb <= min(depth * B, _MAX_KB)):
        raise ValueError(
            f"flat_topk_fused: unsupported depth={depth}, B={B}, kb={kb} (the "
            f"kernel takes depth 1 or 2, B a multiple of 32, depth·B ≤ {_MAX_BINS}, "
            f"kb ≤ {_MAX_KB})"
        )
    if n >= 2**31 - B:
        raise ValueError(f"flat_topk_fused: n={n} does not fit int32 columns")
    for name, t in (("q", q), ("x", x), ("x_sqnorm", sn), ("qadd", qadd)):
        if t is not None and (t.dtype != torch.float32 or t.device != q.device):
            raise ValueError(f"flat_topk_fused: {name} must be float32 on {q.device}")
    if sn is not None and sn.shape != (n,):
        raise ValueError(f"flat_topk_fused: x_sqnorm must have shape ({n},)")
    # the kernels' operands: the bf16 terms in rows of a multiple of 32
    # columns, and the norms of whole tiles (3e38 at and past n_valid)
    dk = _cols(d)
    q_t, x_t = _terms_of(q, terms, dk), _terms_of(x, terms, dk)
    sn_t = torch.full((-(-n // B) * B,), BIG, device=q.device)
    sn_t[:n_valid] = 0.0 if sn is None else sn[:n_valid]
    qadd = qadd.contiguous()
    out_d = torch.empty((nq, kb), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, kb), dtype=torch.int32, device=q.device)
    width = depth * B
    slab = slab_rows(B, depth)
    rows = min(slab, nq)
    bins_v = torch.empty((rows, width), dtype=torch.float32, device=q.device)
    bins_i = torch.empty((rows, width), dtype=torch.int32, device=q.device)
    # past _RUN_TILES tiles the kernel scans runs of them and merges each
    # run's bins into the earlier runs' (``csrc/flat_scan.cu``)
    many = -(-n // B) > _RUN_TILES
    bins_v2 = torch.empty_like(bins_v) if many else None
    bins_i2 = torch.empty_like(bins_i) if many else None
    fn = load_library().annsearch_flat_scan
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for s in range(0, nq, slab):
        m = min(slab, nq - s)
        err = fn(
            q_t[0, s].data_ptr(), x_t.data_ptr(), sn_t.data_ptr(),
            qadd[s : s + m].data_ptr(), bins_v.data_ptr(), bins_i.data_ptr(),
            bins_v2.data_ptr() if many else None, bins_i2.data_ptr() if many else None,
            out_d[s : s + m].data_ptr(), out_i[s : s + m].data_ptr(),
            m, nq, n, dk, B, depth, kb, terms, stream,
        )
        if err:
            raise RuntimeError(f"flat_topk_fused launch failed: cudaError {err}")
        flat_topk_fused.launches += 1
    return out_d, out_i


def flat_extract(bins_v: torch.Tensor, bins_i: torch.Tensor, qadd: torch.Tensor, kb: int):
    """K2's extraction alone: kb rounds of the lexicographic minimum (value,
    column) over each row of bins ``bins_v`` [rows, width] f32 (every value
    at most 3e38) and ``bins_i`` int32, each writing (value + ``qadd`` [rows],
    column) and setting the bins equal to the winner to 3e38: ``(d [rows,
    kb], i [rows, kb] int32)``. width a multiple of 32 up to 4096, kb ≤
    min(width, 128). CUDA tensors launch the kernel that ends every K2 scan
    (or raise), counted in ``flat_extract.launches``; CPU tensors run the
    rounds in tensor operations."""
    if not bins_v.is_cuda:
        return _extract_plain(bins_v, bins_i, qadd, kb)
    from ._cuda import load_library

    rows, width = bins_v.shape
    if width % 32 or width > _MAX_BINS or not 1 <= kb <= min(width, _MAX_KB):
        raise ValueError(f"flat_extract: unsupported width={width}, kb={kb}")
    bins_v, bins_i = bins_v.float().contiguous(), bins_i.int().contiguous()
    qadd = qadd.float().contiguous()
    out_d = torch.empty((rows, kb), dtype=torch.float32, device=bins_v.device)
    out_i = torch.empty((rows, kb), dtype=torch.int32, device=bins_v.device)
    err = load_library().annsearch_flat_extract(
        bins_v.data_ptr(), bins_i.data_ptr(), qadd.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), rows, width, kb, torch.cuda.current_stream(bins_v.device).cuda_stream)
    if err:
        raise RuntimeError(f"flat_extract launch failed: cudaError {err}")
    flat_extract.launches += 1
    return out_d, out_i


def _run(scan, q, x, k, metric, x_sqnorm, n_valid, passes, depth, block_db):
    q, x = q.float(), x.float()
    kb, B = fused_shapes(x.shape[0], k, block_db)
    sn, qadd, n_valid = _prepare(q, x, metric, x_sqnorm, n_valid)
    cd, ci = scan(q, x, sn, qadd, n_valid, B, depth, kb, split_terms(passes))
    return _finish(cd, ci, k, kb, metric, n_valid)


def flat_topk_fused_plain(
    q: torch.Tensor, x: torch.Tensor, k: int, metric: Dist,
    x_sqnorm: torch.Tensor | None = None, n_valid: int | None = None,
    passes: int = 1, depth: int = 2, block_db: int = _DEF_B,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, on whatever device the inputs lie.
    Arguments and result as :func:`flat_topk_fused`."""
    return _run(_scan_plain, q, x, k, metric, x_sqnorm, n_valid, passes, depth, block_db)


def flat_topk_fused(
    q: torch.Tensor,                  # [nq, d] f32 (pre-normalised if cosine)
    x: torch.Tensor,                  # [n, d] f32
    k: int,
    metric: Dist,
    x_sqnorm: torch.Tensor | None = None,
    n_valid: int | None = None,
    passes: int = 1,
    depth: int = 2,
    block_db: int = _DEF_B,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused flat top-k: ``(dists [nq, k] f32, indices [nq, k] int64)``
    ascending. Euclidean distances are squared, cosine is ``1 − sim``; rows
    at or past ``n_valid`` never win. The JAX function's arguments less
    ``block_q`` (it changes no result) and ``interpret``.

    ``passes`` is the grade of the dots: the one, three or six bf16 cross
    terms of a 1-, 2- or 3-way mantissa split of both operands, summed in
    f32 (see the module docstring). ``depth`` bins per class, ``block_db``
    the most classes.
    At most ``kb = min(pow2ceil(max(k, 8)), 128)`` ranks are extracted;
    columns past ``kb`` are (inf, 0), and with fewer than ``kb`` rows the
    tail is the unfilled bins' (about 3e38, clamped id).

    CUDA tensors launch the kernels (or raise), in slabs of queries whose
    bins fit 512 MiB of scratch (twice that past 65,534 database tiles),
    one count in ``flat_topk_fused.launches`` per slab; rows too wide for
    the query terms to stay in shared memory take the wide scan
    (``flat_scan_wide_kernel``, :func:`scan_plan`). CPU tensors run the
    plain version."""
    scan = _scan_cuda if q.is_cuda else _scan_plain
    return _run(scan, q, x, k, metric, x_sqnorm, n_valid, passes, depth, block_db)


#: kernel launches (slabs) since the last reset; plain calls do not count
flat_topk_fused.launches = 0
flat_extract.launches = 0
