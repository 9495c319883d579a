"""Batched space-partition trees (port of ``annsearch_tpu.ops.tree``): the
Annoy, kd-forest and ball-tree substrate.

Build: a balanced tree of depth L is L sort-by-(group, score) passes. Each
level scores every point against its group's splitter (a two-point
hyperplane, a high-spread axis, or the ball's approximate diameter axis),
sorts within groups, and splits every group at its median. All groups of a
level are one ``[g, gs]`` sort; per-group statistics come from equal-sized
reshapes. Query-time descent lives with the indexes (``models/trees.py``).

Routing data is in heap layout: level l holds 2^l nodes, node g's children
are (2g, 2g+1) at level l+1.

Random draws come from one explicit ``torch.Generator`` for the forest, so
one seed gives one forest on one device; they differ from the JAX
package's key stream, so the two packages' trees agree in kind, not in
value (tests carry a JAX forest across to compare queries). The products
are FP32 with TF32 off.

Not ported: ``_tree_level_uniform``, a shape-uniform variant of the level
step whose only purpose is one XLA compilation for every level; here
``_tree_level`` serves every level and leaf size.
"""

from __future__ import annotations

import math

import torch

from ..utils.dist import fp32_matmul

__all__ = ["build_partition_forest", "build_partition_tree", "PartitionTree"]

#: the score of padding rows (they sort to the right half of every group)
_BIG = 1e30


class PartitionTree:
    """One balanced partition tree.

    Attributes:
      order:      [n_pad] int64: point ids in leaf-contiguous order (ids ≥
                  n are padding, always a suffix)
      normals:    list over levels of [2^l, d] splitter normals (kd: one-hot
                  axis vectors; ball: the diameter axis)
      thresholds: list over levels of [2^l] median thresholds
      centers / radii: per level [2^l, d] / [2^l], and one more level for
                  the leaves (ball mode only, else None)
      leaf:       leaf size
    """

    def __init__(self, order, normals, thresholds, centers, radii, leaf):
        self.order = order
        self.normals = normals
        self.thresholds = thresholds
        self.centers = centers
        self.radii = radii
        self.leaf = leaf

    @property
    def n_levels(self) -> int:
        return len(self.normals)


def _group_stats(vecs_g: torch.Tensor, valid_g: torch.Tensor) -> torch.Tensor:
    """Mean per group with padding masked; ``vecs_g [G, gs, d]``."""
    w = valid_g.float()[..., None]
    return (vecs_g * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)


def _unit(v: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Rows of ``v`` with norm > 1e-6 kept, the others replaced by a normal
    draw (a degenerate splitter)."""
    rand = torch.randn(v.shape, generator=gen, device=v.device)
    return torch.where(v.norm(dim=-1, keepdim=True) > 1e-6, v, rand)


def _ball(pts: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per group: the masked centre and the radius (largest member
    distance)."""
    center = _group_stats(pts, valid)
    dd = torch.where(valid, ((pts - center[:, None, :]) ** 2).sum(-1), 0.0)
    return center, torch.sqrt(dd.max(dim=-1).values)


def _tree_level(vectors, order, gen: torch.Generator, g: int, gs: int, mode: str, n: int):
    """One partition level: ``(new_order, normal [g, d], thr [g], center,
    radius)`` (the last two None outside ball mode)."""
    d = vectors.shape[1]
    dev = vectors.device
    pts = vectors[torch.clamp(order, max=n)].reshape(g, gs, d)
    valid = (order < n).reshape(g, gs)
    gi = torch.arange(g, device=dev)

    if mode == "annoy":
        # R candidate two-point hyperplanes per group; keep the one whose
        # in-group projections spread most (the JAX package's use of the
        # reference's split retries: its median split is balanced anyway)
        R = 4
        ia = torch.randint(0, gs, (R, g), generator=gen, device=dev)
        ib = torch.randint(0, gs, (R, g), generator=gen, device=dev)
        cand = _unit(pts[gi[None, :], ia] - pts[gi[None, :], ib], gen)
        cand = cand / torch.clamp(cand.norm(dim=-1, keepdim=True), min=1e-12)
        with fp32_matmul():
            sc = torch.einsum("gsd,rgd->rgs", pts, cand)
        w = valid.float()[None]
        cnt = torch.clamp(w.sum(dim=-1), min=1.0)
        mean = (sc * w).sum(dim=-1) / cnt
        var = (((sc - mean[..., None]) ** 2) * w).sum(dim=-1) / cnt
        normal = cand[torch.argmax(var, dim=0), gi]
    elif mode == "kd":
        # an axis drawn among the three of largest in-group spread (the
        # random pick decorrelates the forest)
        mean = _group_stats(pts, valid)
        var = _group_stats((pts - mean[:, None, :]) ** 2, valid)
        top3 = torch.sort(var, dim=1, descending=True, stable=True).indices[:, : min(3, d)]
        pick = torch.randint(0, top3.shape[1], (g,), generator=gen, device=dev)
        normal = torch.nn.functional.one_hot(top3[gi, pick], d).float()
    else:  # ball: the approximate diameter axis
        mean = _group_stats(pts, valid)
        d2c = torch.where(valid, ((pts - mean[:, None, :]) ** 2).sum(-1), -1.0)
        p1 = pts[gi, torch.argmax(d2c, dim=-1)]
        d2f = torch.where(valid, ((pts - p1[:, None, :]) ** 2).sum(-1), -1.0)
        p2 = pts[gi, torch.argmax(d2f, dim=-1)]
        normal = _unit(p1 - p2, gen)

    with fp32_matmul():
        score = torch.bmm(pts, normal[:, :, None])[:, :, 0]
    score = torch.where(valid, score, _BIG)          # padding → right half
    sorted_score, perm = torch.sort(score, dim=-1, stable=True)
    new_order = torch.gather(order.reshape(g, gs), 1, perm)
    thr = 0.5 * (sorted_score[:, gs // 2 - 1] + sorted_score[:, gs // 2])
    thr = torch.clamp(thr, -_BIG, _BIG)
    center = radius = None
    if mode == "ball":
        center, radius = _ball(pts, valid)
    return new_order.reshape(-1), normal, thr, center, radius


def _leaf_ball_stats(vectors, order, g: int, leaf: int, n: int):
    """Centre and radius of each of the ``g`` leaves."""
    d = vectors.shape[1]
    pts = vectors[torch.clamp(order, max=n)].reshape(g, leaf, d)
    return _ball(pts, (order < n).reshape(g, leaf))


def build_partition_tree(
    gen: torch.Generator,
    vectors: torch.Tensor,   # [n+1, d] f32, sentinel row n
    levels: int,
    leaf: int,
    mode: str,               # "annoy" | "kd" | "ball"
) -> PartitionTree:
    """Build one tree of ``2^levels`` leaves of ``leaf`` slots (more levels
    if they would not hold n rows)."""
    n = vectors.shape[0] - 1
    n_pad = (2 ** levels) * leaf
    if n_pad < n:
        levels = math.ceil(math.log2(max(n / leaf, 1)))
        n_pad = (2 ** levels) * leaf
    dev = vectors.device
    order = torch.cat([torch.arange(n, device=dev),
                       torch.full((n_pad - n,), n, dtype=torch.long, device=dev)])
    normals, thresholds, centers, radii = [], [], [], []
    for lv in range(levels):
        g = 2 ** lv
        order, normal, thr, center, radius = _tree_level(
            vectors, order, gen, g, n_pad // g, mode, n
        )
        normals.append(normal)
        thresholds.append(thr)
        if mode == "ball":
            centers.append(center)
            radii.append(radius)
    if mode == "ball":
        center, radius = _leaf_ball_stats(vectors, order, 2 ** levels, leaf, n)
        centers.append(center)
        radii.append(radius)
    return PartitionTree(
        order, normals, thresholds,
        centers if mode == "ball" else None,
        radii if mode == "ball" else None,
        leaf,
    )


def build_partition_forest(
    gen: torch.Generator, vectors: torch.Tensor, n_trees: int, levels: int, leaf: int,
    mode: str,
) -> list[PartitionTree]:
    """``n_trees`` trees drawn in turn from ``gen``."""
    return [build_partition_tree(gen, vectors, levels, leaf, mode) for _ in range(n_trees)]
