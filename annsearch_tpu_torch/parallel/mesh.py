"""Logical shard grids (port of ``annsearch_tpu.parallel.mesh``).

The JAX package lays the database over a device mesh: one shard per device,
per-device bodies under ``shard_map``, collectives over ICI. Its results
depend on the shard count P (IVF cells and graph sub-graphs are per shard),
so the port makes P a parameter apart from the hardware: a :class:`Mesh` is
a grid of logical shards on one card, optionally carried across the ranks
of a ``torch.distributed`` process group. P must be a multiple of the world
size W, and each rank holds P / W consecutive shards, stacked as one tensor
``[P / W, rows, ...]``. With no group, W = 1: every shard lives on the one
card and no ``torch.distributed`` call is made.

The collectives of the JAX package map to PyTorch so:

* ``axis_index`` → the global shard index (:meth:`Mesh.db_shards`);
* ``all_gather(tiled)`` → :func:`gather_shards`, the local shards' stack,
  and across ranks ``all_gather_into_tensor``;
* ``psum`` → :func:`gather_shards` of the partials, then a sum in shard
  order (fixed, so one seed gives the same sums for any W);
* a ``ppermute`` ring → :func:`ring_shift`: a roll of the local stack, and
  the boundary shard by ``batch_isend_irecv`` across ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "make_mesh", "make_mesh2d", "shard_rows", "replicate",
    "DB_AXIS", "BATCH_AXIS", "Mesh", "gather_shards", "ring_shift",
]

#: mesh axis name the database rows are sharded over
DB_AXIS = "db"
#: mesh axis name query batches are sharded over (2-D meshes)
BATCH_AXIS = "batch"


class Mesh:
    """A grid of logical shards on one card (``device``), its last axis
    split over the ranks of ``group`` (None: one rank).

    ``shape`` maps each axis name to its size, in ``axis_names`` order, as a
    JAX mesh's ``shape`` does. Only the database axis (the last) crosses
    ranks; the batch axis of a 2-D grid is pure data parallelism, and every
    rank answers every batch block against its own database shards."""

    def __init__(self, shape: dict[str, int], device="cuda", group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device = torch.device(device)
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        p = self.shape[self.axis_names[-1]]
        if any(s < 1 for s in self.shape.values()) or p % self.world:
            raise ValueError(
                f"a grid of {dict(self.shape)} logical shards cannot be laid over "
                f"{self.world} ranks: the last axis must be a positive multiple of the world"
            )

    @property
    def n_shards(self) -> int:
        """P, the database shards (the last axis)."""
        return self.shape[self.axis_names[-1]]

    @property
    def n_local(self) -> int:
        """P / W, the database shards this rank holds."""
        return self.n_shards // self.world

    def db_shards(self) -> range:
        """Global indices of this rank's database shards, in stack order."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    @property
    def n_batch(self) -> int:
        """Query-batch blocks of a 2-D ``(batch, db)`` grid, else 1."""
        return self.shape.get(BATCH_AXIS, 1) if len(self.axis_names) > 1 else 1

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, world={self.world})"


def make_mesh(n_devices: int | None = None, axis: str = DB_AXIS, *,
              device="cuda", group=None) -> Mesh:
    """1-D grid of ``n_devices`` logical shards (default: one per rank of
    ``group``, one without a group) on ``device``."""
    if n_devices is None:
        n_devices = dist.get_world_size(group) if group is not None else 1
    return Mesh({axis: n_devices}, device, group)


def make_mesh2d(n_batch: int, n_db: int, *, device="cuda", group=None) -> Mesh:
    """2-D ``(batch, db)`` grid: query batches split into ``n_batch``
    blocks (no collective), database rows into ``n_db`` shards (the top-k
    merge gathers along this axis only). ``ValueError`` when ``n_db`` is
    no positive multiple of the world size."""
    return Mesh({BATCH_AXIS: n_batch, DB_AXIS: n_db}, device, group)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = DB_AXIS) -> torch.Tensor:
    """``x [rows, ...]`` split into the axis's blocks (rows must divide
    evenly; callers pad), on the mesh's card: the database axis gives this
    rank's shards ``[P / W, rows / P, ...]``, the batch axis every block
    ``[n_batch, rows / n_batch, ...]``."""
    s = mesh.shape[axis]
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} rows do not split into {s} shards")
    blocks = x.reshape((s, x.shape[0] // s) + tuple(x.shape[1:]))
    if axis == mesh.axis_names[-1]:
        lo = mesh.rank * mesh.n_local
        blocks = blocks[lo : lo + mesh.n_local]
    return blocks.to(mesh.device).contiguous()


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` whole on the mesh's card (every rank holds its own copy)."""
    return x.to(mesh.device)


def gather_shards(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """This rank's per-shard stack ``[P / W, ...]`` → every shard's ``[P,
    ...]`` in global shard order, on every rank."""
    if mesh.world == 1:
        return local
    local = local.contiguous()
    out = local.new_empty((mesh.world * local.shape[0],) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=mesh.group)
    return out


def ring_shift(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """One hop of the shard ring (the JAX ``ppermute`` i → i + 1): shard
    s's state moves to shard s + 1 mod P. Within a rank a roll of the
    stack; the rank's last shard goes to the next rank's first."""
    out = torch.roll(local, 1, dims=0)
    if mesh.world == 1:
        return out
    ranks = dist.get_process_group_ranks(mesh.group)
    recv = torch.empty_like(local[-1])
    ops = [
        dist.P2POp(dist.isend, local[-1].contiguous(), ranks[(mesh.rank + 1) % mesh.world],
                   group=mesh.group),
        dist.P2POp(dist.irecv, recv, ranks[(mesh.rank - 1) % mesh.world], group=mesh.group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out[0] = recv
    return out
