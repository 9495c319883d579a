"""``parallel/`` across ``torch.distributed`` ranks: two ``gloo`` processes
on the CPU, P = 4 logical shards (two a rank), give the results of one
process holding all four. ``sharded_topk``, ``ShardedIvfIndex`` (its
centroids bit for bit: the Lloyd partials are gathered and added in shard
order, never all-reduced), ``ShardedIvfPqIndex`` (its training sample and
int8 scales gathered across ranks), ``train_centroids_sharded`` and both
rings of ``ShardedGraphIndex.generate_knn``.

The ranks are spawned processes with a join timeout of their own, so a hang
fails the test. This module imports no JAX: the ranks import it. The
``cuda`` test runs the same calls over NCCL, one rank a card, where a
machine has two cards or more (``python -m pytest --noconftest
tests/test_torch_parallel_ranks.py``); it skips here."""

import multiprocessing as mp

import pytest
import torch
import torch.distributed as dist

from annsearch_tpu_torch.parallel import (
    ShardedGraphIndex,
    ShardedIvfIndex,
    ShardedIvfPqIndex,
    make_mesh,
    ring_self_knn,
    sharded_topk,
    train_centroids_sharded,
)
from annsearch_tpu_torch.parallel.mesh import replicate, shard_rows
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

N, D, P, JOIN_S = 598, 32, 4, 120


def _run(mesh) -> dict[str, torch.Tensor]:
    """The calls both runs make, their results by name (whole, on every
    rank, on the host)."""
    x, _ = generate_clustered_data(N, D, 6, seed=1)
    q = torch.as_tensor(subsample_with_noise(x, 40, seed=1))
    xp = torch.cat([torch.as_tensor(x), torch.zeros((-N % mesh.n_shards, D))])
    xs = shard_rows(xp, mesh)
    out = {}
    out["topk_d"], out["topk_i"] = sharded_topk(replicate(q, mesh), xs, 7, Dist.EUCLIDEAN, N, mesh,
                                                db_chunk=64)
    out["centroids"] = train_centroids_sharded(xs, torch.as_tensor(x[::60][:8]), N, mesh, iters=6)
    out["ring_i"], out["ring_d"] = ring_self_knn(xs, 6, Dist.EUCLIDEAN, N, mesh)
    ivf = ShardedIvfIndex(x, nlist=8, seed=2, mesh=mesh)
    out["ivf_centroids"] = ivf.centroids
    out["ivf_i"], out["ivf_d"] = ivf.query(q, 5, nprobe=3)
    pq = ShardedIvfPqIndex(x, nlist=8, seed=2, mesh=mesh)
    out["pq_scales"] = pq.dec_scales
    out["pq_i"], out["pq_d"] = pq.query(q, 5, nprobe=3)
    g = ShardedGraphIndex(x, k=6, mesh=mesh)
    out["graph_i"], out["graph_d"] = g.generate_knn(5)
    out["beam_i"], out["beam_d"] = g.generate_knn(5, flop_budget=0)
    out["query_i"], out["query_d"] = g.query(q, 5)
    return {name: t.cpu() for name, t in out.items()}


def _rank(rank: int, world: int, backend: str, p: int, init_file: str, out_file: str) -> None:
    """One rank: its process group (NCCL: on card ``rank``), the calls at
    ``p`` shards, its results saved to ``out_file``."""
    torch.set_num_threads(1)
    device = "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        torch.save(_run(make_mesh(p, device=device, group=dist.group.WORLD)), out_file)
    finally:
        dist.destroy_process_group()


def _ranks_equal_one(tmp_path, world: int, backend: str, p: int, device: str) -> None:
    """``world`` spawned ranks at ``p`` shards give, on every rank, what one
    process gives at ``p`` shards on ``device``, bit for bit."""
    ctx = mp.get_context("spawn")
    outs = [tmp_path / f"rank{r}.pt" for r in range(world)]
    procs = [ctx.Process(target=_rank,
                         args=(r, world, backend, p, str(tmp_path / "init"), str(outs[r])))
             for r in range(world)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(JOIN_S)
    hung = [proc.is_alive() for proc in procs]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert not any(hung), "a rank did not finish within its timeout"
    assert [proc.exitcode for proc in procs] == [0] * world

    one = _run(make_mesh(p, device=device))
    assert one["ring_i"].shape[0] == N + (-N % p) and (one["ivf_i"] < N).all()
    for out in outs:
        got = torch.load(out, weights_only=True)
        assert got.keys() == one.keys()
        for name, want in one.items():
            assert torch.equal(got[name], want), name


def test_two_gloo_ranks_equal_one_process(tmp_path):
    _ranks_equal_one(tmp_path, 2, "gloo", P, "cpu")


@pytest.mark.cuda
def test_nccl_ranks_on_every_card_equal_one_card(tmp_path):
    """One NCCL rank a card, two shards a rank, against one process on the
    first card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more: NCCL across cards")
    world = torch.cuda.device_count()
    _ranks_equal_one(tmp_path, world, "nccl", 2 * world, "cuda:0")


def test_a_grid_must_lay_over_the_world(monkeypatch):
    """P must be a positive multiple of the world size W; each rank then
    holds P / W consecutive shards (a world of three, its rank 1, stood in
    for by the process-group queries)."""
    from annsearch_tpu_torch.parallel import make_mesh2d
    from annsearch_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda group: 3)
    monkeypatch.setattr(tmesh.dist, "get_rank", lambda group: 1)
    group = object()
    with pytest.raises(ValueError):
        make_mesh(4, device="cpu", group=group)
    with pytest.raises(ValueError):
        make_mesh2d(2, 4, device="cpu", group=group)
    grid = make_mesh2d(2, 6, device="cpu", group=group)
    assert grid.n_local == 2 and list(grid.db_shards()) == [2, 3]
    assert make_mesh(device="cpu", group=group).n_shards == 3     # P = W by default
    x = torch.arange(12.0)[:, None]
    assert torch.equal(shard_rows(x, grid)[:, :, 0], torch.tensor([[4.0, 5.0], [6.0, 7.0]]))


def test_one_rank_makes_no_distributed_call(monkeypatch):
    """W = 1: every collective is local; ``torch.distributed`` is never
    called (each of its entry points used here raises if it is)."""
    from annsearch_tpu_torch.parallel import mesh as tmesh

    def refuse(*a, **kw):
        raise AssertionError("torch.distributed called at W = 1")

    for name in ("get_world_size", "get_rank", "all_gather_into_tensor", "batch_isend_irecv",
                 "get_process_group_ranks", "P2POp"):
        monkeypatch.setattr(tmesh.dist, name, refuse)
    out = _run(make_mesh(P, device="cpu"))
    assert out["query_i"].shape == (40, 5)
