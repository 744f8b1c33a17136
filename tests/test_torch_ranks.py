"""The rank mesh (pg2024_dprt_tpu_torch/parallel/mesh.py RankMesh, one
partition a rank of torch.distributed) against the in-process mesh, on gloo
worlds of 2-4 CPU processes spawned by parallel/spawn.py run_ranks (the
ranks' code is tests/torch_rank_workers.py).

The in-process mesh is held against JAX's shard_map programs in
tests/test_torch_partition.py, so equality with it here is parity with
JAX. Everything compared is exact: the collectives move and sum integers
and floats without rounding differences at these sizes (psum of floats:
one addition order per element, rtol 1e-6), the exchanged rows and their
counts, the ring's flags, diag and grid-culled counts.
"""
import numpy as np
import pytest
import torch

import torch_rank_workers as w
from pg2024_dprt_tpu_torch.parallel import (exchange_paths, make_mesh, make_rank_mesh,
                                            ring_shadow_occlusion, run_ranks)

DEADLINE_S = 120
# exchange rounds: (rows, bucket, seed, share of valid rows); every bucket is
# small enough that rows wait
EXCHANGES = {
    2: {"overflow": (32, 4, 7, 0.9)},
    3: {"random_small_bucket": (40, 5, 8, 0.8)},
    4: {"random": (96, 6, 9, 0.7)},
}
RINGS = {2: [], 3: [], 4: [False, True]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results, one spawn per world size."""
    return {p: run_ranks(w.mesh_world, p, (EXCHANGES[p], RINGS[p]),
                         str(tmp_path_factory.mktemp(f"world{p}")), deadline_s=DEADLINE_S)
            for p in (2, 3, 4)}


@pytest.mark.parametrize("dtype", list(w.DTYPES))
@pytest.mark.parametrize("p", [2, 3, 4])
def test_rank_collectives_equal_in_process(worlds, p, dtype):
    a, s = w.collective_inputs(p, dtype)
    mesh = make_mesh(p, device="cpu")
    want_a = mesh.all_to_all(a).numpy()
    want_s = mesh.psum(s).numpy()
    for r, res in enumerate(worlds[p]):
        assert res["local"] == (r,) and res["backend"] == "gloo"
        got = res[f"all_to_all {dtype}"]
        assert got.dtype == want_a.dtype and got.shape == (1,) + want_a.shape[1:]
        np.testing.assert_array_equal(got[0], want_a[r])
        np.testing.assert_allclose(res[f"psum {dtype}"], want_s, rtol=1e-6)


@pytest.mark.parametrize("p", [2, 3, 4])
def test_rank_exchange_round_equals_in_process(worlds, p):
    (name, (n, bucket, seed, fill)), = EXCHANGES[p].items()
    bufs = w.path_buffers(p, n, seed, fill, p)
    merged, moved, waiting, arrivals = exchange_paths(
        make_mesh(p, device="cpu"), [w.as_paths(b) for b in bufs], bucket_size=bucket)
    counts = torch.stack([moved, waiting, arrivals], 1).numpy()
    assert counts[:, 1].sum() > 0          # rows waited
    for r, res in enumerate(worlds[p]):
        rows, got_counts = res[f"exchange {name}"]
        np.testing.assert_array_equal(got_counts[0], counts[r])
        for f, v in w.as_numpy(merged[r]).items():
            assert rows[f].dtype == v.dtype, f
            np.testing.assert_array_equal(rows[f], v, err_msg=f"{name} rank {r} {f}")


@pytest.mark.parametrize("grids", [False, True])
def test_rank_ring_equals_in_process(worlds, grids):
    p = 4
    part = w.rooms_partitions(p, grids)
    bufs = w.shadow_buffers(p, 384, 5 + grids)
    _, occ, diag, culled = ring_shadow_occlusion(
        make_mesh(p, device="cpu"), part.scenes, [w.as_shadow_paths(b) for b in bufs], 1e-3,
        proxies=part.proxies if grids else None)
    got = [res[f"ring {grids}"] for res in worlds[p]]
    for r in range(p):
        np.testing.assert_array_equal(got[r][0], occ[r].numpy(), err_msg=f"rank {r}")
    assert sum(g[1] for g in got) == int(diag)
    assert sum(g[2] for g in got) == int(culled)
    assert (int(culled) > 100) == grids
    total = sum(int(o.sum()) for o in occ)
    assert 50 < total < sum(int(b["is_valid"].sum()) for b in bufs) - 50


def test_rank_mesh_refuses_what_it_cannot_run(worlds, monkeypatch):
    """A world size that is not the partition count raises in the rank; NCCL
    raises where this PyTorch has none and for a CPU device: neither falls
    back to another backend."""
    for res in worlds[2]:
        assert "3 partitions on a world of 2 ranks" in res["refuses a world size"]
    import torch.distributed as dist

    if not dist.is_nccl_available():
        with pytest.raises(RuntimeError, match="no NCCL"):
            make_rank_mesh(device="cpu", backend="nccl")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    with pytest.raises(ValueError, match="NCCL moves CUDA tensors only"):
        make_rank_mesh(device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_rank_mesh()


@pytest.mark.parametrize("kind", ["raises", "hangs"])
def test_run_ranks_fails_a_world_whose_rank_fails(tmp_path, kind):
    """A rank that raises fails the world at once; one that hangs fails it
    at the deadline; every rank is gone afterwards."""
    import multiprocessing
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose" if kind == "raises"
                       else "still running at the deadline"):
        run_ranks(w.fails, 2, (kind,), str(tmp_path), deadline_s=8)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()
