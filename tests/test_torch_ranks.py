"""The rank mesh (pg2024_dprt_tpu_torch/parallel/mesh.py RankMesh, one
partition a rank of torch.distributed) against the in-process mesh, on gloo
worlds of 2-4 CPU processes spawned by parallel/spawn.py run_ranks (the
ranks' code is tests/torch_rank_workers.py).

The in-process mesh is held against JAX's shard_map programs in
tests/test_torch_partition.py, so equality with it here is parity with
JAX. Everything compared is exact: the collectives move and sum integers
and floats without rounding differences at these sizes (psum of floats:
one addition order per element, rtol 1e-6), the exchanged rows and their
counts, the ring's flags, diag and grid-culled counts, and the CLI's
proxy nets, which each rank trains for its own partition and every rank
gathers (bit for bit, with one torch thread on both sides).
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


@pytest.fixture(scope="module")
def net_world(tmp_path_factory):
    """A 2-rank world's gathered nets (torch_rank_workers.trained_nets)."""
    return run_ranks(w.trained_nets, 2, (), str(tmp_path_factory.mktemp("nets")),
                     deadline_s=DEADLINE_S)


def _one_thread(fn):
    """fn() with one torch thread, as each rank runs (fit's sums are
    bit-equal only then)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def in_process_nets():
    """The same training on the in-process mesh of 2 partitions."""
    return _one_thread(lambda: {name: w.spec_nets(spec, make_mesh(2, device="cpu"))
                                for name, spec in w.NET_SPECS.items()})


def plain_recipe(spec: str):
    """The CLI's offline stage written out with no mesh and no exchange:
    rooms, each partition's vis and depth nets trained in turn (seed
    100 + p, balance_vis / depth_only and its < 256 rows rule, fit) and
    stacked in partition order; instanced, the base pair from
    train_proxy_for_partition. Returns the params (numpy) and the loss lines
    the CLI prints for them."""
    from pg2024_dprt_tpu_torch import train
    from pg2024_dprt_tpu_torch.models import MLPConfig, stack_params
    from pg2024_dprt_tpu_torch.render import __main__ as cli
    from pg2024_dprt_tpu_torch.scene import (build_partitioned_scene, device_scene_from_meshes,
                                             partition_meshes)
    from pg2024_dprt_tpu_torch.scene.partition import _meshes_aabb

    cfg = MLPConfig(width=64, depth=2)

    def tcfg(nn_type):
        return train.TrainConfig(nn_type=nn_type, epochs=w.NET_EPOCHS, batch=4096,
                                 learn_rate=5e-3)

    meshes = cli.load_scene(spec, device="cpu")[0]
    if isinstance(meshes, tuple):
        base = meshes[0]
        lo, hi = _meshes_aabb(base)
        scene = device_scene_from_meshes(base, device="cpu")
        (vp, hv), (dp, hd) = (train.train_proxy_for_partition(
            scene, lo, hi, k, mlp_cfg=cfg, train_cfg=tcfg(k), num_samples=w.NET_SAMPLES)
            for k in ("vis", "depth"))
        nets, lines = [(vp, dp)], [f"base-object nets: vis {hv['test_loss'][-1]:.4f} "
                                   f"depth {hd['test_loss'][-1]:.4f}"]
    else:
        part = build_partitioned_scene(meshes, 2, device="cpu")
        nets, lines = [], []
        for p, idxs in enumerate(partition_meshes(meshes, 2)):
            sub = device_scene_from_meshes([meshes[i] for i in idxs], device="cpu")
            feats, d = train.generate_proxy_dataset(
                sub, part.proxies.aabb_min[p].numpy(), part.proxies.aabb_max[p].numpy(),
                w.NET_SAMPLES, seed=100 + p)
            vp, hv = train.fit(*train.balance_vis(feats, d), cfg, tcfg("vis"), device="cpu")
            xd, yd = train.depth_only(feats, d)
            if xd.shape[0] < 256:
                xd, yd = feats, d
            dp, hd = train.fit(xd, yd, cfg, tcfg("depth"), device="cpu")
            nets.append((vp, dp))
            lines += [f"partition {p}: vis loss {hv['test_loss'][-1]:.4f}",
                      f"partition {p}: depth loss {hd['test_loss'][-1]:.4f}"]
    return {kind: {k: v.numpy() for k, v in stack_params([n[i] for n in nets]).items()}
            for i, kind in enumerate(("vis", "depth"))} | {"lines": lines}


def assert_same_nets(got, want, what):
    for kind in ("vis", "depth"):
        assert sorted(got[kind]) == sorted(want[kind]), what
        for k, v in want[kind].items():
            assert got[kind][k].dtype == v.dtype == np.float32
            np.testing.assert_array_equal(got[kind][k].view(np.uint32), v.view(np.uint32),
                                          err_msg=f"{what} {kind} {k}")


def loss_lines(out: str):
    return [line for line in out.splitlines() if "loss" in line or "base-object" in line]


@pytest.mark.parametrize("name", list(w.NET_SPECS))
def test_in_process_training_is_the_plain_recipe(in_process_nets, name):
    """The in-process mesh's training (train_partition_proxies /
    _train_base_object through the exchange) gives, bit for bit, the nets
    of the recipe called directly for each partition, each at its own
    partition, and prints each partition's own losses."""
    want = _one_thread(lambda: plain_recipe(w.NET_SPECS[name]))
    got = in_process_nets[name]
    assert_same_nets(got, want, "in-process mesh")
    assert loss_lines(got["stdout"]) == want["lines"]


@pytest.mark.parametrize("name", list(w.NET_SPECS))
def test_rank_training_gathers_the_in_process_nets(net_world, in_process_nets, name):
    """Every rank holds every partition's nets (rooms:2), or the one base
    pair (instanced), bit for bit those the in-process mesh trains."""
    want = in_process_nets[name]
    assert want["num_objects"] == (2 if name == "rooms" else 1)
    for r, res in enumerate(net_world):
        got = res[name]
        assert got["num_objects"] == want["num_objects"]
        assert_same_nets(got, want, f"rank {r}")
    # rank 0 prints every partition's losses, the other rank nothing
    assert loss_lines(net_world[0][name]["stdout"]) == loss_lines(want["stdout"])
    assert not loss_lines(net_world[1][name]["stdout"])


@pytest.mark.parametrize("name", list(w.NET_SPECS))
def test_each_rank_trains_only_its_own_partition(net_world, in_process_nets, name):
    """A rank casts rays for and fits only the nets of the partitions it
    holds (rooms: partition r, seed 100 + r; instanced: the base pair on
    rank 0); together the ranks run the in-process mesh's calls."""
    calls = [res[name]["calls"] for res in net_world]
    if name == "rooms":
        assert calls == [[("datagen", 100 + r), ("fit", "vis"), ("fit", "depth")]
                         for r in range(2)]
    else:
        assert calls == [[("datagen", 0), ("fit", "vis"), ("datagen", 0), ("fit", "depth")], []]
    assert sum(calls, []) == in_process_nets[name]["calls"]


@pytest.mark.parametrize("kind", ["raises", "hangs"])
def test_run_ranks_fails_a_world_whose_rank_fails(tmp_path, kind):
    """A rank that raises fails the world at once: within the other ranks'
    grace (parallel/spawn.py FAILURE_GRACE_S) and 3 s of its raise, timed
    from the raise so that the ranks' start (an interpreter and torch each,
    slow on a loaded host) does not count; one that hangs fails it at the
    deadline; every rank is gone afterwards."""
    import multiprocessing
    import re
    import time

    from pg2024_dprt_tpu_torch.parallel.spawn import FAILURE_GRACE_S

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose" if kind == "raises"
                       else "still running at the deadline") as err:
        run_ranks(w.fails, 2, (kind,), str(tmp_path),
                  deadline_s=DEADLINE_S if kind == "raises" else 8)
    failed_at = time.time()
    assert time.monotonic() - t0 < 30
    if kind == "raises":
        raised_at = float(re.search(r"fails on purpose at ([0-9.]+)", str(err.value)).group(1))
        assert 0 <= failed_at - raised_at < FAILURE_GRACE_S + 3
    assert not multiprocessing.active_children()
