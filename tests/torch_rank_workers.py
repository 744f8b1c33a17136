"""What each rank runs in the rank-mesh tests (tests/test_torch_ranks.py,
tests/test_torch_distributed.py): functions that spawned ranks import by
module path (pg2024_dprt_tpu_torch/parallel/spawn.py run_ranks). Each makes
its RankMesh on the CPU over gloo, runs the port's code on its own
partition and returns numpy arrays and Python values to the parent, which
holds them against the in-process mesh. No JAX here: the ranks import only
the port.
"""
import pickle

import numpy as np
import torch

from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core.types import PathState
from pg2024_dprt_tpu_torch.parallel import (exchange_paths, make_rank_mesh,
                                            render_image_distributed, ring_shadow_occlusion)

DTYPES = {"f32": torch.float32, "i32": torch.int32, "i64": torch.int64, "bool": torch.bool}


def collective_inputs(p: int, name: str, seed: int = 3):
    """Every partition's seeded blocks: (P, P, 5, 2) for all_to_all and
    (P, 3, 4) for psum, of dtype `name`."""
    rng = np.random.RandomState(seed + p)
    a = rng.randint(-50, 50, (p, p, 5, 2))
    s = rng.randint(-50, 50, (p, 3, 4))
    if name == "f32":
        a, s = a + rng.rand(*a.shape), s + rng.rand(*s.shape)
    elif name == "bool":
        a, s = a > 0, s > 0
    dt = DTYPES[name]
    return torch.as_tensor(a).to(dt), torch.as_tensor(s).to(dt)


def path_buffers(p: int, n: int, seed: int, fill: float, targets: int):
    """Per-partition path buffers as numpy dicts: a share `fill` of valid
    rows with targets in [-1, targets), every other field a payload."""
    rng = np.random.RandomState(seed)
    out = []
    for part in range(p):
        idx = np.arange(n)
        valid = rng.rand(n) < fill
        out.append(dict(
            origin=rng.rand(n, 3).astype(np.float32),
            direction=rng.randn(n, 3).astype(np.float32),
            tmax=rng.rand(n).astype(np.float32),
            throughput=rng.rand(n, 3).astype(np.float32),
            pixel_index=(part * 1000 + idx).astype(np.int64),
            shadow_path_id=rng.randint(-1, 4, n).astype(np.int64),
            is_shadow=rng.rand(n) > 0.8, is_delta=rng.rand(n) > 0.8,
            is_valid=valid, is_hit=rng.rand(n) > 0.5,
            current_node=rng.randint(-1, p, n).astype(np.int64),
            target_node=np.where(valid, rng.randint(-1, targets, n), -1).astype(np.int64),
            visited_mask=rng.randint(0, 2 ** p, n).astype(np.int64),
            hit_tri=rng.randint(-1, 50, n).astype(np.int32),
            hit_u=rng.rand(n).astype(np.float32), hit_v=rng.rand(n).astype(np.float32)))
    return out


def as_paths(b) -> PathState:
    return PathState(**{k: torch.as_tensor(v) for k, v in b.items()})


def as_numpy(paths: PathState) -> dict:
    return {k: v.numpy() for k, v in paths._asdict().items()}


def shadow_buffers(p: int, n: int, seed: int):
    """Shadow rays across the rooms of rooms_scene(p) (numpy dicts)."""
    rng = np.random.RandomState(seed)
    bufs = []
    for part in range(p):
        o = np.stack([rng.rand(n) * 2.5 * p - 0.5, rng.rand(n) * 1.4 - 0.2,
                      rng.rand(n) * 1.4 - 0.2], 1).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
        d[:, 0] *= 3.0
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        bufs.append(dict(origin=o, direction=d,
                         tmax=(rng.rand(n) * 4.0 + 0.2).astype(np.float32),
                         is_valid=rng.rand(n) > 0.15,
                         pixel_index=(part * 1000 + np.arange(n)).astype(np.int64)))
    return bufs


def as_shadow_paths(b) -> PathState:
    n = b["origin"].shape[0]
    return PathState.empty(n, device="cpu")._replace(
        origin=torch.as_tensor(b["origin"]), direction=torch.as_tensor(b["direction"]),
        tmax=torch.as_tensor(b["tmax"]), is_valid=torch.as_tensor(b["is_valid"]),
        is_shadow=torch.ones(n, dtype=torch.bool), pixel_index=torch.as_tensor(b["pixel_index"]))


def rooms_partitions(p: int, grids: bool):
    meshes, _ = tscene.two_room_scene(num_rooms=p, tris_per_room=600, seed=2, device="cpu")
    return tscene.build_partitioned_scene(meshes, p, visibility_grids=grids, grid_res=(8, 8, 8),
                                          device="cpu")


def mesh_world(exchanges, rings):
    """One gloo world's checks: the collectives on every dtype, the
    exchange rounds `exchanges` ({name: (n, bucket, seed, fill)}), the ring
    (`rings`: a list of grid flags) and the refusals. Returns a dict of
    numpy results for this rank."""
    mesh = make_rank_mesh(device="cpu")
    p, r = mesh.size, mesh.rank
    out = {"rank": r, "local": mesh.local, "backend": mesh.backend}
    for name in DTYPES:
        a, s = collective_inputs(p, name)
        out[f"all_to_all {name}"] = mesh.all_to_all(a[r:r + 1]).numpy()
        out[f"psum {name}"] = mesh.psum(s[r:r + 1]).numpy()
    for name, (n, bucket, seed, fill) in exchanges.items():
        bufs = path_buffers(p, n, seed, fill, p)
        merged, moved, waiting, arrivals = exchange_paths(mesh, [as_paths(bufs[r])],
                                                          bucket_size=bucket)
        out[f"exchange {name}"] = (as_numpy(merged[0]),
                                   np.stack([moved, waiting, arrivals], 1))
    for grids in rings:
        part = rooms_partitions(p, grids)
        sp = as_shadow_paths(shadow_buffers(p, 384, 5 + grids)[r])
        _, occ, diag, culled = ring_shadow_occlusion(
            mesh, part.scenes, [sp], 1e-3, proxies=part.proxies if grids else None)
        out[f"ring {grids}"] = (occ[0].numpy(), int(diag), int(culled))
    try:
        make_rank_mesh(p + 1, device="cpu")
        out["refuses a world size"] = None
    except ValueError as e:
        out["refuses a world size"] = str(e)
    return out


def rank_frame(blob: bytes):
    """A RankMesh frame of the pickled (partitioned scene, models, lights,
    env, camera, config); returns (image, stats)."""
    part, models, lights, env, cam, cfg = pickle.loads(blob)
    mesh = make_rank_mesh(part.num_partitions, device="cpu")
    img, stats = render_image_distributed(part, models, lights, env, cam, cfg, mesh=mesh,
                                          return_stats=True)
    return img.numpy(), stats


# the CLI's offline stage on small scenes: each partition's nets (rooms:2)
# and the instanced scene's one base pair
NET_SPECS = {"rooms": "rooms:2", "instanced": "instanced:2,512"}
NET_SAMPLES, NET_EPOCHS = 2000, 2


def spec_nets(spec: str, mesh):
    """The CLI's offline stage (render/__main__.py) for SCENE `spec` on
    `mesh`, on the CPU: each partition's pair (rooms) or the base pair
    (instanced). Returns the gathered params (numpy), the datagen seeds
    and fits this process ran, in order, and what it printed."""
    import contextlib
    import io

    from pg2024_dprt_tpu_torch import train
    from pg2024_dprt_tpu_torch.render import __main__ as cli

    calls = []
    fit, gen = train.loop.fit, train.loop.generate_proxy_dataset

    def counted_fit(*a, **k):
        calls.append(("fit", (a[3] if len(a) > 3 else k["cfg"]).nn_type))
        return fit(*a, **k)

    def counted_gen(*a, **k):
        calls.append(("datagen", a[4] if len(a) > 4 else k.get("seed", 0)))
        return gen(*a, **k)

    sites = [(m, name) for m in (train, train.loop) for name in ("fit", "generate_proxy_dataset")]
    saved = [getattr(m, name) for m, name in sites]
    for (m, name), fn in zip(sites, (counted_fit, counted_gen) * 2):
        setattr(m, name, fn)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            meshes = cli.load_scene(spec, device="cpu")[0]
            if isinstance(meshes, tuple):
                models = cli._train_base_object(meshes[0], mesh, NET_SAMPLES, NET_EPOCHS)
            else:
                part = tscene.build_partitioned_scene(meshes, mesh.size, device="cpu")
                models = cli.train_partition_proxies(meshes, part, mesh, NET_SAMPLES, NET_EPOCHS)
    finally:
        for (m, name), fn in zip(sites, saved):
            setattr(m, name, fn)
    return {"vis": {k: v.numpy() for k, v in models.vis_params.items()},
            "depth": {k: v.numpy() for k, v in models.depth_params.items()},
            "num_objects": models.num_objects, "calls": calls, "stdout": buf.getvalue()}


def trained_nets():
    """Every NET_SPECS case's spec_nets on this rank's mesh."""
    mesh = make_rank_mesh(device="cpu")
    return {name: spec_nets(spec, mesh) for name, spec in NET_SPECS.items()}


def fails(kind: str):
    """Rank 1 raises (its message holds the wall-clock time of the raise) or
    hangs; rank 0 waits for it in a collective."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        if kind == "raises":
            raise RuntimeError(f"rank 1 fails on purpose at {time.time()!r}")
        time.sleep(3600)
    dist.barrier()
    return "done"
