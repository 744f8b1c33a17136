"""The port's partitioner, compaction, path exchange, ring shadows and
visibility grids (pg2024_dprt_tpu_torch/scene/partition.py,
ops/compaction.py, parallel/exchange.py, scene/visibility_grid.py) against
the JAX package, on the same numpy inputs. JAX runs its per-device programs
under shard_map on the virtual 8-device CPU mesh of tests/conftest.py; the
port runs all partitions in one process on the CPU.

Tolerances: integers (ids, nodes, counts, grids, exchanged rows, occlusion
flags) are exact; scene tables are exact (both packages build them with the
same numpy code); images of the instanced distributed frame within rtol 1e-3
/ atol 1e-4, the frame tolerance of tests/test_torch_render.py, with equal
stats.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.core.types import PathState as JPathState
from pg2024_dprt_tpu.models import random_proxy_models as j_random_models
from pg2024_dprt_tpu.ops import compaction as jcomp
from pg2024_dprt_tpu.parallel import NODES_AXIS, make_mesh as j_make_mesh
from pg2024_dprt_tpu.parallel import render_image_distributed as j_render_dist
from pg2024_dprt_tpu.parallel.exchange import exchange_paths as j_exchange
from pg2024_dprt_tpu.parallel.exchange import ring_shadow_occlusion as j_ring
from pg2024_dprt_tpu.render import RenderConfig as JConfig
from pg2024_dprt_tpu.scene import build_partitioned_scene as j_partition
from pg2024_dprt_tpu.scene import build_partitioned_scene_instanced as j_partition_inst
from pg2024_dprt_tpu.scene import cornell_box as j_cornell
from pg2024_dprt_tpu.scene import random_tri_soup as j_soup
from pg2024_dprt_tpu.scene import two_room_scene as j_rooms
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
from pg2024_dprt_tpu.scene.lights import LightTable as JLights
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera
from pg2024_dprt_tpu_torch.core.types import PathState
from pg2024_dprt_tpu_torch.ops import compaction as tcomp
from pg2024_dprt_tpu_torch.parallel import exchange_paths, make_mesh, ring_shadow_occlusion
from pg2024_dprt_tpu_torch.parallel import render_image_distributed
from pg2024_dprt_tpu_torch.render import RenderConfig

FIELDS = JPathState._fields
INT64 = ("pixel_index", "shadow_path_id", "visited_mask", "current_node", "target_node")


def _port_meshes(jmeshes):
    return [tscene.MeshGeometry(v0=m.v0, v1=m.v1, v2=m.v2, n0=m.n0, n1=m.n1, n2=m.n2,
                                uv0=m.uv0, uv1=m.uv1, uv2=m.uv2, base_color=m.base_color,
                                bsdf_type=m.bsdf_type, texture_index=m.texture_index,
                                name=m.name) for m in jmeshes]


# --------------------------------------------------------------------------
# compaction

@pytest.mark.parametrize("n,keys,seed", [(64, 4, 0), (257, 9, 1)])
def test_compaction_is_integer_exact(n, keys, seed):
    rng = np.random.RandomState(seed)
    key = rng.randint(-1, keys, n).astype(np.int32)
    valid = rng.rand(n) > 0.3
    perm, sk, sv = jcomp.compact_by_key(jnp.asarray(key), jnp.asarray(valid))
    tperm, tsk, tsv = tcomp.compact_by_key(torch.as_tensor(key), torch.as_tensor(valid))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(sk))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(sv))
    in_range = valid & (key >= 0)
    counts = jcomp.counts_per_key(jnp.asarray(key), jnp.asarray(in_range), keys)
    tcounts = tcomp.counts_per_key(torch.as_tensor(key), torch.as_tensor(in_range), keys)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(tcomp.segment_offsets(tcounts).numpy(),
                                  np.asarray(jcomp.segment_offsets(counts)))
    # a stack of partitions compacts row by row
    both = tcomp.compact_by_key(torch.as_tensor(np.stack([key, key[::-1]])),
                                torch.as_tensor(np.stack([valid, valid[::-1]])))
    np.testing.assert_array_equal(both[0][0].numpy(), np.asarray(perm))


# --------------------------------------------------------------------------
# exchange_paths

def _buffers(p, n, fill):
    """Per-partition numpy paths: `fill(rng, part, idx)` gives (valid,
    target) of each row; every other field is a random payload."""
    rng = np.random.RandomState(17 * p + n)
    out = []
    for part in range(p):
        idx = np.arange(n)
        valid, target = fill(rng, part, idx)
        out.append(dict(
            origin=rng.rand(n, 3).astype(np.float32),
            direction=rng.randn(n, 3).astype(np.float32),
            tmax=rng.rand(n).astype(np.float32),
            throughput=rng.rand(n, 3).astype(np.float32),
            pixel_index=(part * 1000 + idx).astype(np.int32),
            shadow_path_id=rng.randint(-1, 4, n).astype(np.int32),
            visited_mask=rng.randint(0, 2 ** p, n).astype(np.uint32),
            current_node=rng.randint(-1, p, n).astype(np.int32),
            target_node=np.where(valid, target, -1).astype(np.int32),
            is_shadow=rng.rand(n) > 0.8, is_delta=rng.rand(n) > 0.8,
            is_valid=np.asarray(valid, bool), is_hit=rng.rand(n) > 0.5,
            hit_tri=rng.randint(-1, 50, n).astype(np.int32),
            hit_u=rng.rand(n).astype(np.float32), hit_v=rng.rand(n).astype(np.float32)))
    return out


def _jax_exchange(bufs, bucket):
    p = len(bufs)

    def prog(*leaves):
        my_id = jax.lax.axis_index(NODES_AXIS).astype(jnp.int32)
        merged, moved, waiting, arrivals = j_exchange(
            JPathState(*[a[0] for a in leaves]), my_id, bucket_size=bucket)
        return tuple(a[None] for a in merged), jnp.stack([moved, waiting, arrivals])[None]

    spec = JP(NODES_AXIS)
    fn = jax.jit(jax.shard_map(prog, mesh=j_make_mesh(p), in_specs=(spec,) * len(FIELDS),
                               out_specs=((spec,) * len(FIELDS), spec), check_vma=False))
    merged, counts = fn(*[jnp.asarray(np.stack([b[f] for b in bufs])) for f in FIELDS])
    return [np.asarray(a) for a in merged], np.asarray(counts)


def _port_paths(b):
    conv = {f: torch.as_tensor(b[f].astype(np.int64) if f in INT64 else b[f]) for f in FIELDS}
    return PathState(**conv)


EXCHANGES = {
    # every row addressed to the next partition arrives there
    "round_trip": (4, 64, 16, lambda rng, p, i: (i < 8, np.full(len(i), (p + 1) % 4))),
    # a full bucket: the rest stay valid and wait
    "overflow": (2, 32, 4, lambda rng, p, i: (i < 10, np.full(len(i), 1 - p))),
    # everything to a full partition 0: nothing ships, nothing is lost
    "concentration": (4, 16, 16, lambda rng, p, i: (i < 16, np.zeros(len(i)))),
    # ... and with free rows there: all of it ships in one round
    "concentration_drains": (4, 64, 16, lambda rng, p, i: (i < 16, np.zeros(len(i)))),
    # random fill and targets, the default bucket and a small one
    "random": (4, 96, 0, lambda rng, p, i: (rng.rand(len(i)) < 0.7,
                                            rng.randint(-1, 4, len(i)))),
    "random_small_bucket": (3, 40, 5, lambda rng, p, i: (rng.rand(len(i)) < 0.8,
                                                         rng.randint(-1, 3, len(i)))),
}


@pytest.mark.parametrize("case", list(EXCHANGES))
def test_exchange_paths_matches_jax_row_by_row(case):
    p, n, bucket, fill = EXCHANGES[case]
    bufs = _buffers(p, n, fill)
    want, want_counts = _jax_exchange(bufs, bucket)
    got, moved, waiting, arrivals = exchange_paths(
        make_mesh(p, device="cpu"), [_port_paths(b) for b in bufs], bucket_size=bucket)
    np.testing.assert_array_equal(torch.stack([moved, waiting, arrivals], 1).numpy(),
                                  want_counts)
    for part in range(p):
        for fi, f in enumerate(FIELDS):
            np.testing.assert_array_equal(
                getattr(got[part], f).numpy(), want[fi][part].astype(
                    np.int64 if f in INT64 else want[fi].dtype), err_msg=f"{case} {part} {f}")
    valid_before = sum(int(b["is_valid"].sum()) for b in bufs)
    assert sum(int(g.is_valid.sum()) for g in got) == valid_before   # nothing dropped
    if case == "overflow":
        assert moved.tolist() == [4, 4] and waiting.tolist() == [6, 6]
    if case == "concentration":
        assert moved.sum() == 0 and (waiting[1:] == 16).all()


# --------------------------------------------------------------------------
# partitions, grids and ring shadows

def _rooms(parts, tris=160, seed=2):
    jmeshes, _ = j_rooms(num_rooms=parts, tris_per_room=tris, seed=seed)
    return jmeshes


TABLES = ("cl_aabb_min", "cl_aabb_max", "cl_count", "cl_mt_table", "scene_aabb")


def _assert_partition_equal(port_scene, jstacked, p, inst_base_tris=None):
    """The port's (unpadded) partition p against row p of JAX's padded
    block: the port's rows equal JAX's first rows, JAX's remaining rows are
    padding."""
    row = lambda name: np.asarray(getattr(jstacked, name))[p]
    k = port_scene.cl_count.shape[0]
    c = port_scene.tris_per_cluster
    for name in TABLES:
        got = getattr(port_scene, name).numpy()
        want = row(name)
        if name == "cl_mt_table" and port_scene.instanced:
            np.testing.assert_array_equal(got, want[: got.shape[0]], err_msg=name)
            continue
        np.testing.assert_array_equal(got, want[: got.shape[0]], err_msg=name)
    assert (row("cl_count")[k:] == 0).all()
    np.testing.assert_array_equal(port_scene.cl_boxes.numpy(), row("cl_boxes")[:, :k])
    np.testing.assert_array_equal(port_scene.cl_tri_map.numpy(), row("cl_tri_map")[: k * c])
    kg = port_scene.cl_gboxes.shape[1]
    np.testing.assert_array_equal(port_scene.cl_gboxes.numpy(), row("cl_gboxes")[:, :kg])
    np.testing.assert_array_equal(port_scene.cl_mboxes.numpy(), row("cl_mboxes")[:kg])
    t = port_scene.tri_shade.shape[0] if port_scene.instanced else int(
        port_scene.tri_valid.sum())
    np.testing.assert_array_equal(port_scene.tri_shade.numpy()[:t], row("tri_shade")[:t])
    if port_scene.instanced:
        ni = port_scene.cl_xf.shape[0]
        np.testing.assert_array_equal(port_scene.cl_xf.numpy(), row("cl_xf")[:ni])


def _assert_table_equal(got, want):
    for name in ("aabb_min", "aabb_max", "max_length", "obj_id", "node_id", "world_to_obj",
                 "obj_min", "obj_span", "vis_grid"):
        w = getattr(want, name)
        g = getattr(got, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("kind,parts,grids", [("rooms", 4, True), ("rooms", 3, False),
                                              ("cornell", 8, True)])
def test_build_partitioned_scene_matches_jax(kind, parts, grids):
    """Rooms, and the cornell box over 8 partitions (7 meshes: one partition
    is empty): every partition's tables, the proxy table and the grids."""
    jmeshes = _rooms(parts) if kind == "rooms" else j_cornell()[0]
    jp = j_partition(jmeshes, parts, visibility_grids=grids, grid_res=(8, 8, 8))
    tp = tscene.build_partitioned_scene(_port_meshes(jmeshes), parts, visibility_grids=grids,
                                        grid_res=(8, 8, 8), device="cpu")
    assert tp.num_partitions == parts and len(tp.scenes) == parts
    for p in range(parts):
        _assert_partition_equal(tp.scenes[p], jp.stacked, p)
    _assert_table_equal(tp.proxies, jp.proxies)
    if grids:
        assert tp.proxies.vis_grid.any() and not tp.proxies.vis_grid.all()
    if kind == "cornell":
        assert (tp.proxies.max_length == 0).sum() == 1     # the empty partition


def _instanced_setup(ni=6, tris=240, side=24):
    """tests/test_distributed_instanced.py's row of rotated, scaled instances
    of one soup under an area light."""
    base = j_soup(tris, seed=4)
    rng = np.random.RandomState(11)
    m = np.zeros((ni, 3, 4), np.float32)
    for i in range(ni):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        m[i, :, :3] = (q @ np.diag(0.6 + rng.rand(3) * 0.9)).astype(np.float32)
        m[i, :, 3] = [2.0 * i, 0.0, 0.0]
    lo0, hi0 = base.aabb()
    corners = np.stack([np.where(np.asarray(sel), hi0, lo0) for sel in np.ndindex(2, 2, 2)])
    wc = np.einsum("iab,cb->ica", m[:, :, :3], corners) + m[:, None, :, 3]
    lo, hi = wc.reshape(-1, 3).min(0), wc.reshape(-1, 3).max(0)
    cx, cz, y = 0.5 * (lo[0] + hi[0]), 0.5 * (lo[2] + hi[2]), hi[1] + 0.5
    quad = np.asarray(
        [[[cx - 1, y, cz - 1], [cx + 1, y, cz - 1], [cx + 1, y, cz + 1]],
         [[cx - 1, y, cz - 1], [cx + 1, y, cz + 1], [cx - 1, y, cz + 1]]], np.float32)
    center = 0.5 * (lo + hi)
    eye = center + np.asarray([0.0, 1.2, 1.6]) * max(hi[0] - lo[0], 2.0) * 0.6
    cam = (list(eye), list(center), [0, 1, 0], 55.0, side, side)
    return base, m, quad, cam


@pytest.mark.parametrize("parts,grids", [(2, True), (8, False)])
def test_build_partitioned_scene_instanced_matches_jax(parts, grids):
    """Instance partitions: tables (the port keeps one padding instance only
    where a partition owns none), partition boxes, grids and the
    instance-level nn_proxies."""
    base, m, _, _ = _instanced_setup()
    jp = j_partition_inst([base], m, parts, visibility_grids=grids, grid_res=(8, 8, 8))
    tp = tscene.build_partitioned_scene_instanced(
        _port_meshes([base]), m, parts, visibility_grids=grids, grid_res=(8, 8, 8),
        device="cpu")
    for p in range(parts):
        assert tp.scenes[p].instanced
        _assert_partition_equal(tp.scenes[p], jp.stacked, p)
    _assert_table_equal(tp.proxies, jp.proxies)
    _assert_table_equal(tp.nn_proxies, jp.nn_proxies)
    assert tscene.partition_instances(_port_meshes([base]), m, parts) == \
        [list(x) for x in __import__("pg2024_dprt_tpu.scene.partition", fromlist=["x"])
         .partition_instances([base], m, parts)]


def test_partitioned_scene_refuses_curves_and_raises_without_a_device():
    # curves are ported (tests/test_torch_curves.py holds the split against
    # JAX's): a strand over both rooms lands in both partitions
    meshes = _port_meshes(_rooms(2))
    strand = tscene.CurveSet.from_strand(
        [[0.2, 0.9, 0.5], [1.0, 1.4, 0.5], [2.2, 1.5, 0.4], [3.4, 1.2, 0.5]], 0.1,
        device="cpu")
    part = tscene.build_partitioned_scene(meshes, 2, curves=strand, device="cpu")
    pieces = [s.curves.num_pieces for s in part.scenes if s.curves is not None]
    assert len(pieces) == 2 and sum(pieces) == strand.num_pieces
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tscene.build_partitioned_scene(meshes, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            tscene.build_partitioned_scene_instanced(meshes, np.eye(3, 4)[None], 1)


def _shadow_buffers(parts, n, seed):
    rng = np.random.RandomState(seed)
    bufs = []
    for p in range(parts):
        o = np.stack([rng.rand(n) * 2.5 * parts - 0.5, rng.rand(n) * 1.4 - 0.2,
                      rng.rand(n) * 1.4 - 0.2], 1).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
        d[:, 0] *= 3.0
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        bufs.append(dict(origin=o, direction=d,
                         tmax=(rng.rand(n) * 4.0 + 0.2).astype(np.float32),
                         is_valid=rng.rand(n) > 0.15,
                         pixel_index=(p * 1000 + np.arange(n)).astype(np.int32)))
    return bufs


@pytest.mark.parametrize("grids", [False, True])
def test_ring_shadow_occlusion_matches_jax(grids):
    """The exact distributed shadow test: per ray the OR over partitions,
    the trace diag and the grid-culled count equal JAX's ring (whose buffer
    of device i ends on device i - 1)."""
    parts, n = 4, 384
    jmeshes = _rooms(parts, tris=600)
    jp = j_partition(jmeshes, parts, visibility_grids=grids, grid_res=(8, 8, 8))
    tp = tscene.build_partitioned_scene(_port_meshes(jmeshes), parts, visibility_grids=grids,
                                        grid_res=(8, 8, 8), device="cpu")
    bufs = _shadow_buffers(parts, n, 5 + grids)
    jproxies = jp.proxies if grids else None

    def prog(block, o, d, tmax, valid, pix):
        scene = jax.tree.map(lambda a: a[0], block)
        sp = JPathState.empty(n)._replace(origin=o[0], direction=d[0], tmax=tmax[0],
                                          is_valid=valid[0], pixel_index=pix[0],
                                          is_shadow=jnp.ones((n,), bool))
        sp2, occ, diag, culled = j_ring(scene, sp, 1e-3, proxies=jproxies)
        return sp2.pixel_index[None], occ[None], jnp.stack([diag, culled])[None]

    spec = JP(NODES_AXIS)
    fn = jax.jit(jax.shard_map(
        prog, mesh=j_make_mesh(parts),
        in_specs=(jax.tree.map(lambda _: spec, jp.stacked),) + (spec,) * 5,
        out_specs=(spec, spec, spec), check_vma=False))
    stack = lambda f: jnp.asarray(np.stack([b[f] for b in bufs]))
    jpix, jocc, jstats = (np.asarray(a) for a in fn(
        jp.stacked, stack("origin"), stack("direction"), stack("tmax"), stack("is_valid"),
        stack("pixel_index")))
    shadows = [PathState.empty(n, device="cpu")._replace(
        origin=torch.as_tensor(b["origin"]), direction=torch.as_tensor(b["direction"]),
        tmax=torch.as_tensor(b["tmax"]), is_valid=torch.as_tensor(b["is_valid"]),
        is_shadow=torch.ones(n, dtype=torch.bool),
        pixel_index=torch.as_tensor(b["pixel_index"]).long()) for b in bufs]
    _, occ, diag, culled = ring_shadow_occlusion(
        make_mesh(parts, device="cpu"), tp.scenes, shadows, 1e-3,
        proxies=tp.proxies if grids else None)
    for i in range(parts):
        src = (i + 1) % parts
        np.testing.assert_array_equal(jpix[i], bufs[src]["pixel_index"])
        np.testing.assert_array_equal(occ[src].numpy(), jocc[i], err_msg=str(i))
    assert int(diag) == int(jstats[:, 0].sum()) == 0
    assert int(culled) == int(jstats[:, 1].sum())
    total = sum(int(o.sum()) for o in occ)
    assert 50 < total < sum(int(b["is_valid"].sum()) for b in bufs) - 50
    assert (int(culled) > 100) == grids


# --------------------------------------------------------------------------
# the instanced distributed frame

@pytest.fixture(scope="module")
def instanced_frames():
    """JAX's instanced distributed frames (P = 2 and 4) and the inputs."""
    base, m, quad, cam = _instanced_setup()
    cfg = dict(width=24, height=24, spp=1, bounces=2)
    out = {}
    for parts in (2, 4):
        jp = j_partition_inst([base], m, parts)
        img, stats = j_render_dist(
            jp, j_random_models(jax.random.PRNGKey(0), parts),
            JLights.from_arrays(quad, np.full((2, 3), 14.0, np.float32)),
            JEnv.constant((0.25, 0.28, 0.35)), JCamera.look_at(*cam), JConfig(**cfg),
            j_make_mesh(parts), return_stats=True)
        out[parts] = (np.asarray(img), stats)
    return base, m, quad, cam, cfg, out


@pytest.mark.parametrize("parts", [2, 4])
def test_instanced_distributed_frame_matches_jax(instanced_frames, parts):
    base, m, quad, cam, cfg, out = instanced_frames
    want, want_stats = out[parts]
    tp = tscene.build_partitioned_scene_instanced(_port_meshes([base]), m, parts,
                                                  device="cpu")
    got, stats = render_image_distributed(
        tp, None, tscene.LightTable.from_arrays(quad, np.full((2, 3), 14.0, np.float32),
                                                device="cpu"),
        tscene.EnvironmentMap.constant((0.25, 0.28, 0.35), device="cpu"),
        Camera.look_at(*cam, device="cpu"), RenderConfig(**cfg), device="cpu",
        return_stats=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    for k, v in want_stats.items():
        assert stats[k] == v, k
    assert stats["paths_moved"] > 0 and stats["migration_truncated"] == 0
    assert float(got.mean()) > 0.0
