"""Geometry partitioner (counterpart of pg2024_dprt_tpu/scene/partition.py):
splits a scene into P partitions for the distributed frame
(parallel/distributed.py).

It returns a `PartitionedScene`:

  * `scenes`: one `DeviceScene` per partition (with the curve pieces it
    owns, when the scene has curves). JAX stacks them into one
    padded (P, ...) block for `shard_map`; the port runs every partition on
    one device and keeps a list of unpadded scenes (an empty partition is a
    scene with no triangles, or one instance whose clusters are all empty);
  * `proxies`: the global table of partition boxes that migrating rays
    route through (with a conservative visibility grid per partition when
    asked for, scene/visibility_grid.py);
  * `nn_proxies` (instance partitions only): one proxy row per instance for
    the neural stages, as in JAX.

Meshes (or instances) go to partitions by a recursive spatial median split
of their centres, so partitions stay spatially coherent. Each partition's
triangles keep their global mesh ids: shading reads the global material
table.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from .bvh import build_bvh
from .curves import CurveSet
from .geometry import (DeviceScene, MeshGeometry, ProxyTable, _instance_tables,
                       _pack_device_scene, concat_geometry)
from .textures import build_textures

# JAX packs every partition at this cluster width (_pack_device_scene's
# default); the tables match JAX's partition by partition
PARTITION_TRIS_PER_CLUSTER = 128


class PartitionedScene(NamedTuple):
    scenes: list               # P DeviceScenes
    proxies: ProxyTable        # P partition-level rows
    num_partitions: int
    # instance partitions only: one row per instance for the neural stages
    # (obj_id selects the net, node_id routes to the owning partition); the
    # migration loop routes through `proxies`
    nn_proxies: Optional[ProxyTable] = None


def _median_split(centroids: np.ndarray, num_partitions: int) -> List[List[int]]:
    """Recursive spatial median split of (N, 3) centroids into P index lists."""
    if num_partitions == 1:
        return [list(range(centroids.shape[0]))]

    def split(idx: np.ndarray, parts: int) -> List[List[int]]:
        if parts == 1:
            return [idx.tolist()]
        c = centroids[idx]
        axis = int(np.argmax(c.max(0) - c.min(0))) if len(idx) > 1 else 0
        order = idx[np.argsort(c[:, axis], kind="stable")]
        left_parts = parts // 2
        mid = int(round(len(order) * left_parts / parts))
        mid = min(max(mid, 0), len(order))
        return split(order[:mid], left_parts) + split(order[mid:], parts - left_parts)

    return split(np.arange(centroids.shape[0]), num_partitions)


def partition_meshes(meshes: Sequence[MeshGeometry], num_partitions: int) -> List[List[int]]:
    """Mesh indices of each of the P partitions, by the median split of the
    mesh box centres."""
    if num_partitions == 1:
        return [list(range(len(meshes)))]
    centroids = np.array([(m.aabb()[0] + m.aabb()[1]) * 0.5 for m in meshes])
    return _median_split(centroids, num_partitions)


def partition_instances(meshes: Sequence[MeshGeometry], transforms,
                        num_partitions: int) -> List[List[int]]:
    """Instance indices of each partition, by the median split of the
    transformed centre of the base meshes' box."""
    m = np.asarray(transforms, np.float64)
    if num_partitions == 1:
        return [list(range(m.shape[0]))]
    lo, hi = _meshes_aabb(meshes)
    center = ((lo + hi) * 0.5).astype(np.float64)
    centroids = np.einsum("iab,b->ia", m[:, :, :3], center) + m[:, :, 3]
    return _median_split(centroids, num_partitions)


def _meshes_aabb(meshes):
    los = np.array([m.aabb()[0] for m in meshes])
    his = np.array([m.aabb()[1] for m in meshes])
    return los.min(0).astype(np.float32), his.max(0).astype(np.float32)


def _table(aabb_min, aabb_max, vis_grid, dev) -> ProxyTable:
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    diag = np.linalg.norm(np.maximum(aabb_max - aabb_min, 0.0), axis=-1).astype(np.float32)
    return ProxyTable(
        aabb_min=torch.as_tensor(aabb_min, device=dev),
        aabb_max=torch.as_tensor(aabb_max, device=dev),
        max_length=torch.as_tensor(diag, device=dev),
        vis_grid=None if vis_grid is None else torch.as_tensor(np.stack(vis_grid), device=dev))


def _split_curves(curves, aabb_min: np.ndarray, aabb_max: np.ndarray):
    """Give each curve piece to the partition whose triangle box is nearest
    its midpoint (0 inside a box; the first of equal distances), as JAX's
    _split_curves does. A partition holds its own pieces in their global
    order and no padding; one that owns none gets None.

    Returns (per-partition CurveSet or None, (P, 3) f32 lo, (P, 3) f32 hi of
    each partition's piece boxes, +inf / -inf where it owns none)."""
    f64 = lambda x: x.detach().cpu().numpy().astype(np.float64)
    p0, p1, r0, r1 = f64(curves.p0), f64(curves.p1), f64(curves.r0), f64(curves.r1)
    seg = curves.seg_id.cpu().numpy()
    mid = 0.5 * (p0 + p1)                                   # (M,3)
    # distance from piece midpoint to each partition box (0 inside)
    lo_ok = np.where(np.isfinite(aabb_min), aabb_min, np.inf)
    hi_ok = np.where(np.isfinite(aabb_max), aabb_max, -np.inf)
    clamped = np.clip(mid[:, None, :], lo_ok[None], hi_ok[None])  # (M,P,3)
    dist = np.linalg.norm(np.where(np.isfinite(clamped),
                                   clamped - mid[:, None, :], np.inf), axis=-1)
    owner = np.argmin(dist, axis=1)                         # (M,)

    sets, clo, chi = [], [], []
    for p in range(aabb_min.shape[0]):
        idx = np.where(owner == p)[0]
        if idx.shape[0]:
            t = lambda a, dt=np.float32: torch.as_tensor(
                np.ascontiguousarray(a[idx], dt), device=curves.p0.device)
            sets.append(CurveSet(p0=t(p0), p1=t(p1), r0=t(r0), r1=t(r1),
                                 seg_id=t(seg, np.int32), color=curves.color))
            clo.append(np.minimum(p0[idx] - r0[idx, None], p1[idx] - r1[idx, None]).min(0))
            chi.append(np.maximum(p0[idx] + r0[idx, None], p1[idx] + r1[idx, None]).max(0))
        else:
            sets.append(None)
            clo.append(np.full(3, np.inf))
            chi.append(np.full(3, -np.inf))
    return sets, np.asarray(clo, np.float32), np.asarray(chi, np.float32)


def build_partitioned_scene(
    meshes: Sequence[MeshGeometry],
    num_partitions: int,
    assignment: Optional[List[List[int]]] = None,
    textures: Optional[list] = None,
    visibility_grids: bool = False,
    grid_res: tuple = (16, 16, 16),
    curves=None,
    device=None,
) -> PartitionedScene:
    """The P partition scenes and the proxy table on `device` (CUDA unless
    the caller passes another).

    `curves`, a CurveSet of the whole scene: each piece goes to the nearest
    partition (`_split_curves`), and merges with that partition's local
    traces as on one device. The proxy boxes widen to cover their
    partition's pieces, or a migrating ray would never route to the rank
    that owns a hair hit. With `visibility_grids` every partition gets a
    conservative grid of (width, height, angle) = `grid_res` over its
    (widened) box, built from its triangle boxes and its pieces'
    swept-sphere boxes."""
    dev = resolve_device(device)
    if assignment is None:
        assignment = partition_meshes(meshes, num_partitions)
    if len(assignment) != num_partitions:
        raise ValueError(f"{len(assignment)} partition lists for {num_partitions} partitions")

    # the global material table: a partition's triangles keep global mesh ids
    global_host = concat_geometry(list(meshes))
    tex = build_textures(textures, device=dev) if textures else None
    hosts, tables, aabb_min, aabb_max = [], [], [], []
    for part in assignment:
        host = concat_geometry([meshes[i] for i in part])
        if part:
            host["tri_mesh_id"] = np.asarray(part, np.int32)[host["tri_mesh_id"]]
        for k in ("mesh_base_color", "mesh_bsdf_type", "mesh_texture_index"):
            host[k] = global_host[k]
        tables.append(_pack_device_scene(
            host, build_bvh(host["v0"], host["v1"], host["v2"]),
            tris_per_cluster=PARTITION_TRIS_PER_CLUSTER))
        host["tmin"] = np.minimum(np.minimum(host["v0"], host["v1"]), host["v2"])
        host["tmax"] = np.maximum(np.maximum(host["v0"], host["v1"]), host["v2"])
        hosts.append(host)
        if host["v0"].shape[0] > 0:
            aabb_min.append(host["tmin"].min(0))
            aabb_max.append(host["tmax"].max(0))
        else:
            aabb_min.append(np.full(3, np.inf, np.float32))
            aabb_max.append(np.full(3, -np.inf, np.float32))
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)

    curve_sets = [None] * num_partitions
    if curves is not None:
        curve_sets, clo, chi = _split_curves(curves.to(dev), aabb_min, aabb_max)
        aabb_min = np.minimum(aabb_min, clo)
        aabb_max = np.maximum(aabb_max, chi)

    grids = None
    if visibility_grids:
        from .visibility_grid import build_conservative_grid

        width, height, angle = grid_res
        grids = []
        for host, cs, lo, hi in zip(hosts, curve_sets, aabb_min, aabb_max):
            if (host["v0"].shape[0] == 0 and cs is None) or not np.all(np.isfinite(lo)):
                grids.append(np.zeros((6, height, width, angle), bool))
                continue
            tmin, tmax = host["tmin"], host["tmax"]
            if cs is not None:
                # the pieces are content too: their swept-sphere boxes keep
                # the grid conservative for hair hits
                cp0, cp1 = cs.p0.cpu().numpy(), cs.p1.cpu().numpy()
                cr0, cr1 = cs.r0.cpu().numpy()[:, None], cs.r1.cpu().numpy()[:, None]
                tmin = np.concatenate([tmin, np.minimum(cp0 - cr0, cp1 - cr1)], axis=0)
                tmax = np.concatenate([tmax, np.maximum(cp0 + cr0, cp1 + cr1)], axis=0)
            grids.append(build_conservative_grid(tmin, tmax, lo, hi, width, height, angle))
    scenes = [DeviceScene(**{k: torch.as_tensor(v, device=dev) for k, v in arrays.items()},
                          albedo_textures=tex, curves=cs)
              for arrays, cs in zip(tables, curve_sets)]
    return PartitionedScene(scenes=scenes, proxies=_table(aabb_min, aabb_max, grids, dev),
                            num_partitions=num_partitions)


def build_partitioned_scene_instanced(
    meshes: Sequence[MeshGeometry],
    transforms,
    num_partitions: int,
    assignment: Optional[List[List[int]]] = None,
    visibility_grids: bool = False,
    grid_res: tuple = (16, 16, 16),
    tris_per_cluster: Optional[int] = None,
    device=None,
) -> PartitionedScene:
    """Distributed two-level instancing: instances (not meshes) go to
    partitions, and every partition's scene shares one set of base triangle
    tables and carries the instance-level cluster boxes and transforms of
    the instances it owns (one empty padding instance when it owns none).

    `transforms`: (I, 3, 4) object-to-world affines over the base mesh list.
    tris_per_cluster=None applies the adaptive rule to the largest
    partition's effective triangle count, as JAX does. With
    `visibility_grids` each partition's grid is built from its non-empty
    instance-cluster world boxes. `nn_proxies` holds one row per instance:
    its world box, the object-space diagonal as depth denormalizer, obj_id 0
    (one shared base object), the owning partition and the world-to-object
    map."""
    dev = resolve_device(device)
    m = np.asarray(transforms, np.float32)
    if m.ndim != 3 or m.shape[1:] != (3, 4):
        raise ValueError(f"transforms: want (I, 3, 4), got {m.shape}")
    if assignment is None:
        assignment = partition_instances(meshes, m, num_partitions)
    if len(assignment) != num_partitions:
        raise ValueError(f"{len(assignment)} partition lists for {num_partitions} partitions")
    icap = max(1, max((len(p) for p in assignment), default=1))
    if tris_per_cluster is None:
        eff = icap * sum(mesh.num_triangles for mesh in meshes)
        tris_per_cluster = (128 if eff <= 262144 else
                            512 if eff <= 8_388_608 else 2048)
    host = concat_geometry(list(meshes))
    base = _pack_device_scene(host, build_bvh(host["v0"], host["v1"], host["v2"]),
                              tris_per_cluster=tris_per_cluster)
    base_t = {k: torch.as_tensor(v, device=dev) for k, v in base.items()}

    ident = np.zeros((1, 3, 4), np.float32)
    ident[0, :, :3] = np.eye(3, dtype=np.float32)
    width, height, angle = grid_res
    scenes, aabb_min, aabb_max, grids = [], [], [], []
    for part in assignment:
        mp = m[np.asarray(part, np.int64)] if part else ident
        fields, (wmin, wmax, nonempty) = _instance_tables(base, mp, n_valid=len(part))
        scenes.append(DeviceScene(**{**base_t, **{
            k: torch.as_tensor(v, device=dev) for k, v in fields.items()}}))
        if nonempty.any():
            lo = wmin[nonempty].min(0).astype(np.float32)
            hi = wmax[nonempty].max(0).astype(np.float32)
        else:
            lo = np.full(3, np.inf, np.float32)
            hi = np.full(3, -np.inf, np.float32)
        aabb_min.append(lo)
        aabb_max.append(hi)
        if visibility_grids:
            if nonempty.any():
                from .visibility_grid import build_conservative_grid

                grids.append(build_conservative_grid(wmin[nonempty], wmax[nonempty],
                                                     lo, hi, width, height, angle))
            else:
                grids.append(np.zeros((6, height, width, angle), bool))
    proxies = _table(aabb_min, aabb_max, grids if visibility_grids else None, dev)

    # instance-level rows for the neural stages, featurized in object space
    blo, bhi = _meshes_aabb(meshes)
    corners = np.stack([np.where(np.asarray(sel), bhi, blo)
                        for sel in np.ndindex(2, 2, 2)])          # (8, 3)
    wc = np.einsum("iab,cb->ica", m[:, :, :3], corners) + m[:, None, :, 3]
    inv_lin = np.linalg.inv(m[:, :, :3].astype(np.float64)).astype(np.float32)
    inv_tr = -np.einsum("iab,ib->ia", inv_lin, m[:, :, 3])
    w2o = np.concatenate([inv_lin, inv_tr[:, :, None]], axis=2)
    owner = np.zeros(m.shape[0], np.int32)
    for p, part in enumerate(assignment):
        owner[np.asarray(part, np.int64)] = p
    ni = m.shape[0]
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    nn_proxies = ProxyTable(
        aabb_min=f32(wc.min(axis=1)), aabb_max=f32(wc.max(axis=1)),
        max_length=f32(np.full(ni, np.linalg.norm(bhi - blo))),
        obj_id=torch.zeros((ni,), dtype=torch.int32, device=dev),
        node_id=torch.as_tensor(owner, device=dev),
        world_to_obj=f32(w2o), obj_min=f32(np.broadcast_to(blo, (ni, 3))),
        obj_span=f32(np.broadcast_to(bhi - blo, (ni, 3))))
    return PartitionedScene(scenes=scenes, proxies=proxies,
                            num_partitions=num_partitions, nn_proxies=nn_proxies)
