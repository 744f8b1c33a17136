"""Scene geometry containers (counterpart of pg2024_dprt_tpu/scene/geometry.py).

`MeshGeometry` (numpy, host) is one object's triangle soup and material.
`DeviceScene` (tensors) holds the tables both frame paths read: the cluster
tables that the trace kernels and the frame kernel stream (ops/resident.py,
ops/frame.py), the per-triangle shading rows that shading gathers
(render/shade.py) and the packed albedo textures (scene/textures.py); and
those of the other trace back ends: the pair tracer's triangle and Woop
tables (ops/tracer.py), the BVH and vertex arrays of the stackless walk
(ops/traversal.py).
`ProxyTable` (tensors) is the global table of proxy boxes that the neural
routing stage marches (render/proxy_stages.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import BSDF_DIFFUSE
from .bvh import FlatBVH, build_bvh
from .curves import CurveSet
from .textures import PackedTextures, build_textures

# cluster-group fan-out of the two-level cull (grouped trace kernels K9/K10)
CL_GROUP = 8


@dataclass
class MeshGeometry:
    """One logical object: triangle soup + per-mesh material."""

    v0: np.ndarray  # (T,3) f32
    v1: np.ndarray
    v2: np.ndarray
    # Per-corner shading normals; default = geometric normal.
    n0: Optional[np.ndarray] = None
    n1: Optional[np.ndarray] = None
    n2: Optional[np.ndarray] = None
    uv0: Optional[np.ndarray] = None  # (T,2)
    uv1: Optional[np.ndarray] = None
    uv2: Optional[np.ndarray] = None
    base_color: tuple = (0.8, 0.8, 0.8)
    bsdf_type: int = BSDF_DIFFUSE
    texture_index: int = -1
    name: str = ""

    def __post_init__(self):
        t = self.v0.shape[0]
        if self.n0 is None:
            gn = np.cross(self.v1 - self.v0, self.v2 - self.v0)
            norm = np.linalg.norm(gn, axis=-1, keepdims=True)
            gn = gn / np.maximum(norm, 1e-12)
            self.n0 = self.n1 = self.n2 = gn.astype(np.float32)
        if self.uv0 is None:
            self.uv0 = np.zeros((t, 2), np.float32)
            self.uv1 = np.zeros((t, 2), np.float32)
            self.uv2 = np.zeros((t, 2), np.float32)

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def aabb(self):
        """(lo, hi) f32 box of the mesh's vertices."""
        lo = np.minimum(np.minimum(self.v0.min(0), self.v1.min(0)), self.v2.min(0))
        hi = np.maximum(np.maximum(self.v0.max(0), self.v1.max(0)), self.v2.max(0))
        return lo.astype(np.float32), hi.astype(np.float32)


def concat_geometry(meshes: list) -> dict:
    """Concatenate meshes into flat numpy SoA + per-tri mesh ids + material
    tables. Returns a dict of host arrays."""
    if not meshes:
        z3 = np.zeros((0, 3), np.float32)
        z2 = np.zeros((0, 2), np.float32)
        return dict(
            v0=z3, v1=z3, v2=z3, n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
            tri_mesh_id=np.zeros((0,), np.int32),
            mesh_base_color=np.zeros((0, 3), np.float32),
            mesh_bsdf_type=np.zeros((0,), np.int32),
            mesh_texture_index=np.full((0,), -1, np.int32),
        )
    parts = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")}
    tri_mesh_id = []
    for mi, m in enumerate(meshes):
        for k in parts:
            parts[k].append(getattr(m, k))
        tri_mesh_id.append(np.full((m.num_triangles,), mi, np.int32))
    out = {k: np.concatenate(v, axis=0).astype(np.float32) for k, v in parts.items()}
    out["tri_mesh_id"] = np.concatenate(tri_mesh_id)
    out["mesh_base_color"] = np.asarray([m.base_color for m in meshes], np.float32)
    out["mesh_bsdf_type"] = np.asarray([m.bsdf_type for m in meshes], np.int32)
    out["mesh_texture_index"] = np.asarray([m.texture_index for m in meshes], np.int32)
    return out


class ProxyTable(NamedTuple):
    """Global proxy-AABB table, the same on every device. Row p describes
    partition p.

    Instancing (optional): when `world_to_obj` is set, each row is an
    instance of an object. The march then transforms hits to object space
    for the net's features, selects the net by `obj_id`, routes to
    `node_id`, and emits the world/object depth scale `t_ratio`;
    `max_length` is then the object-space diagonal.

    `vis_grid` (optional): one conservative visibility grid per row, (P, 6,
    H, W, A) bool (scene/visibility_grid.py), the exact-mode culling of
    the distributed frame (RenderConfig.use_visibility_grids)."""

    aabb_min: torch.Tensor    # (P, 3) f32 world-space box
    aabb_max: torch.Tensor    # (P, 3) f32
    max_length: torch.Tensor  # (P,) f32 box diagonal; 0 marks an empty partition
    obj_id: Optional[torch.Tensor] = None        # (P,) i32 net/object index
    node_id: Optional[torch.Tensor] = None       # (P,) i32 owning partition
    world_to_obj: Optional[torch.Tensor] = None  # (P, 3, 4) f32 affine world -> object
    obj_min: Optional[torch.Tensor] = None       # (P, 3) f32 object-space box min
    obj_span: Optional[torch.Tensor] = None      # (P, 3) f32 object-space box extent
    vis_grid: Optional[torch.Tensor] = None      # (P, 6, H, W, A) bool

    @property
    def num_partitions(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def instanced(self) -> bool:
        return self.world_to_obj is not None

    def to(self, device) -> "ProxyTable":
        return ProxyTable(*(None if x is None else x.to(device) for x in self))


class DeviceScene(NamedTuple):
    """One partition's device-resident tables, with the same layouts and
    values as the JAX DeviceScene fields of the same names.

    Cluster tables (K clusters of C triangle slots, BVH-cut, see
    scene/clusters.py); padding slots are all-zero (n = 0 -> rejected):
      * cl_mt_table (K, 16, C) rows: v0 xyz, e1 xyz, e2 xyz, n = e1 x e2
        xyz, canonical id as f32 (row 12, exact below 2^24 only — the
        kernels read cl_tri_map instead), rows 13..15 zero.
      * cl_boxes (8, K) rows: min xyz, max xyz, non-empty flag, pad;
        non-finite (empty-cluster) entries zeroed.
      * scene_aabb (2, 3): union of the non-empty cluster boxes.
    tri_shade (T, 24) per-triangle row in BVH order: n0 xyz, n1, n2, uv0,
    uv1, uv2, albedo rgb (15:18), bsdf_type (18), texture_index (19), mesh
    id (20), pad.
    albedo_textures: the packed texel pool that tri_shade's texture_index
    points into, or None for an untextured scene.

    Two-level cull tables (the grouped kernels K9/K10, ops/resident.py):
    CL_GROUP consecutive clusters form a group. cl_gboxes (8, Kg) mirrors
    cl_boxes at group granularity; cl_mboxes[g, m] = [min xyz, max xyz,
    non-empty flag, pad] of member m (empty and padding members carry flag
    0). For an instanced scene groups are cut per instance over the base
    cluster order, and cl_mboxes[g, 0, 7] holds the group's first member's
    instance-level cluster id cid0 (its members are cid0 .. cid0 + 7).

    Two-level instancing (`device_scene_from_instances`): the cluster arrays
    (cl_boxes, cl_aabb_*, cl_count, cl_tri_map) are instance-level, K = I *
    KB, while cl_mt_table and tri_shade stay base-level (KB clusters,
    num_base_tris rows) and are shared by every instance. cl_xf (I, 1, 16)
    holds one row per instance: lanes 0-8 the world-to-object linear map
    (row-major), 9-11 its translation, 13 the instance id. Cluster k belongs
    to instance k // KB and reads table slice k % KB; a hit's id is the
    virtual id instance * num_base_tris + base canonical id.

    Tables of the other trace back ends (ops/tracer.py, ops/traversal.py,
    ops/cluster_tracer.py), built for every flat scene; on an instanced
    scene they stay base-level and those back ends raise ValueError:
      * cl_tri_table (K, 10*C) rows: [v0x(C) v0y v0z v1x .. v2z tmap(C)],
        component-planar, tmap the canonical id as f32 (-1 pad);
      * cl_woop_table (K, 16*C): per triangle M = [e1 e2 n]^-1 and b = -M v0
        in the (4, 4*C) layout [o, 1] @ W = [o'x o'y o'z tmap]; degenerate
        triangles have zero rows and tmap -1;
      * node_min/max/first/count/skip: the threaded BVH (scene/bvh.py);
      * v0/v1/v2 (T, 3) in BVH order and tri_valid (T,) bool.

    curves: the scene's round B-spline pieces (scene/curves.py CurveSet),
    or None. The trace entry points merge them with the triangle hits
    (ops/trace_api.py); a curve hit's id is -2 - piece.

    Left out of the port: the tables only TPU kernels read (cl_mt_table_t,
    cl_shade_table(_t), the texture scanline pool)."""

    cl_aabb_min: torch.Tensor  # (K, 3) f32 (+inf/-inf for empty clusters)
    cl_aabb_max: torch.Tensor  # (K, 3) f32
    cl_count: torch.Tensor     # (K,) i32 valid triangles per cluster
    cl_tri_map: torch.Tensor   # (K*C,) i32 slot -> canonical tri (-1 pad)
    cl_mt_table: torch.Tensor  # (K, 16, C) f32
    cl_boxes: torch.Tensor     # (8, K) f32
    scene_aabb: torch.Tensor   # (2, 3) f32
    tri_shade: torch.Tensor    # (T, 24) f32
    albedo_textures: Optional[PackedTextures] = None
    cl_gboxes: Optional[torch.Tensor] = None  # (8, Kg) f32
    cl_mboxes: Optional[torch.Tensor] = None  # (Kg, CL_GROUP, 8) f32
    cl_xf: Optional[torch.Tensor] = None      # (I, 1, 16) f32, instanced only
    cl_tri_table: Optional[torch.Tensor] = None   # (K, 10*C) f32
    cl_woop_table: Optional[torch.Tensor] = None  # (K, 16*C) f32
    node_min: Optional[torch.Tensor] = None       # (M, 3) f32
    node_max: Optional[torch.Tensor] = None       # (M, 3) f32
    node_first: Optional[torch.Tensor] = None     # (M,) i32
    node_count: Optional[torch.Tensor] = None     # (M,) i32
    node_skip: Optional[torch.Tensor] = None      # (M,) i32
    v0: Optional[torch.Tensor] = None             # (T, 3) f32, BVH order
    v1: Optional[torch.Tensor] = None
    v2: Optional[torch.Tensor] = None
    tri_valid: Optional[torch.Tensor] = None      # (T,) bool
    curves: Optional[CurveSet] = None

    @property
    def instanced(self) -> bool:
        return self.cl_xf is not None

    @property
    def num_base_tris(self) -> int:
        """Virtual-triangle-id stride: an instanced hit's id is instance *
        num_base_tris + base canonical id."""
        return self.tri_shade.shape[0]

    @property
    def textured(self) -> bool:
        return self.albedo_textures is not None and self.albedo_textures.count > 0

    @property
    def has_cutout(self) -> bool:
        return self.textured and self.albedo_textures.has_cutout

    @property
    def num_triangles(self) -> int:
        return self.tri_shade.shape[0]

    @property
    def num_clusters(self) -> int:
        """K, instance-level for an instanced scene (its table holds KB)."""
        return self.cl_count.shape[0] if self.instanced else self.cl_mt_table.shape[0]

    @property
    def tris_per_cluster(self) -> int:
        return self.cl_mt_table.shape[2]


def device_scene_from_meshes(
    meshes: list,
    tri_capacity: Optional[int] = None,
    tris_per_cluster: Optional[int] = None,
    cluster_capacity: Optional[int] = None,
    textures: Optional[list] = None,
    curves=None,
    device=None,
) -> DeviceScene:
    """Build a single-partition DeviceScene (BVH + cluster tables) on
    `device` (CUDA unless the caller passes another).

    tris_per_cluster=None scales the cluster size with the scene, by the
    JAX package's rule, so both packages cut the same clusters. `curves`, a
    CurveSet, goes to the scene's device."""
    dev = resolve_device(device)
    host = concat_geometry(meshes)
    if tris_per_cluster is None:
        t_n = host["v0"].shape[0]
        tris_per_cluster = (128 if t_n <= 262144 else
                            512 if t_n <= 8_388_608 else 2048)
    bvh = build_bvh(host["v0"], host["v1"], host["v2"])
    arrays = _pack_device_scene(host, bvh, tri_capacity, tris_per_cluster,
                                cluster_capacity)
    return DeviceScene(
        **{k: torch.as_tensor(v, device=dev) for k, v in arrays.items()},
        albedo_textures=build_textures(textures, device=dev) if textures else None,
        curves=None if curves is None else curves.to(dev))


def _pack_device_scene(host: dict, bvh: FlatBVH, tri_capacity=None,
                       tris_per_cluster: int = 128,
                       cluster_capacity=None) -> dict:
    """Host numpy tables of a DeviceScene, built exactly as the JAX
    package's _pack_device_scene builds the same fields."""
    from .clusters import build_clusters

    order = bvh.tri_order
    t = order.shape[0]
    tc = tri_capacity or max(t, 1)

    clusters = build_clusters(bvh, max_tris=tris_per_cluster)
    kc = cluster_capacity or max(clusters.aabb_min.shape[0], 1)
    c = clusters.tris_per_cluster
    k0 = clusters.aabb_min.shape[0]
    if k0 > kc:
        raise ValueError(f"cluster count {k0} exceeds capacity {kc}")

    inf = np.float32(np.inf)
    cl_min = np.full((kc, 3), inf, np.float32)
    cl_max = np.full((kc, 3), -inf, np.float32)
    cl_cnt = np.zeros((kc,), np.int32)
    cl_min[:k0] = clusters.aabb_min
    cl_max[:k0] = clusters.aabb_max
    cl_cnt[:k0] = clusters.count
    tri_map = np.full((kc * c,), -1, np.int32)
    tri_map[: k0 * c] = clusters.tri_map

    tri_shade = np.zeros((tc, 24), np.float32)
    tri_shade[:, 19] = -1.0  # texture_index: pad rows fetch no texture
    if t > 0:
        oa = {k: host[k][order] for k in ("n0", "n1", "n2", "uv0", "uv1", "uv2")}
        omesh = host["tri_mesh_id"][order]
        tri_shade[:t, 0:3] = oa["n0"]
        tri_shade[:t, 3:6] = oa["n1"]
        tri_shade[:t, 6:9] = oa["n2"]
        tri_shade[:t, 9:11] = oa["uv0"]
        tri_shade[:t, 11:13] = oa["uv1"]
        tri_shade[:t, 13:15] = oa["uv2"]
        tri_shade[:t, 15:18] = host["mesh_base_color"][omesh]
        tri_shade[:t, 18] = host["mesh_bsdf_type"][omesh]
        tri_shade[:t, 19] = host["mesh_texture_index"][omesh]
        tri_shade[:t, 20] = omesh

    # cluster-major component-planar vertices (padding slots zero), row 9
    # the canonical id as f32
    ordered = {k: host[k][order] for k in ("v0", "v1", "v2")}
    safe = np.maximum(tri_map, 0)
    table = np.zeros((kc, 10, c), np.float32)
    if t > 0:
        for vi, key in enumerate(("v0", "v1", "v2")):
            a = ordered[key][safe]             # (kc*c, 3)
            a[tri_map < 0] = 0.0
            table[:, vi * 3: vi * 3 + 3, :] = a.reshape(kc, c, 3).transpose(0, 2, 1)
    table[:, 9, :] = tri_map.reshape(kc, c).astype(np.float32)
    v0t = table[:, 0:3, :]
    e1t = table[:, 3:6, :] - v0t
    e2t = table[:, 6:9, :] - v0t
    mt_table = np.concatenate(
        [v0t, e1t, e2t, np.cross(e1t, e2t, axis=1),
         tri_map.reshape(kc, 1, c).astype(np.float32),       # row 12: canon
         np.zeros((kc, 3, c), np.float32)], axis=1           # rows 13..15 pad
    ).astype(np.float32)
    boxes = np.concatenate(
        [cl_min.T, cl_max.T,
         (cl_cnt > 0).astype(np.float32)[None, :],
         np.zeros((1, kc), np.float32)], axis=0)
    boxes = np.where(np.isfinite(boxes), boxes, 0.0).astype(np.float32)

    # group tables of the two-level cull (CL_GROUP consecutive clusters per
    # group; K padded to a full final group with empty boxes)
    kgc = -(-kc // CL_GROUP)
    bpad = np.zeros((8, kgc * CL_GROUP), np.float32)
    bpad[:, :kc] = boxes
    b3 = bpad.reshape(8, kgc, CL_GROUP)                      # (8, Kg, G)
    gboxes = _group_boxes(b3[0:3].transpose(1, 2, 0), b3[3:6].transpose(1, 2, 0),
                          b3[6] > 0.0)
    mboxes = b3.transpose(1, 2, 0).astype(np.float32).copy()  # (Kg, G, 8)

    nonempty = cl_cnt > 0
    if nonempty.any():
        s_lo = cl_min[nonempty].min(axis=0)
        s_hi = cl_max[nonempty].max(axis=0)
    else:
        s_lo = np.zeros((3,), np.float32)
        s_hi = np.zeros((3,), np.float32)

    def pad_tri(a):
        out = np.zeros((tc,) + a.shape[1:], a.dtype)
        out[:t] = a
        return out

    tri_valid = np.zeros((tc,), bool)
    tri_valid[:t] = True
    return dict(
        cl_aabb_min=cl_min,
        cl_aabb_max=cl_max,
        cl_count=cl_cnt,
        cl_tri_map=tri_map,
        cl_mt_table=np.ascontiguousarray(mt_table),
        cl_boxes=np.ascontiguousarray(boxes),
        scene_aabb=np.stack([s_lo, s_hi]).astype(np.float32),
        tri_shade=tri_shade,
        cl_gboxes=gboxes,
        cl_mboxes=mboxes,
        cl_tri_table=table.reshape(kc, 10 * c),
        cl_woop_table=_woop_table(ordered, tri_map, kc, c, t),
        node_min=bvh.bounds_min.astype(np.float32),
        node_max=bvh.bounds_max.astype(np.float32),
        node_first=bvh.first.astype(np.int32),
        node_count=bvh.count.astype(np.int32),
        node_skip=bvh.skip.astype(np.int32),
        v0=pad_tri(ordered["v0"]),
        v1=pad_tri(ordered["v1"]),
        v2=pad_tri(ordered["v2"]),
        tri_valid=tri_valid,
    )


def _woop_table(ordered: dict, tri_map, kc: int, c: int, t: int):
    """(K, 16*C) Woop transform table, as the JAX package builds it: per
    triangle M = [e1 e2 n]^-1 (n = e1 x e2) and b = -M v0 in the (4, 4, C)
    layout [input row, output block, lane]: rows 0-2 hold M's columns, row 3
    b, block 3 holds tmap on row 3. Degenerate triangles keep zero rows and
    tmap -1."""
    woop = np.zeros((kc, 4, 4, c), np.float32)
    woop[:, 3, 3, :] = tri_map.reshape(kc, c).astype(np.float32)
    if t > 0:
        safe = np.maximum(tri_map, 0)
        va, vb, vc = (ordered[k][safe].reshape(kc, c, 3) for k in ("v0", "v1", "v2"))
        e1 = vb - va
        e2 = vc - va
        t_mat = np.stack([e1, e2, np.cross(e1, e2)], axis=-1)  # columns e1, e2, n
        good = (np.abs(np.linalg.det(t_mat)) > 1e-20) & (tri_map.reshape(kc, c) >= 0)
        t_safe = np.where(good[..., None, None], t_mat, np.eye(3, dtype=np.float32))
        m = np.linalg.inv(t_safe).astype(np.float32)          # (kc, c, 3, 3)
        b = -np.einsum("kcij,kcj->kci", m, va).astype(np.float32)
        m = np.where(good[..., None, None], m, 0.0)
        b = np.where(good[..., None], b, 0.0)
        for oc in range(3):
            woop[:, 0:3, oc, :] = m[:, :, oc, :].transpose(0, 2, 1)
            woop[:, 3, oc, :] = b[:, :, oc]
        woop[:, 3, 3, :] = np.where(good, woop[:, 3, 3, :], -1.0)
    return woop.reshape(kc, 16 * c)


def _group_boxes(mmin, mmax, ok):
    """(8, Kg) group boxes from (Kg, G, 3) member boxes and (Kg, G) member
    flags: the union over non-empty members, rows min xyz, max xyz,
    non-empty flag, pad; an empty group is all zero."""
    big = np.float32(3.4e38)
    gmin = np.where(ok[..., None], mmin, big).min(axis=1)     # (Kg, 3)
    gmax = np.where(ok[..., None], mmax, -big).max(axis=1)
    g_any = ok.any(axis=1)
    gmin = np.where(g_any[:, None], gmin, 0.0)
    gmax = np.where(g_any[:, None], gmax, 0.0)
    return np.concatenate(
        [gmin.T, gmax.T, g_any.astype(np.float32)[None],
         np.zeros((1, ok.shape[0]), np.float32)], axis=0).astype(np.float32)


def device_scene_from_instances(meshes: list, transforms,
                                tris_per_cluster: Optional[int] = None,
                                device=None) -> DeviceScene:
    """Instanced scene on `device` (CUDA unless the caller passes another):
    I copies of the base mesh list, each placed by a (3, 4) object-to-world
    affine (rows [R | t], invertible). The triangle tables are built once
    over the base geometry; each instance adds only its cluster boxes, its
    tile of the tri-map and a 16-float transform row, so N instances of a
    mesh cost one table. No textures: instanced scenes have no cutouts.

    tris_per_cluster=None applies the adaptive rule to the effective
    triangle count (instances x base triangles): per-cluster costs scale
    with K = I * KB."""
    if tris_per_cluster is None:
        eff = len(np.asarray(transforms)) * sum(m.num_triangles for m in meshes)
        tris_per_cluster = (128 if eff <= 262144 else
                            512 if eff <= 8_388_608 else 2048)
    dev = resolve_device(device)
    host = concat_geometry(meshes)
    arrays = _pack_device_scene(host, build_bvh(host["v0"], host["v1"], host["v2"]),
                                tris_per_cluster=tris_per_cluster)
    fields, _ = _instance_tables(arrays, transforms)
    arrays.update(fields)
    return DeviceScene(**{k: torch.as_tensor(v, device=dev) for k, v in arrays.items()})


def _instance_tables(base: dict, transforms, n_valid: Optional[int] = None):
    """Instance-level cluster and group tables over a shared base scene's
    host tables (`_pack_device_scene`'s dict), built exactly as the JAX
    package's _instance_tables builds them.

    Returns (fields, aux): `fields` is the dict of host arrays that replace
    the base scene's; `aux` is (wmin, wmax, nonempty) of the (I*KB,)
    instance-cluster world boxes. `n_valid` < I marks the trailing instances
    empty (all boxes non-entered, counts 0): the padding rows that make
    per-partition instance tables rectangular."""
    m = np.asarray(transforms, np.float32)
    if m.ndim != 3 or m.shape[1:] != (3, 4):
        raise ValueError(f"transforms: want (I, 3, 4), got {m.shape}")
    ni = m.shape[0]
    if n_valid is None:
        n_valid = ni
    kb, _, c = base["cl_mt_table"].shape
    k = ni * kb

    # world-to-object inverses
    inv_lin = np.linalg.inv(m[:, :, :3])                     # (I, 3, 3)
    inv_tr = -np.einsum("iab,ib->ia", inv_lin, m[:, :, 3])   # (I, 3)

    # world-space cluster boxes: the 8 transformed corners of each base box
    bmin, bmax = base["cl_aabb_min"], base["cl_aabb_max"]   # (KB, 3)
    corners = np.stack([np.where(np.asarray(sel)[None, :], bmax, bmin)
                        for sel in np.ndindex(2, 2, 2)], axis=1)   # (KB, 8, 3)
    wc = (np.einsum("iab,kcb->ikca", m[:, :, :3], corners)
          + m[:, None, None, :, 3])                          # (I, KB, 8, 3)
    finite = np.isfinite(bmin).all(axis=1) & np.isfinite(bmax).all(axis=1)
    wmin = wc.min(axis=2).reshape(k, 3)
    wmax = wc.max(axis=2).reshape(k, 3)
    valid_inst = np.repeat(np.arange(ni) < n_valid, kb)
    count = np.where(valid_inst, np.tile(base["cl_count"], ni), 0)
    nonempty = (count > 0) & np.tile(finite, ni) & valid_inst
    wmin = np.where(nonempty[:, None], wmin, 0.0)
    wmax = np.where(nonempty[:, None], wmax, 0.0)
    cl_boxes = np.concatenate(
        [wmin.T, wmax.T, nonempty.astype(np.float32)[None, :],
         np.zeros((1, k), np.float32)], axis=0)              # (8, K)

    # one transform row per instance: lanes 0-8 world-to-object linear map,
    # 9-11 translation, 13 instance id
    xf = np.zeros((ni, 1, 16), np.float32)
    xf[:, 0, 0:9] = inv_lin.reshape(ni, 9)
    xf[:, 0, 9:12] = inv_tr
    xf[:, 0, 13] = np.arange(ni, dtype=np.float32)

    scene_lo = wmin[nonempty].min(axis=0) if nonempty.any() else np.zeros(3)
    scene_hi = wmax[nonempty].max(axis=0) if nonempty.any() else np.ones(3)
    tri_map = np.tile(base["cl_tri_map"].reshape(kb, c), (ni, 1))

    # group tables: CL_GROUP base clusters per group, per instance over the
    # base order; mboxes[g, 0, 7] = cid0, the group's first member's
    # instance-level cluster id
    g = CL_GROUP
    gbb = -(-kb // g)
    kgi = ni * gbb
    kbp = gbb * g
    w3min = np.zeros((ni, kbp, 3), np.float32)
    w3max = np.zeros((ni, kbp, 3), np.float32)
    okm = np.zeros((ni, kbp), bool)
    w3min[:, :kb] = wmin.reshape(ni, kb, 3)
    w3max[:, :kb] = wmax.reshape(ni, kb, 3)
    okm[:, :kb] = nonempty.reshape(ni, kb)
    mboxes = np.zeros((kgi, g, 8), np.float32)
    mboxes[..., 0:3] = w3min.reshape(kgi, g, 3)
    mboxes[..., 3:6] = w3max.reshape(kgi, g, 3)
    mboxes[..., 6] = okm.reshape(kgi, g)
    cid0 = (np.arange(ni)[:, None] * kb + np.arange(gbb)[None, :] * g).reshape(kgi)
    mboxes[:, 0, 7] = cid0.astype(np.float32)
    gboxes = _group_boxes(w3min.reshape(kgi, g, 3), w3max.reshape(kgi, g, 3),
                          okm.reshape(kgi, g))

    fields = dict(
        cl_aabb_min=wmin.astype(np.float32),
        cl_aabb_max=wmax.astype(np.float32),
        cl_count=count.astype(np.int32),
        cl_tri_map=tri_map.reshape(k * c),
        cl_boxes=cl_boxes.astype(np.float32),
        scene_aabb=np.stack([scene_lo, scene_hi]).astype(np.float32),
        cl_xf=xf,
        cl_gboxes=gboxes,
        cl_mboxes=mboxes,
    )
    return fields, (wmin, wmax, nonempty)
