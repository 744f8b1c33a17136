"""Scene geometry containers (counterpart of pg2024_dprt_tpu/scene/geometry.py).

`MeshGeometry` (numpy, host) is one object's triangle soup and material.
`DeviceScene` (tensors) holds the tables both frame paths read: the cluster
tables that the trace kernels and the frame kernel stream (ops/resident.py,
ops/frame.py), the per-triangle shading rows that shading gathers
(render/shade.py) and the packed albedo textures (scene/textures.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import BSDF_DIFFUSE
from .bvh import FlatBVH, build_bvh
from .textures import PackedTextures, build_textures


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

    Left out of the port so far (callers that ask for them get
    NotImplementedError): instancing (cl_xf), curves, the stackless tracer's
    BVH node arrays, and the tables only TPU kernels read (cl_woop_table,
    cl_mt_table_t, cl_gboxes/cl_mboxes, cl_shade_table(_t), the texture
    scanline pool)."""

    cl_aabb_min: torch.Tensor  # (K, 3) f32 (+inf/-inf for empty clusters)
    cl_aabb_max: torch.Tensor  # (K, 3) f32
    cl_count: torch.Tensor     # (K,) i32 valid triangles per cluster
    cl_tri_map: torch.Tensor   # (K*C,) i32 slot -> canonical tri (-1 pad)
    cl_mt_table: torch.Tensor  # (K, 16, C) f32
    cl_boxes: torch.Tensor     # (8, K) f32
    scene_aabb: torch.Tensor   # (2, 3) f32
    tri_shade: torch.Tensor    # (T, 24) f32
    albedo_textures: Optional[PackedTextures] = None

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
        return self.cl_mt_table.shape[0]

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
    JAX package's rule, so both packages cut the same clusters."""
    if curves is not None:
        raise NotImplementedError("curves are not ported yet")
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
        albedo_textures=build_textures(textures, device=dev) if textures else None)


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

    # cluster-major component-planar vertices (padding slots zero)
    safe = np.maximum(tri_map, 0)
    table = np.zeros((kc, 9, c), np.float32)
    if t > 0:
        for vi, key in enumerate(("v0", "v1", "v2")):
            a = host[key][order][safe]         # (kc*c, 3)
            a[tri_map < 0] = 0.0
            table[:, vi * 3: vi * 3 + 3, :] = a.reshape(kc, c, 3).transpose(0, 2, 1)
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

    nonempty = cl_cnt > 0
    if nonempty.any():
        s_lo = cl_min[nonempty].min(axis=0)
        s_hi = cl_max[nonempty].max(axis=0)
    else:
        s_lo = np.zeros((3,), np.float32)
        s_hi = np.zeros((3,), np.float32)

    return dict(
        cl_aabb_min=cl_min,
        cl_aabb_max=cl_max,
        cl_count=cl_cnt,
        cl_tri_map=tri_map,
        cl_mt_table=np.ascontiguousarray(mt_table),
        cl_boxes=np.ascontiguousarray(boxes),
        scene_aabb=np.stack([s_lo, s_hi]).astype(np.float32),
        tri_shade=tri_shade,
    )
