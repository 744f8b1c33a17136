"""Wavefront OBJ loader (counterpart of pg2024_dprt_tpu/scene/obj.py).

Host code: `load_obj` parses v / vn / vt, negative indices, polygons (fan
triangulation) and o / g / usemtl grouping into one MeshGeometry per
(object, material) group, with the .mtl's Kd colour and map_Kd texture
path; `load_texture_images` decodes those textures (utils/png.py), and
`scene_from_obj` packs the whole file into a DeviceScene on `device` (CUDA
unless the caller passes another). The arrays equal the JAX loader's.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ..core.types import BSDF_DIFFUSE
from .geometry import MeshGeometry


def parse_mtl(path: str) -> Dict[str, dict]:
    """Minimal .mtl parser: Kd (diffuse color) and map_Kd (texture path)."""
    mats: Dict[str, dict] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = {"Kd": (0.8, 0.8, 0.8), "map_Kd": None}
            elif cur and parts[0] == "Kd":
                mats[cur]["Kd"] = tuple(float(x) for x in parts[1:4])
            elif cur and parts[0] == "map_Kd":
                mats[cur]["map_Kd"] = parts[-1]
    return mats


def load_obj(path: str, default_color=(0.8, 0.8, 0.8)) -> Tuple[List[MeshGeometry], List[str]]:
    """Parse an OBJ file into MeshGeometry per (object, material) group.

    Returns (meshes, texture_paths); mesh.texture_index points into
    texture_paths (-1 = untextured)."""
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []

    mats: Dict[str, dict] = {}
    texture_paths: List[str] = []
    tex_lut: Dict[str, int] = {}

    groups: Dict[Tuple[str, str], List] = {}
    cur_obj = "default"
    cur_mat = ""

    def resolve(idx: str, n: int) -> int:
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt":
                texcoords.append(tuple(float(x) for x in parts[1:3]))
            elif tag == "mtllib":
                mats.update(parse_mtl(os.path.join(os.path.dirname(path), parts[1])))
            elif tag in ("o", "g"):
                cur_obj = parts[1] if len(parts) > 1 else "default"
            elif tag == "usemtl":
                cur_mat = parts[1]
            elif tag == "f":
                corners = []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi = resolve(comps[0], len(positions))
                    ti = resolve(comps[1], len(texcoords)) if len(comps) > 1 and comps[1] else -1
                    ni = resolve(comps[2], len(normals)) if len(comps) > 2 and comps[2] else -1
                    corners.append((vi, ti, ni))
                key = (cur_obj, cur_mat)
                tris = groups.setdefault(key, [])
                for i in range(1, len(corners) - 1):  # fan triangulation
                    tris.append((corners[0], corners[i], corners[i + 1]))

    pos = np.asarray(positions, np.float32) if positions else np.zeros((0, 3), np.float32)
    nrm = np.asarray(normals, np.float32) if normals else np.zeros((0, 3), np.float32)
    uvs = np.asarray(texcoords, np.float32) if texcoords else np.zeros((0, 2), np.float32)

    meshes: List[MeshGeometry] = []
    for (obj, mat), tris in groups.items():
        t = len(tris)
        v = np.zeros((3, t, 3), np.float32)
        n = np.zeros((3, t, 3), np.float32)
        uv = np.zeros((3, t, 2), np.float32)
        has_n = True
        for ti, tri in enumerate(tris):
            for c in range(3):
                vi, tci, ni = tri[c]
                v[c, ti] = pos[vi]
                if ni >= 0 and ni < nrm.shape[0]:
                    n[c, ti] = nrm[ni]
                else:
                    has_n = False
                if tci >= 0 and tci < uvs.shape[0]:
                    uv[c, ti] = uvs[tci]

        m = mats.get(mat, {})
        tex_path = m.get("map_Kd")
        tex_index = -1
        if tex_path:
            if tex_path not in tex_lut:
                tex_lut[tex_path] = len(texture_paths)
                texture_paths.append(tex_path)
            tex_index = tex_lut[tex_path]

        meshes.append(
            MeshGeometry(
                v0=v[0], v1=v[1], v2=v[2],
                n0=n[0] if has_n else None,
                n1=n[1] if has_n else None,
                n2=n[2] if has_n else None,
                uv0=uv[0], uv1=uv[1], uv2=uv[2],
                base_color=m.get("Kd", default_color),
                bsdf_type=BSDF_DIFFUSE,
                texture_index=tex_index,
                name=f"{obj}:{mat}",
            )
        )
    return meshes, texture_paths


def load_texture_images(texture_paths: List[str], base_dir: str = "") -> List[np.ndarray]:
    """Decode the texture files an OBJ's materials name into float (H, W, C)
    arrays for build_textures (PNG through utils/png.py). A missing or
    undecodable file becomes a 1x1 white texel, with a warning, so the scene
    still builds, as in the JAX package."""
    import warnings

    images: List[np.ndarray] = []
    for p in texture_paths:
        full = p if os.path.isabs(p) else os.path.join(base_dir, p)
        try:
            from ..utils.png import read_png

            # no flip here: sample_textures applies the stbi-style v flip
            # (y = (1-v)*h), so images stay in decoded top-down row order
            images.append(read_png(full))
        except Exception as e:  # noqa: BLE001 — any decode failure degrades
            warnings.warn(f"texture {full!r} not decodable ({e}); using 1x1 white")
            images.append(np.ones((1, 1, 3), np.float32))
    return images


def scene_from_obj(path: str, default_color=(0.8, 0.8, 0.8), device=None,
                   **scene_kwargs):
    """OBJ file on disk -> textured DeviceScene on `device` (CUDA unless
    given): parse the geometry and materials, decode every map_Kd, pack."""
    from .geometry import device_scene_from_meshes

    meshes, texture_paths = load_obj(path, default_color=default_color)
    images = load_texture_images(texture_paths, base_dir=os.path.dirname(path))
    return device_scene_from_meshes(meshes, textures=images, device=device, **scene_kwargs)
