"""Procedural test scenes (counterpart of pg2024_dprt_tpu/scene/procedural.py:
the cornell box and the random triangle soup) and the frame configurations
built on them. Meshes are host numpy; the light table goes to `device`."""
from __future__ import annotations

import numpy as np

from ..core.types import BSDF_DIFFUSE, BSDF_WATER
from .geometry import MeshGeometry
from .lights import LightTable


def _quad(p00, p10, p11, p01):
    """Two triangles for a quad given CCW corners."""
    p00, p10, p11, p01 = (np.asarray(p, np.float32) for p in (p00, p10, p11, p01))
    v0 = np.stack([p00, p00])
    v1 = np.stack([p10, p11])
    v2 = np.stack([p11, p01])
    return v0, v1, v2


def _box(lo, hi):
    """12 triangles of an axis-aligned box with outward normals."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    quads = [
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),  # floor
        ([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]),  # ceiling
        ([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0]),  # -z
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # +z
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # -x
        ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),  # +x
    ]
    parts = [_quad(*q) for q in quads]
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))


def cornell_box(with_water_sphere: bool = False, device=None):
    """Cornell-box-scale scene: 5 walls, 2 boxes, 1 area light.

    Returns (meshes, light_table). World: x in [0,1], y in [0,1] up, z in
    [0,1]; the usual camera looks down -z from z=2.4."""
    meshes = []

    def wall(p00, p10, p11, p01, color, name):
        v0, v1, v2 = _quad(p00, p10, p11, p01)
        meshes.append(MeshGeometry(v0=v0, v1=v1, v2=v2, base_color=color, name=name))

    white = (0.73, 0.73, 0.73)
    wall([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], white, "floor")
    wall([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], white, "ceiling")
    wall([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], white, "back")
    wall([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], (0.65, 0.05, 0.05), "left")
    wall([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], (0.12, 0.45, 0.15), "right")

    v0, v1, v2 = _box([0.55, 0.0, 0.55], [0.85, 0.3, 0.85])
    meshes.append(MeshGeometry(v0=v0, v1=v1, v2=v2, base_color=white, name="short_box"))
    # tall box (water if requested, to exercise the dielectric BSDF path)
    v0, v1, v2 = _box([0.15, 0.0, 0.15], [0.45, 0.6, 0.45])
    meshes.append(MeshGeometry(
        v0=v0, v1=v1, v2=v2,
        base_color=(1.0, 1.0, 1.0) if with_water_sphere else white,
        bsdf_type=BSDF_WATER if with_water_sphere else BSDF_DIFFUSE,
        name="tall_box"))

    # area light just under the ceiling
    light_tris = np.asarray(
        [[[0.35, 0.998, 0.35], [0.65, 0.998, 0.35], [0.65, 0.998, 0.65]],
         [[0.35, 0.998, 0.35], [0.65, 0.998, 0.65], [0.35, 0.998, 0.65]]],
        np.float32)
    radiance = np.asarray([[15.0, 15.0, 15.0]] * 2, np.float32)
    return meshes, LightTable.from_arrays(light_tris, radiance, device=device)


def textured_cornell_box(floor_tex: int = 0, back_tex: int = -1, uv_scale: float = 1.0,
                         with_water_sphere: bool = False, device=None):
    """cornell_box with a uv-mapped floor (texture `floor_tex`) and, when
    `back_tex` >= 0, the second wall mesh textured too; uv spans
    [0, uv_scale], so a scale above 1 exercises wrap addressing. The texture
    images go to device_scene_from_meshes(textures=...). Returns (meshes,
    light_table)."""
    meshes, lights = cornell_box(with_water_sphere, device=device)
    uv = uv_scale * np.asarray(
        [[0, 0], [0, 1], [1, 1], [0, 0], [1, 1], [1, 0]], np.float32)

    def retex(m, ti):
        reps = (m.num_triangles // 2, 1)
        return MeshGeometry(
            v0=m.v0, v1=m.v1, v2=m.v2, uv0=np.tile(uv[0::3], reps),
            uv1=np.tile(uv[1::3], reps), uv2=np.tile(uv[2::3], reps),
            base_color=m.base_color, texture_index=ti, name=m.name)

    meshes[0] = retex(meshes[0], floor_tex)
    if back_tex >= 0:
        meshes[1] = retex(meshes[1], back_tex)
    return meshes, lights


def random_tri_soup(n: int, seed: int = 0, extent: float = 1.0, jitter: float = 0.08):
    """n random small triangles in [0, extent]^3 — the BVH stress and
    benchmark scene."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n, 3).astype(np.float32) * extent
    e1 = (rng.rand(n, 3).astype(np.float32) - 0.5) * jitter * extent
    e2 = (rng.rand(n, 3).astype(np.float32) - 0.5) * jitter * extent
    return MeshGeometry(v0=base, v1=base + e1, v2=base + e2, name=f"soup{n}")


def soup_frame(size: int = 256, n_tris: int = 65536, device=None):
    """The exact-frame benchmark configuration (the JAX package's
    scripts/bench_frame.py and the frame row of scripts/bench_suite.py):
    a random soup packed at 512 triangles per cluster under one area light
    at y=2, a constant sky, size x size, spp 1, 4 bounces, RIS NEE.
    Returns (scene, lights, env, camera, cfg)."""
    from ..core.camera import Camera
    from ..render.config import RenderConfig
    from .geometry import device_scene_from_meshes
    from .lights import EnvironmentMap

    scene = device_scene_from_meshes([random_tri_soup(n_tris, seed=0)],
                                     tris_per_cluster=512, device=device)
    light_tris = np.asarray([[[0.3, 2.0, 0.3], [0.7, 2.0, 0.3], [0.7, 2.0, 0.7]]], np.float32)
    lights = LightTable.from_arrays(light_tris, np.asarray([[60.0, 60.0, 60.0]], np.float32),
                                    device=device)
    env = EnvironmentMap.constant((0.4, 0.5, 0.7), device=device)
    camera = Camera.look_at([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0, size, size,
                            device=device)
    cfg = RenderConfig(width=size, height=size, spp=1, bounces=4, nee_mode="ris")
    return scene, lights, env, camera, cfg


def auto_light(lo, hi, intensity: float, device=None) -> LightTable:
    """Two-triangle area light hovering over the box [lo, hi], its radiance
    scaled so its power covers the box's footprint (the JAX package's CLI
    rule, render/__main__.py auto_light)."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    cx, cz = 0.5 * (lo[0] + hi[0]), 0.5 * (lo[2] + hi[2])
    ex, ez = hi[0] - lo[0], hi[2] - lo[2]
    y = hi[1] + 0.25 * max(hi[1] - lo[1], 1e-3)
    hx, hz = 0.2 * max(ex, 1e-3), 0.2 * max(ez, 1e-3)
    quad = np.asarray(
        [[[cx - hx, y, cz - hz], [cx + hx, y, cz - hz], [cx + hx, y, cz + hz]],
         [[cx - hx, y, cz - hz], [cx + hx, y, cz + hz], [cx - hx, y, cz + hz]]],
        np.float32)
    rad = intensity * max(ex * ez, 1e-6) / max(4.0 * hx * hz, 1e-6)
    return LightTable.from_arrays(quad, np.full((2, 3), rad, np.float32), device=device)


def instanced_frame(size: int = 256, device=None):
    """The camera_4m_instanced configuration of the JAX package's
    scripts/bench_suite.py as a frame: 8 instances of
    random_tri_soup(1 << 19, seed=9), instance i translated to
    [2.2 (i % 4), 0, 2.2 (i // 4)], 4,194,304 effective triangles over one
    shared base table at the adaptive 512 per cluster; the CLI's auto light
    (intensity 8) over the scene box; a constant sky; the grazing camera
    (eye [3.3, 1.5, 9.0], target [3.3, 0.5, 1.0], fov 55); size x size,
    spp 1, 4 bounces, RIS NEE. Returns (scene, lights, env, camera, cfg)."""
    from ..core.camera import Camera
    from ..render.config import RenderConfig
    from .geometry import device_scene_from_instances
    from .lights import EnvironmentMap

    grid = np.zeros((8, 3, 4), np.float32)
    for i in range(8):
        grid[i, :, :3] = np.eye(3, dtype=np.float32)
        grid[i, :, 3] = [2.2 * (i % 4), 0.0, 2.2 * (i // 4)]
    scene = device_scene_from_instances([random_tri_soup(1 << 19, seed=9)], grid,
                                        device=device)
    lo, hi = scene.scene_aabb.cpu().numpy()
    lights = auto_light(lo, hi, 8.0, device=device)
    env = EnvironmentMap.constant((0.4, 0.5, 0.7), device=device)
    camera = Camera.look_at([3.3, 1.5, 9.0], [3.3, 0.5, 1.0], [0, 1, 0], 55.0, size, size,
                            device=device)
    cfg = RenderConfig(width=size, height=size, spp=1, bounces=4, nee_mode="ris")
    return scene, lights, env, camera, cfg
