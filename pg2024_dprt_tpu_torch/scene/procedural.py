"""Procedural test scenes (counterpart of pg2024_dprt_tpu/scene/procedural.py:
the cornell box, the random triangle soup, the statue object, the city
surface and the rooms of the distributed tests) and the frame
configurations built on them. Meshes are host numpy; the light table goes
to `device`."""
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


def statue_mesh(res: int = 48, seed: int = 0, extent: float = 1.0):
    """A closed, smoothly displaced sphere (low-frequency lobes and a
    mid-frequency ripple) in [0, extent]^3, about 4 res^2 triangles: the
    statue-class object that the proxy nets learn."""
    rng = np.random.RandomState(seed)
    th = np.linspace(0.0, np.pi, res + 1)
    ph = np.linspace(0.0, 2 * np.pi, 2 * res + 1)
    t, pg = np.meshgrid(th, ph, indexing="ij")
    a, b, c = 0.22 + 0.06 * rng.rand(3)
    r = (1.0
         + a * np.sin(3.0 * t) * np.cos(2.0 * pg)
         + b * np.cos(2.0 * t) * np.sin(3.0 * pg)
         + c * 0.4 * np.sin(5.0 * t + 1.3) * np.sin(4.0 * pg + 0.7))
    v = np.stack([r * np.sin(t) * np.cos(pg), r * np.cos(t), r * np.sin(t) * np.sin(pg)],
                 axis=-1)
    lo = v.reshape(-1, 3).min(0)
    hi = v.reshape(-1, 3).max(0)
    v = (v - lo) / max((hi - lo).max(), 1e-9) * extent
    p00 = v[:-1, :-1].reshape(-1, 3)
    p10 = v[1:, :-1].reshape(-1, 3)
    p01 = v[:-1, 1:].reshape(-1, 3)
    p11 = v[1:, 1:].reshape(-1, 3)
    v0 = np.concatenate([p00, p00]).astype(np.float32)
    v1 = np.concatenate([p10, p11]).astype(np.float32)
    v2 = np.concatenate([p11, p01]).astype(np.float32)
    # drop the degenerate slivers at the poles
    keep = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1) > 1e-12
    return MeshGeometry(v0=v0[keep], v1=v1[keep], v2=v2[keep],
                        base_color=(0.75, 0.72, 0.68), name=f"statue{res}")


def city_scene(n: int, seed: int = 0, extent: float = 1.0):
    """About n triangles of a city-like surface: a jittered, smoothed height
    field plus axis-aligned box buildings (rays hit a surface and stop, and
    cluster boxes tile the surface). Deterministic in (n, seed); the count
    is within a few percent of n."""
    rng = np.random.RandomState(seed)
    n_build = max(1, n // 24)           # each box = 12 tris, half the budget
    n_terrain = max(2, n - 12 * n_build)

    # terrain: jittered heightfield grid of g x g cells, 2 tris per cell
    g = max(1, int(np.sqrt(n_terrain / 2)))
    xs = np.linspace(0.0, extent, g + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    h = rng.rand(g + 1, g + 1).astype(np.float32)
    # smooth the noise a little so the surface is rolling, not spiky
    for _ in range(2):
        h = 0.25 * (np.roll(h, 1, 0) + np.roll(h, -1, 0)
                    + np.roll(h, 1, 1) + np.roll(h, -1, 1))
    gy = h * (0.15 * extent)
    p = np.stack([gx, gy, gz], axis=-1)                       # (g+1, g+1, 3)
    a = p[:-1, :-1].reshape(-1, 3)
    b = p[1:, :-1].reshape(-1, 3)
    c = p[1:, 1:].reshape(-1, 3)
    d = p[:-1, 1:].reshape(-1, 3)
    v0 = np.concatenate([a, a])
    v1 = np.concatenate([b, c])
    v2 = np.concatenate([c, d])

    # buildings: axis-aligned boxes scattered on the terrain
    bs = []
    for _ in range(n_build):
        cx, cz = rng.rand(2).astype(np.float32) * extent * 0.9 + 0.05 * extent
        w, dep = (rng.rand(2).astype(np.float32) * 0.02 + 0.004) * extent
        ht = (rng.rand() * 0.12 + 0.02) * extent
        y0 = 0.0
        bs.append(_box([cx - w, y0, cz - dep], [cx + w, y0 + ht, cz + dep]))
    if bs:
        bv0 = np.concatenate([q[0] for q in bs])
        bv1 = np.concatenate([q[1] for q in bs])
        bv2 = np.concatenate([q[2] for q in bs])
        v0 = np.concatenate([v0, bv0])
        v1 = np.concatenate([v1, bv1])
        v2 = np.concatenate([v2, bv2])
    return MeshGeometry(v0=v0.astype(np.float32), v1=v1.astype(np.float32),
                        v2=v2.astype(np.float32), name=f"city{n}")


def two_room_scene(num_rooms: int = 2, tris_per_room: int = 512, seed: int = 1,
                   device=None):
    """`num_rooms` random soups of unit extent 2.5 apart along x (each room
    maps to one partition) under one area light. Returns (meshes, lights)."""
    rng = np.random.RandomState(seed)
    meshes = []
    for r in range(num_rooms):
        offset = np.asarray([2.5 * r, 0.0, 0.0], np.float32)
        base = rng.rand(tris_per_room, 3).astype(np.float32) + offset
        e1 = (rng.rand(tris_per_room, 3).astype(np.float32) - 0.5) * 0.15
        e2 = (rng.rand(tris_per_room, 3).astype(np.float32) - 0.5) * 0.15
        meshes.append(MeshGeometry(v0=base, v1=base + e1, v2=base + e2,
                                   base_color=(0.7, 0.6 + 0.1 * (r % 3), 0.5),
                                   name=f"room{r}"))
    light_tris = np.asarray([[[0.5, 3.0, 0.5], [1.5, 3.0, 0.5], [1.5, 3.0, 1.5]]], np.float32)
    lights = LightTable.from_arrays(light_tris, np.asarray([[40.0, 40.0, 40.0]], np.float32),
                                    device=device)
    return meshes, lights


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


def instance_grid():
    """The instanced frame's geometry: ([random_tri_soup(1 << 19, seed=9)],
    (8, 3, 4) transforms placing instance i at [2.2 (i % 4), 0, 2.2 (i // 4)])."""
    grid = np.zeros((8, 3, 4), np.float32)
    for i in range(8):
        grid[i, :, :3] = np.eye(3, dtype=np.float32)
        grid[i, :, 3] = [2.2 * (i % 4), 0.0, 2.2 * (i // 4)]
    return [random_tri_soup(1 << 19, seed=9)], grid


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

    meshes, grid = instance_grid()
    scene = device_scene_from_instances(meshes, grid, device=device)
    lo, hi = scene.scene_aabb.cpu().numpy()
    lights = auto_light(lo, hi, 8.0, device=device)
    env = EnvironmentMap.constant((0.4, 0.5, 0.7), device=device)
    camera = Camera.look_at([3.3, 1.5, 9.0], [3.3, 0.5, 1.0], [0, 1, 0], 55.0, size, size,
                            device=device)
    cfg = RenderConfig(width=size, height=size, spp=1, bounces=4, nee_mode="ris")
    return scene, lights, env, camera, cfg
