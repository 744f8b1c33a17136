"""The scene kind `soup`: one mesh of random small triangles in a cube.

Its scene entry: `triangles`, `extent` (the cube's side), `jitter` (the
edges' size, a share of the side), `color` (optional), `seed`, and
`tris_per_cluster` for the one-device build. The generator is a frozen
copy, so that a change to the program's procedural scenes does not change
what the benchmark renders.
"""
from __future__ import annotations

import numpy as np

# the port's build and the reference's scene, shared by the kinds of
# triangle meshes
from portbench.meshes import device_scene, partitioned_scene  # noqa: F401
from portbench.reference.triangles import reference_scene as reference  # noqa: F401

# the scene entry's key that sets its size
SIZE = "triangles"


def soup_mesh(n: int, seed: int, extent: float, jitter: float, color, name: str) -> dict:
    """n random small triangles in [0, extent]^3."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n, 3).astype(np.float32) * extent
    e1 = (rng.rand(n, 3).astype(np.float32) - 0.5) * jitter * extent
    e2 = (rng.rand(n, 3).astype(np.float32) - 0.5) * jitter * extent
    return dict(v0=base, v1=base + e1, v2=base + e2, base_color=tuple(color), name=name)


def inputs(scene: dict) -> list:
    """The meshes of a configuration's `scene` entry."""
    return [soup_mesh(scene["triangles"], scene["seed"], scene["extent"], scene["jitter"],
                      scene.get("color", (0.8, 0.8, 0.8)), "soup")]
