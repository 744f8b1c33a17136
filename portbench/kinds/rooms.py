"""The scene kind `rooms`: a row of rooms, each a soup of its own.

Its scene entry: `rooms`, `tris_per_room`, `spacing` (between the rooms'
corners along x), `jitter`, `seed`, and `partitions` for the partitioned
build (or `tris_per_cluster` for the one-device one). The generator is a
frozen copy, so that a change to the program's procedural scenes does not
change what the benchmark renders.
"""
from __future__ import annotations

import numpy as np

# the port's build and the reference's scene, shared by the kinds of
# triangle meshes
from portbench.meshes import device_scene, partitioned_scene  # noqa: F401
from portbench.reference.triangles import reference_scene as reference  # noqa: F401

# the scene entry's key that sets its size
SIZE = "tris_per_room"


def room_meshes(rooms: int, tris_per_room: int, seed: int, spacing: float,
                jitter: float) -> list:
    """`rooms` unit soups `spacing` apart along x, room r coloured (0.7,
    0.6 + 0.1 (r % 3), 0.5)."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(rooms):
        offset = np.asarray([spacing * r, 0.0, 0.0], np.float32)
        base = rng.rand(tris_per_room, 3).astype(np.float32) + offset
        e1 = (rng.rand(tris_per_room, 3).astype(np.float32) - 0.5) * jitter
        e2 = (rng.rand(tris_per_room, 3).astype(np.float32) - 0.5) * jitter
        out.append(dict(v0=base, v1=base + e1, v2=base + e2,
                        base_color=(0.7, 0.6 + 0.1 * (r % 3), 0.5), name=f"room{r}"))
    return out


def inputs(scene: dict) -> list:
    """The meshes of a configuration's `scene` entry."""
    return room_meshes(scene["rooms"], scene["tris_per_room"], scene["seed"], scene["spacing"],
                       scene["jitter"])
