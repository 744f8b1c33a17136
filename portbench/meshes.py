"""The port's builds of a scene of triangle meshes, through its public
entries: shared by the scene kinds whose inputs are meshes (dicts of
float32 (T, 3) arrays v0, v1, v2, a base_color and a name; `kinds/soup.py`,
`kinds/rooms.py`). The port is imported when a build runs, not when a kind
is loaded.
"""
from __future__ import annotations


def geometry(meshes: list) -> list:
    """The port's `MeshGeometry` of each mesh."""
    from pg2024_dprt_tpu_torch.scene import MeshGeometry

    return [MeshGeometry(v0=m["v0"], v1=m["v1"], v2=m["v2"], base_color=m["base_color"],
                         name=m["name"]) for m in meshes]


def device_scene(meshes: list, scene: dict, device):
    """The one-device scene (`device_scene_from_meshes`), packed
    `scene["tris_per_cluster"]` triangles to a cluster."""
    from pg2024_dprt_tpu_torch.scene import device_scene_from_meshes

    return device_scene_from_meshes(geometry(meshes), tris_per_cluster=scene["tris_per_cluster"],
                                    device=device)


def partitioned_scene(meshes: list, scene: dict, device):
    """The scene split into `scene["partitions"]` partitions
    (`build_partitioned_scene`), each on `device`."""
    from pg2024_dprt_tpu_torch.scene import build_partitioned_scene

    return build_partitioned_scene(geometry(meshes), scene["partitions"], device=device)
