"""Carry scene state across from the JAX package, as numpy arrays.

The slice has no network weights: its state is the scene. These functions
build the port's records from the JAX records' fields given as numpy arrays
(e.g. `{k: np.asarray(v) for k, v in jax_scene._asdict().items()}`), so
both packages can trace and shade identical tables whatever each builder
would produce. Nothing here imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from .geometry import DeviceScene
from .lights import EnvironmentMap, LightTable
from .textures import PackedTextures

# fields that carry data the port cannot render yet
_UNSUPPORTED = ("cl_xf", "curves")


def device_scene_from_arrays(arrays: dict, device=None) -> DeviceScene:
    """Port DeviceScene from the JAX DeviceScene's fields. Fields the port
    does not keep (BVH nodes, TPU-only tables) are ignored; instanced or
    curve scenes raise NotImplementedError. `albedo_textures`, when present,
    is the dict of the JAX PackedTextures' fields (packed_textures_from_arrays)."""
    for name in _UNSUPPORTED:
        if arrays.get(name) is not None:
            raise NotImplementedError(f"{name} is not ported yet")
    dev = resolve_device(device)
    tex = arrays.get("albedo_textures")
    return DeviceScene(
        **{name: torch.as_tensor(np.array(arrays[name]), device=dev)
           for name in DeviceScene._fields if name != "albedo_textures"},
        albedo_textures=None if tex is None else packed_textures_from_arrays(tex, dev))


def packed_textures_from_arrays(arrays: dict, device=None):
    """Port PackedTextures from the JAX PackedTextures' fields; the scanline
    pool (a TPU-kernel layout) is dropped. None for an empty pool."""
    if np.asarray(arrays["offset"]).shape[0] == 0:
        return None
    dev = resolve_device(device)
    i32 = lambda name: torch.as_tensor(np.array(arrays[name], np.int32), device=dev)
    return PackedTextures(
        torch.as_tensor(np.array(arrays["texels"], np.float32), device=dev),
        i32("offset"), i32("height"), i32("width"), i32("cutout_rows"))


def light_table_from_arrays(arrays: dict, device=None) -> LightTable:
    dev = resolve_device(device)
    return LightTable(**{
        name: torch.as_tensor(np.array(arrays[name], np.float32), device=dev)
        for name in LightTable._fields})


def environment_from_arrays(arrays: dict, device=None) -> EnvironmentMap:
    return EnvironmentMap.from_image(arrays["image"],
                                     float(arrays["rotation_offset"]), device)


def camera_from_arrays(arrays: dict, width: int, height: int,
                       device=None) -> Camera:
    dev = resolve_device(device)
    f32 = lambda name: torch.as_tensor(np.array(arrays[name], np.float32), device=dev)
    return Camera(f32("origin"), f32("forward"), f32("right"), f32("up"),
                  f32("tan_half_fov"), width, height)
