"""Per-frame light and camera motion (counterpart of
pg2024_dprt_tpu/render/animation.py): the reference renderer's LIGHT_MOVE /
CAMERA_MOVE frame hooks as pure functions of the frame index."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.camera import Camera
from ..scene.lights import LightTable


def translate_lights(lights: LightTable, offset) -> LightTable:
    off = torch.as_tensor(np.asarray(offset, np.float32), device=lights.p0.device)
    return LightTable(p0=lights.p0 + off, p1=lights.p1 + off, p2=lights.p2 + off,
                      radiance=lights.radiance)


def animate_lights(lights: LightTable, frame: int, velocity=(0.0, 0.0, 0.0)) -> LightTable:
    """LIGHT_MOVE: the lights moved by frame * velocity."""
    return translate_lights(lights, np.asarray(velocity, np.float32) * np.float32(frame))


def orbit_camera(camera: Camera, frame: int, center, radius: float, height: float,
                 degrees_per_frame: float, fov_degrees: float) -> Camera:
    """CAMERA_MOVE: orbit around `center` at a fixed radius and height."""
    ang = np.deg2rad(degrees_per_frame * frame)
    center = np.asarray(center, np.float32)
    eye = center + np.asarray([radius * np.cos(ang), height, radius * np.sin(ang)],
                              np.float32)
    return Camera.look_at(eye, center, [0, 1, 0], fov_degrees, camera.width, camera.height,
                          device=camera.origin.device)


def dolly_camera(camera: Camera, frame: int, velocity=(0.0, 0.0, 0.0)) -> Camera:
    """CAMERA_MOVE: the camera moved by frame * velocity."""
    off = np.asarray(velocity, np.float32) * np.float32(frame)
    return dataclasses.replace(
        camera, origin=camera.origin + torch.as_tensor(off, device=camera.origin.device))
