"""Pinhole camera (counterpart of pg2024_dprt_tpu/core/camera.py): a
look-at camera with vertical FOV, one ray per (row, col) pixel with
sub-pixel jitter, vectorized over the whole image."""
from __future__ import annotations

import dataclasses
import math

import torch

from .device import resolve_device
from .math import cross, normalize


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor        # (3,) f32
    forward: torch.Tensor       # (3,) unit
    right: torch.Tensor         # (3,) unit
    up: torch.Tensor            # (3,) unit
    tan_half_fov: torch.Tensor  # () f32
    width: int = 0
    height: int = 0

    @staticmethod
    def look_at(origin, target, up, fov_degrees: float, width: int, height: int,
                device=None) -> "Camera":
        dev = resolve_device(device)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        origin, target, up = f32(origin), f32(target), f32(up)
        forward = normalize(target - origin)
        right = normalize(cross(forward, up))
        true_up = cross(right, forward)
        tan_half_fov = torch.tan(f32(fov_degrees) * (math.pi / 180.0) * 0.5)
        return Camera(origin, forward, right, true_up, tan_half_fov, width, height)

    def generate_rays(self, rows, cols, xi1, xi2):
        """Rays through pixel centers jittered by (xi1, xi2) in [0,1).
        rows/cols are integer tensors (row 0 = top of image). Returns
        (origins (N,3), directions (N,3))."""
        aspect = self.width / self.height
        px = (cols.to(torch.float32) + xi1) / self.width * 2.0 - 1.0
        py = 1.0 - (rows.to(torch.float32) + xi2) / self.height * 2.0
        d = (self.forward[None, :]
             + px[:, None] * (self.tan_half_fov * aspect) * self.right[None, :]
             + py[:, None] * self.tan_half_fov * self.up[None, :])
        directions = normalize(d)
        origins = self.origin.expand_as(directions)
        return origins, directions
