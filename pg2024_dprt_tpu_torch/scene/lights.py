"""Emissive triangle lights + lat-long environment map (counterpart of
pg2024_dprt_tpu/scene/lights.py). Lights are a small table; the env lookup
is a bilinear gather."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.math import cartesian_to_spherical


class LightTable(NamedTuple):
    p0: torch.Tensor        # (L,3) f32
    p1: torch.Tensor        # (L,3)
    p2: torch.Tensor        # (L,3)
    radiance: torch.Tensor  # (L,3) Le

    @property
    def count(self) -> int:
        return self.p0.shape[0]

    @staticmethod
    def from_arrays(tris, radiance, device=None) -> "LightTable":
        dev = resolve_device(device)
        tris = torch.as_tensor(np.asarray(tris, np.float32), device=dev)  # (L,3,3)
        return LightTable(
            p0=tris[:, 0].contiguous(),
            p1=tris[:, 1].contiguous(),
            p2=tris[:, 2].contiguous(),
            radiance=torch.as_tensor(np.asarray(radiance, np.float32), device=dev),
        )


class EnvironmentMap(NamedTuple):
    """Lat-long radiance map; `rotation_offset` rotates the azimuth."""

    image: torch.Tensor           # (H, W, 3) f32
    rotation_offset: float        # radians

    @staticmethod
    def constant(color, h: int = 4, w: int = 8, rotation_offset: float = 0.0,
                 device=None) -> "EnvironmentMap":
        img = np.broadcast_to(np.asarray(color, np.float32), (h, w, 3)).copy()
        return EnvironmentMap.from_image(img, rotation_offset, device)

    @staticmethod
    def from_image(img, rotation_offset: float = 0.0, device=None) -> "EnvironmentMap":
        dev = resolve_device(device)
        return EnvironmentMap(
            torch.as_tensor(np.array(img, np.float32), device=dev),
            float(np.float32(rotation_offset)))

    def sample(self, directions: torch.Tensor) -> torch.Tensor:
        """Bilinear lookup of radiance for (N,3) directions -> (N,3):
        u = phi/2pi (after rotation, wrapped), v = theta/pi."""
        phi, theta = cartesian_to_spherical(directions)
        phi = phi + self.rotation_offset
        phi = torch.where(phi > 2.0 * math.pi, phi - 2.0 * math.pi, phi)
        u = phi / (2.0 * math.pi)
        v = theta / math.pi

        h, w = self.image.shape[0], self.image.shape[1]
        x = u * w - 0.5
        y = v * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        x0i = torch.remainder(x0.to(torch.int64), w)
        x1i = torch.remainder(x0i + 1, w)
        y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)

        img = self.image
        c00 = img[y0i, x0i]
        c01 = img[y0i, x1i]
        c10 = img[y1i, x0i]
        c11 = img[y1i, x1i]
        return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
                + c10 * (1 - fx) * fy + c11 * fx * fy)
