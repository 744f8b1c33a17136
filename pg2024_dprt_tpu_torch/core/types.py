"""SoA wavefront records (counterpart of pg2024_dprt_tpu/core/types.py).

`PathState` holds one fixed-capacity structure-of-arrays path buffer; path
counts are validity masks. `HitRecord` is the closest-hit payload that
shading consumes: per-triangle attributes are gathered from `tri_index`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BSDF_DIFFUSE = 0
BSDF_WATER = 1


class PathState(NamedTuple):
    """Fixed-capacity SoA path buffer; every tensor has leading dim N.

    The JAX record's migration fields (visited_mask, current_node,
    target_node, the carried hit payload) serve the distributed loop and
    are not part of the single-device port."""

    origin: torch.Tensor       # (N, 3) f32
    direction: torch.Tensor    # (N, 3) f32
    tmax: torch.Tensor         # (N,)   f32
    throughput: torch.Tensor   # (N, 3) f32 (shadow paths carry NEE contribution)
    pixel_index: torch.Tensor  # (N,)   i64
    shadow_path_id: torch.Tensor  # (N,) i64 (-1 for camera/bounce paths)
    is_shadow: torch.Tensor    # (N,)   bool
    is_delta: torch.Tensor     # (N,)   bool
    is_valid: torch.Tensor     # (N,)   bool

    @property
    def capacity(self) -> int:
        return self.origin.shape[0]


class HitRecord(NamedTuple):
    """Closest-hit payload."""

    t: torch.Tensor          # (N,) f32 hit distance (F32_MAX on miss)
    tri_index: torch.Tensor  # (N,) i32 canonical (BVH-order) triangle index, -1 miss
    u: torch.Tensor          # (N,) f32 barycentric (weights v1)
    v: torch.Tensor          # (N,) f32 barycentric (weights v2)
    is_hit: torch.Tensor     # (N,) bool
