"""SoA wavefront records (counterpart of pg2024_dprt_tpu/core/types.py).

`PathState` holds one fixed-capacity structure-of-arrays path buffer; path
counts are validity masks. `HitRecord` is the closest-hit payload that
shading consumes: per-triangle attributes are gathered from `tri_index`.
`NNQuery` is the neural-proxy query record that the proxy march emits and
the vis/depth nets consume (render/proxy_stages.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BSDF_DIFFUSE = 0
BSDF_WATER = 1


class PathState(NamedTuple):
    """Fixed-capacity SoA path buffer; every tensor has leading dim N.

    The routing fields (is_hit, current_node, target_node, visited_mask) are
    written by the neural-proxy routing stage (render/proxy_stages.py) and
    the distributed migration loop (parallel/distributed.py) and default to
    None, which they read as "no hit, node -1, nothing visited"; the
    single-device frame paths never set them. visited_mask is uint32 in the
    JAX record: here it is int64 holding a value below 2^32, as core/rng.py
    holds its uint32 words.

    hit_tri / hit_u / hit_v carry the winning hit of the distributed
    migration loop (parallel/distributed.py) with the path: the triangle id
    and barycentrics at the partition that owns the nearest hit
    (current_node; the t is tmax), so that the settled partition shades
    without tracing again. They default to None like the routing fields."""

    origin: torch.Tensor       # (N, 3) f32
    direction: torch.Tensor    # (N, 3) f32
    tmax: torch.Tensor         # (N,)   f32
    throughput: torch.Tensor   # (N, 3) f32 (shadow paths carry NEE contribution)
    pixel_index: torch.Tensor  # (N,)   i64
    shadow_path_id: torch.Tensor  # (N,) i64 (-1 for camera/bounce paths)
    is_shadow: torch.Tensor    # (N,)   bool
    is_delta: torch.Tensor     # (N,)   bool
    is_valid: torch.Tensor     # (N,)   bool
    is_hit: torch.Tensor = None        # (N,) bool
    current_node: torch.Tensor = None  # (N,) i64
    target_node: torch.Tensor = None   # (N,) i64
    visited_mask: torch.Tensor = None  # (N,) i64, bit i = partition i traced
    hit_tri: torch.Tensor = None       # (N,) i32 carried hit's triangle (-1 none)
    hit_u: torch.Tensor = None         # (N,) f32
    hit_v: torch.Tensor = None         # (N,) f32

    @property
    def capacity(self) -> int:
        return self.origin.shape[0]

    def with_routing(self) -> "PathState":
        """The same paths with every unset routing field at its empty value
        (no hit, nodes -1, nothing visited, no carried hit)."""
        n, dev = self.capacity, self.origin.device
        fill = lambda x, v, dt: torch.full((n,), v, dtype=dt, device=dev) if x is None else x
        return self._replace(
            is_hit=fill(self.is_hit, False, torch.bool),
            current_node=fill(self.current_node, -1, torch.int64),
            target_node=fill(self.target_node, -1, torch.int64),
            visited_mask=fill(self.visited_mask, 0, torch.int64),
            hit_tri=fill(self.hit_tri, -1, torch.int32),
            hit_u=fill(self.hit_u, 0.0, torch.float32),
            hit_v=fill(self.hit_v, 0.0, torch.float32))

    def gather(self, idx: torch.Tensor) -> "PathState":
        """Rows reordered or compacted by an index tensor (rows may repeat;
        mask separately). Unset fields stay None."""
        return PathState(*(None if x is None else x[idx] for x in self))

    @staticmethod
    def empty(n: int, device=None) -> "PathState":
        """n invalid paths with every field set (the JAX PathState.empty)."""
        from .device import resolve_device

        dev = resolve_device(device)
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        flag = lambda: torch.zeros((n,), dtype=torch.bool, device=dev)
        return PathState(
            origin=z(n, 3), direction=z(n, 3), tmax=z(n), throughput=z(n, 3),
            pixel_index=torch.zeros((n,), dtype=torch.int64, device=dev),
            shadow_path_id=torch.full((n,), -1, dtype=torch.int64, device=dev),
            is_shadow=flag(), is_delta=flag(), is_valid=flag()).with_routing()


class HitRecord(NamedTuple):
    """Closest-hit payload."""

    t: torch.Tensor          # (N,) f32 hit distance (F32_MAX on miss)
    tri_index: torch.Tensor  # (N,) i32 canonical (BVH-order) triangle index, -1 miss,
    #                          -2 - piece for a curve hit (ops/trace_api.py)
    u: torch.Tensor          # (N,) f32 barycentric (weights v1)
    v: torch.Tensor          # (N,) f32 barycentric (weights v2)
    is_hit: torch.Tensor     # (N,) bool


class NNQuery(NamedTuple):
    """Neural-proxy query record, Q = N * max_hits rows (row n * max_hits + k
    is ray n's k-th recorded proxy hit; valid rows are front-packed per ray).
    `features` are the 5 network inputs: the hit point normalized to the
    proxy box, then phi / 2pi and theta / pi of the (object-space, on an
    inside hit negated) direction."""

    features: torch.Tensor      # (Q, 5) f32 (rounded to bf16 where the nets read them)
    aabb_id: torch.Tensor       # (Q,) i32 proxy object id = net index (-1 invalid)
    pixel_index: torch.Tensor   # (Q,) i32, zeros: filled by the caller
    shadow_path_id: torch.Tensor  # (Q,) i32, zeros: filled by the caller
    hit_sequence: torch.Tensor  # (Q,) i32 which of the marched hits
    is_inside: torch.Tensor     # (Q,) bool segment start was inside the box
    is_valid: torch.Tensor      # (Q,) bool
    path_index: torch.Tensor    # (Q,) i32 row in the emitting path buffer
    aabb_t: torch.Tensor        # (Q,) f32 ray distance of the proxy hit
    max_length: torch.Tensor    # (Q,) f32 box diagonal (depth denormalizer)
    t_ratio: torch.Tensor       # (Q,) f32 world-t / object-t scale
    normalized_t: torch.Tensor  # (Q,) f32 object-space entry depth (inside hits)
    node_id: torch.Tensor = None  # (Q,) i32 owning partition of the hit proxy
