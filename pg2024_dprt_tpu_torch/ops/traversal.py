"""The "stackless" trace back end and the all-triangles oracle (counterpart
of pg2024_dprt_tpu/ops/traversal.py). Plain PyTorch, as the JAX module is
plain XLA: no kernel of its own.

`traverse_bvh` walks the threaded BVH (scene/bvh.py) with one node cursor
per ray, all rays in lockstep: per step the node boxes are gathered and
slab-tested against each ray's running best t, a leaf's triangles are
tested with a fixed MAX_LEAF unroll, and each cursor descends (node + 1) or
skips. The loop ends when no cursor is live, which costs one host check per
step. `intersect_brute_force` tests every ray against every triangle, in
chunks, and picks the lowest index at equal t, as `jnp.argmin` does.
"""
from __future__ import annotations

import torch

from ..core.math import cross, dot, safe_inv
from ..core.types import HitRecord
from ..scene.bvh import MAX_LEAF
from .resident import F32_MAX

# elements per (ray, triangle) chunk of the brute-force oracle
_BRUTE_CHUNK = 1 << 22


def _flat_scene(scene):
    """Raise unless `scene` carries the flat BVH and vertex arrays."""
    if scene.instanced:
        raise ValueError("the stackless tracer traces flat scenes only; an "
                         "instanced scene's BVH is its base geometry's")
    if scene.node_min is None or scene.v0 is None:
        raise ValueError("the scene carries no BVH arrays")


def moller_trumbore(o, d, p0, p1, p2, t_min, t_max):
    """Two-sided ray-triangle test over broadcast (..., 3) operands.
    Returns (hit, t, u, v)."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    valid = det.abs() > 1e-12
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return hit, t, u, v


def traverse_bvh(scene, origin, direction, t_min, t_max, active) -> HitRecord:
    """Closest hit of (N,) rays by the stackless BVH walk. t_min / t_max
    are scalars or (N,)."""
    _flat_scene(scene)
    n = origin.shape[0]
    dev = origin.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    best_t = torch.where(active, t_max, 0.0)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((n,), dtype=torch.float32, device=dev)
    v_best = torch.zeros_like(u_best)
    inv_dir = safe_inv(direction)
    node = torch.where(active, 0, -1).to(torch.int64)
    last = scene.num_triangles - 1
    while bool((node >= 0).any()):
        live = node >= 0
        nd = node.clamp(min=0)
        bmin, bmax = scene.node_min[nd], scene.node_max[nd]
        first, count = scene.node_first[nd].long(), scene.node_count[nd]
        t0 = (bmin - origin) * inv_dir
        t1 = (bmax - origin) * inv_dir
        near = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), t_min)
        far = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), best_t)
        box_hit = live & (near <= far)
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf
        for k in range(MAX_LEAF):
            idx = (first + k).clamp(max=last)
            hit, t, u, v = moller_trumbore(origin, direction, scene.v0[idx], scene.v1[idx],
                                           scene.v2[idx], t_min, best_t)
            hit = hit & do_leaf & (k < count) & scene.tri_valid[idx]
            best_t = torch.where(hit, t, best_t)
            tri = torch.where(hit, idx.to(torch.int32), tri)
            u_best = torch.where(hit, u, u_best)
            v_best = torch.where(hit, v, v_best)
        nxt = torch.where(box_hit & ~is_leaf, node + 1, scene.node_skip[nd].long())
        node = torch.where(live, nxt, -1)
    is_hit = tri >= 0
    return HitRecord(t=torch.where(is_hit, best_t, F32_MAX), tri_index=tri, u=u_best,
                     v=v_best, is_hit=is_hit)


def intersect_brute_force(scene, origin, direction, t_min, t_max, active) -> HitRecord:
    """Oracle: every ray against every triangle. The winner is the first
    triangle at the smallest t; a miss reports triangle 0's u and v, as the
    JAX oracle's argmin does."""
    _flat_scene(scene)
    n = origin.shape[0]
    dev = origin.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    nt = scene.v0.shape[0]
    tc = max(1, min(nt, _BRUTE_CHUNK // max(n, 1)))
    best_t = torch.full((n,), F32_MAX, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    for s0 in range(0, nt, tc):
        sl = slice(s0, s0 + tc)
        hit, t, u, v = moller_trumbore(origin[:, None], direction[:, None], scene.v0[None, sl],
                                       scene.v1[None, sl], scene.v2[None, sl],
                                       t_min[:, None], t_max[:, None])
        hit = hit & scene.tri_valid[None, sl] & active[:, None]
        t = torch.where(hit, t, F32_MAX)
        tm, j = t.min(dim=1)                   # first minimal index on ties
        take = lambda a: a.gather(1, j[:, None])[:, 0]
        better = (tm < best_t) if s0 else torch.ones_like(best_hit)
        best_t = torch.where(better, tm, best_t)
        best_i = torch.where(better, j + s0, best_i)
        best_u = torch.where(better, take(u), best_u)
        best_v = torch.where(better, take(v), best_v)
        best_hit = torch.where(better, take(hit), best_hit)
    return HitRecord(t=best_t, tri_index=torch.where(best_hit, best_i, -1).to(torch.int32),
                     u=best_u, v=best_v, is_hit=best_hit)
