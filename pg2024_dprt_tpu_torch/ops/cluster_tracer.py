"""The "cluster" trace back end (counterpart of
pg2024_dprt_tpu/ops/cluster_tracer.py): bulk cull, dispatch and block
intersection. Plain PyTorch, as the JAX module is plain XLA.

Per chunk of rays:
  1. cull: every ray against every cluster box, an (m, K) slab test;
  2. dispatch: the surviving (ray, cluster) pairs are packed into blocks of
     `block_rays` rays that share one cluster, each pair's place from one
     cumsum over the rays and one over the clusters' block counts; blocks
     beyond `block_budget` are dropped, as in JAX (the default budget is
     the JAX package's);
  3. intersect: each block's rays against its cluster's C triangles of
     `cl_tri_table` (a dense (blocks, block_rays, C) Moller-Trumbore), in
     groups of GROUP_BLOCKS blocks; then one min-scatter over the rays.

Departures from the JAX module, none of which changes a result: the
cluster rows are gathered by index (the JAX module's one-hot matmul is a
TPU layout choice); ids come from `cl_tri_map` (int32), not from the f32
tmap row, which is exact only below 2^24; groups past the last live block
are not computed. The JAX winner write `.at[wslot].set` leaves the order
among equal-t winners of one ray (two clusters hit at the same t)
undefined; the port takes the winner of the lowest pair index, i.e. the
cluster with the lowest index (dispatch orders blocks by cluster).
"""
from __future__ import annotations

import torch

from ..core.math import safe_inv
from ..core.types import HitRecord
from .resident import F32_MAX

_MISS = 0xFFFFFFFF

GROUP_BLOCKS = 32  # blocks intersected per loop step (bounds peak memory)


def _enc_t(t):
    """Monotone unsigned encoding of non-negative floats, as int64 (the JAX
    module's uint32 bitcast)."""
    return t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _check_scene(scene):
    if scene.instanced:
        raise ValueError("the cluster tracer traces flat scenes only; an "
                         "instanced scene's triangle table is its base geometry's")
    if scene.cl_tri_table is None:
        raise ValueError("the scene carries no cl_tri_table")


def _chunk_trace(scene, o, d, t_min, t_max, active, block_rays: int,
                 block_budget: int, any_hit: bool):
    """Trace one chunk of m rays. Returns (m,) occluded, or (t, tri, u, v,
    is_hit, dropped)."""
    m = o.shape[0]
    k = scene.num_clusters
    c = scene.tris_per_cluster
    br = block_rays
    dev = o.device

    # ---- 1. cull
    inv = safe_inv(d)
    enter = torch.full((m, k), -F32_MAX, dtype=torch.float32, device=dev)
    exit_ = torch.full((m, k), F32_MAX, dtype=torch.float32, device=dev)
    for ax in range(3):
        lo = (scene.cl_aabb_min[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        hi = (scene.cl_aabb_max[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        enter = torch.maximum(enter, torch.minimum(lo, hi))
        exit_ = torch.minimum(exit_, torch.maximum(lo, hi))
    hit_box = (active[:, None] & (scene.cl_count[None, :] > 0) & (exit_ >= enter)
               & (exit_ > t_min[:, None]) & (enter < t_max[:, None]))
    del enter, exit_

    # ---- 2. dispatch
    hb = hit_box.to(torch.int64)
    rank = torch.cumsum(hb, dim=0) - 1                              # (m, K)
    counts = hb.sum(dim=0)                                          # (K,)
    nblocks = (counts + br - 1) // br
    block_end = torch.cumsum(nblocks, dim=0)
    block_off = block_end - nblocks
    total_blocks = int(block_end[-1]) if k else 0
    block_id = block_off[None, :] + torch.div(rank, br, rounding_mode="floor")
    in_budget = hit_box & (block_id < block_budget)
    slot = torch.where(in_budget, block_id * br + rank % br, block_budget * br)
    ray_ids = torch.arange(m, device=dev)[:, None].expand(m, k)
    bucket_ray = torch.full((block_budget * br + 1,), -1, dtype=torch.int64, device=dev)
    bucket_ray[slot[in_budget]] = ray_ids[in_budget]
    bucket_ray = bucket_ray[:-1].view(block_budget, br)
    dropped = int((hit_box & ~in_budget).sum())
    del hit_box, hb, rank, block_id, in_budget, slot, ray_ids
    blocks = torch.arange(block_budget, device=dev)
    block_cluster = torch.searchsorted(block_end, blocks, right=True).clamp(max=k - 1)
    block_live = blocks < total_blocks

    # ---- 3. intersect, GROUP_BLOCKS blocks at a time
    table = scene.cl_tri_table
    tri_map = scene.cl_tri_map.view(-1, c)
    occ = torch.zeros((m,), dtype=torch.bool, device=dev)
    parts = []
    for b0 in range(0, min(total_blocks, block_budget), GROUP_BLOCKS):
        b = slice(b0, b0 + GROUP_BLOCKS)
        g_ray = bucket_ray[b]                                       # (gb, br)
        valid = (g_ray >= 0) & block_live[b, None]
        ray = g_ray.clamp(min=0)
        bo, bd = o[ray], d[ray]                                     # (gb, br, 3)
        btmin, btmax = t_min[ray], t_max[ray]
        cl = block_cluster[b]
        tile = table[cl]                                            # (gb, 10C)
        btm = tri_map[cl]                                           # (gb, C)
        comp = lambda j: tile[:, None, j * c:(j + 1) * c]           # (gb, 1, C)
        e1x, e1y, e1z = (comp(3 + i) - comp(i) for i in range(3))
        e2x, e2y, e2z = (comp(6 + i) - comp(i) for i in range(3))
        dx, dy, dz = (bd[:, :, i, None] for i in range(3))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = det.abs() > 1e-12
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        tx = bo[:, :, 0, None] - comp(0)
        ty = bo[:, :, 1, None] - comp(1)
        tz = bo[:, :, 2, None] - comp(2)
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        tri_ok = (ok & (btm[:, None, :] >= 0) & valid[:, :, None] & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > btmin[:, :, None]) & (t < btmax[:, :, None]))
        if any_hit:
            hit_ray = ray[tri_ok.any(dim=-1) & valid]
            occ[hit_ray] = True
            continue
        t_masked = torch.where(tri_ok, t, F32_MAX)
        pair_t, best_c = t_masked.min(dim=-1)                       # first lane on ties
        take = lambda a: a.gather(-1, best_c[..., None])[..., 0]
        pair_hit = (pair_t < F32_MAX) & valid
        pair_tri = btm.gather(1, best_c)                            # (gb, br)
        parts.append((ray[pair_hit], _enc_t(pair_t[pair_hit]), pair_tri[pair_hit],
                      take(u)[pair_hit], take(v)[pair_hit]))
    if any_hit:
        return occ

    # ---- one reduction: per ray the least t, then the first pair at it
    cat = lambda i, dt: (torch.cat([p[i] for p in parts]) if parts
                         else torch.empty((0,), dtype=dt, device=dev))
    tgt, t_enc = cat(0, torch.int64), cat(1, torch.int64)
    p_tri, p_u, p_v = cat(2, torch.int32), cat(3, torch.float32), cat(4, torch.float32)
    best_enc = torch.full((m,), _MISS, dtype=torch.int64, device=dev)
    best_enc.scatter_reduce_(0, tgt, t_enc, reduce="amin")
    winner = t_enc == best_enc[tgt]
    pair_idx = torch.arange(tgt.shape[0], device=dev)
    first = torch.full((m,), tgt.shape[0], dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, tgt[winner], pair_idx[winner], reduce="amin")
    has = first < tgt.shape[0]
    w = first.clamp(max=max(tgt.shape[0] - 1, 0))
    pick = lambda a, miss: (torch.where(has, a[w], miss) if tgt.shape[0]
                            else torch.full((m,), miss, dtype=a.dtype, device=dev))
    out_tri = pick(p_tri, -1).to(torch.int32)
    out_u = pick(p_u, 0.0)
    out_v = pick(p_v, 0.0)
    out_hit = (best_enc != _MISS) & (out_tri >= 0)
    out_t = torch.where(out_hit, best_enc.to(torch.int32).view(torch.float32), F32_MAX)
    return out_t, out_tri, out_u, out_v, out_hit, dropped


def _default_budget(scene, chunk: int, block_rays: int) -> int:
    """Block budget: the exact worst case (every ray in every cluster)
    capped by an average of 32 candidate clusters per ray (the JAX rule)."""
    k = scene.num_clusters
    worst = k * ((chunk + block_rays - 1) // block_rays)
    avg = k + (32 * chunk) // block_rays
    return max(GROUP_BLOCKS, min(worst, avg))


def _chunks(scene, origin, t_min, t_max, chunk, block_rays, block_budget):
    n = origin.shape[0]
    dev = origin.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    chunk = min(chunk, max(n, 1))
    budget = block_budget or _default_budget(scene, chunk, block_rays)
    return t_min, t_max, chunk, budget


def traverse_clusters(scene, origin, direction, t_min, t_max, active,
                      block_rays: int = 1024, block_budget: int = 0,
                      chunk: int = 65536, return_dropped: bool = False):
    """Closest hit through the cluster dispatch pipeline -> HitRecord, or
    (HitRecord, pairs dropped past the block budget) with return_dropped."""
    _check_scene(scene)
    t_min, t_max, chunk, budget = _chunks(scene, origin, t_min, t_max, chunk,
                                          block_rays, block_budget)
    outs, dropped = [], 0
    for r0 in range(0, origin.shape[0], chunk):
        r = slice(r0, r0 + chunk)
        *res, dr = _chunk_trace(scene, origin[r], direction[r], t_min[r], t_max[r],
                                active[r], block_rays, budget, any_hit=False)
        outs.append(res)
        dropped += dr
    if outs:
        t, tri, u, v, hit = (torch.cat(x) for x in zip(*outs))
    else:
        t = u = v = torch.empty((0,), dtype=torch.float32, device=origin.device)
        tri = torch.empty((0,), dtype=torch.int32, device=origin.device)
        hit = torch.empty((0,), dtype=torch.bool, device=origin.device)
    hits = HitRecord(t=t, tri_index=tri, u=u, v=v, is_hit=hit)
    return (hits, dropped) if return_dropped else hits


def occlusion_clusters(scene, origin, direction, t_min, t_max, active,
                       block_rays: int = 1024, block_budget: int = 0,
                       chunk: int = 65536) -> torch.Tensor:
    """Any-hit (shadow) trace: (N,) bool occluded."""
    _check_scene(scene)
    t_min, t_max, chunk, budget = _chunks(scene, origin, t_min, t_max, chunk,
                                          block_rays, block_budget)
    occ = [_chunk_trace(scene, origin[r0:r0 + chunk], direction[r0:r0 + chunk],
                        t_min[r0:r0 + chunk], t_max[r0:r0 + chunk], active[r0:r0 + chunk],
                        block_rays, budget, any_hit=True)
           for r0 in range(0, origin.shape[0], chunk)]
    return torch.cat(occ) if occ else torch.zeros((0,), dtype=torch.bool,
                                                  device=origin.device)
