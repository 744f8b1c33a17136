"""Streaming pair tracer (counterpart of pg2024_dprt_tpu/ops/pallas_tracer.py).

The JAX package retired this tracer from its tracer API: its tile-interval
cull misses corner-edge rays that the dropped-pair count cannot see. It
stays there as a study module with its own tests, reached through
trace_api._pallas_escalating; the port keeps it the same way
(ops/trace_api.py::_pairs_escalating) and reproduces its results, misses
included.

Pipeline (the host prep is plain PyTorch, as it is plain XLA in JAX):
  0. optionally the rays are sorted by `morton_key` (ops/resident.py) so
     tiles of `tile_rays` consecutive rays are spatially coherent;
  1. `interval_cull`: a conservative interval-arithmetic slab test of every
     (tile, cluster) pair; `prep_pairs` lays the survivors out as a global
     pool of slots, each tile a contiguous pp-aligned region ordered front
     to back by conservative enter distance (stable sorts: the slot order
     decides ties at equal t across clusters). Tiles that do not fit the
     static budget are reported (`dropped`) and forced to miss;
  2. the kernels (csrc/pair_trace.cu), each a walk split across the card
     into warps of 32 rays x a share of each cluster's triangles x a piece
     of the region: K11 `pair_closest` (replaces pallas_tracer.py::_kernel)
     or K13 `pair_woop` (_woop_kernel), merged per ray by a 64-bit atomic
     min, then a resolve pass; K12 `pair_anyhit` (_occl_kernel), a lane a
     triangle that tests the warp's open rays in turn: a ray is dropped
     once it is occluded (its byte of the output, which the other warps
     read) and skips the slots whose cluster box its segment misses.

Beside each kernel is its plain PyTorch version, which computes the same
function densely: for each slot index r, every tile's r-th slot gets the
same Moller-Trumbore (or Woop) arithmetic in the same order, with the same
strict improvement and no horizon skip. A wrapper runs the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. `LAUNCHES` (ops/resident.py) counts the launches of each wrapper.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.math import safe_inv
from ..core.types import HitRecord
from ..utils.timing import launch_span
from . import _build
from .resident import (F32_MAX, LAUNCHES, _check, _checked, _ptr, _stream, morton_key,
                       unsorted)

TILE_RAYS = 512     # rays per tile (TM)
REGION = 32         # average pair slots per tile (S), a multiple of PP
PAIRS_PER_STEP = 4  # PP: regions are PP-aligned


class PairList(NamedTuple):
    """The pair pool of one trace, as JAX's _prep_pairs returns it
    (pair_tile, pair_cluster, pair_flags, pair_enter, tile_fit, dropped),
    plus each tile's region (offset, slots) that the kernels walk."""

    pair_tile: torch.Tensor     # (budget,) i32 tile of each slot
    pair_cluster: torch.Tensor  # (budget,) i32 cluster of each slot
    pair_flags: torch.Tensor    # (budget,) i32 bit 0 init, bit 1 pair present
    pair_enter: torch.Tensor    # (budget,) i32 conservative enter distance bits
    tile_fit: torch.Tensor      # (T,) bool
    dropped: torch.Tensor       # () i64 pairs past the budget
    tile_offset: torch.Tensor   # (T,) i32 first slot of the tile's region
    tile_region: torch.Tensor   # (T,) i32 slots of the region

    @property
    def budget(self) -> int:
        return self.pair_cluster.shape[0]


def interval_cull(scene, o, d, t_max, active, tiles: int, tile_rays: int):
    """Conservative tile x cluster slab test (never culls a possible hit in
    exact arithmetic). Returns ((T, K) bool possible, (T, K) f32 enter_lo)."""
    k = scene.num_clusters
    tr = lambda a: a.reshape(tiles, tile_rays)
    inv = safe_inv(d)
    act_any = tr(active).any(dim=1)
    tmax_hi = tr(torch.where(active, t_max, 0.0)).amax(dim=1)
    enter_lo = torch.zeros((tiles, k), dtype=torch.float32, device=o.device)
    exit_hi = torch.full((tiles, k), F32_MAX, dtype=torch.float32, device=o.device)
    for ax in range(3):
        o_l, o_h = tr(o[:, ax]).amin(dim=1)[:, None], tr(o[:, ax]).amax(dim=1)[:, None]
        i_l, i_h = tr(inv[:, ax]).amin(dim=1)[:, None], tr(inv[:, ax]).amax(dim=1)[:, None]
        cmin = scene.cl_aabb_min[None, :, ax]
        cmax = scene.cl_aabb_max[None, :, ax]
        prods = []
        for b_l, b_h in ((cmin - o_h, cmin - o_l), (cmax - o_h, cmax - o_l)):
            for iv in (i_l, i_h):
                prods += [b_l * iv, b_h * iv]
        lo_all, hi_all = prods[0], prods[0]
        for q in prods[1:]:
            lo_all = torch.minimum(lo_all, q)
            hi_all = torch.maximum(hi_all, q)
        enter_lo = torch.maximum(enter_lo, lo_all)
        exit_hi = torch.minimum(exit_hi, hi_all)
    possible = (act_any[:, None] & (scene.cl_count > 0)[None, :] & (enter_lo <= exit_hi)
                & (exit_hi > 0.0) & (enter_lo < tmax_hi[:, None]))
    return possible, enter_lo


def prep_pairs(possible, enter_lo, tiles: int, budget: int, pp: int) -> PairList:
    """The global-pool pair list: each tile owns a contiguous pp-aligned
    region sized to its candidate count (at least pp, so every tile has an
    init slot), its clusters ranked by conservative enter distance with a
    stable sort. Slots past `budget` are dropped and counted; a tile whose
    first step does not fit is reported in tile_fit."""
    dev = possible.device
    k = possible.shape[1]
    i32 = lambda x: x.to(torch.int32)
    counts = possible.sum(dim=1)
    region = pp * torch.clamp(-(-counts // pp), min=1)
    offsets = torch.cumsum(region, dim=0) - region
    tile_fit = offsets + pp <= budget
    enter_key = torch.where(possible, enter_lo, F32_MAX)
    order = torch.argsort(enter_key, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(k, device=dev).expand(tiles, k))
    slot = torch.where(possible, offsets[:, None] + rank, budget).clamp(max=budget)
    keep = slot < budget
    pair_cluster = torch.zeros((budget,), dtype=torch.int32, device=dev)
    pair_flags = torch.zeros((budget,), dtype=torch.int32, device=dev)
    pair_enter = torch.zeros((budget,), dtype=torch.int32, device=dev)
    pair_cluster[slot[keep]] = i32(torch.arange(k, device=dev).expand(tiles, k)[keep])
    pair_flags[slot[keep]] = 2
    pair_enter[slot[keep]] = enter_lo.clamp(min=0.0).view(torch.int32)[keep]
    pair_flags[offsets[tile_fit]] += 1
    ends = offsets + region
    pair_tile = torch.searchsorted(ends, torch.arange(budget, device=dev), right=True)
    dropped = (possible & (slot >= budget)).sum()
    return PairList(i32(pair_tile.clamp(max=tiles - 1)), pair_cluster, pair_flags, pair_enter,
                    tile_fit, dropped, i32(offsets), i32(region))


def scene_exit_cap(scene, o, d, t_max):
    """Each ray's bound capped at its scene-box exit: no hit lies beyond it,
    and it keeps escaping rays from pinning a tile's horizon at +inf."""
    inv = safe_inv(d)
    tt0 = (scene.scene_aabb[0] - o) * inv
    tt1 = (scene.scene_aabb[1] - o) * inv
    scene_exit = torch.maximum(tt0, tt1).amin(dim=-1)
    return torch.minimum(t_max, torch.clamp(scene_exit, min=0.0) * 1.001 + 1e-4)


def _check_scene(scene, woop: bool):
    if scene.instanced:
        raise ValueError("the pair tracer traces flat scenes only; an instanced "
                         "scene's triangle tables are its base geometry's")
    if (scene.cl_woop_table if woop else scene.cl_tri_table) is None:
        raise ValueError("the scene carries no pair-tracer table")


class PairTrace(NamedTuple):
    """What the kernels of one trace read: the packed rays (tiles *
    tile_rays, 8) [o, d, tmin, tmax] (inactive and padding rays closed:
    tmin = F32_MAX, tmax = 0; tmax capped at the scene exit), the pair list,
    the (T, K) cull it was cut from, and the wavefront order (perm, None
    unless sorted; active in that order)."""

    packed: torch.Tensor
    pairs: PairList
    possible: torch.Tensor
    perm: torch.Tensor
    active: torch.Tensor


def prepare_pairs(scene, origin, direction, t_min, t_max, active,
                  tile_rays: int = TILE_RAYS, region: int = REGION,
                  pairs_per_step: int = PAIRS_PER_STEP,
                  sort_rays: bool = False) -> PairTrace:
    """The host prep of trace_pairs: optional Morton sort, padding to whole
    tiles, the interval cull, the pair list for a budget of `region`
    average slots per tile, the packed rays."""
    n = origin.shape[0]
    dev = origin.device
    tm, pp = tile_rays, pairs_per_step
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    rays = (origin, direction, t_min, t_max, active)
    perm = None
    if sort_rays:
        key = torch.where(active, morton_key(scene, origin, direction), 0xFFFFFFFF)
        perm = torch.sort(key, stable=True)[1]
        rays = tuple(x[perm] for x in rays)
    pad = (-n) % tm
    o, d, tmin, tmax, act = (
        torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])
        for x, fill in zip(rays, (0.0, 1.0, 0.0, 0.0, False)))
    tiles = (n + pad) // tm
    budget = -(-(tiles * region) // pp) * pp
    possible, enter_lo = interval_cull(scene, o, d, tmax, act, tiles, tm)
    packed = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                          torch.where(act, tmin, F32_MAX),
                          torch.where(act, scene_exit_cap(scene, o, d, tmax), 0.0)], dim=-1)
    return PairTrace(packed, prep_pairs(possible, enter_lo, tiles, budget, pp), possible,
                     perm, rays[4])


def trace_pairs(scene, origin, direction, t_min, t_max, active,
                tile_rays: int = TILE_RAYS, region: int = REGION,
                pairs_per_step: int = PAIRS_PER_STEP, sort_rays: bool = False,
                woop: bool = False, any_hit: bool = False):
    """Closest hit -> (HitRecord, dropped), or with any_hit=True ((N,) bool
    occluded, dropped); dropped is the count of (tile, cluster) pairs past
    the budget of `region` average slots per tile (their tiles report
    misses). t_min / t_max are scalars or (N,). any_hit ignores woop (the
    occlusion kernel is Moller-Trumbore), as in JAX."""
    if any_hit:
        woop = False
    _check_scene(scene, woop)
    n = origin.shape[0]
    prep = prepare_pairs(scene, origin, direction, t_min, t_max, active, tile_rays, region,
                         pairs_per_step, sort_rays)
    dropped = int(prep.pairs.dropped)
    if any_hit:
        occ = pair_anyhit(scene, prep.packed, prep.pairs, tile_rays)[:n] & prep.active
        return (occ if prep.perm is None else unsorted(occ, prep.perm)), dropped
    kern = pair_woop if woop else pair_closest
    t, tri, u, v = kern(scene, prep.packed, prep.pairs, tile_rays)
    is_hit = (tri[:n] >= 0) & prep.active
    hits = HitRecord(t=torch.where(is_hit, t[:n], F32_MAX),
                     tri_index=torch.where(is_hit, tri[:n], -1), u=u[:n], v=v[:n],
                     is_hit=is_hit)
    if prep.perm is not None:
        hits = HitRecord(*(unsorted(x, prep.perm) for x in hits))
    return hits, dropped


# --------------------------------------------------------------------------
# kernel wrappers

def pair_closest(scene, packed, pairs: PairList, tile_rays: int):
    """(t, tri, u, v) of every packed ray by Moller-Trumbore over its tile's
    pair slots: K11 for CUDA tensors, the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return pair_trace_plain(scene, packed, pairs, tile_rays)
    return _launch("pair_closest", scene, packed, pairs, tile_rays)


def pair_woop(scene, packed, pairs: PairList, tile_rays: int):
    """The same by the Woop unit-space test over cl_woop_table: K13 for
    CUDA tensors, the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return pair_trace_plain(scene, packed, pairs, tile_rays, mode="woop")
    return _launch("pair_woop", scene, packed, pairs, tile_rays)


def pair_anyhit(scene, packed, pairs: PairList, tile_rays: int) -> torch.Tensor:
    """(mp,) bool occluded of every packed ray: K12 for CUDA tensors, the
    plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return pair_trace_plain(scene, packed, pairs, tile_rays, mode="anyhit")
    return _launch("pair_anyhit", scene, packed, pairs, tile_rays)


def pair_walk_tests(scene, packed, pairs: PairList, tile_rays: int, woop: bool = False,
                    any_hit: bool = False) -> int:
    """The ray-triangle tests that K11's walk (K13's with woop=True, K12's
    with any_hit=True) runs on these inputs: one launch with the kernel's
    counter on. K11 / K13 count lanes x triangles of each walked chunk, K12
    open rays x triangles. CUDA tensors only."""
    counters = torch.zeros(1, dtype=torch.int64, device=packed.device)
    name = "pair_anyhit" if any_hit else "pair_woop" if woop else "pair_closest"
    _launch(name, scene, packed, pairs, tile_rays, counters)
    return int(counters[0])


def _launch(name, scene, packed, pairs: PairList, tile_rays: int, counters=None):
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"rays on {dev}: the kernels take CUDA tensors")
    if tile_rays % 32 or not 32 <= tile_rays <= 1024:
        raise ValueError(f"tile_rays {tile_rays}: the kernels take a multiple of 32 "
                         "up to 1024 (the JAX tracer's tiles; a warp walks 32 rays)")
    mp = packed.shape[0]
    if mp % tile_rays:
        raise ValueError(f"{mp} packed rays are not whole tiles of {tile_rays}")
    with launch_span(name, mp):
        woop = name == "pair_woop"
        _check_scene(scene, woop)
        tiles, k, c = mp // tile_rays, scene.num_clusters, scene.tris_per_cluster
        if k * c >= 2**31 or mp >= 2**31:
            raise ValueError("slot or ray count exceeds int32")
        table = _checked("cl_woop_table" if woop else "cl_tri_table",
                         scene.cl_woop_table if woop else scene.cl_tri_table,
                         torch.float32, (k, (16 if woop else 10) * c), dev)
        b = pairs.budget
        # held until the launch is enqueued (a contiguous copy would otherwise be
        # freed before the kernel reads it)
        ins = [_checked(f, getattr(pairs, f), dt, shape, dev) for f, dt, shape in (
            ("tile_offset", torch.int32, (tiles,)), ("tile_region", torch.int32, (tiles,)),
            ("tile_fit", torch.bool, (tiles,)), ("pair_cluster", torch.int32, (b,)),
            ("pair_flags", torch.int32, (b,)), ("pair_enter", torch.int32, (b,)))]
        rays = _checked("packed rays", packed, torch.float32, (mp, 8), dev)
        args = [_ptr(rays), tiles, tile_rays, *map(_ptr, ins), b, _ptr(table)]
        count = None if counters is None else _ptr(counters)
        if name == "pair_anyhit":
            boxes = [_checked(f, getattr(scene, f), torch.float32, (k, 3), dev)
                     for f in ("cl_aabb_min", "cl_aabb_max")]
            occ = torch.empty(mp, dtype=torch.bool, device=dev)  # zeroed by the entry
            rc = _lib().pair_anyhit(*args, c, *map(_ptr, boxes), count, _ptr(occ), _stream(packed))
            out = occ
        else:
            tri_map = _checked("cl_tri_map", scene.cl_tri_map, torch.int32, (k * c,), dev)
            t = torch.empty(mp, dtype=torch.float32, device=dev)
            u, v = torch.empty_like(t), torch.empty_like(t)
            tri = torch.empty(mp, dtype=torch.int32, device=dev)
            keys = torch.empty(mp, dtype=torch.int64, device=dev)  # the walk's scratch
            rc = getattr(_lib(), name)(*args, _ptr(tri_map), c, _ptr(keys), count, _ptr(t),
                                       _ptr(tri), _ptr(u), _ptr(v), _stream(packed))
            out = (t, tri, u, v)
        _check(rc, name)
        if mp:
            LAUNCHES[name] += 1
    return out


def _lib():
    lib = _build.load("pair_trace")
    if not getattr(lib, "_pg_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p, i, i, p, p, p, p, p, p, i, p]  # rays .. budget, table
        closest = head + [p, i, p, p, p, p, p, p, p]
        lib.pair_closest.argtypes = closest
        lib.pair_woop.argtypes = closest
        lib.pair_anyhit.argtypes = head + [i, p, p, p, p, p]
        for fn in (lib.pair_closest, lib.pair_woop, lib.pair_anyhit):
            fn.restype = i
        lib._pg_typed = True
    return lib


# --------------------------------------------------------------------------
# plain PyTorch version (the kernels' function, densely, slot index by slot
# index over all tiles; no horizon skip)

def _mt(rows, c, o, d, tmin):
    """Moller-Trumbore of the rays (T, TM, 3) against each tile's staged
    cl_tri_table row (T, 10*C), in the kernels' order: ((T, TM, C) t, u, v,
    accepted-without-tmax)."""
    comp = lambda j: rows[:, None, j * c:(j + 1) * c]
    t0x, t0y, t0z = comp(0), comp(1), comp(2)
    e1x, e1y, e1z = comp(3) - t0x, comp(4) - t0y, comp(5) - t0z
    e2x, e2y, e2z = comp(6) - t0x, comp(7) - t0y, comp(8) - t0z
    ox, oy, oz = (o[:, :, i, None] for i in range(3))
    dx, dy, dz = (d[:, :, i, None] for i in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tx, ty, tz = ox - t0x, oy - t0y, oz - t0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    inside = ok & (comp(9) >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
    return t, u, v, inside


def _woop(rows, c, o, d, tmin):
    """The Woop unit-space test of the rays against each tile's staged
    cl_woop_table row (T, 16*C), explicit sums in the kernel's order."""
    w = lambda r, q: rows[:, None, r * 4 * c + q * c:r * 4 * c + (q + 1) * c]
    ox, oy, oz = (o[:, :, i, None] for i in range(3))
    dx, dy, dz = (d[:, :, i, None] for i in range(3))
    op = [ox * w(0, q) + oy * w(1, q) + oz * w(2, q) + w(3, q) for q in range(3)]
    dp = [dx * w(0, q) + dy * w(1, q) + dz * w(2, q) for q in range(3)]
    dz_ok = dp[2].abs() > 1e-12
    inv_dz = torch.where(dz_ok, 1.0 / torch.where(dz_ok, dp[2], 1.0), 0.0)
    t = -op[2] * inv_dz
    u = op[0] + t * dp[0]
    v = op[1] + t * dp[1]
    eps = 1e-5
    inside = (dz_ok & (w(3, 3) >= 0.0) & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
              & (t > tmin))
    return t, u, v, inside


def pair_trace_plain(scene, packed, pairs: PairList, tile_rays: int, mode: str = "closest"):
    """Plain version of K11 (mode "closest"), K12 ("anyhit") and K13
    ("woop"): (t, tri, u, v) or (mp,) bool occluded per packed ray."""
    dev = packed.device
    mp = packed.shape[0]
    tiles = mp // tile_rays
    c = scene.tris_per_cluster
    rays = packed.view(tiles, tile_rays, 8)
    o, d = rays[..., 0:3], rays[..., 3:6]
    tmin, tmax = rays[..., 6:7], rays[..., 7]
    table = scene.cl_woop_table if mode == "woop" else scene.cl_tri_table
    test = _woop if mode == "woop" else _mt
    best_t = tmax.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_slot = torch.full(best_t.shape, -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(best_t.shape, dtype=torch.bool, device=dev)
    start = pairs.tile_offset.long()
    length = torch.where(pairs.tile_fit, torch.clamp(
        start + pairs.tile_region.long(), max=pairs.budget) - start, 0)
    steps = int(length.max()) if tiles else 0
    for r in range(steps):
        s = torch.where(r < length, start + r, 0)
        take = (r < length) & ((pairs.pair_flags[s] & 2) != 0)
        if not bool(take.any()):
            continue
        cl = pairs.pair_cluster[s].long()
        t, u, v, inside = test(table[cl], c, o, d, tmin)
        inside = inside & take[:, None, None]
        if mode == "anyhit":
            occ |= (inside & (t < tmax[..., None])).any(dim=-1)
            continue
        tm, j = torch.where(inside & (t < best_t[..., None]), t, F32_MAX).min(dim=-1)
        better = tm < best_t                  # the first lane at the least t
        best_t = torch.where(better, tm, best_t)
        best_u = torch.where(better, u.gather(-1, j[..., None])[..., 0], best_u)
        best_v = torch.where(better, v.gather(-1, j[..., None])[..., 0], best_v)
        best_slot = torch.where(better, cl[:, None] * c + j, best_slot)
    fit = pairs.tile_fit[:, None]
    if mode == "anyhit":
        return (occ & fit).reshape(mp)
    tri = torch.where(best_slot >= 0, scene.cl_tri_map[best_slot.clamp(min=0)], -1)
    flat = lambda a: a.reshape(mp)
    return (flat(torch.where(fit, best_t, 0.0)), flat(tri.to(torch.int32)),
            flat(best_u), flat(best_v))
