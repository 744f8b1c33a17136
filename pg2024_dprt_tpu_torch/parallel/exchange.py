"""Path migration between partitions (counterpart of
pg2024_dprt_tpu/parallel/exchange.py).

`exchange_paths` is one round of the migration: every partition groups the
paths that want to move by destination (one stable sort,
ops/compaction.py), posts its per-destination demand, receives a grant from
each destination bounded by that destination's free rows, ships the granted
rows in fixed-size buckets through the mesh's `all_to_all`, and merges what
stays with what arrives. Denied rows stay valid where they are and retry in
the next round, so no path is dropped and the merge always fits the fixed
buffer. The handshake, the bucket slots and the merge order (staying rows
first, then received rows in (sender, slot) order, then a stable compaction)
are JAX's, so the merged buffers equal JAX's row by row.

`ring_shadow_occlusion` is the exact distributed shadow test: a shadow ray
is occluded when any partition's local any-hit test says so. JAX rotates
the shadow buffers around a ring with `ppermute`, OR-ing in each hop's
test; on one device every partition tests all partitions' shadow rays in
one wavefront, which gives the same flags and the same counts.

Both work on the partitions' buffers as a list of PathStates (one per
partition, all of one capacity); the exchange stacks them along a leading
partition axis and moves rows only through `mesh.all_to_all`.
"""
from __future__ import annotations

import torch

from ..core.types import PathState
from ..ops.compaction import compact_by_key, counts_per_key, segment_offsets
from ..ops.trace_api import trace_occlusion_cutout as trace_occlusion
from ..scene.visibility_grid import query_conservative_grids


def _grid_gate(proxies, j: int, origin, direction, tmax, eps: float):
    """Rays that partition j must test: the segment meets its box and the
    grid bin it enters through is marked (or it starts inside the box)."""
    lo = proxies.aabb_min[j]
    hi = proxies.aabb_max[j]
    d = direction
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    t0 = (lo[None] - origin) * inv
    t1 = (hi[None] - origin) * inv
    t_near = torch.minimum(t0, t1)                       # (N, 3)
    t_enter = t_near.amax(dim=-1)
    t_exit = torch.maximum(t0, t1).amin(dim=-1)
    seg_hit = (t_exit >= t_enter.clamp(min=eps)) & (t_enter < tmax)
    vis = query_conservative_grids(
        proxies.vis_grid[j:j + 1], lo[None], hi[None], origin, direction,
        t_enter[:, None], t_near[:, None, :])[:, 0]
    return seg_hit & (vis | (t_enter <= eps))


def _stack(buffers) -> PathState:
    full = [b.with_routing() for b in buffers]
    return PathState(*(torch.stack(list(fs), dim=0) for fs in zip(*full)))


def _unstack(stacked: PathState, p: int):
    return [PathState(*(f[i] for f in stacked)) for i in range(p)]


def _rows(stacked: PathState, idx: torch.Tensor) -> PathState:
    """Per-partition row gather: out[p, i] = x[p, idx[p, i]]."""
    def take(x):
        ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
        return torch.gather(x, 1, ix)
    return PathState(*(take(f) for f in stacked))


def exchange_paths(mesh, buffers, bucket_size: int = 0):
    """One migration round over the mesh's partitions. `buffers` is a list
    of P PathStates of one capacity N; a valid path moves when its
    target_node is another partition.

    Returns (merged buffers, moved_now, still_waiting, arrivals): the three
    counts are (P,) int64 tensors, per partition the rows shipped this
    round, the rows that wanted to move and were denied (bucket full or
    receiver without free rows), and the rows received."""
    p = mesh.size
    n = buffers[0].capacity
    b = bucket_size or -(-n // p)
    paths = _stack(buffers)
    dev = paths.origin.device
    me = torch.arange(p, device=dev)[:, None]

    target = paths.target_node
    want_move = paths.is_valid & (target >= 0) & (target != me)

    # group by destination: one stable sort per partition
    perm, sorted_key, moving = compact_by_key(target, want_move)
    sorted_paths = _rows(paths, perm)
    counts = counts_per_key(target, want_move, p)                 # (s, d)
    offsets = segment_offsets(counts)
    dest = torch.where(moving, sorted_key, 0)
    idx_in_seg = torch.arange(n, device=dev)[None] - torch.gather(offsets, 1, dest)

    # demand/allowance handshake: a receiver grants at most its free rows
    # (not counting its own departures this round), senders in rank order
    demand = counts.clamp(max=b)
    demand_from = mesh.all_to_all(demand)                         # (d, s)
    free = (n - paths.is_valid.sum(dim=1)).clamp(min=0)
    before = torch.cumsum(demand_from, dim=1) - demand_from
    grant_to = torch.minimum((free[:, None] - before).clamp(min=0), demand_from)
    allow = mesh.all_to_all(grant_to)                             # (s, d)

    send_ok = moving & (idx_in_seg < torch.gather(allow, 1, dest))
    slot = torch.where(send_ok, dest * b + idx_in_seg, p * b)     # denied -> pad row
    rows = me.expand(p, n)

    def scatter(x):
        buf = torch.zeros((p, p * b + 1) + x.shape[2:], dtype=x.dtype, device=dev)
        buf[rows, slot] = x
        return buf[:, : p * b]

    send = PathState(*(scatter(f) for f in sorted_paths))
    send = send._replace(is_valid=send.is_valid & scatter(send_ok))
    recv = PathState(*(
        mesh.all_to_all(f.reshape((p, p, b) + f.shape[2:])).reshape((p, p * b) + f.shape[2:])
        for f in send))

    # rows that left a partition become invalid there
    sent_orig = torch.zeros((p, n), dtype=torch.bool, device=dev)
    sent_orig[rows, perm] = send_ok
    stay = paths._replace(is_valid=paths.is_valid & ~sent_orig)

    # merge staying + received rows into the fixed buffer, valid rows first
    merged = PathState(*(torch.cat([a, c], dim=1) for a, c in zip(stay, recv)))
    mperm, _, _ = compact_by_key(torch.zeros_like(merged.target_node), merged.is_valid)
    merged = _rows(merged, mperm[:, :n])

    moved_now = send_ok.sum(dim=1)
    still_waiting = (want_move & ~sent_orig).sum(dim=1)
    arrivals = recv.is_valid.sum(dim=1)
    return _unstack(merged, p), moved_now, still_waiting, arrivals


def ring_shadow_occlusion(mesh, scenes, shadow_paths, eps: float, tracer: str = "auto",
                          proxies=None):
    """Exact distributed occlusion of every partition's shadow rays against
    every partition's geometry. `shadow_paths` is a list of P PathStates.

    With `proxies` carrying conservative visibility grids
    (ProxyTable.vis_grid), a partition skips the rays whose segment misses
    its box or enters it through an empty grid bin; the skipped rays are
    counted.

    Returns (shadow_paths, occluded flags per partition, diag,
    grid_culled)."""
    p = mesh.size
    sizes = [sp.capacity for sp in shadow_paths]
    cat = lambda xs: torch.cat(list(xs), dim=0)
    o = cat(sp.origin for sp in shadow_paths)
    d = cat(sp.direction for sp in shadow_paths)
    valid = cat(sp.is_valid for sp in shadow_paths)
    t_max_raw = cat(sp.tmax for sp in shadow_paths)
    t_max = t_max_raw * (1.0 - 1e-3)
    use_grids = proxies is not None and proxies.vis_grid is not None
    occ = torch.zeros_like(valid)
    diag, culled = 0, 0
    # every partition's local test is a hop of JAX's ring: trace with the
    # schedule sort, as its any-hit trace does by default
    for j in range(p):
        active = valid
        if use_grids:
            mask = _grid_gate(proxies, j, o, d, t_max_raw, eps)
            culled = culled + (valid & ~mask).sum()
            active = valid & mask
        hit, dg = trace_occlusion(scenes[j], o, d, eps, t_max, active, tracer=tracer,
                                  sort_rays=True)
        occ = occ | (hit & active)
        diag = diag + dg
    return shadow_paths, list(torch.split(occ, sizes)), diag, culled
