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
test. Here one `all_to_all` hands every partition all partitions' shadow
rays, each partition tests them in one wavefront (in sender order), and a
second `all_to_all` returns the flags to their senders, who OR them: the
same flags and counts, and the bytes of JAX's P - 1 hops.

Both work on the buffers of the partitions this process holds
(`mesh.local`) as a list of PathStates of one capacity; the exchange stacks
them along a leading axis and moves rows only through `mesh.all_to_all`,
every field of a row packed into one byte block (one collective for the
rows, not one a field).
"""
from __future__ import annotations

import math

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


def _pack(fields) -> torch.Tensor:
    """Tensors of one leading shape (L, R, ...) -> one uint8 block
    (L, R, bytes a row): each field's bytes side by side, bools as uint8."""
    lead = fields[0].shape[:2]
    return torch.cat([f.reshape(lead + (-1,)).contiguous().view(torch.uint8)
                      for f in fields], dim=-1)


def _unpack(block: torch.Tensor, like) -> list:
    """The inverse of _pack: tensors shaped as `like` (a field's trailing
    shape and dtype) on the block's leading two axes."""
    out, at = [], 0
    lead = tuple(block.shape[:2])
    for f in like:
        width = math.prod(f.shape[2:]) * f.element_size()
        part = block[..., at:at + width].contiguous().view(f.dtype)
        out.append(part.reshape(lead + tuple(f.shape[2:])))
        at += width
    return out


def _stack(buffers) -> PathState:
    full = [b.with_routing() for b in buffers]
    return PathState(*(torch.stack(list(fs), dim=0) for fs in zip(*full)))


def _unstack(stacked: PathState, count: int):
    return [PathState(*(f[i] for f in stacked)) for i in range(count)]


def _rows(stacked: PathState, idx: torch.Tensor) -> PathState:
    """Per-partition row gather: out[l, i] = x[l, idx[l, i]]."""
    def take(x):
        ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
        return torch.gather(x, 1, ix)
    return PathState(*(take(f) for f in stacked))


def exchange_paths(mesh, buffers, bucket_size: int = 0):
    """One migration round over the mesh's partitions. `buffers` is a list
    of the L PathStates this process holds (partitions `mesh.local`), of one
    capacity N; a valid path moves when its target_node is another
    partition.

    Returns (merged buffers, moved_now, still_waiting, arrivals): the three
    counts are (L,) int64 tensors, per local partition the rows shipped
    this round, the rows that wanted to move and were denied (bucket full or
    receiver without free rows), and the rows received."""
    p = mesh.size
    n = buffers[0].capacity
    b = bucket_size or -(-n // p)
    paths = _stack(buffers)
    dev = paths.origin.device
    count = len(buffers)
    me = torch.tensor(mesh.local, device=dev)[:, None]

    target = paths.target_node
    want_move = paths.is_valid & (target >= 0) & (target != me)

    # group by destination: one stable sort per partition
    perm, sorted_key, moving = compact_by_key(target, want_move)
    sorted_paths = _rows(paths, perm)
    counts = counts_per_key(target, want_move, p)                 # (l, d)
    offsets = segment_offsets(counts)
    dest = torch.where(moving, sorted_key, 0)
    idx_in_seg = torch.arange(n, device=dev)[None] - torch.gather(offsets, 1, dest)

    # demand/allowance handshake: a receiver grants at most its free rows
    # (not counting its own departures this round), senders in rank order
    demand = counts.clamp(max=b)
    demand_from = mesh.all_to_all(demand)                         # (l, s)
    free = (n - paths.is_valid.sum(dim=1)).clamp(min=0)
    before = torch.cumsum(demand_from, dim=1) - demand_from
    grant_to = torch.minimum((free[:, None] - before).clamp(min=0), demand_from)
    allow = mesh.all_to_all(grant_to)                             # (l, d)

    send_ok = moving & (idx_in_seg < torch.gather(allow, 1, dest))
    slot = torch.where(send_ok, dest * b + idx_in_seg, p * b)     # denied -> pad row
    rows = torch.arange(count, device=dev)[:, None].expand(count, n)

    def scatter(x):
        buf = torch.zeros((count, p * b + 1) + x.shape[2:], dtype=x.dtype, device=dev)
        buf[rows, slot] = x
        return buf[:, : p * b]

    send = PathState(*(scatter(f) for f in sorted_paths))
    send = send._replace(is_valid=send.is_valid & scatter(send_ok))
    block = _pack(list(send))                                     # (l, p * b, bytes)
    got = mesh.all_to_all(block.reshape(count, p, b, -1)).reshape(block.shape)
    recv = PathState(*_unpack(got, list(send)))

    # rows that left a partition become invalid there
    sent_orig = torch.zeros((count, n), dtype=torch.bool, device=dev)
    sent_orig[rows, perm] = send_ok
    stay = paths._replace(is_valid=paths.is_valid & ~sent_orig)

    # merge staying + received rows into the fixed buffer, valid rows first
    merged = PathState(*(torch.cat([a, c], dim=1) for a, c in zip(stay, recv)))
    mperm, _, _ = compact_by_key(torch.zeros_like(merged.target_node), merged.is_valid)
    merged = _rows(merged, mperm[:, :n])

    moved_now = send_ok.sum(dim=1)
    still_waiting = (want_move & ~sent_orig).sum(dim=1)
    arrivals = recv.is_valid.sum(dim=1)
    return _unstack(merged, count), moved_now, still_waiting, arrivals


def ring_shadow_occlusion(mesh, scenes, shadow_paths, eps: float, tracer: str = "auto",
                          proxies=None):
    """Exact distributed occlusion of every partition's shadow rays against
    every partition's geometry. `shadow_paths` is a list of the L
    PathStates this process holds, `scenes` the partitions' scenes by
    partition id (only those of `mesh.local` are read).

    With `proxies` carrying conservative visibility grids
    (ProxyTable.vis_grid), a partition skips the rays whose segment misses
    its box or enters it through an empty grid bin; the skipped rays are
    counted.

    Returns (shadow_paths, occluded flags per local partition, diag,
    grid_culled); diag and grid_culled count this process's tests."""
    p = mesh.size
    count = len(shadow_paths)
    n = shadow_paths[0].capacity
    fields = [torch.stack([getattr(sp, f) for sp in shadow_paths])
              for f in ("origin", "direction", "tmax", "is_valid")]
    # every local buffer to every partition: (l, p, n, bytes) -> (l, s, n, bytes)
    block = _pack(fields)
    got = mesh.all_to_all(block[:, None].expand(count, p, n, block.shape[-1]))
    o, d, t_max_raw, valid = _unpack(got.reshape(count, p * n, -1), fields)
    t_max = t_max_raw * (1.0 - 1e-3)
    use_grids = proxies is not None and proxies.vis_grid is not None
    occ, diag, culled = [], 0, 0
    # each partition's local test of all partitions' rays is a hop of JAX's
    # ring: traced with the schedule sort, as its any-hit trace does by default
    for i, j in enumerate(mesh.local):
        active = valid[i]
        if use_grids:
            mask = _grid_gate(proxies, j, o[i], d[i], t_max_raw[i], eps)
            culled = culled + (valid[i] & ~mask).sum()
            active = valid[i] & mask
        hit, dg = trace_occlusion(scenes[j], o[i], d[i], eps, t_max[i], active, tracer=tracer,
                                  sort_rays=True)
        occ.append(hit & active)
        diag = diag + dg
    # the flags back to their senders: (l, s, n) -> (l, d, n), OR over d
    back = mesh.all_to_all(torch.stack(occ).reshape(count, p, n))
    return shadow_paths, list(back.any(dim=1)), diag, culled
