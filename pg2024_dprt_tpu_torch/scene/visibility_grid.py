"""Conservative visibility grids (counterpart of the conservative part of
pg2024_dprt_tpu/scene/visibility_grid.py): the exact-mode culling of
cross-partition work.

A partition's grid has 6 faces x (height x width) cells x `angle` azimuth
bins over the partition's box. `build_conservative_grid` marks a (face,
cell, bin) when any ray entering the box through that cell rectangle with
that azimuth can reach any content box (triangle or instance-cluster
boxes); every real hit's entry lands in a marked bin, so a ray whose entry
bin is unmarked provably hits nothing there. The migration loop and the
ring shadow test skip such partitions (parallel/distributed.py,
parallel/exchange.py) and the image stays exact.

The grid is built in host numpy, as in JAX, and equals JAX's bit for bit; the
lookup `query_conservative_grids` is PyTorch. (JAX's sampled grids,
`build_visibility_grid`, label rays by training-data generation, which is
not ported.)
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _face_frames():
    """Per face f (0..5): (axis, sign, u_axis, v_axis) of the du/dv azimuth
    frame: du = s * d_u, dv = s * d_v with s = +1 entering the -side."""
    return [
        (0, +1.0, 1, 2), (0, -1.0, 1, 2),
        (1, +1.0, 2, 0), (1, -1.0, 2, 0),
        (2, +1.0, 0, 1), (2, -1.0, 0, 1),
    ]


def _cell_rects(face: int, width: int, height: int):
    """Box-relative [0,1]^3 interval of every (row, col) cell rectangle of
    `face`. Returns (lo, hi), each (H*W, 3)."""
    axis = face // 2
    ci = np.arange(width)[None, :].repeat(height, 0).reshape(-1)
    ri = np.arange(height)[:, None].repeat(width, 1).reshape(-1)
    col_lo, col_hi = ci / width, (ci + 1) / width
    row_lo, row_hi = ri / height, (ri + 1) / height
    lo = np.zeros((height * width, 3))
    hi = np.zeros((height * width, 3))
    if axis == 0:      # col = rel_y, row = 1 - rel_z
        lo[:, 1], hi[:, 1] = col_lo, col_hi
        lo[:, 2], hi[:, 2] = 1 - row_hi, 1 - row_lo
    elif axis == 1:    # col = 1 - rel_x, row = 1 - rel_z
        lo[:, 0], hi[:, 0] = 1 - col_hi, 1 - col_lo
        lo[:, 2], hi[:, 2] = 1 - row_hi, 1 - row_lo
    else:              # col = rel_y, row = rel_x
        lo[:, 1], hi[:, 1] = col_lo, col_hi
        lo[:, 0], hi[:, 0] = row_lo, row_hi
    fc = 0.0 if face % 2 == 0 else 1.0
    lo[:, axis] = fc
    hi[:, axis] = fc
    return lo, hi


def build_conservative_grid(content_min, content_max, aabb_min, aabb_max,
                            width: int = 16, height: int = 16, angle: int = 16,
                            pad: float = 1e-3, rel_pad: float = 1e-5,
                            chunk: int = 4096) -> np.ndarray:
    """Analytic conservative grid of one partition: (6, H, W, A) bool, True
    where some entering ray may reach content.

    content_min/max: (T, 3) world boxes of the partition's content. `pad`
    widens azimuth arcs (radians) against rounding at their ends; `rel_pad`
    widens each cell rectangle in its plane, so an entry that rounds onto a
    cell or face edge lands in a marked bin of either face. Azimuths come
    from world-space deltas, as the lookup bins the world direction."""
    aabb_min = np.asarray(aabb_min, np.float64)
    aabb_max = np.asarray(aabb_max, np.float64)
    span = np.maximum(aabb_max - aabb_min, 1e-12)
    t_lo = (np.asarray(content_min, np.float64) - aabb_min) / span
    t_hi = (np.asarray(content_max, np.float64) - aabb_min) / span
    t_lo, t_hi = np.minimum(t_lo, t_hi), np.maximum(t_lo, t_hi)
    n_boxes = t_lo.shape[0]
    grid = np.zeros((6, height * width, angle), bool)
    if n_boxes == 0:
        return grid.reshape(6, height, width, angle)
    bins = np.arange(angle)

    for face, (axis, s, ua, va) in enumerate(_face_frames()):
        c_lo, c_hi = _cell_rects(face, width, height)
        pad_vec = np.full(3, rel_pad)
        pad_vec[axis] = 0.0  # the face-plane coordinate stays exact
        c_lo, c_hi = c_lo - pad_vec, c_hi + pad_vec
        for start in range(0, n_boxes, chunk):
            tl, th = t_lo[start:start + chunk], t_hi[start:start + chunk]
            # content - cell per axis, in world units: (C, Tc, 3)
            d_lo = (tl[None, :, :] - c_hi[:, None, :]) * span[None, None, :]
            d_hi = (th[None, :, :] - c_lo[:, None, :]) * span[None, None, :]
            # feasible: the direction's face-axis component has sign s
            feas = (s * d_hi[:, :, axis] if s > 0 else -d_lo[:, :, axis]) \
                >= -1e-9 * span[axis]
            if s > 0:
                du_lo, du_hi = d_lo[:, :, ua], d_hi[:, :, ua]
                dv_lo, dv_hi = d_lo[:, :, va], d_hi[:, :, va]
            else:
                du_lo, du_hi = -d_hi[:, :, ua], -d_lo[:, :, ua]
                dv_lo, dv_hi = -d_hi[:, :, va], -d_lo[:, :, va]
            full = (du_lo <= 0) & (0 <= du_hi) & (dv_lo <= 0) & (0 <= dv_hi)
            # corner azimuths; the arc is the complement of the widest gap
            cu = np.stack([du_lo, du_hi, du_lo, du_hi], -1)
            cv = np.stack([dv_lo, dv_lo, dv_hi, dv_hi], -1)
            th4 = np.arctan2(cv, cu)
            th4 = np.where(th4 < 0, th4 + 2 * np.pi, th4)
            th4 = np.sort(th4, axis=-1)
            gaps = np.diff(th4, axis=-1)
            wrap = (th4[..., 0] + 2 * np.pi - th4[..., 3])[..., None]
            gaps = np.concatenate([gaps, wrap], axis=-1)
            gi = np.argmax(gaps, axis=-1)
            arc_lo = np.take_along_axis(
                th4, ((gi + 1) % 4)[..., None], axis=-1)[..., 0] - pad
            arc_len = 2 * np.pi - np.take_along_axis(
                gaps, gi[..., None], axis=-1)[..., 0] + 2 * pad
            arc_len = np.where(full, 2 * np.pi, arc_len)
            # bins overlapping [arc_lo, arc_lo + arc_len], circularly
            scale = angle / (2 * np.pi)
            b_lo = np.floor(arc_lo * scale).astype(np.int64)
            nb = np.minimum(
                np.ceil((arc_lo + arc_len) * scale).astype(np.int64) - b_lo + 1, angle)
            mark = ((bins[None, None, :] - b_lo[..., None]) % angle
                    < nb[..., None]) & feas[..., None]
            grid[face] |= mark.any(axis=1)
    return grid.reshape(6, height, width, angle)


def query_conservative_grids(vis_grid, aabb_min, aabb_max, origin, direction,
                             t_enter, t_near):
    """Batched lookup over N rays and P partitions.

    vis_grid (P, 6, H, W, A) bool; aabb_min/max (P, 3); origin/direction
    (N, 3); t_enter (N, P) the slab entry parameter; t_near (N, P, 3) the
    per-axis near-plane parameter (the entry face is the slab test's own).
    Returns (N, P) bool: True = the partition may produce a hit."""
    p, _, h, w, a = vis_grid.shape
    entry = origin[:, None, :] + t_enter[..., None] * direction[:, None, :]
    span = torch.clamp(aabb_max - aabb_min, min=1e-12)[None]
    rel = torch.clamp((entry - aabb_min[None]) / span, 0.0, 1.0)   # (N, P, 3)

    axis = torch.argmax(t_near, dim=-1)                             # (N, P)
    d = direction[:, None, :].expand(rel.shape)
    d_axis = torch.gather(d, -1, axis[..., None])[..., 0]
    face = axis * 2 + (d_axis < 0).to(torch.int64)

    rx, ry, rz = rel[..., 0], rel[..., 1], rel[..., 2]
    col = torch.where(axis == 0, ry, torch.where(axis == 1, 1 - rx, ry))
    row = torch.where(axis == 2, rx, 1 - rz)
    ci = (col * w).to(torch.int64).clamp(0, w - 1)
    ri = (row * h).to(torch.int64).clamp(0, h - 1)

    sgn = torch.where(d_axis >= 0, 1.0, -1.0)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    du = sgn * torch.where(axis == 0, dy, torch.where(axis == 1, dz, dx))
    dv = sgn * torch.where(axis == 0, dz, torch.where(axis == 1, dx, dy))
    phi = torch.atan2(dv, du)
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    ab = (phi / (2 * math.pi) * a).to(torch.int64).clamp(0, a - 1)

    pidx = torch.arange(p, device=face.device)[None, :]
    flat = (((pidx * 6 + face) * h + ri) * w + ci) * a + ab
    return vis_grid.reshape(-1)[flat]
