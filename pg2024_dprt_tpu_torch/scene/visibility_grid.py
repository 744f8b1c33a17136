"""Visibility grids (counterpart of pg2024_dprt_tpu/scene/visibility_grid.py).

A grid has 6 faces x (height x width) cells x `angle` azimuth bins over a
box: a ray entering the box maps to (entry face, face cell, azimuth bin of
its direction re-oriented so the face axis leads), and the bin says whether
anything may be hit through that entry.

* The sampled grid (`build_visibility_grid`, `query_visibility`) casts
  random entry rays at the geometry (train/datagen.py's sampler and trace)
  and marks the bins of the rays that hit: a cheap predictor, not a
  guarantee, since an unsampled ray may hit through an unmarked bin.
* The conservative grid (`build_conservative_grid`) marks a (face, cell,
  bin) when any ray entering the box through that cell rectangle with that
  azimuth can reach any content box (triangle or instance-cluster boxes);
  every real hit's entry lands in a marked bin, so a ray whose entry bin is
  unmarked provably hits nothing there. The migration loop and the ring
  shadow test skip such partitions (parallel/distributed.py,
  parallel/exchange.py) and the image stays exact. It is built in host
  numpy, as in JAX, and equals JAX's bit for bit; the lookup
  `query_conservative_grids` is PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class VisibilityGrid(NamedTuple):
    """One object's sampled grid; index = face * (W * H * A) + cell * A +
    angle bin, cell = row * W + col (the conservative grid's (6, H, W, A)
    layout, flattened)."""

    grid: torch.Tensor      # (6 * W * H * A,) bool
    aabb_min: torch.Tensor  # (3,)
    aabb_max: torch.Tensor  # (3,)
    width: int
    height: int
    angle: int


def _face_and_cell(aabb_min, aabb_max, point, direction, width, height, angle):
    """Flat grid index of box surface points and directions (N,): the face
    is the nearest face plane (0/1 = -x/+x, 2/3 = -y/+y, 4/5 = -z/+z), the
    cell the point's (row, col) on it, the bin the azimuth of the direction
    re-oriented so that the face axis leads."""
    span = torch.clamp(aabb_max - aabb_min, min=1e-12)
    rel = (point - aabb_min) / span
    d_face = torch.stack([rel[:, 0], 1 - rel[:, 0], rel[:, 1], 1 - rel[:, 1], rel[:, 2],
                          1 - rel[:, 2]], dim=-1)
    face = torch.argmin(d_face, dim=-1)
    axis = face // 2
    col = torch.where(axis == 0, rel[:, 1], torch.where(axis == 1, 1 - rel[:, 0], rel[:, 1]))
    row = torch.where(axis == 2, rel[:, 0], 1 - rel[:, 2])
    ci = (col * width).to(torch.int32).clamp(0, width - 1).long()
    ri = (row * height).to(torch.int32).clamp(0, height - 1).long()
    cell = ri * width + ci

    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    sgn = lambda c: torch.where(c > 0, 1.0, -1.0)
    du = torch.where(axis == 0, sgn(dx) * dy, torch.where(axis == 1, sgn(dy) * dz, sgn(dz) * dx))
    dv = torch.where(axis == 0, sgn(dx) * dz, torch.where(axis == 1, sgn(dy) * dx, sgn(dz) * dy))
    phi = torch.atan2(dv, du)
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    ab = (phi / (2 * math.pi) * angle).to(torch.int32).clamp(0, angle - 1).long()
    return face * (width * height * angle) + cell * angle + ab


def grid_from_rays(scene, aabb_min, aabb_max, origin, direction, width: int = 16,
                   height: int = 16, angle: int = 8, eps: float = 1e-4) -> VisibilityGrid:
    """The sampled grid of the entry rays (origin on the box's surface)
    traced against `scene` on its device (train/datagen.py trace_labels,
    in batches of its BATCH rays): a bin is marked when a ray entering
    through it hits."""
    from ..train.datagen import BATCH, trace_labels

    dev = scene.cl_boxes.device
    lo = torch.as_tensor(np.asarray(aabb_min, np.float32), device=dev)
    hi = torch.as_tensor(np.asarray(aabb_max, np.float32), device=dev)
    origin, direction = origin.to(dev), direction.to(dev)
    grid = torch.zeros((6 * width * height * angle,), dtype=torch.bool, device=dev)
    for s in range(0, origin.shape[0], BATCH):
        o, d = origin[s:s + BATCH], direction[s:s + BATCH]
        _, is_hit = trace_labels(scene, o, d, eps)
        idx = _face_and_cell(lo, hi, o, d, width, height, angle)
        grid[idx[is_hit]] = True
    return VisibilityGrid(grid, lo, hi, width, height, angle)


def build_visibility_grid(scene, aabb_min, aabb_max, width: int = 16, height: int = 16,
                          angle: int = 8, samples: int = 200_000,
                          seed: int = 0) -> VisibilityGrid:
    """Cast `samples` random entry rays (train/datagen.py's sampler, a CPU
    torch.Generator seeded with `seed`, so every device draws the same
    rays) at the object's geometry and mark the bins of the rays that hit."""
    from ..train.datagen import _sample_entry_rays

    gen = torch.Generator().manual_seed(int(seed))
    o, d = _sample_entry_rays(gen, aabb_min, aabb_max, samples)
    return grid_from_rays(scene, aabb_min, aabb_max, o, d, width, height, angle)


def query_visibility(vg: VisibilityGrid, origin, direction, t_enter):
    """For (N,) rays entering the box at parameter t_enter: True = something
    may be hit through that entry (up to the grid's resolution and sampling)."""
    point = origin + t_enter[:, None] * direction
    idx = _face_and_cell(vg.aabb_min, vg.aabb_max, point, direction,
                         vg.width, vg.height, vg.angle)
    return vg.grid[idx]


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
