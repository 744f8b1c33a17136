"""Analytic ray / round-cone (swept-sphere) intersection for curve primitives
(counterpart of pg2024_dprt_tpu/ops/curve_intersect.py).

Curves are flattened to round-cone pieces at build time (scene/curves.py),
and a ray wavefront is tested against the whole piece table densely, rays x
pieces, with branch-free closed-form math: a select over the side surface
and the two spherical caps. The operations are JAX's, in JAX's order, so
the flags, pieces, t and normals equal the JAX package's on the CPU.

Geometry: the convex hull of two spheres (p0, r0), (p1, r1). The side
surface is a quadratic once the axis is projected out; a cap hit counts
only where the cone side does not cover it.

The dense test is plain PyTorch on every device: in the JAX package it is
XLA outside any Pallas kernel. So that no (rows x pieces) intermediate grows
with the wavefront, the ray axis runs in chunks of at most `PAIR_BUDGET`
(ray, piece) pairs for the device; each ray's row is independent, so the
chunking changes no bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..scene.curves import CurveSet

F32_MAX = 3.402823466e38
# most (ray, piece) pairs one chunk of the dense test holds, by device type;
# each of a chunk's (rows, pieces) f32 intermediates is 4 bytes a pair: 64
# MiB on CUDA, where larger chunks mean fewer launches, and 4 MiB on the CPU,
# where chunks that stay in cache run several times faster
PAIR_BUDGET = {"cuda": 2 ** 24, "cpu": 2 ** 20}
# the profiler range around every call of the dense test: a profiled frame
# reads the test's share of the device time from it (chip_smoke.py phase 12)
CURVE_RANGE = "curve_test"


class CurveHit(NamedTuple):
    t: torch.Tensor        # (N,) f32
    piece: torch.Tensor    # (N,) i32 flattened piece index (-1 = miss)
    seg: torch.Tensor      # (N,) i32 source B-spline segment (-1 = miss)
    normal: torch.Tensor   # (N, 3) f32 outward surface normal at the hit
    is_hit: torch.Tensor   # (N,) bool


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sqrt(x):
    """Correctly rounded f32 square root: CUDA's is; PyTorch's vectorized
    CPU sqrt is not always (it differs from numpy and XLA in the last bit),
    so the CPU takes it in float64, whose rounding to f32 is exact."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def _ray_round_cone(o, d, pa, pb, ra, rb, t_lo, t_hi):
    """Dense (N, M) entry distance of rays into round cones. Returns (t (N,
    M) f32 with +inf misses, y (N, M) axial coordinate for normals).
    Vectors are kept as three (N, M) components, so no (N, M, 3) tensor is
    made; the dot products add their terms left to right."""
    col = lambda a: [a[None, :, k] for k in range(3)]        # 3 x (1, M)
    row = lambda a: [a[:, None, k] for k in range(3)]        # 3 x (N, 1)
    ba = col(pb - pa)
    o3, dd = row(o), row(d)
    a3, b3 = col(pa), col(pb)
    oa = [o3[k] - a3[k] for k in range(3)]                   # 3 x (N, M)
    ob = [o3[k] - b3[k] for k in range(3)]
    rr = (ra - rb)[None, :]                                  # (1, M)

    m0 = _dot(ba, ba)                                        # (1, M)
    m1 = _dot(ba, oa)                                        # (N, M)
    m2 = _dot(ba, dd)
    m3 = _dot(dd, oa)
    m5 = _dot(oa, oa)
    m6 = _dot(ob, dd)
    m7 = _dot(ob, ob)
    del oa, ob

    raB = ra[None, :]
    rbB = rb[None, :]
    d2 = m0 - rr * rr                                        # (1, M) > 0 for valid cones
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * raB
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * raB - m0 * raB * raB

    h = k1 * k1 - k0 * k2
    k2_safe = torch.where(k2.abs() > 1e-12, k2, 1e-12)
    t_side = (-_sqrt(torch.clamp(h, min=0.0)) - k1) / k2_safe
    y = m1 + t_side * m2
    side_ok = (h >= 0.0) & (k2 > 1e-12) & (y > 0.0) & (y < d2)
    del k0, k1, k2, k2_safe, h, y

    # spherical caps (entry roots); accepted only where the side surface
    # does not cover the hit direction
    ha = m3 * m3 - m5 + raB * raB
    hb = m6 * m6 - m7 + rbB * rbB
    t_a = -m3 - _sqrt(torch.clamp(ha, min=0.0))
    t_b = -m6 - _sqrt(torch.clamp(hb, min=0.0))
    ya = m1 + t_a * m2
    yb = m1 + t_b * m2
    a_ok = (ha >= 0.0) & (ya <= 0.0)
    b_ok = (hb >= 0.0) & (yb >= d2)

    inf = float("inf")
    lo = t_lo[:, None]
    hi = t_hi[:, None]
    pick = lambda ok, t: torch.where(ok & (t > lo) & (t < hi), t, inf)
    t_best = torch.minimum(
        pick(side_ok, t_side), torch.minimum(pick(a_ok, t_a), pick(b_ok, t_b)))
    y_best = m1 + t_best * m2
    return t_best, torch.where(torch.isfinite(t_best), y_best, 0.0)


def _bounds(origin, t_min, t_max, active):
    n = origin.shape[0]
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=origin.device).expand(n)
    return f32(t_min), torch.where(active, f32(t_max), 0.0)


def _chunks(n: int, m: int, pair_budget, device):
    budget = pair_budget or PAIR_BUDGET.get(device.type, PAIR_BUDGET["cuda"])
    rows = max(1, budget // max(m, 1))
    return [(s, min(n, s + rows)) for s in range(0, n, rows)]


def intersect_curves(curves: CurveSet, origin, direction, t_min, t_max, active,
                     with_normal: bool = True, pair_budget: int = None) -> CurveHit:
    """Closest curve hit for a wavefront: dense rays x pieces, the ray axis
    in chunks of at most `pair_budget` pairs (the device's PAIR_BUDGET when
    None). The piece is the first of equal minima (torch.argmin, as
    jnp.argmin). A set with no piece gives no hits.

    with_normal=False skips the surface-normal derivation and returns zeros
    in `normal`: the trace_api merge uses it (HitRecord carries no normal;
    shading re-derives it from the winning piece, render/shade.py)."""
    with record_function(CURVE_RANGE):
        return _intersect(curves, origin, direction, t_min, t_max, active, with_normal,
                          pair_budget)


def _intersect(curves, origin, direction, t_min, t_max, active, with_normal, pair_budget):
    n = origin.shape[0]
    dev = origin.device
    m = curves.num_pieces
    no_normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if m == 0:
        miss = torch.full((n,), -1, dtype=torch.int32, device=dev)
        return CurveHit(t=torch.full((n,), F32_MAX, device=dev), piece=miss, seg=miss,
                        normal=no_normal, is_hit=torch.zeros_like(active))
    t_lo, t_hi = _bounds(origin, t_min, t_max, active)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    piece = torch.empty((n,), dtype=torch.int64, device=dev)
    y = torch.zeros((n,), dtype=torch.float32, device=dev)
    for s, e in _chunks(n, m, pair_budget, dev):
        t_all, y_all = _ray_round_cone(origin[s:e], direction[s:e], curves.p0, curves.p1,
                                       curves.r0, curves.r1, t_lo[s:e], t_hi[s:e])
        best = torch.argmin(t_all, dim=1)
        t[s:e] = t_all.gather(1, best[:, None])[:, 0]
        piece[s:e] = best
        if with_normal:
            y[s:e] = y_all.gather(1, best[:, None])[:, 0]
    is_hit = torch.isfinite(t) & active
    # an all-miss row's argmin (0) is masked here and never reaches a record
    out_t = torch.where(is_hit, t, F32_MAX)
    out_piece = torch.where(is_hit, piece, -1).to(torch.int32)
    out_seg = torch.where(is_hit, curves.seg_id[piece], -1).to(torch.int32)
    if not with_normal:
        return CurveHit(t=out_t, piece=out_piece, seg=out_seg, normal=no_normal,
                        is_hit=is_hit)

    # normal: side surface -> gradient of the cone distance; caps -> sphere
    pa = curves.p0[piece]
    pb = curves.p1[piece]
    rr = curves.r0[piece] - curves.r1[piece]
    t_s = torch.where(is_hit, t, 0.0)
    pos = origin + t_s[:, None] * direction
    ba = pb - pa
    m0 = _dot(ba.unbind(-1), ba.unbind(-1))
    d2 = m0 - rr * rr
    oa = pos - pa
    on_a = y <= 0.0
    on_b = y >= d2
    n_side = d2[:, None] * oa - ba * y[:, None]
    nrm = torch.where(on_a[:, None], oa, torch.where(on_b[:, None], pos - pb, n_side))
    ln = _sqrt(torch.clamp(_dot(nrm.unbind(-1), nrm.unbind(-1)), min=1e-20))
    nrm = nrm / ln[:, None]
    return CurveHit(t=out_t, piece=out_piece, seg=out_seg,
                    normal=torch.where(is_hit[:, None], nrm, 0.0), is_hit=is_hit)


def occlude_curves(curves: CurveSet, origin, direction, t_min, t_max, active,
                   pair_budget: int = None):
    """Any-hit against the curve table: (N,) bool occluded."""
    with record_function(CURVE_RANGE):
        n = origin.shape[0]
        occ = torch.zeros((n,), dtype=torch.bool, device=origin.device)
        if curves.num_pieces == 0:
            return occ
        t_lo, t_hi = _bounds(origin, t_min, t_max, active)
        for s, e in _chunks(n, curves.num_pieces, pair_budget, origin.device):
            t_all, _ = _ray_round_cone(origin[s:e], direction[s:e], curves.p0, curves.p1,
                                       curves.r0, curves.r1, t_lo[s:e], t_hi[s:e])
            occ[s:e] = torch.isfinite(t_all).any(dim=1)
        return occ & active
