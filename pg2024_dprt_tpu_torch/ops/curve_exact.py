"""Exact round cubic B-spline intersection (counterpart of
pg2024_dprt_tpu/ops/curve_exact.py): the canal (swept-sphere) surface the
flattened round cones of scene/curves.py approximate.

`from_bspline(tolerance=...)` carries a derived surface-deviation bound
(chord + radius linearization error <= (max|C''| + max|r''|) / (8 L^2) for
L pieces). This module supplies the exact intersector that validates it:
sphere tracing against the distance field

    d(x) = min_u |x - C(u)| - r(u),   u in [0, 1]

to the union of spheres whose boundary is the round-curve surface. The
inner minimization is a dense u-scan plus a Newton polish; the outer march
is a fixed-iteration sphere trace, both straight-line tensor math over
(rays x segments). The bounds (`tessellation_error_bound`,
`pieces_for_tolerance`, `scan_count_for`) are numpy, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..scene.curves import _BSPLINE

# derivative operators in the power basis: d/du [1, u, u^2, u^3]
_D1 = np.zeros((4, 4)); _D1[1, 0] = 1; _D1[2, 1] = 2; _D1[3, 2] = 3
_D2 = np.zeros((4, 4)); _D2[2, 0] = 2; _D2[3, 1] = 6


def _basis(u):
    """u (...) -> B-spline weights and first / second derivative weights,
    each (..., 4)."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=u.device)
    b = f32(_BSPLINE)
    pw = torch.stack([torch.ones_like(u), u, u * u, u ** 3], dim=-1)
    return pw @ b, pw @ (f32(_D1) @ b), pw @ (f32(_D2) @ b)


def _closest_u(cp, rad, x, n_scan: int = 16, newton: int = 3):
    """argmin_u |x - C(u)| - r(u) per (ray, segment) pair.

    cp (S, 4, 3) control points, rad (S, 4) radii, x (N, S, 3) query
    points. A dense scan over n_scan parameters, then a Newton polish of the
    stationarity condition, kept only where it improves on the scan.
    Returns (u (N, S), dist (N, S)) with dist = |x - C(u)| - r(u)."""
    us = torch.linspace(0.0, 1.0, n_scan, dtype=torch.float32, device=x.device)
    w, _, _ = _basis(us)                                        # (U,4)
    c = torch.einsum("uc,scd->sud", w, cp)                      # (S,U,3)
    r = torch.einsum("uc,sc->su", w, rad)                       # (S,U)
    d2 = ((x[:, :, None, :] - c[None]) ** 2).sum(-1)            # (N,S,U)
    dist = torch.sqrt(d2.clamp(min=1e-20)) - r[None]            # (N,S,U)
    k = torch.argmin(dist, dim=-1)                              # (N,S)
    u = us[k]

    for _ in range(newton):
        w, w1, w2 = _basis(u)                                   # (N,S,4)
        cu = torch.einsum("nsc,scd->nsd", w, cp)
        c1 = torch.einsum("nsc,scd->nsd", w1, cp)
        c2 = torch.einsum("nsc,scd->nsd", w2, cp)
        r1 = torch.einsum("nsc,sc->ns", w1, rad)
        dx = x - cu                                             # (N,S,3)
        nrm = torch.sqrt((dx * dx).sum(-1).clamp(min=1e-20))
        # g(u) = d/du (|x - C| - r) = -(dx . C') / |dx| - r'
        g = -(dx * c1).sum(-1) / nrm - r1
        gp = ((c1 * c1).sum(-1) - (dx * c2).sum(-1)) / nrm \
            - ((dx * c1).sum(-1) ** 2) / (nrm ** 3)
        step = torch.where(gp.abs() > 1e-12, -g / gp, 0.0)
        u = (u + step.clamp(-0.25, 0.25)).clamp(0.0, 1.0)

    w, _, _ = _basis(u)
    cu = torch.einsum("nsc,scd->nsd", w, cp)
    ru = torch.einsum("nsc,sc->ns", w, rad)
    dx = x - cu
    dist_n = torch.sqrt((dx * dx).sum(-1).clamp(min=1e-20)) - ru
    # Newton may wander off the global minimum: keep the better of the two
    dist_scan = dist.amin(dim=-1)
    use_n = dist_n <= dist_scan
    return torch.where(use_n, u, us[k]), torch.minimum(dist_n, dist_scan)


def scan_count_for(control_points, radii, hit_eps: float = 1e-4) -> int:
    """Certified u-scan density: the scan's distance estimate overshoots the
    true distance by at most L_u * h / 2 (L_u a Lipschitz bound on u ->
    |x - C(u)| - r(u), h the scan spacing). Choosing h so that L_u * h / 2
    <= hit_eps / 2 makes `_closest_u`'s scan minimum a distance certified to
    hit_eps / 2 even where Newton diverges. L_u <= max|C'| + max|r'| <= the
    sum of the power-basis derivative coefficient norms over u in [0, 1]."""
    cp = np.asarray(control_points, np.float64)
    rr = np.asarray(radii, np.float64)
    d1 = _D1 @ _BSPLINE
    ac = np.einsum("jc,scd->sjd", d1.T, cp)   # (S,4,3) power coeffs of C'
    ar = np.einsum("jc,sc->sj", d1.T, rr)     # (S,4)  power coeffs of r'
    lip = np.linalg.norm(ac, axis=-1).sum(-1) + np.abs(ar).sum(-1)
    h = hit_eps / np.maximum(lip.max(), 1e-12)
    return int(np.clip(np.ceil(1.0 / h) + 1, 16, 4096))


def intersect_bspline_exact(control_points, radii, origin, direction, t_min, t_max,
                            steps: int = 64, hit_eps: float = 1e-4,
                            step_scale: float = 0.75, n_scan: int = 16):
    """Closest hit of (N,) rays against (S,) round cubic B-spline segments.

    control_points (S, 4, 3) and radii (S, 4), the windows that
    `CurveSet.from_bspline` consumes; origin / direction (N, 3) tensors (the
    device of `origin` is the device of the computation). Returns dict(t
    (N,), seg (N,) i32, u (N,), is_hit (N,)): the nearest surface crossing
    along each ray, by sphere tracing per (ray, segment) and reducing over
    segments.

    Each march step advances by `step_scale` times the estimated distance.
    The estimate comes from an `n_scan`-point u-scan and a Newton polish;
    where the global minimizer falls between scan samples outside Newton's
    basin it can overshoot by up to L_u / (2 (n_scan - 1)), so the
    no-step-across guarantee is strict only for n_scan >= scan_count_for(...);
    n_scan 16 and step_scale 0.75 are the settings the JAX package
    validates against dense sphere sampling."""
    o = torch.as_tensor(origin, dtype=torch.float32)
    dev = o.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    cp = f32(control_points)
    rad = f32(radii)
    d = f32(direction)
    n, s = o.shape[0], cp.shape[0]

    # conservative per-segment box (control hull + max radius) entry point
    lo = cp.amin(dim=1) - rad.amax(dim=1)[:, None]   # (S,3)
    hi = cp.amax(dim=1) + rad.amax(dim=1)[:, None]
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    t0 = (lo[None] - o[:, None]) * inv[:, None]      # (N,S,3)
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    t_enter = torch.minimum(t0, t1).amax(dim=-1)
    t_exit = torch.maximum(t0, t1).amin(dim=-1)
    t_max = f32(t_max).expand(n)[:, None]
    t_min = float(t_min)
    alive = (t_exit >= t_enter.clamp(min=t_min)) & (t_enter <= t_max)

    t = t_enter.clamp(min=t_min)                     # (N,S)
    hit = torch.zeros((n, s), dtype=torch.bool, device=dev)
    u_hit = torch.zeros((n, s), dtype=torch.float32, device=dev)
    for _ in range(steps):
        x = o[:, None, :] + t[..., None] * d[:, None, :]
        u, dist = _closest_u(cp, rad, x, n_scan=n_scan)
        new_hit = alive & (dist < hit_eps)
        hit = hit | new_hit
        u_hit = torch.where(new_hit & (u_hit == 0.0), u, u_hit)
        alive = alive & (~new_hit)
        t = torch.where(alive, t + (dist * step_scale).clamp(min=hit_eps * 0.5), t)
        alive = alive & (t <= torch.minimum(t_exit, t_max))

    t = torch.where(hit, t, 3.4e38)
    best = torch.argmin(t, dim=-1)                   # (N,)
    pick = lambda a: torch.gather(a, 1, best[:, None])[:, 0]
    return dict(t=pick(t), seg=best.to(torch.int32), u=pick(u_hit), is_hit=pick(hit))


def tessellation_error_bound(control_points, radii, pieces_per_segment: int):
    """Upper bound on the surface deviation between the L-piece round-cone
    linearization and the exact round B-spline: per segment, (max|C''| +
    max|r''|) / (8 L^2) (both second derivatives are linear in u for a
    cubic, so the max is at an endpoint). Returns (S,) numpy bounds."""
    cp = np.asarray(control_points, np.float64)
    rr = np.asarray(radii, np.float64)
    d2 = _D2 @ _BSPLINE                    # power-basis second derivative
    w2_0 = np.array([1.0, 0.0, 0.0, 0.0]) @ d2
    w2_1 = np.array([1.0, 1.0, 1.0, 1.0]) @ d2
    c2_0 = np.linalg.norm(np.einsum("c,scd->sd", w2_0, cp), axis=-1)
    c2_1 = np.linalg.norm(np.einsum("c,scd->sd", w2_1, cp), axis=-1)
    r2_0 = np.abs(np.einsum("c,sc->s", w2_0, rr))
    r2_1 = np.abs(np.einsum("c,sc->s", w2_1, rr))
    m = np.maximum(c2_0, c2_1) + np.maximum(r2_0, r2_1)
    return m / (8.0 * pieces_per_segment ** 2)


def pieces_for_tolerance(control_points, radii, tolerance: float,
                         min_pieces: int = 2, max_pieces: int = 64) -> int:
    """Smallest uniform piece count whose tessellation_error_bound is below
    `tolerance` for every segment."""
    m = tessellation_error_bound(control_points, radii, 1) * 8.0  # = max M
    worst = float(m.max()) if m.size else 0.0
    if worst <= 0.0:
        return min_pieces
    l = int(np.ceil(np.sqrt(worst / (8.0 * tolerance))))
    return int(np.clip(l, min_pieces, max_pieces))
