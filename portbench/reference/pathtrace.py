"""The plain reference path tracer: what a frame of the benchmark's cells
must show at the pixels the check samples.

Plain PyTorch, written from the renderer's published semantics (a pinhole
camera with TEA-seeded jitter, Lambertian shading with a cosine-weighted
throughput, next-event estimation by resampled importance sampling over
`shadow_path_count` light candidates, a constant-texel lat-long sky). It
imports nothing of the program.

The scene it traces is its configuration's kind's (`kinds/<kind>.py`
`reference`, written under this folder: `triangles.py` for meshes). Which
primitive a ray can hit, and how a hit is found and shaded, is the kind's
to know, so the loop here asks the scene and nothing else: `closest(o, d,
tmin, tmax, active)` -> (t, primitive, u, v, hit), `occluded(o, d, tmin,
tmax, active)` -> whether anything is hit in (tmin, tmax), `surface(o, d,
t, primitive, u, v, hit)` -> (point, unit normal, albedo); and, for the
partitioned frame (neural.py), `part` (each primitive's partition) and
`select(mask)` (the scene of the primitives in `mask`). A kind works its
scene out from the inputs the benchmark made, not from anything the
program built, and tests every ray against every primitive, so no
acceleration structure of the program's is trusted.

Paths are independent of each other, so the reference renders only the
pixels it is asked for: `render_pixels` returns their (P, 3) values for one
sample. Every float it computes is in `dtype` (float32 as the
configurations state; the control passes bfloat16); the random numbers are
the TEA / LCG words of the renderer, bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

EPS = 1e-8
RIS_SALT = 0x52495331
_MASK = 0xFFFFFFFF


# --------------------------------------------------------------------------
# random numbers: TEA-4 seeds, an LCG stream (uint32 words in int64)

def tea(val0, val1, rounds: int = 4):
    v0 = torch.as_tensor(val0, dtype=torch.int64) & _MASK
    v1 = torch.as_tensor(val1, dtype=torch.int64, device=v0.device) & _MASK
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & _MASK
        v0 = (v0 + (((((v1 << 4) & _MASK) + 0xA341316C) ^ ((v1 + s0) & _MASK))
                    ^ ((v1 >> 5) + 0xC8013EA4))) & _MASK
        v1 = (v1 + (((((v0 << 4) & _MASK) + 0xAD90777D) ^ ((v0 + s0) & _MASK))
                    ^ ((v0 >> 5) + 0x7E95761E))) & _MASK
    return v0


def tea_int(val0: int, val1: int, rounds: int = 4) -> int:
    v0, v1, s0 = val0 & _MASK, val1 & _MASK, 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & _MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s0)) ^ ((v1 >> 5) + 0xC8013EA4))) & _MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s0)) ^ ((v0 >> 5) + 0x7E95761E))) & _MASK
    return v0


def draws(seed, count: int, dtype):
    """`count` floats in [0, 1) from each seed's LCG stream."""
    out = []
    for _ in range(count):
        seed = (1664525 * seed + 1013904223) & _MASK
        out.append(((seed & 0x00FFFFFF).to(torch.float32) / float(0x01000000)).to(dtype))
    return out


# --------------------------------------------------------------------------
# vector math on (..., 3) tensors, products summed left to right

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def norm(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v / torch.clamp(norm(v), min=EPS)[..., None]


def frame_of(n):
    """Orthonormal tangent and bitangent around the unit normal n (Duff et
    al. 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def spherical(d):
    """(phi in [0, 2pi), theta in [0, pi]) of a direction, y up."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    return torch.where(phi < 0.0, phi + 2.0 * math.pi, phi), theta


def safe_inv(d):
    return 1.0 / torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype), d)


# --------------------------------------------------------------------------
# a helper of the kinds' queries

def active_only(trace, defaults):
    """`trace` run on the active rays alone, each inactive ray given its
    `defaults` entry: a ray's result does not depend on the other rays."""
    def wrapped(scene, o, d, tmin, tmax, active):
        if bool(active.all()):
            return trace(scene, o, d, tmin, tmax, active)
        rows = active.nonzero(as_tuple=True)[0]
        part = trace(scene, o[rows], d[rows], tmin[rows], tmax[rows], active[rows])
        part = part if isinstance(part, tuple) else (part,)
        out = []
        for value, default in zip(part, defaults(o)):
            full = torch.full((o.shape[0],), default, dtype=value.dtype, device=o.device)
            full[rows] = value
            out.append(full)
        return tuple(out) if len(out) > 1 else out[0]
    return wrapped


# --------------------------------------------------------------------------
# camera, sky, lights, shading

@dataclass
class View:
    """The frame's camera, lights, sky and render request, on the device."""

    origin: torch.Tensor
    forward: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    tan_half_fov: torch.Tensor
    width: int
    height: int
    light_tris: torch.Tensor   # (L, 3, 3)
    light_radiance: torch.Tensor  # (L, 3)
    sky: torch.Tensor          # (H, W, 3) lat-long texels
    bounces: int
    shadow_path_count: int
    t_epsilon: float


def make_view(camera: dict, lights: dict, sky: dict, request: dict, device,
              dtype=torch.float32) -> View:
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    eye, target, up = f32(camera["eye"]), f32(camera["target"]), f32(camera["up"])
    forward = normalize(target - eye)
    right = normalize(cross(forward, up))
    true_up = cross(right, forward)
    tan_half = torch.tan(f32(camera["fov_degrees"]) * (math.pi / 180.0) * 0.5)
    texels = np.broadcast_to(np.asarray(sky["color"], np.float32),
                             (sky["height"], sky["width"], 3)).copy()
    c = lambda x: x.to(dtype)
    return View(c(eye), c(forward), c(right), c(true_up), c(tan_half),
                request["width"], request["height"],
                c(f32(lights["triangles"])), c(f32(lights["radiance"])), c(f32(texels)),
                request["bounces"], request["shadow_path_count"], request["t_epsilon"])


def camera_rays(view: View, pix, sample: int):
    dt = view.origin.dtype
    xi1, xi2 = draws(tea(pix, int(sample)), 2, dt)
    rows, cols = pix // view.width, pix % view.width
    px = (cols.to(dt) + xi1) / view.width * 2.0 - 1.0
    py = 1.0 - (rows.to(dt) + xi2) / view.height * 2.0
    aspect = view.width / view.height
    d = (view.forward[None, :] + px[:, None] * (view.tan_half_fov * aspect) * view.right[None, :]
         + py[:, None] * view.tan_half_fov * view.up[None, :])
    d = normalize(d)
    return view.origin.expand_as(d), d


def sky_radiance(view: View, d):
    """Bilinear lookup of the lat-long sky at u = phi / 2pi, v = theta / pi."""
    phi, theta = spherical(d)
    phi = torch.where(phi > 2.0 * math.pi, phi - 2.0 * math.pi, phi)
    h, w = view.sky.shape[0], view.sky.shape[1]
    x = phi / (2.0 * math.pi) * w - 0.5
    y = theta / math.pi * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    img = view.sky
    return (img[y0i, x0i] * (1 - fx) * (1 - fy) + img[y0i, x1i] * fx * (1 - fy)
            + img[y1i, x0i] * (1 - fx) * fy + img[y1i, x1i] * fx * fy)


@dataclass
class Shaded:
    """One shading pass's results for each path."""

    point: torch.Tensor
    next_dir: torch.Tensor
    next_throughput: torch.Tensor
    next_live: torch.Tensor
    shadow_dir: torch.Tensor
    shadow_dist: torch.Tensor
    shadow_contrib: torch.Tensor
    shadow_live: torch.Tensor


def shade(view: View, pix, sample: int, bounce: int, d, throughput, hit, point, nrm,
          albedo) -> Shaded:
    """The hit's shading: the diffuse bounce and one NEE shadow ray chosen
    among `shadow_path_count` light candidates by weighted reservoir
    sampling (its contribution carries W / w_j)."""
    dt = d.dtype
    n = pix.shape[0]
    inside = dot(nrm, -d) < 0.0
    nrm = torch.where(inside[:, None], -nrm, nrm)
    bounce_salt = tea_int(int(sample), int(bounce))
    xi1, xi2 = draws(tea(pix, bounce_salt), 2, dt)
    r = torch.sqrt(torch.clamp(1.0 - xi1 * xi1, min=0.0))
    phi = 2.0 * math.pi * xi2
    wi_local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), xi1], dim=-1)
    tg, bt = frame_of(nrm)
    wi = normalize(wi_local[:, 0:1] * tg + wi_local[:, 1:2] * bt + wi_local[:, 2:3] * nrm)
    cos_theta = wi_local[:, 2].abs()
    next_tp = throughput * (2.0 * cos_theta)[:, None] * albedo

    s = view.shadow_path_count
    seeds = tea(pix.repeat_interleave(s) * s
                + torch.arange(s, dtype=torch.int64, device=pix.device).repeat(n), bounce_salt)
    sx1, sx2, sx3 = draws(seeds, 3, dt)
    count = view.light_tris.shape[0]
    li = torch.clamp(torch.floor(sx1 * count).long(), max=count - 1)
    p0, p1, p2 = (view.light_tris[li, k] for k in range(3))
    su = torch.sqrt(sx2)
    b0, b1 = 1.0 - su, sx3 * su
    lpoint = p0 + b0[:, None] * (p1 - p0) + b1[:, None] * (p2 - p0)
    cr = cross(p1 - p0, p2 - p0)
    area = 0.5 * norm(cr)
    lnormal = cr / torch.clamp(2.0 * area[:, None], min=EPS)
    area_pdf = 1.0 / torch.clamp(area, min=EPS) / count
    rep = lambda a: a.repeat_interleave(s, dim=0)
    to_light = lpoint - rep(point)
    dist = norm(to_light)
    wl = to_light / torch.clamp(dist[:, None], min=1e-12)
    contrib = (view.light_radiance[li] * rep(throughput) * rep(albedo)
               * torch.clamp(dot(lnormal, -wl), min=0.0)[:, None]
               * torch.clamp(dot(wl, rep(nrm)), min=0.0)[:, None]
               / area_pdf[:, None] / torch.clamp(dist * dist, min=1e-12)[:, None] / math.pi)
    c_sum = contrib[:, 0] + contrib[:, 1] + contrib[:, 2]
    valid = rep(hit) & (c_sum > 0.0)
    w_all = torch.where(valid, c_sum, torch.zeros_like(c_sum)).reshape(n, s)
    cums = [w_all[:, 0]]
    for j in range(1, s):
        cums.append(cums[-1] + w_all[:, j])
    cum = torch.stack(cums, dim=1)
    w_tot = cum[:, -1]
    (u_draw,) = draws(tea(pix, tea_int(bounce_salt, RIS_SALT)), 1, dt)
    pick = (cum > (u_draw * w_tot)[:, None]).to(torch.int32).argmax(dim=1)
    row = torch.arange(n, device=pix.device) * s + pick
    w_sel = w_all.reshape(n * s)[row]
    live1 = (w_tot > 0.0) & hit
    scale = torch.where(live1, w_tot / torch.clamp(w_sel, min=1e-30), torch.zeros_like(w_tot))
    return Shaded(point=point, next_dir=wi, next_throughput=torch.where(hit[:, None], next_tp, 0.0),
                  next_live=hit, shadow_dir=wl[row], shadow_dist=dist[row],
                  shadow_contrib=torch.where(live1[:, None], contrib[row] * scale[:, None], 0.0),
                  shadow_live=live1)


def render_pixels(view: View, scene, pix, sample: int, trace_log=None):
    """(P, 3) value of each pixel in `pix` for one sample: the direct light
    of every bounce's shadow ray that reaches the light, plus the sky of
    the paths that leave the scene. `trace_log`, a list, receives each
    bounce's closest-hit and shadow rays with their results."""
    dt = view.origin.dtype
    n = pix.shape[0]
    o, d = camera_rays(view, pix, sample)
    o = o.contiguous()
    tp = torch.ones((n, 3), dtype=dt, device=pix.device)
    live = torch.ones((n,), dtype=torch.bool, device=pix.device)
    tmax = torch.full((n,), torch.finfo(dt).max, dtype=dt, device=pix.device)
    eps = torch.full((n,), view.t_epsilon, dtype=dt, device=pix.device)
    direct = torch.zeros((n, 3), dtype=dt, device=pix.device)
    env = torch.zeros((n, 3), dtype=dt, device=pix.device)
    for bounce in range(view.bounces):
        t, tri, u, v, hit = scene.closest(o, d, eps, tmax, live)
        miss = live & ~hit
        env = env + torch.where(miss[:, None], tp * sky_radiance(view, d), 0.0)
        hit = live & hit
        point, nrm, albedo = scene.surface(o, d, t, tri, u, v, hit)
        sh = shade(view, pix, sample, bounce, d, tp, hit, point, nrm, albedo)
        occ = scene.occluded(sh.point, sh.shadow_dir, eps, sh.shadow_dist * (1.0 - 1e-3),
                             sh.shadow_live)
        if trace_log is not None:
            trace_log.append(dict(bounce=bounce, closest=(o, d, eps, tmax, live), t=t, tri=tri,
                                  hit=hit,
                                  shadow=(sh.point, sh.shadow_dir, eps,
                                          sh.shadow_dist * (1.0 - 1e-3), sh.shadow_live),
                                  occluded=occ))
        ok = sh.shadow_live & ~occ
        direct = direct + torch.where(ok[:, None], sh.shadow_contrib / view.shadow_path_count, 0.0)
        o, d, tp, live = sh.point, sh.next_dir, sh.next_throughput, sh.next_live
    return (direct + env).to(torch.float32)
