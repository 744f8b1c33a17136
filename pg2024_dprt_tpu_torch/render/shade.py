"""Shading stage (counterpart of pg2024_dprt_tpu/render/shade.py): given the
closest hits, sample the BSDF, emit the next bounce's paths and the NEE
shadow paths (their full unoccluded contribution in `throughput`), and
accumulate the environment radiance of misses.

Everything is masked tensor math over the whole wavefront. The random
numbers are the JAX package's, bit for bit: the same TEA seeds (pixel,
sample, bounce and the RIS/RR stream salts) feed the same LCG draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as cmath
from ..core.rng import rnd, rnd2, rnd3, tea, tea_int
from ..core.types import BSDF_WATER, PathState
from ..scene.textures import sample_textures

F32_MAX = 3.402823466e38
# TEA stream id for the RIS reservoir u draw ("RIS1")
RIS_SALT = 0x52495331
# TEA stream id for the Russian-roulette survival draw ("RR01")
RR_SALT = 0x52523031
# survival-probability floor: bounds the 1/p compensation
RR_FLOOR = 0.05


class SurfaceAttributes(NamedTuple):
    point: torch.Tensor      # (N,3) hit position
    normal: torch.Tensor     # (N,3) shading normal, flipped toward wo
    albedo: torch.Tensor     # (N,3)
    bsdf_type: torch.Tensor  # (N,) i32
    is_inside: torch.Tensor  # (N,) bool


def surface_attributes(scene, origin, direction, hits) -> SurfaceAttributes:
    """Gather + interpolate hit attributes from the per-triangle shading
    rows (scene.tri_shade layout: scene/geometry.py)."""
    tri = hits.tri_index.clamp(min=0).long()
    u = hits.u[:, None]
    v = hits.v[:, None]
    w = 1.0 - u - v
    row = scene.tri_shade[tri]                          # (N, 24)
    n0, n1, n2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    albedo = row[:, 15:18]
    bsdf_type = row[:, 18].to(torch.int32)
    # barycentric convention: u weights n1, v weights n2
    normal = cmath.normalize(w * n0 + u * n1 + v * n2)

    # albedo-texture fetch at the interpolated uv
    if scene.textured:
        tex_idx = row[:, 19].to(torch.int32)
        uv = w * row[:, 9:11] + u * row[:, 11:13] + v * row[:, 13:15]
        rgba = sample_textures(scene.albedo_textures, tex_idx, uv[:, 0], uv[:, 1])
        albedo = torch.where((tex_idx >= 0)[:, None], rgba[:, :3], albedo)

    t = torch.where(hits.is_hit, hits.t, 0.0)
    point = origin + t[:, None] * direction

    cos = cmath.dot(normal, -direction)
    is_inside = cos < 0.0
    normal = torch.where(is_inside[:, None], -normal, normal)
    return SurfaceAttributes(point, normal, albedo, bsdf_type, is_inside)


def bsdf_sample(xi1, xi2, attrs: SurfaceAttributes, wo_world):
    """Lambertian + water (Fresnel dielectric, eta 1/1.33) sampling,
    selected per path by material. Returns (wi_local, weight, is_delta)."""
    wi_diffuse = cmath.uniform_hemisphere(xi1, xi2)
    weight_diffuse = torch.full_like(xi1, 2.0)

    wo = cmath.to_local(attrs.normal, wo_world)
    eta_i = torch.where(attrs.is_inside, 1.33, 1.0)
    eta_t = torch.where(attrs.is_inside, 1.0, 1.33)
    wi_refract, _ = cmath.refract_z(wo, eta_i, eta_t)
    fresnel = cmath.dielectric_reflectance(wo[..., 2].abs(), eta_i, eta_t)
    reflecting = xi1 < fresnel
    wi_water = torch.where(reflecting[:, None], cmath.reflect_z(wo), wi_refract)
    cos_wi = wi_water[..., 2].abs()
    safe_cos = torch.clamp(cos_wi, min=1e-12)
    # reflect: (F/cos)/F = 1/cos; refract: ((1-F)/cos)*(etaI/etaT)^2/(1-F)
    eta_corr = (eta_i / eta_t) ** 2
    weight_water = torch.where(reflecting, 1.0 / safe_cos, eta_corr / safe_cos)
    weight_water = torch.where(cos_wi == 0.0, 0.0, weight_water)

    is_water = attrs.bsdf_type == BSDF_WATER
    wi_local = torch.where(is_water[:, None], wi_water, wi_diffuse)
    weight = torch.where(is_water, weight_water, weight_diffuse)
    return wi_local, weight, is_water


def _paths(origin, direction, tmax, throughput, pixel_index, shadow_path_id,
           is_shadow: bool, is_delta, is_valid) -> PathState:
    n = origin.shape[0]
    dev = origin.device
    return PathState(
        origin=origin, direction=direction, tmax=tmax, throughput=throughput,
        pixel_index=pixel_index, shadow_path_id=shadow_path_id,
        is_shadow=torch.full((n,), is_shadow, dtype=torch.bool, device=dev),
        is_delta=is_delta, is_valid=is_valid)


def shade(scene, lights, env, paths: PathState, hits, sample_count: int,
          bounce: int, shadow_path_count: int, frame_buffer_size: int,
          nee_mode: str = "sum", rr: bool = False):
    """One shade pass. Returns (next_paths, shadow_paths, env_image_add).

    * misses: throughput * env(direction) goes to the env image;
    * hits: the next path with throughput *= weight * |cos| * albedo, and
      the NEE shadow paths: shadow_path_count per hit ("sum"), or one
      chosen among shadow_path_count candidates by weighted reservoir
      sampling ("ris"), whose throughput carries c_j * W / w_j so that the
      consumers' division by shadow_path_count stays unbiased;
    * rr=True applies Russian roulette to the next paths: survival p =
      clip(max channel of the next throughput, RR_FLOOR, 1), survivors
      divide by p."""
    n = paths.capacity
    dev = paths.origin.device
    attrs = surface_attributes(scene, paths.origin, paths.direction, hits)
    wo_world = -paths.direction

    live = paths.is_valid & (~paths.is_shadow)
    hit = live & hits.is_hit
    miss = live & (~hits.is_hit)

    # --- environment on miss ---
    env_contrib = torch.where(miss[:, None], paths.throughput * env.sample(paths.direction), 0.0)
    env_image_add = torch.zeros((frame_buffer_size, 3), dtype=torch.float32, device=dev)
    env_image_add.index_add_(0, paths.pixel_index, env_contrib)

    # --- BSDF sample ---
    bounce_salt = tea_int(int(sample_count), int(bounce))
    _, xi1, xi2 = rnd2(tea(paths.pixel_index, bounce_salt))
    wi_local, weight, is_delta = bsdf_sample(xi1, xi2, attrs, wo_world)
    wi_world = cmath.normalize(cmath.to_world(attrs.normal, wi_local))
    cos_theta = wi_local[..., 2].abs()

    next_throughput = paths.throughput * (weight * cos_theta)[:, None] * attrs.albedo
    next_live = hit
    if rr:
        _, u_rr = rnd(tea(paths.pixel_index, tea_int(bounce_salt, RR_SALT)))
        p = torch.clamp(next_throughput.amax(dim=1), RR_FLOOR, 1.0)
        next_live = hit & (u_rr < p)
        next_throughput = next_throughput / p[:, None]
    next_paths = _paths(
        attrs.point, wi_world,
        torch.full((n,), F32_MAX, dtype=torch.float32, device=dev),
        torch.where(next_live[:, None], next_throughput, 0.0),
        paths.pixel_index,
        torch.full((n,), -1, dtype=torch.int64, device=dev),
        False, is_delta & next_live, next_live)

    # --- NEE shadow paths: S candidates per shading point ---
    s = shadow_path_count
    pix = paths.pixel_index.repeat_interleave(s)                   # (N*S,)
    spid = torch.arange(s, dtype=torch.int64, device=dev).repeat(n)
    _, sx1, sx2, sx3 = rnd3(tea(pix * s + spid, bounce_salt))

    light_index = torch.clamp(torch.floor(sx1 * lights.count).long(), max=lights.count - 1)
    lp0 = lights.p0[light_index]
    lp1 = lights.p1[light_index]
    lp2 = lights.p2[light_index]
    le = lights.radiance[light_index]
    light_point, light_normal, area_pdf = cmath.uniform_sample_triangle(lp0, lp1, lp2, sx2, sx3)
    area_pdf = area_pdf / lights.count  # light choice pdf

    rep = lambda a: a.repeat_interleave(s, dim=0)
    origin_s = rep(attrs.point)
    to_light = light_point - origin_s
    dist = cmath.norm(to_light)
    wi = to_light / torch.clamp(dist[:, None], min=1e-12)

    contribution = (
        le
        * rep(paths.throughput)
        * rep(attrs.albedo)
        * torch.clamp(cmath.dot(light_normal, -wi), min=0.0)[:, None]
        * torch.clamp(cmath.dot(wi, rep(attrs.normal)), min=0.0)[:, None]
        / area_pdf[:, None]
        / torch.clamp(dist * dist, min=1e-12)[:, None]
        / math.pi
    )
    c_sum = contribution[:, 0] + contribution[:, 1] + contribution[:, 2]

    # zero-contribution samples need no occlusion trace: every factor is
    # nonnegative, so their add is zero either way
    shadow_valid = rep(hit & (~is_delta)) & (c_sum > 0.0)

    if nee_mode == "ris" and s > 1:
        w_all = torch.where(shadow_valid, c_sum, 0.0).reshape(n, s)
        cum = _running_sum(w_all)
        w_tot = cum[:, -1]
        _, u_draw = rnd(tea(paths.pixel_index, tea_int(bounce_salt, RIS_SALT)))
        thresh = u_draw * w_tot
        pick = (cum > thresh[:, None]).to(torch.int32).argmax(dim=1)   # first True
        row = torch.arange(n, device=dev) * s + pick
        w_sel = w_all.reshape(n * s)[row]
        valid_1 = (w_tot > 0.0) & hit & (~is_delta)
        scale = torch.where(valid_1, w_tot / torch.clamp(w_sel, min=1e-30), 0.0)
        shadow_paths = _paths(
            attrs.point, wi[row], dist[row],
            torch.where(valid_1[:, None], contribution[row] * scale[:, None], 0.0),
            paths.pixel_index,
            torch.zeros((n,), dtype=torch.int64, device=dev),
            True, torch.zeros((n,), dtype=torch.bool, device=dev), valid_1)
        return next_paths, shadow_paths, env_image_add

    shadow_paths = _paths(
        origin_s, wi, dist,
        torch.where(shadow_valid[:, None], contribution, 0.0),
        pix, spid, True,
        torch.zeros((n * s,), dtype=torch.bool, device=dev), shadow_valid)
    return next_paths, shadow_paths, env_image_add


def _running_sum(w):
    """Left-to-right prefix sums over dim 1, in the JAX package's order
    (the RIS pick compares against them, so their rounding must match)."""
    cums = [w[:, 0]]
    for j in range(1, w.shape[1]):
        cums.append(cums[-1] + w[:, j])
    return torch.stack(cums, dim=1)
