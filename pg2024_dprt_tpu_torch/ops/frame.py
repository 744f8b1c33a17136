"""Whole-sample fused frame (counterpart of
pg2024_dprt_tpu/ops/pallas_frame.py): every sample of a path-traced frame —
camera rays, closest hit, shading, environment on a miss, NEE with its
any-hit rays, Russian roulette, accumulation over spp — in ONE kernel launch.

The kernel, K3 `frame_sample` in csrc/frame.cu, is written by hand for Hopper
and replaces pallas_frame.py::_frame_kernel; its source says what it
computes, how, and what bounds it. It shares the traversal device functions
of K1/K2 (csrc/resident_trace.cuh), so the fused and the composed frame
intersect with identical arithmetic.

Beside it is its plain PyTorch version, `render_frame_fused_plain`: a
transcription of the fused program (camera rays from pixel ids, the
per-(sample, bounce) salt table, per-ray state in ray order, the sample-major
S-candidate block, the RIS pick by running sums, the ray-order to pixel-order
permutation at the end), not a call into the engine's bounce loop. The
wrapper runs it only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises. `LAUNCHES["frame_sample"]` counts the kernel launches.

Why a fused frame on this card: the composed frame issues thousands of small
eager ops per frame and the device idles while the host issues them; the
fused frame is one launch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core import math as cmath
from ..core.rng import rnd, rnd2, rnd3, tea, tea_int
from ..render.pathgen import tiled_pixel_order
from ..render.shade import RIS_SALT, RR_FLOOR, RR_SALT, bsdf_sample, surface_attributes
from ..utils.timing import launch_span, to_device
from . import _build
from .resident import (
    F32_MAX, LAUNCHES, _check, _checked, _ptr, _stream, group_args,
    resident_anyhit_plain, resident_closest_plain, scene_tables, use_grouped,
)

# the salt table's width: 8 columns each for the bounce, RIS and roulette
# salts of one sample
MAX_BOUNCES = 8
SALT_COLS = 32


def fused_frame_supported(scene, lights, env, cfg) -> bool:
    """Static gate of the fused frame: the semantic conditions of the JAX
    gate (pallas_frame.py fused_frame_supported). A scene it rejects takes
    the composed path under fused_frame="auto".

      * no cutout textures: the kernel's trace is closest-hit only, the
        re-trace past transparent hits stays composed (ops/trace_api.py);
      * no curves: K3's trace has no curve stage, so curve scenes compose
        (ops/trace_api.py merges the curve test into K1 / K2's hits), as
        in JAX; and no instancing (instanced scenes compose, through the
        instance-aware trace kernels, as in JAX);
      * at least one light (the NEE light pick indexes the table);
      * bounces <= 8, the salt table's width.

    Dropped, because they are VMEM budgets of the TPU kernel and K3 reads
    every table from global memory by index: env pixels <= 2048 and lights
    <= 64 (one-hot gather matrices), the per-ray re-cull matrix bytes
    (_RECULL_BYTES_LIMIT), the 14 MiB texture-plus-table budget, and the
    presence of the texture scanline pool."""
    if scene.has_cutout:
        return False
    if getattr(scene, "curves", None) is not None:
        return False
    if getattr(scene, "cl_xf", None) is not None:
        return False
    if lights.count < 1:
        return False
    return cfg.bounces <= MAX_BOUNCES


def salt_table(base_sample: int, spp: int, bounces: int) -> torch.Tensor:
    """(spp, 32) int64 table of uint32 values on the CPU, one row per sample:
    cols 0..7 the per-bounce TEA salts tea(sample, bounce)
    (render/shade.py bounce_salt), col 8 the sample id, cols 16..23 the RIS
    draw salts tea(salt, RIS_SALT), cols 24..31 the roulette draw salts
    tea(salt, RR_SALT). Built in Python ints: no tensor op on the host."""
    rows = []
    for si in range(spp):
        sample = (int(base_sample) + si) & 0xFFFFFFFF
        row = [0] * SALT_COLS
        row[8] = sample
        for b in range(bounces):
            salt = tea_int(sample, b)
            row[b], row[16 + b], row[24 + b] = salt, tea_int(salt, RIS_SALT), tea_int(salt, RR_SALT)
        rows.append(row)
    return torch.tensor(rows, dtype=torch.int64).reshape(spp, SALT_COLS)


def render_frame_fused(scene, lights, env, camera, base_sample: int, cfg,
                       spp: int = 1, grouped=None):
    """`spp` samples of the frame in one launch. Returns the summed
    (direct (npix, 3), env (npix, 3), diag = 0) in pixel order — divide by
    spp for the frame average. K3 for CUDA tensors, the plain version for
    CPU tensors. K3's traces take the grouped walks where
    ops/resident.py::use_grouped(scene, grouped) says so; the image is the
    same either way."""
    if not fused_frame_supported(scene, lights, env, cfg):
        raise ValueError("the fused frame does not take this scene or config "
                         "(see fused_frame_supported); use fused_frame='off'")
    if (camera.width, camera.height) != (cfg.width, cfg.height):
        raise ValueError(f"camera {camera.width}x{camera.height} and config "
                         f"{cfg.width}x{cfg.height} differ")
    dev = camera.origin.device
    if dev.type == "cpu":
        return render_frame_fused_plain(scene, lights, env, camera, base_sample,
                                        cfg, spp)
    if dev.type != "cuda":
        raise ValueError(f"camera on {dev}: the kernel takes CUDA tensors")
    with launch_span("frame_sample", cfg.frame_buffer_size):
        npix = cfg.frame_buffer_size
        grouped = use_grouped(scene, grouped)
        tab, k, c = scene_tables(scene, dev, grouped)
        f32, i32 = torch.float32, torch.int32
        t_n = scene.tri_shade.shape[0]
        l_n = lights.count
        eh, ew = env.image.shape[0], env.image.shape[1]
        cam = [_checked(f"camera.{name}", getattr(camera, name), f32, shape, dev)
               for name, shape in (("origin", (3,)), ("forward", (3,)), ("right", (3,)),
                                   ("up", (3,)), ("tan_half_fov", ()))]
        tri_shade = _checked("tri_shade", scene.tri_shade, f32, (t_n, 24), dev)
        lts = [_checked(f"lights.{name}", getattr(lights, name), f32, (l_n, 3), dev)
               for name in ("p0", "p1", "p2", "radiance")]
        env_img = _checked("env.image", env.image, f32, (eh, ew, 3), dev)
        if scene.textured:
            tex = scene.albedo_textures
            n_tex = tex.count
            texs = [_checked("texels", tex.texels, f32, (tex.texels.shape[0], 4), dev)] + [
                _checked(f"textures.{name}", getattr(tex, name), i32, (n_tex,), dev)
                for name in ("offset", "height", "width")]
        else:
            n_tex, texs = 0, [None] * 4
        pix_ids = _pixel_ids(cfg.width, cfg.height, str(dev))
        salts = salt_table(base_sample, spp, cfg.bounces)
        # uint32 values as the int32 bit patterns the kernel reads
        salts = to_device(torch.where(salts >= 2**31, salts - 2**32, salts).to(i32), device=dev)
        direct = torch.empty((npix, 3), dtype=f32, device=dev)
        env_out = torch.empty((npix, 3), dtype=f32, device=dev)
        s = cfg.shadow_path_count
        ptr = lambda x: None if x is None else _ptr(x)
        rc = _lib().frame_sample(
            _ptr(pix_ids), npix, cfg.width, cfg.height, *map(_ptr, cam),
            cfg.width / cfg.height,
            _ptr(tab["cl_boxes"]), _ptr(tab["cl_mt_table"]), _ptr(tab["cl_tri_map"]),
            _ptr(tab["cl_count"]), _ptr(tab["scene_aabb"]), k, c,
            *(group_args(tab) if grouped else (None, None, 0)), _ptr(tri_shade),
            *map(_ptr, lts), l_n, _ptr(env_img), eh, ew, env.rotation_offset,
            *map(ptr, texs), n_tex, _ptr(salts), spp, cfg.bounces, s,
            int(cfg.nee_mode == "ris"), int(cfg.russian_roulette), cfg.t_epsilon,
            _ptr(direct), _ptr(env_out), _stream(camera.origin))
        _check(rc, "frame_sample")
        if npix:
            LAUNCHES["frame_sample"] += 1
    return direct, env_out, 0


def render_sample_fused(scene, lights, env, camera, sample_count: int, cfg):
    """One spp — the contract of render/engine.py render_sample:
    (direct (npix, 3), env (npix, 3), diag)."""
    return render_frame_fused(scene, lights, env, camera, sample_count, cfg, spp=1)


@functools.lru_cache(maxsize=8)
def _pixel_ids(width: int, height: int, device: str) -> torch.Tensor:
    """(npix,) int32 pixel ids in the tiled ray order, kept on the device
    between frames."""
    return tiled_pixel_order(width, height, device=device).to(torch.int32)


def _lib():
    lib = _build.load("frame")
    if not getattr(lib, "_pg_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.frame_sample.argtypes = (
            [p, i, i, i] + [p] * 5 + [f]          # pixels, image size, camera
            + [p] * 5 + [i, i]                    # cluster tables
            + [p, p, i, p]                        # group tables, tri_shade
            + [p] * 4 + [i] + [p, i, i, f]        # lights, environment
            + [p] * 4 + [i]                       # textures
            + [p, i, i, i, i, i, f]               # salts, spp .. eps
            + [p, p, p])                          # outputs, stream
        lib.frame_sample.restype = i
        lib._pg_typed = True
    return lib


# --------------------------------------------------------------------------
# plain PyTorch version (the fused program, vectorized over the pixels)

def render_frame_fused_plain(scene, lights, env, camera, base_sample: int, cfg,
                             spp: int = 1):
    """Plain version of K3: the same program over all pixels at once, in ray
    (tiled pixel) order, permuted to pixel order at the end. One path per
    pixel, so accumulation is a plain add."""
    dev = camera.origin.device
    w, npix = cfg.width, cfg.frame_buffer_size
    s = cfg.shadow_path_count
    ris = cfg.nee_mode == "ris" and s > 1
    order = tiled_pixel_order(w, cfg.height, device=dev)       # ray -> pixel id
    rows, cols = order // w, order % w
    salts = salt_table(base_sample, spp, cfg.bounces)
    eps = torch.full((npix,), cfg.t_epsilon, dtype=torch.float32, device=dev)
    fmax = torch.full((npix,), F32_MAX, dtype=torch.float32, device=dev)
    # sample-major S block: row j * npix + i is candidate j of ray i
    tile = lambda x: x.repeat(s, *([1] * (x.dim() - 1)))
    direct_sum = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    env_sum = torch.zeros_like(direct_sum)

    for si in range(spp):
        salt_row = [int(x) for x in salts[si]]
        # ---- 0. camera paths from the pixel ids
        _, cx1, cx2 = rnd2(tea(order, salt_row[8]))
        o, d = camera.generate_rays(rows, cols, cx1, cx2)
        o = o.contiguous()
        tp = torch.ones((npix, 3), dtype=torch.float32, device=dev)
        act = torch.ones((npix,), dtype=torch.bool, device=dev)
        direct = torch.zeros_like(direct_sum)
        env_acc = torch.zeros_like(direct_sum)

        for b in range(cfg.bounces):
            salt = salt_row[b]
            # ---- 1./2. closest hit and attributes
            hits = resident_closest_plain(scene, o, d, eps, fmax, act)
            attrs = surface_attributes(scene, o, d, hits)
            hit = act & hits.is_hit
            miss = act & (~hits.is_hit)
            # ---- 4. environment on a miss
            env_acc = env_acc + torch.where(miss[:, None], tp * env.sample(d), 0.0)
            # ---- 3. BSDF sample
            _, xi1, xi2 = rnd2(tea(order, salt))
            wi_local, weight, is_delta = bsdf_sample(xi1, xi2, attrs, -d)
            wi_world = cmath.normalize(cmath.to_world(attrs.normal, wi_local))
            cos_theta = wi_local[..., 2].abs()

            # ---- 5. NEE
            if s > 0:
                pix_s = ((order * s)[None, :] + torch.arange(
                    s, dtype=torch.int64, device=dev)[:, None]).reshape(s * npix)
                _, sx1, sx2, sx3 = rnd3(tea(pix_s, salt))
                li = torch.clamp(torch.floor(sx1 * lights.count).long(),
                                 max=lights.count - 1)
                lpnt, lnorm, area_pdf = cmath.uniform_sample_triangle(
                    lights.p0[li], lights.p1[li], lights.p2[li], sx2, sx3)
                area_pdf = area_pdf / lights.count
                to_light = lpnt - tile(attrs.point)
                dist = cmath.norm(to_light)
                wi = to_light / torch.clamp(dist[:, None], min=1e-12)
                contrib = (
                    lights.radiance[li] * tile(tp) * tile(attrs.albedo)
                    * torch.clamp(cmath.dot(lnorm, -wi), min=0.0)[:, None]
                    * torch.clamp(cmath.dot(wi, tile(attrs.normal)), min=0.0)[:, None]
                    / area_pdf[:, None]
                    / torch.clamp(dist * dist, min=1e-12)[:, None]
                    / math.pi)
                c_sum = contrib[:, 0] + contrib[:, 1] + contrib[:, 2]
                # zero-contribution samples need no occlusion trace
                valid_s = tile(hit & (~is_delta)) & (c_sum > 0.0)
                if ris:
                    w_row = torch.where(valid_s, c_sum, 0.0).reshape(s, npix)
                    cums = [w_row[0]]
                    for j in range(1, s):
                        cums.append(cums[-1] + w_row[j])
                    w_tot = cums[-1]
                    _, u_draw = rnd(tea(order, salt_row[16 + b]))
                    thresh = u_draw * w_tot
                    # first j with cum > thresh (candidate 0 when none)
                    pick = torch.zeros((npix,), dtype=torch.int64, device=dev)
                    picked = torch.zeros((npix,), dtype=torch.bool, device=dev)
                    for j in range(s):
                        gt = cums[j] > thresh
                        pick = torch.where(gt & (~picked), j, pick)
                        picked = picked | gt
                    idx = pick * npix + torch.arange(npix, device=dev)
                    valid_1 = (w_tot > 0.0) & hit & (~is_delta)
                    scale = torch.where(
                        valid_1, w_tot / torch.clamp(w_row.reshape(-1)[idx], min=1e-30), 0.0)
                    occ = resident_anyhit_plain(
                        scene, attrs.point, wi[idx], eps, dist[idx] * (1.0 - 1e-3), valid_1)
                    direct = direct + torch.where(
                        (valid_1 & (~occ))[:, None], contrib[idx] * scale[:, None] / s, 0.0)
                else:
                    occ = resident_anyhit_plain(
                        scene, tile(attrs.point), wi, tile(eps), dist * (1.0 - 1e-3), valid_s)
                    add = torch.where((valid_s & (~occ))[:, None], contrib / s, 0.0)
                    for j in range(s):
                        direct = direct + add[j * npix:(j + 1) * npix]

            # ---- 6. next bounce state, Russian roulette
            tp = tp * (weight * cos_theta)[:, None] * attrs.albedo
            act = hit
            if cfg.russian_roulette and cfg.russian_roulette <= b + 1 < cfg.bounces:
                _, u_rr = rnd(tea(order, salt_row[24 + b]))
                p = torch.clamp(tp.amax(dim=1), RR_FLOOR, 1.0)
                act = hit & (u_rr < p)
                tp = tp / p[:, None]
            tp = torch.where(act[:, None], tp, 0.0)
            o, d = attrs.point, wi_world
        # ---- 7. samples add in sample order
        direct_sum = direct_sum + direct
        env_sum = env_sum + env_acc

    # ray order -> pixel order (the tiled order is a permutation)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(npix, dtype=torch.int64, device=dev)
    return direct_sum[inv], env_sum[inv], 0
