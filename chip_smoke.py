#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg2024_dprt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the nvcc build of every
     kernel source in pg2024_dprt_tpu_torch/csrc/ (sm_90a, one nvcc per
     source, all started together, into pg2024_dprt_tpu_torch/build/), with
     ptxas' registers and spills per kernel;
  2. cornell 32x32 spp2 b3 held against the golden EXR (rtol 1e-3 / atol
     1e-4) twice: through the composed path (fused_frame="off": K1/K2
     launched, K3 not) and through the fused frame with the default config
     (one K3 launch, K1/K2 not); K1/K2 timed on the cornell wavefronts;
  3. the main path, the full-size frame — a 65,536-triangle soup (512
     triangles per cluster) under an area light, 256x256, spp 1, 4 bounces,
     RIS NEE — through render_image with the default config (the fused frame:
     launches {frame_sample: 1}), with the launch counts reset just before
     and read just after; the same frame through the composed path
     (fused_frame="off": K1/K2 4/4); frame ms of both (CUDA events, median of
     7 after a warm-up), K3's ms at every depth from 1 bounce up beside the
     paths alive per bounce, per-wavefront kernel ms and Mrays/s, and the
     composed frame with the plain versions in place of K1/K2 (one run);
  4. each kernel against its plain version on the card. K1/K2 on the frame's
     camera, first-bounce and first-shadow wavefronts: hit flags agree on
     >= 99.99 % of rays, every disagreement is an edge hit (min barycentric
     < 1e-5) or lies at the ray's tmax, ids agree wherever both hit and the
     plain t is unique, t/u/v within rtol 1e-4 / atol 1e-5. K3 against its
     plain version on the full frame and on the textured checkerboard
     cornell with the water box, and against the composed path (K1/K2 +
     eager shade, same seed) in "ris" and "sum" mode, with and without
     roulette: at most 0.1 % of the pixels outside |a-b| / max(|a|, 1e-2) <
     1e-3 (a last-bit difference of sinf/cosf/atan2f can flip an edge hit, an
     RIS pick or a roulette survival, and that pixel then differs by far more
     than rounding) and frame means within 1e-3; two K3 launches
     bit-identical;
  5. per wavefront, the work the query needs (ray-triangle tests, slab
     tests, bytes), the bound it gives, and for K1 the slab tests it runs;
     K3's bound from every bounce's wavefronts of the composed frame; then
     the kernels line (JSON; `disagreements` is the flag disagreements of
     K1/K2 on the phase-4 wavefronts and K3's outlier pixels against its
     plain version), the card line, and the final
     {"ok": true, "device": {...}} line.

Without CUDA, or run alone outside the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "cornell_32x32_spp2_b3.exr")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# FP32 operations per ray-triangle test (triple-product MT: 12 sub, 18 mul,
# 8 add, 1 div, ~6 compare/select) and per ray-cluster slab test
MT_OPS = 40
SLAB_OPS = 30


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(torch, fn, reps: int, warmup: int = 1):
    """Median device ms of fn() over `reps` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def frame_wavefronts(pt, scene, lights, env, camera, cfg, sample=0):
    """Every trace input of one composed frame sample, per bounce: the
    closest-hit rays with K1's hits and the shadow rays — each ray set as
    (origin, direction, tmin, tmax, active), as the engine passes them."""
    import torch

    paths = pt.render.generate_camera_paths(camera, sample)
    dev = paths.origin.device
    eps = lambda n: torch.full((n,), cfg.t_epsilon, device=dev)
    out = []
    for b in range(cfg.bounces):
        rays = (paths.origin, paths.direction, eps(paths.capacity), paths.tmax,
                paths.is_valid)
        hits = pt.ops.resident_closest(scene, *rays)
        rr = bool(cfg.russian_roulette) and cfg.russian_roulette <= b + 1 < cfg.bounces
        paths, shadow, _ = pt.render.shade(
            scene, lights, env, paths, hits, sample, b, cfg.shadow_path_count,
            cfg.frame_buffer_size, nee_mode=cfg.nee_mode, rr=rr)
        shd = (shadow.origin, shadow.direction, eps(shadow.capacity),
               shadow.tmax * (1.0 - 1e-3), shadow.is_valid)
        out.append({"closest": rays, "hits": hits, "shadow": shd})
    return out


def named_wavefronts(per_bounce):
    """The three wavefronts the trace kernels are timed and checked on."""
    return {"camera": per_bounce[0]["closest"], "shadow0": per_bounce[0]["shadow"],
            "bounce1": per_bounce[1]["closest"]}


@contextlib.contextmanager
def plain_traces(pt):
    """Route the engine's traces through the plain versions (for timing the
    plain frame)."""
    res = pt.ops.resident
    saved = res.resident_closest, res.resident_anyhit
    res.resident_closest, res.resident_anyhit = res.resident_closest_plain, res.resident_anyhit_plain
    try:
        yield
    finally:
        res.resident_closest, res.resident_anyhit = saved


def closest_work(pt, scene, rays, want):
    """What the closest-hit query needs on these rays, from the plain
    result `want`: ray-triangle tests (every triangle of every cluster the
    ray enters before its final t, before its capped tmax on a miss), slab
    tests (every cluster box once per active ray), bytes (the active flag of
    every ray, the rest of the record of active rays, the table rows 0-11 of
    the triangles of clusters some ray needs, boxes, counts, scene box, the
    `cl_tri_map` entry of each hit, the record out for every ray), and the
    slab tests K1 runs: one pass over all K boxes per cluster it visits,
    plus the pass that finds none. K1 visits every cluster whose enter
    distance is within its horizon (best t * (1 + 1e-4) + 1e-7 after a hit,
    capped tmax before), so the visit count follows from the final t."""
    import torch

    o, d, tmin, tmax, active = rays
    inv, _, tcap = pt.ops.resident.ray_limits(scene, o, d, tmin, tmax, active)
    counts = scene.cl_count.to(torch.int64)
    k = scene.num_clusters
    tests, run_passes = 0, 0
    needed = torch.zeros(k, dtype=torch.bool, device=o.device)
    for r0 in range(0, o.shape[0], 8192):
        r = slice(r0, r0 + 8192)
        en = pt.ops.resident.cluster_enters_plain(scene, o[r], inv[r], tcap[r])
        need = (en <= torch.minimum(want.t[r], tcap[r])[:, None]) & active[r][:, None]
        tests += int((need.to(torch.int64) * counts[None, :]).sum())
        needed |= need.any(0)
        horizon = torch.where(want.is_hit[r], want.t[r] * (1.0 + 1e-4) + 1e-7, tcap[r])
        visits = ((en <= horizon[:, None]) & active[r][:, None]).sum(1)
        run_passes += int((visits + 1)[active[r]].sum())
    n, n_act = o.shape[0], int(active.sum())
    nbytes = (n + 32 * n_act + 48 * int(counts[needed].sum()) + 32 * k + 24
              + 4 * int(want.is_hit.sum()) + 17 * n)
    return {"tests": tests, "slabs": n_act * k, "bytes": nbytes,
            "slabs_run": run_passes * k, "needed": needed}


def anyhit_work(pt, scene, rays, occ):
    """What the any-hit query needs on these rays, from the plain result
    `occ`: an unoccluded ray must test every triangle of every cluster it
    enters and every box; an occluded ray one triangle and one box, in one
    cluster that occludes it (taken as its closest hit's). Bytes: the active
    flag of every ray, the rest of the record of active rays, table rows
    0-11 of the triangles of needed clusters, boxes, counts, scene box, one
    flag out per ray (`cl_tri_map` is not read)."""
    import torch

    o, d, tmin, tmax, active = rays
    inv, _, tcap = pt.ops.resident.ray_limits(scene, o, d, tmin, tmax, active)
    counts = scene.cl_count.to(torch.int64)
    k, c = scene.num_clusters, scene.tris_per_cluster
    n_occ = int(occ.sum())
    tests, slabs = n_occ, n_occ
    needed = torch.zeros(k, dtype=torch.bool, device=o.device)
    for r0 in range(0, o.shape[0], 8192):
        r = slice(r0, r0 + 8192)
        en = pt.ops.resident.cluster_enters_plain(scene, o[r], inv[r], tcap[r])
        open_ = active[r] & ~occ[r]
        need = torch.isfinite(en) & open_[:, None]
        tests += int((need.to(torch.int64) * counts[None, :]).sum())
        slabs += int(open_.sum()) * k
        needed |= need.any(0)
    if n_occ:
        sub = tuple(x[occ] for x in rays)
        h = pt.ops.resident_closest_plain(scene, *sub)
        tri_map = scene.cl_tri_map.to(torch.int64)
        slot_of = torch.full((int(tri_map.max()) + 1,), -1, dtype=torch.int64,
                             device=o.device)
        real = tri_map >= 0
        slot_of[tri_map[real]] = torch.arange(k * c, device=o.device)[real]
        needed[slot_of[h.tri_index[h.is_hit].to(torch.int64)] // c] = True
    n, n_act = o.shape[0], int(active.sum())
    nbytes = n + 32 * n_act + 48 * int(counts[needed].sum()) + 32 * k + 24 + n
    return {"tests": tests, "slabs": slabs, "bytes": nbytes, "needed": needed}


def bound(work):
    """(bound_ms, bound_by): the larger of the bytes the query must move
    over HBM bandwidth and its FP32 operations over the FP32 peak."""
    byte_s = work["bytes"] / HBM_BYTES_PER_S
    op_s = (work["tests"] * MT_OPS + work["slabs"] * SLAB_OPS) / FP32_FLOP_PER_S
    return max(byte_s, op_s) * 1e3, ("operations" if op_s >= byte_s else "bytes")


def frame_work(pt, scene, lights, env, cfg, per_bounce):
    """What the fused frame needs, from one composed frame's wavefronts: the
    ray-triangle and slab tests of every bounce's closest and any-hit
    queries (closest_work, anyhit_work; the shade arithmetic, some hundred
    operations per path and bounce, is left out beside them), and the bytes:
    4 B in and 24 B out per pixel, rows 0-11 of the triangles of every
    cluster some ray of some bounce needs (counted once), boxes, counts and
    the scene box, the tri_map entry and tri_shade row of each distinct
    triangle hit, the lights and the environment map."""
    import torch

    k = scene.num_clusters
    needed = torch.zeros(k, dtype=torch.bool, device=scene.cl_count.device)
    tests = slabs = 0
    hit_tris = []
    for wave in per_bounce:
        hits = wave["hits"]
        occ = pt.ops.resident_anyhit(scene, *wave["shadow"])
        for w in (closest_work(pt, scene, wave["closest"], hits),
                  anyhit_work(pt, scene, wave["shadow"], occ)):
            tests += w["tests"]
            slabs += w["slabs"]
            needed |= w["needed"]
        hit_tris.append(hits.tri_index[hits.is_hit])
    n_hit_tris = int(torch.unique(torch.cat(hit_tris)).numel())
    nbytes = (28 * cfg.frame_buffer_size
              + 48 * int(scene.cl_count.to(torch.int64)[needed].sum()) + 32 * k + 24
              + 100 * n_hit_tris + 48 * lights.count + 4 * env.image.numel())
    return {"tests": tests, "slabs": slabs, "bytes": nbytes}


def compare_frames(name, got, want, npix):
    """The frame criterion: pixels outside |a-b| / max(|a|, 1e-2) < 1e-3 (on
    the direct or the env image) are at most 0.1 % of the frame, and the
    frame means agree within 1e-3 relative. `got`/`want` are (direct, env,
    ...) tuples. Returns (outlier pixels, max abs err over the other pixels)."""
    import torch

    bad = torch.zeros(npix, dtype=torch.bool, device=got[0].device)
    for a, b in zip(got[:2], want[:2]):
        check(tuple(a.shape) == (npix, 3) and bool(torch.isfinite(a).all()),
              f"{name}: image is not finite (npix, 3)")
        bad |= ((a - b).abs() / b.abs().clamp(min=1e-2) >= 1e-3).any(dim=1)
    outliers = int(bad.sum())
    check(outliers <= 1e-3 * npix, f"{name}: {outliers} of {npix} pixels outside tolerance")
    mean_a = float((got[0] + got[1]).mean())
    mean_b = float((want[0] + want[1]).mean())
    check(abs(mean_a - mean_b) <= 1e-3 * abs(mean_b),
          f"{name}: frame means {mean_a:.6g} and {mean_b:.6g} differ")
    err = max(float((a - b).abs()[~bad].max()) for a, b in zip(got[:2], want[:2]))
    return outliers, err


def compare_closest(pt, scene, rays, got, want):
    """Phase-4 check of K1 against its plain version; returns max abs err
    of t/u/v over rays where both hit the same triangle."""
    import torch

    o, d = rays[0], rays[1]
    n = int(rays[4].sum())
    dis = got.is_hit != want.is_hit
    check(int(dis.sum()) <= 1e-4 * max(n, 1),
          f"K1 hit flags disagree on {int(dis.sum())} of {n} rays")
    if dis.any():
        # every disagreement must be an edge hit of the side that hit
        u = torch.where(got.is_hit, got.u, want.u)[dis]
        v = torch.where(got.is_hit, got.v, want.v)[dis]
        edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v) < 1e-5
        check(bool(edge.all()), "K1 disagreement that is not an edge hit")
    both = got.is_hit & want.is_hit
    t_ok = torch.isclose(got.t[both], want.t[both], rtol=1e-4, atol=1e-5)
    check(bool(t_ok.all()), f"K1 t differs on {int((~t_ok).sum())} rays")
    # ids must agree where the plain winner's t is unique: an id mismatch
    # is allowed only where the two winners' t tie (as tests/test_pallas_resident.py)
    idm = both & (got.tri_index != want.tri_index)
    tie = (got.t - want.t).abs() <= 1e-5 * torch.clamp(want.t.abs(), min=1.0)
    check(bool(tie[idm].all()), "K1 picked another triangle at a different t")
    same = both & ~idm
    err = 0.0
    for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
        if same.any():
            err = max(err, float((a[same] - b[same]).abs().max()))
    for name, a, b in (("u", got.u, want.u), ("v", got.v, want.v)):
        ok = torch.isclose(a[same], b[same], rtol=1e-4, atol=1e-5)
        check(bool(ok.all()), f"K1 {name} differs on {int((~ok).sum())} rays")
    return err, int(dis.sum()), int(idm.sum())


def compare_anyhit(pt, scene, rays, got, want):
    """Phase-4 check of K2: occlusion flags agree on >= 99.99 % of rays and
    every disagreement is an edge hit or a hit at the ray's tmax. Returns the
    max abs err of the flags as 0/1 values and the count of rays whose flags
    differ."""
    import torch

    n = int(rays[4].sum())
    dis = got != want
    check(int(dis.sum()) <= 1e-4 * max(n, 1),
          f"K2 occlusion disagrees on {int(dis.sum())} of {n} rays")
    if dis.any():
        sub = tuple(x[dis] for x in rays)
        h = pt.ops.resident_closest_plain(scene, *sub)
        _, _, tcap = pt.ops.resident.ray_limits(scene, *sub)
        edge = torch.minimum(torch.minimum(h.u, h.v), 1.0 - h.u - h.v) < 1e-5
        at_tmax = (h.t - tcap).abs() <= 1e-4 * tcap.abs() + 1e-5
        check(bool((h.is_hit & (edge | at_tmax)).all()),
              "K2 disagreement that is not an edge hit")
    err = float((got.to(torch.float32) - want.to(torch.float32)).abs().max())
    return err, int(dis.sum())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import pg2024_dprt_tpu_torch as pt
        import pg2024_dprt_tpu_torch.core
        import pg2024_dprt_tpu_torch.ops
        import pg2024_dprt_tpu_torch.render
        import pg2024_dprt_tpu_torch.scene
        import pg2024_dprt_tpu_torch.utils
        from pg2024_dprt_tpu_torch.ops import _build
        from pg2024_dprt_tpu_torch.scene import native_bvh
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    import numpy as np

    dev = pt.core.resolve_device()
    launches = pt.ops.LAUNCHES
    off = lambda cfg: dataclasses.replace(cfg, fused_frame="off")

    def counted(fn):
        """fn() with every launch count set to 0 just before and read just
        after; returns (result, counts)."""
        pt.ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(launches)

    def samples(cfg, fused, sample=0):
        """(direct, env, diag) sums of cfg.spp samples through K3 or through
        the composed path."""
        if fused:
            return pt.ops.render_frame_fused(scene, lights, env, cam, sample, cfg, spp=cfg.spp)
        parts = [pt.render.render_sample(scene, lights, env, cam, sample + s, off(cfg))
                 for s in range(cfg.spp)]
        return sum(p[0] for p in parts), sum(p[1] for p in parts), 0

    try:
        # ---- phase 1: card + build
        card = card_line()
        t0 = time.perf_counter()
        report = _build.build(force=True)
        build_s = time.perf_counter() - t0
        print(f"phase1 card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
              f"| kernel build {build_s:.2f} s ({', '.join(report)})", flush=True)
        for name, (_, log) in report.items():
            regs = [ln.strip().replace("ptxas info    : ", "") for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"phase1 ptxas {name}: {' | '.join(regs)}", flush=True)

        # ---- phase 2: cornell golden, composed and fused
        meshes, lights = pt.scene.cornell_box(device=dev)
        scene = pt.scene.device_scene_from_meshes(meshes, device=dev)
        env = pt.scene.EnvironmentMap.constant((0.2, 0.3, 0.4), device=dev)
        cam = pt.core.Camera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0],
                                     40.0, 32, 32, device=dev)
        cfg = pt.render.RenderConfig(width=32, height=32, spp=2, bounces=3)
        golden, names = pt.utils.read_exr(GOLDEN)
        golden = golden[:, :, [names.index(ch) for ch in "RGB"]]
        for path, c2, want_counts in (
                ("composed", off(cfg), None),
                ("fused", cfg, {"resident_closest": 0, "resident_anyhit": 0, "frame_sample": 1})):
            img, counts2 = counted(lambda: pt.render.render_image(scene, lights, env, cam, c2))
            img = img.cpu().numpy()
            err2 = float(np.abs(img - golden).max())
            check(np.allclose(img, golden, rtol=1e-3, atol=1e-4),
                  f"cornell ({path}) differs from the golden EXR (max abs err {err2:.3g})")
            if want_counts is None:
                check(counts2["resident_closest"] > 0 and counts2["resident_anyhit"] > 0
                      and counts2["frame_sample"] == 0, f"cornell composed launches {counts2}")
            else:
                check(counts2 == want_counts, f"cornell fused launches {counts2}")
            print(f"phase2 cornell 32x32 spp2 b3 {path} vs golden: max abs err {err2:.3g} "
                  f"(rtol 1e-3 / atol 1e-4) ok; launches {counts2}", flush=True)
        cwaves = named_wavefronts(frame_wavefronts(pt, scene, lights, env, cam, cfg))
        for wname, kern, plain, work_fn in (
                ("camera", pt.ops.resident_closest, pt.ops.resident_closest_plain, closest_work),
                ("shadow0", pt.ops.resident_anyhit, pt.ops.resident_anyhit_plain, anyhit_work)):
            rays = cwaves[wname]
            k_ms = cuda_ms(torch, lambda: kern(scene, *rays), reps=20)
            p_ms = cuda_ms(torch, lambda: plain(scene, *rays), reps=3)
            b_ms, b_by = bound(work_fn(pt, scene, rays, plain(scene, *rays)))
            print(f"phase2 cornell wavefront {wname}: {int(rays[4].sum())} active rays, "
                  f"{kern.__name__} {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {b_ms:.6f} ms ({b_by})", flush=True)

        # ---- phase 3: the full-size frame; the main path is the fused frame
        scene, lights, env, cam, cfg = pt.scene.soup_frame(device=dev)
        npix = cfg.frame_buffer_size
        builder = "native" if native_bvh.available() else "python"
        print(f"phase3 scene: {scene.num_triangles} tris, K={scene.num_clusters} "
              f"clusters of C={scene.tris_per_cluster} ({builder} BVH builder)", flush=True)
        img, main_counts = counted(lambda: pt.render.render_image(scene, lights, env, cam, cfg))
        check(main_counts == {"resident_closest": 0, "resident_anyhit": 0, "frame_sample": 1},
              f"main frame launches {main_counts}")
        check(tuple(img.shape) == (256, 256, 3) and bool(torch.isfinite(img).all())
              and bool((img >= 0).all()) and float(img.max()) > 0.0,
              "frame image is not finite, nonnegative and lit")
        _, composed_counts = counted(
            lambda: pt.render.render_image(scene, lights, env, cam, off(cfg)))
        check(composed_counts == {"resident_closest": cfg.bounces,
                                  "resident_anyhit": cfg.bounces, "frame_sample": 0},
              f"composed frame launches {composed_counts}")
        seeds = iter(range(1, 1000))
        frame_ms = cuda_ms(torch, lambda: pt.render.render_image(
            scene, lights, env, cam, cfg, base_sample=next(seeds)), reps=7)
        composed_ms = cuda_ms(torch, lambda: pt.render.render_image(
            scene, lights, env, cam, off(cfg), base_sample=next(seeds)), reps=7)
        with plain_traces(pt):
            plain_frame_ms = cuda_ms(torch, lambda: pt.render.render_image(
                scene, lights, env, cam, off(cfg), base_sample=next(seeds)), reps=1, warmup=0)
        print(f"phase3 frame 256x256 spp1 b4 ris: fused {frame_ms:.3f} ms, composed "
              f"{composed_ms:.3f} ms (medians of 7); composed with the plain versions "
              f"{plain_frame_ms:.1f} ms (one run); launches fused {main_counts}, "
              f"composed {composed_counts}", flush=True)
        k3_ms = cuda_ms(torch, lambda: samples(cfg, True, next(seeds)), reps=7)
        # what each further bounce costs K3, beside the paths still alive in it
        by_depth = [cuda_ms(torch, lambda: samples(dataclasses.replace(cfg, bounces=nb), True),
                            reps=5) for nb in range(1, cfg.bounces + 1)]

        per_bounce = frame_wavefronts(pt, scene, lights, env, cam, cfg)
        alive = [int(w["closest"][4].sum()) for w in per_bounce]
        shadows = [int(w["shadow"][4].sum()) for w in per_bounce]
        print(f"phase3 paths alive per bounce {alive}, shadow rays per bounce {shadows} "
              f"of {npix} pixels; K3 ms at 1..{cfg.bounces} bounces "
              f"{[round(t, 3) for t in by_depth]}", flush=True)
        waves = named_wavefronts(per_bounce)
        timings = {}
        for wname, rays in waves.items():
            n_act = int(rays[4].sum())
            if wname == "shadow0":
                k_fn = lambda: pt.ops.resident_anyhit(scene, *rays)
                p_fn = lambda: pt.ops.resident_anyhit_plain(scene, *rays)
            else:
                k_fn = lambda: pt.ops.resident_closest(scene, *rays)
                p_fn = lambda: pt.ops.resident_closest_plain(scene, *rays)
            k_ms = cuda_ms(torch, k_fn, reps=20)
            p_ms = cuda_ms(torch, p_fn, reps=3)
            timings[wname] = (k_ms, p_ms, n_act)
            print(f"phase3 wavefront {wname}: {n_act} active rays, kernel {k_ms:.4f} ms "
                  f"({n_act / k_ms / 1e3:.1f} Mrays/s), plain {p_ms:.2f} ms", flush=True)

        # ---- phase 4: kernels vs plain versions on the card
        k1_err, k2_err = 0.0, 0.0
        k1_dis, k2_dis = 0, 0
        work = {}
        for wname, rays in waves.items():
            if wname == "shadow0":
                got = pt.ops.resident_anyhit(scene, *rays)
                want = pt.ops.resident_anyhit_plain(scene, *rays)
                e, ndis = compare_anyhit(pt, scene, rays, got, want)
                k2_err, k2_dis = max(k2_err, e), k2_dis + ndis
                work[wname] = anyhit_work(pt, scene, rays, want)
                print(f"phase4 K2 {wname}: {ndis} flag disagreements ok", flush=True)
            else:
                got = pt.ops.resident_closest(scene, *rays)
                want = pt.ops.resident_closest_plain(scene, *rays)
                e, ndis, nid = compare_closest(pt, scene, rays, got, want)
                k1_err, k1_dis = max(k1_err, e), k1_dis + ndis
                work[wname] = closest_work(pt, scene, rays, want)
                print(f"phase4 K1 {wname}: {ndis} flag disagreements, {nid} tie ids, "
                      f"max abs err t/u/v {e:.3g} ok", flush=True)

        # K3 against its plain version at the main path's shapes (the one
        # plain run is also its time), then against the composed path
        got = samples(cfg, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pt.ops.render_frame_fused_plain(scene, lights, env, cam, 0, cfg, spp=cfg.spp)
        torch.cuda.synchronize()
        k3_plain_ms = (time.perf_counter() - t0) * 1e3
        k3_dis, k3_err = compare_frames("K3 vs plain, 64k frame", got, want, npix)
        print(f"phase4 K3 vs its plain version, 64k frame: {k3_dis} outlier pixels of {npix}, "
              f"max abs err elsewhere {k3_err:.3g} ok; plain {k3_plain_ms:.1f} ms (one run)",
              flush=True)
        again = samples(cfg, True)
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              "two K3 launches with the same arguments differ")
        print("phase4 K3 determinism: two launches bit-identical ok", flush=True)
        for mode, rr in (("ris", 0), ("ris", 2), ("sum", 2)):
            c4 = dataclasses.replace(cfg, nee_mode=mode, russian_roulette=rr, spp=2)
            ndis, e = compare_frames(f"K3 vs composed, {mode} rr{rr}", samples(c4, True, 3),
                                     samples(c4, False, 3), npix)
            print(f"phase4 K3 vs the composed path, 64k frame spp2 {mode} roulette {rr}: "
                  f"{ndis} outlier pixels of {npix}, max abs err elsewhere {e:.3g} ok",
                  flush=True)
        frame_scene = (scene, lights, env, cam)
        meshes, lights = pt.scene.textured_cornell_box(with_water_sphere=True, device=dev)
        scene = pt.scene.device_scene_from_meshes(
            meshes, textures=[pt.scene.checkerboard(tiles=4)], device=dev)
        env = pt.scene.EnvironmentMap.constant((0.2, 0.3, 0.4), device=dev)
        cam = pt.core.Camera.look_at([0.5, 0.9, 2.2], [0.5, 0.2, 0.0], [0, 1, 0],
                                     45.0, 32, 32, device=dev)
        for mode, rr in (("ris", 0), ("sum", 2)):
            c4 = pt.render.RenderConfig(width=32, height=32, spp=4, bounces=3,
                                        nee_mode=mode, russian_roulette=rr)
            got_t = samples(c4, True, 2)
            ndis, e = compare_frames(
                f"K3 vs plain, textured cornell {mode}", got_t,
                pt.ops.render_frame_fused_plain(scene, lights, env, cam, 2, c4, spp=4), 1024)
            ndis_c, _ = compare_frames(f"K3 vs composed, textured cornell {mode}", got_t,
                                       samples(c4, False, 2), 1024)
            print(f"phase4 K3 textured checkerboard cornell + water box 32x32 spp4 b3 {mode} "
                  f"roulette {rr}: {ndis} outlier pixels vs plain, {ndis_c} vs composed, of 1024, "
                  f"max abs err elsewhere {e:.3g} ok", flush=True)
        scene, lights, env, cam = frame_scene

        # ---- phase 5: the kernels line
        b1, b1_by = bound(work["camera"])
        b2, b2_by = bound(work["shadow0"])
        k3_work = frame_work(pt, scene, lights, env, cfg, per_bounce)
        b3, b3_by = bound(k3_work)
        src = "pg2024_dprt_tpu_torch/csrc/resident_trace.cu"
        kernels = [
            {"name": "resident_closest", "route": "cuda", "source": src,
             "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1372 (_kernel; "
                         "also _kernel_tiny :1114, _kernel_tiny_t :1284)",
             "launches": composed_counts["resident_closest"], "max_abs_err": k1_err,
             "disagreements": k1_dis,
             "ms": timings["camera"][0], "plain_ms": timings["camera"][1],
             "bound_ms": b1, "bound_by": b1_by, "library_ms": None},
            {"name": "resident_anyhit", "route": "cuda", "source": src,
             "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1773 (_occl_kernel; "
                         "also _occl_kernel_tiny :1153, _occl_kernel_tiny_t :1361)",
             "launches": composed_counts["resident_anyhit"], "max_abs_err": k2_err,
             "disagreements": k2_dis,
             "ms": timings["shadow0"][0], "plain_ms": timings["shadow0"][1],
             "bound_ms": b2, "bound_by": b2_by, "library_ms": None},
            {"name": "frame_sample", "route": "cuda",
             "source": "pg2024_dprt_tpu_torch/csrc/frame.cu",
             "replaces": "pg2024_dprt_tpu/ops/pallas_frame.py:228 (_frame_kernel, "
                         "pallas_call :1087)",
             "launches": main_counts["frame_sample"], "max_abs_err": k3_err,
             "disagreements": k3_dis,
             "ms": k3_ms, "plain_ms": k3_plain_ms,
             "bound_ms": b3, "bound_by": b3_by, "library_ms": None},
        ]
        for wname, w in work.items():
            run = (f", K1 runs {w['slabs_run']} slab tests "
                   f"({w['slabs_run'] / max(w['slabs'], 1):.1f}x)" if "slabs_run" in w else "")
            print(f"phase5 work {wname}: {w['tests']} ray-triangle tests, "
                  f"{w['slabs']} slab tests, {w['bytes']} bytes needed{run}; "
                  f"bound {bound(w)[0]:.6f} ms ({bound(w)[1]})", flush=True)
        print(f"phase5 work fused frame (all {cfg.bounces} bounces): {k3_work['tests']} "
              f"ray-triangle tests, {k3_work['slabs']} slab tests, {k3_work['bytes']} bytes "
              f"needed; bound {b3:.6f} ms ({b3_by}); K3 {k3_ms:.3f} ms", flush=True)
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
