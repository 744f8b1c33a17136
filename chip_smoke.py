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
     K3's bound from every bounce's wavefronts of the composed frame;
  6. the neural-proxy routing stage at its full width (the neural_route_64k
     row of scripts/bench_suite.py): 65,536 random rays against a
     65,536-triangle soup at 128 triangles per cluster, 8 unit proxy boxes
     around it, max_hits 3, 8 pairs of production-width vis/depth nets with
     seeded random weights (nn.Linear's bounds, a different draw per
     object). The main path is secondary_route and shadow_direct_light_nn by
     their default dispatch: launches {schedule_keys: 1, route_secondary: 1}
     (secondary rays are scattered, so K7 runs on them in schedule order) and
     {route_shadow: 1}. The same stages composed (schedule_keys, K1 or K2,
     proxy_march, mlp_dense; with a 12-object model set, which is over the
     dense rule, mlp_pair). Each kernel against its plain version on the
     card: K8 on every ray (integer keys, equal), with the times of K1 and
     K7 on the wavefront as given and in schedule order; K4 on
     every row (ids, flags and sequence equal, t rtol 1e-5 / atol 1e-6,
     features rtol 1e-4 / atol 2e-5, phi / 2pi modulo 1), also on the
     instanced table of the march_instanced row; K5 and K6 within rtol / atol
     2e-2 (bf16 operands, sums in another order; the count beyond 1e-3 is
     printed), on the seeded nets and on the straddling nets below, where
     outputs spread by 0.6 and the plain version with the object ids rotated
     by one must differ beyond the tolerance on most rows (a wrong object's
     weights would show); K7 against its plain
     version and against the composed stage, on the seeded nets and on the
     same nets with the heads shifted so that predictions straddle the
     thresholds: 0 disagreeing decisions among the rays none of whose queries
     is at a knife edge (|vis - 0.5| < 0.05, or a predicted t, length or depth
     within 2e-2 relative of what it is compared with), the size of that set
     printed; predicted t within 2e-2 of the box diagonal. CUDA-event medians
     of 7 for each kernel and stage, the plain versions' times, the bounds,
     and the per-object bf16 torch.matmul chain as K5/K6's yardstick; then
     the kernels line (JSON, eight kernels; `disagreements` is the flag
     disagreements of K1/K2 on the phase-4 wavefronts, K3's outlier pixels
     against its plain version, K4's rows with another id or flag, K5/K6's
     values beyond tolerance, K7's decisions outside the knife-edge set, K8's
     rays with another key), the
     card line, and the final {"ok": true, "device": {...}} line.

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
BF16_TENSOR_FLOP_PER_S = 989e12
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


# ---------------------------------------------------------------------------
# phase 6: the neural-proxy routing stage

UNIT_PROXY_OFFSETS = [[-1.05, 0, 0], [1.05, 0, 0], [0, -1.05, 0], [0, 1.05, 0],
                      [0, 0, -1.05], [0, 0, 1.05], [-1.05, -1.05, 0], [1.05, 1.05, 0]]
MAX_HITS = 3
MARCH_EPS = 1e-3
# FP32 operations of one slab test plus candidate selection in the march
MARCH_OPS = 25
# bytes of one NNQuery record the march writes (features 20, six 4-byte
# fields, two flags, path_index 4, normalized_t 4)
QUERY_BYTES = 54


@contextlib.contextmanager
def composed_route(pt):
    """Send the proxy stages down their composed path (the path of what the
    fused route's gate rejects), to hold the fused kernel against it."""
    stages = pt.render.proxy_stages
    saved = stages._use_fused_route
    stages._use_fused_route = lambda *a: False
    try:
        yield
    finally:
        stages._use_fused_route = saved


def route_config(pt, torch, np, dev, n=65536):
    """The neural_route_64k row of scripts/bench_suite.py, not cut: scene,
    proxy table, models, secondary paths, shadow paths (tmax 2.0), env."""
    scene = pt.scene.device_scene_from_meshes(
        [pt.scene.random_tri_soup(65536, seed=0)], tris_per_cluster=128, device=dev)
    rng = np.random.RandomState(1)
    o = rng.rand(n, 3).astype(np.float32) * 1.4 - 0.2
    d = rng.randn(n, 3).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    on = lambda a: torch.as_tensor(a, device=dev)
    offs = np.asarray(UNIT_PROXY_OFFSETS, np.float32)
    proxies = pt.scene.ProxyTable(
        aabb_min=on(offs), aabb_max=on(offs + 1.0),
        max_length=on(np.linalg.norm(np.ones((8, 3), np.float32), axis=1).astype(np.float32)))
    models = pt.models.random_proxy_models(np.random.RandomState(1), 8, device=dev)
    paths = pt.core.PathState.empty(n, device=dev)._replace(
        origin=on(o), direction=on(d),
        tmax=torch.full((n,), 3.4e38, device=dev),
        throughput=torch.ones((n, 3), device=dev),
        pixel_index=torch.arange(n, device=dev),
        is_valid=torch.ones((n,), dtype=torch.bool, device=dev))
    shadow = paths._replace(tmax=torch.full((n,), 2.0, device=dev))
    env = pt.scene.EnvironmentMap.constant((0.4, 0.5, 0.7), device=dev)
    return scene, proxies, models, paths, shadow, env


def instanced_march_config(pt, torch, np, dev, n=65536):
    """The march_instanced row of scripts/bench_suite.py: 16 instance rows
    over 4 objects and 8 nodes; the caller is node 31."""
    rng = np.random.RandomState(17)
    p = 16
    offs = rng.rand(p, 3).astype(np.float32) * 4.0 - 1.5
    sc = 0.4 + rng.rand(p).astype(np.float32) * 0.8
    m = np.zeros((p, 3, 4), np.float32)
    for i in range(p):
        m[i, :, :3] = np.eye(3, dtype=np.float32) / sc[i]
        m[i, :, 3] = -offs[i] / sc[i]
    on = lambda a: torch.as_tensor(a, device=dev)
    table = pt.scene.ProxyTable(
        aabb_min=on(offs), aabb_max=on(offs + sc[:, None]),
        max_length=on(np.full((p,), np.sqrt(3.0), np.float32)),
        obj_id=on((np.arange(p) % 4).astype(np.int32)),
        node_id=on((np.arange(p) % 8).astype(np.int32)),
        world_to_obj=on(m), obj_min=on(np.zeros((p, 3), np.float32)),
        obj_span=on(np.ones((p, 3), np.float32)))
    o = rng.rand(n, 3).astype(np.float32) * 5.0 - 2.0
    d = rng.randn(n, 3).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays = (on(o), on(d), torch.full((n,), 3.4e38, device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev))
    return table, rays, 31


def compare_march(name, got, want):
    """K4 against its plain version on every row. Returns (max abs err of t
    and the features, rows with another id or flag)."""
    import torch

    dis = torch.zeros_like(want.is_valid)
    for f in ("aabb_id", "node_id", "hit_sequence", "is_inside", "is_valid", "path_index"):
        dis |= getattr(got, f) != getattr(want, f)
    ndis = int(dis.sum())
    check(ndis == 0, f"{name}: {ndis} rows with another id, flag or sequence")
    err = 0.0
    for f in ("aabb_t", "max_length", "t_ratio", "normalized_t"):
        a, b = getattr(got, f), getattr(want, f)
        ok = torch.isclose(a, b, rtol=1e-5, atol=1e-6)
        check(bool(ok.all()), f"{name}: {f} differs on {int((~ok).sum())} rows")
        err = max(err, float((a - b).abs().max()))
    diff = (got.features - want.features).abs()
    diff[:, 3] = torch.minimum(diff[:, 3], 1.0 - diff[:, 3])      # phi / 2pi wraps
    ok = diff <= 2e-5 + 1e-4 * want.features.abs()
    check(bool(ok.all()), f"{name}: features differ on {int((~ok).any(1).sum())} rows")
    check(bool(torch.isfinite(got.features).all()), f"{name}: features are not finite")
    return max(err, float(diff.max())), ndis


def compare_nets(name, got, want):
    """K5 / K6 against the plain version: (max abs err, values beyond rtol /
    atol 2e-2, values beyond rtol / atol 1e-3) over vis and depth; fails on
    any value beyond 2e-2."""
    import torch

    err, beyond, fine = 0.0, 0, 0
    for a, b in zip(got, want):
        check(bool(torch.isfinite(a).all()), f"{name}: predictions are not finite")
        beyond += int((~torch.isclose(a, b, rtol=2e-2, atol=2e-2)).sum())
        fine += int((~torch.isclose(a, b, rtol=1e-3, atol=1e-3)).sum())
        err = max(err, float((a - b).abs().max()))
    check(beyond == 0, f"{name}: {beyond} predictions beyond rtol/atol 2e-2 "
                       f"(max abs err {err:.3g})")
    return err, beyond, fine


def straddling(pt, torch, models, vis, depth, valid):
    """The same nets with their heads' last Linear rescaled so that, on this
    query batch, vis spreads around the 0.5 threshold (mean 0.5, deviation
    0.6) and depth around 0.3 (deviation 0.15): predictions then decide
    routes, which the seeded nets' small outputs never do."""
    out = {}
    for key, params, pred, mean, dev_ in (("vis_params", models.vis_params, vis, 0.5, 0.6),
                                          ("depth_params", models.depth_params, depth, 0.3, 0.15)):
        mu, sd = float(pred[valid].mean()), float(pred[valid].std())
        gain = dev_ / max(sd, 1e-6)
        out[key] = {**params, "head_w1": params["head_w1"] * gain,
                    "head_b1": (params["head_b1"] - mu) * gain + mean}
    return dataclasses.replace(models, **out)


def knife_edges(torch, q, vis, depth, local_t, shadow: bool):
    """(N,) rays with a query at a knife edge: |vis - 0.5| < 0.05, or a
    predicted t, length or depth within 2e-2 relative of what the consumption
    compares it with (secondary: the local bound, the entry distance of an
    inside hit, another node's prediction; shadow: the entry depth of an
    inside hit)."""
    n = local_t.shape[0]
    mh = q.is_valid.shape[0] // n
    near = lambda a, b: (a - b).abs() < 2e-2 * b.abs() + 1e-6
    edge = (vis - 0.5).abs() < 0.05
    if shadow:
        edge |= q.is_inside & near(depth, q.normalized_t)
        return (edge & q.is_valid).reshape(n, mh).any(1)
    pred_len = q.t_ratio * q.max_length * depth
    pred_t = torch.where(q.is_inside, (q.aabb_t - pred_len).clamp(min=0.0), q.aabb_t + pred_len)
    edge |= near(pred_t, local_t.repeat_interleave(mh))
    edge |= q.is_inside & near(pred_len, q.aabb_t)
    ray = (edge & q.is_valid).reshape(n, mh).any(1)
    shown = torch.where(q.is_valid & (vis > 0.5), pred_t, float("inf")).reshape(n, mh)
    node = q.node_id.reshape(n, mh)
    for a in range(mh):
        for b in range(a + 1, mh):
            both = torch.isfinite(shown[:, a]) & torch.isfinite(shown[:, b])
            ray |= both & near(shown[:, a], shown[:, b]) & (node[:, a] != node[:, b])
    return ray


def compare_decisions(name, got, want, edge, fields, t_field, diag):
    """Decisions of two runs of the routing stage, ray by ray: the fields in
    `fields` equal and `t_field` within 2e-2 of the box diagonal (the nets'
    tolerance times the depth denormalizer) plus 2e-2 relative, except among
    the knife-edge rays `edge`. Returns (disagreements outside the set,
    disagreements inside it, max abs err of t_field elsewhere)."""
    import torch

    dis = torch.zeros_like(edge)
    for f in fields:
        dis |= got[f].to(torch.int64) != want[f].to(torch.int64)
    a, b = got[t_field], want[t_field]
    t_err = (a - b).abs()
    dis |= t_err > 2e-2 * diag + 2e-2 * b.abs()
    outside = int((dis & ~edge).sum())
    check(outside == 0, f"{name}: {outside} rays disagree outside the knife-edge set "
                        f"({int(edge.sum())} rays set aside)")
    same = ~dis
    err = float(t_err[same].max()) if bool(same.any()) else 0.0
    return outside, int((dis & edge).sum()), err


def nets_work(pt, models, q_rows: int, valid_rows: int):
    """What the vis + depth nets need on a batch: the multiply-adds of one
    pair per valid row (2 FLOPs each), and the bytes (20 B of features, an
    object id and a flag in and 8 B out per row, every net's bf16 weights and
    f32 biases once)."""
    macs = (pt.models.mlp.macs_per_row(models.vis_cfg)
            + pt.models.mlp.macs_per_row(models.depth_cfg))
    biases = sum(fo for cfg in (models.vis_cfg, models.depth_cfg)
                 for _, _, fo in pt.models.param_shapes(cfg))
    return {"flops": 2 * macs * valid_rows,
            "bytes": q_rows * 33 + models.num_objects * (2 * macs + 4 * biases)}


def nets_bound(work):
    """(bound_ms, bound_by, FP32-pipe ms): the larger of the FLOPs at the
    dense bf16 tensor-core rate and the bytes over the memory rate; the FP32
    figure beside it, since these first kernels run on the FP32 pipes."""
    op_s = work["flops"] / BF16_TENSOR_FLOP_PER_S
    byte_s = work["bytes"] / HBM_BYTES_PER_S
    return (max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes",
            work["flops"] / FP32_FLOP_PER_S * 1e3)


def march_work(table, n_active: int, n: int, records: int):
    """What the march needs: every allowed box once per step and active ray,
    the rays in (29 B), the records out, the table once."""
    p = table.num_partitions
    row_bytes = 36 + (72 if table.instanced else 0)
    return {"ops": n_active * MAX_HITS * p * MARCH_OPS,
            "bytes": n * 29 + records * QUERY_BYTES + p * row_bytes}


def march_bound(work):
    op_s = work["ops"] / FP32_FLOP_PER_S
    byte_s = work["bytes"] / HBM_BYTES_PER_S
    return max(op_s, byte_s) * 1e3, ("operations" if op_s >= byte_s else "bytes")


def matmul_chain(pt, torch, models, feats, obj, valid):
    """The yardstick for K5 / K6: the per-object chain of bf16 torch.matmul
    calls (addmm with the bias) over the batch sorted by object, vis then
    depth net. Returns a function that runs the chain; it is timed here and
    used on no path of the port."""
    bias_name = pt.models.mlp.bias_name
    o_count = models.num_objects
    key = torch.where(valid, obj.to(torch.int64), o_count)
    sorted_key, perm = torch.sort(key, stable=True)
    seg = torch.searchsorted(
        sorted_key, torch.arange(o_count + 1, device=feats.device)).tolist()
    xs = feats[perm].to(torch.bfloat16)
    half = [({k: v.to(torch.bfloat16) for k, v in params.items()}, cfg)
            for params, cfg in ((models.vis_params, models.vis_cfg),
                                (models.depth_params, models.depth_cfg))]

    def run():
        outs = []
        for o in range(o_count):
            x = xs[seg[o]:seg[o + 1]]
            for params, cfg in half:
                dot = lambda h, wn, out_w: torch.addmm(params[bias_name(wn)][o], h, params[wn][o])
                outs.append(pt.models.net_forward(x, dot, cfg, cfg.final_activation))
        return outs

    return run


def route_phase(pt, torch, np, dev, counted):
    """Phase 6; returns the kernels-line entries of K4-K8."""
    ops, stages = pt.ops, pt.render.proxy_stages
    scene, proxies, models, paths, shadow, env = route_config(pt, torch, np, dev)
    n = paths.capacity
    q_rows = n * MAX_HITS
    my_id = 8
    diag = float(proxies.max_length.max())
    print(f"phase6 config: {n} rays, {scene.num_triangles} tris in K={scene.num_clusters} "
          f"clusters of C={scene.tris_per_cluster}, {proxies.num_partitions} proxy boxes, "
          f"max_hits {MAX_HITS}, {models.num_objects} net pairs of width "
          f"{models.vis_cfg.width} depth {models.vis_cfg.depth} "
          f"({pt.models.mlp.macs_per_row(models.vis_cfg)} multiply-adds per net and row)",
          flush=True)

    secondary = lambda m=models: stages.secondary_route(
        scene, proxies, m, env, paths, my_id, MAX_HITS, MARCH_EPS, n)
    shadowed = lambda m=models: stages.shadow_direct_light_nn(
        scene, proxies, m, shadow, my_id, MAX_HITS, MARCH_EPS, 1, n)

    # ---- the main path: both stages by their default dispatch
    (new_paths, env_add, _), main_sec = counted(secondary)
    check(main_sec == {"schedule_keys": 1, "route_secondary": 1},
          f"secondary_route launches {main_sec}")
    (light, _), main_shd = counted(shadowed)
    check(main_shd == {"route_shadow": 1}, f"shadow_direct_light_nn launches {main_shd}")
    check(tuple(env_add.shape) == (n, 3) and tuple(light.shape) == (n, 3)
          and bool(torch.isfinite(env_add).all()) and bool(torch.isfinite(light).all())
          and bool(torch.isfinite(new_paths.tmax).all()), "stage outputs are not finite (N, 3)")
    settled = new_paths.is_hit
    check(bool((new_paths.target_node[settled] >= 0).all())
          and bool((new_paths.target_node[settled] <= my_id).all())
          and bool((new_paths.visited_mask == 0xFFFFFFFF).all())
          and float(light.sum()) > 0.0 and float(env_add.sum()) > 0.0,
          "stage outputs are out of range")
    print(f"phase6 main path: secondary_route launches {main_sec} "
          f"({int(settled.sum())} rays settled, {int((~new_paths.is_valid).sum())} to the "
          f"environment); shadow_direct_light_nn launches {main_shd} "
          f"({int((light.sum(1) > 0).sum())} rays lit)", flush=True)

    # ---- the same stages composed; 12 net pairs are over the dense rule
    with composed_route(pt):
        (c_paths, c_env, _), comp_sec = counted(secondary)
        (c_light, _), comp_shd = counted(shadowed)
        models12 = pt.models.random_proxy_models(np.random.RandomState(2), 12, device=dev)
        check(not ops.mlp.use_dense(models12.vis_params, models12.depth_params)
              and ops.mlp.use_dense(models.vis_params, models.depth_params),
              "the dense rule does not split 8 and 12 production pairs")
        _, comp12 = counted(lambda: secondary(models12))
    check(comp_sec == {"schedule_keys": 1, "resident_closest": 1, "proxy_march": 1,
                       "mlp_dense": 1}, f"composed secondary_route launches {comp_sec}")
    check(comp_shd == {"schedule_keys": 1, "resident_anyhit": 1, "proxy_march": 1,
                       "mlp_dense": 1}, f"composed shadow_direct_light_nn launches {comp_shd}")
    check(comp12 == {"schedule_keys": 1, "resident_closest": 1, "proxy_march": 1,
                     "mlp_pair": 1},
          f"composed secondary_route with 12 net pairs launches {comp12}")
    print(f"phase6 composed: secondary {comp_sec}, shadow {comp_shd}, "
          f"secondary with 12 net pairs {comp12}", flush=True)

    # ---- the composed stage's kernels by hand, for their inputs
    eps_v = torch.full((n,), MARCH_EPS, device=dev)
    live = paths.is_valid
    sec_rays = (paths.origin, paths.direction, eps_v, paths.tmax, live)
    shd_rays = (shadow.origin, shadow.direction, eps_v, shadow.tmax * (1.0 - 1e-3), live)
    hits = ops.resident_closest(scene, *sec_rays)
    local_hit = live & hits.is_hit
    local_t = torch.where(local_hit, hits.t, paths.tmax)
    march_args = (proxies, paths.origin, paths.direction, local_t, live, my_id,
                  MAX_HITS, MARCH_EPS)
    q = ops.proxy_march(*march_args)
    occ = ops.resident_anyhit(scene, *shd_rays)
    q_shd = ops.proxy_march(proxies, shadow.origin, shadow.direction, shd_rays[3], live & ~occ,
                            my_id, MAX_HITS, MARCH_EPS)
    n_valid, n_valid_shd = int(q.is_valid.sum()), int(q_shd.is_valid.sum())
    print(f"phase6 queries: secondary {n_valid} valid of {q_rows} rows "
          f"({int(q.is_inside.sum())} inside hits, {int(local_hit.sum())} local hits); shadow "
          f"{n_valid_shd} valid ({int(occ.sum())} rays occluded locally)", flush=True)

    # ---- K8 against its plain version, every ray; what schedule order buys
    key = ops.schedule_keys(scene, *sec_rays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_key = ops.schedule_keys_plain(scene, *sec_rays)
    torch.cuda.synchronize()
    k8_plain_ms = (time.perf_counter() - t0) * 1e3
    k8_dis = int((key != want_key).sum())
    check(k8_dis == 0 and key.dtype == torch.int32,
          f"K8 schedule_keys: {k8_dis} rays with another key than the plain version")
    entered = (key >> 12) != 0xFFF
    check(bool((key[entered] >> 12 < scene.num_clusters).all()) and int(entered.sum()) > n // 2,
          "K8 schedule_keys: keys out of range")
    perm = ops.schedule_order(scene, *sec_rays)
    check(bool((key[perm][1:] >= key[perm][:-1]).all()), "schedule_order is not sorted by key")
    in_order = tuple(x[perm] for x in sec_rays)
    k8_ms = cuda_ms(torch, lambda: ops.schedule_keys(scene, *sec_rays), reps=7)
    order_ms = cuda_ms(torch, lambda: ops.schedule_order(scene, *sec_rays), reps=7)
    n_live = int(live.sum())
    k8_work = {"tests": 0, "slabs": n_live * scene.num_clusters,
               "bytes": n + 32 * n_live + 32 * scene.num_clusters + 24 + 4 * n}
    k8_bound, k8_by = bound(k8_work)
    k1_ms = cuda_ms(torch, lambda: ops.resident_closest(scene, *sec_rays), reps=7)
    k1_order_ms = cuda_ms(torch, lambda: ops.resident_closest(scene, *in_order), reps=7)
    k1_sorted_ms = cuda_ms(torch, lambda: ops.trace_resident(
        scene, *sec_rays, sort_rays=True), reps=7)
    sorted_hits, _ = ops.trace_resident(scene, *sec_rays, sort_rays=True)
    check(all(torch.equal(a, b) for a, b in zip(sorted_hits, hits)),
          "the sorted closest-hit trace differs from the unsorted one")
    print(f"phase6 K8 schedule_keys vs plain: {k8_dis} rays with another key ok "
          f"({int(entered.sum())} rays enter a cluster, {int(torch.unique(key).numel())} "
          f"distinct keys); {k8_ms:.4f} ms, plain {k8_plain_ms:.1f} ms (one run), bound "
          f"{k8_bound:.6f} ms ({k8_by}: {k8_work['slabs']} slab tests, {k8_work['bytes']} "
          f"bytes); key + sort {order_ms:.4f} ms; K1 on the wavefront as given {k1_ms:.3f} ms, "
          f"in schedule order {k1_order_ms:.3f} ms, with key, sort, gather and un-sort "
          f"{k1_sorted_ms:.3f} ms", flush=True)

    # ---- K4 against its plain version, every row; the instanced table too
    k4_err, k4_dis = compare_march("K4 proxy_march", q, ops.march_proxies_plain(*march_args))
    k4_ms = cuda_ms(torch, lambda: ops.proxy_march(*march_args), reps=7)
    k4_plain_ms = cuda_ms(torch, lambda: ops.march_proxies_plain(*march_args), reps=3)
    k4_work = march_work(proxies, int(live.sum()), n, n_valid)
    k4_bound, k4_by = march_bound(k4_work)
    itable, irays, inode = instanced_march_config(pt, torch, np, dev)
    iargs = (itable, *irays, inode, MAX_HITS, MARCH_EPS)
    qi = ops.proxy_march(*iargs)
    ki_err, _ = compare_march("K4 instanced", qi, ops.march_proxies_plain(*iargs))
    ki_ms = cuda_ms(torch, lambda: ops.proxy_march(*iargs), reps=7)
    ki_plain_ms = cuda_ms(torch, lambda: ops.march_proxies_plain(*iargs), reps=3)
    ki_bound, ki_by = march_bound(march_work(itable, n, n, int(qi.is_valid.sum())))
    print(f"phase6 K4 proxy_march vs plain: every row equal, max abs err {k4_err:.3g} ok; "
          f"{k4_ms:.4f} ms, plain {k4_plain_ms:.3f} ms, bound {k4_bound:.6f} ms ({k4_by}: "
          f"{k4_work['bytes']} bytes, {k4_work['ops']} operations)", flush=True)
    print(f"phase6 K4 instanced march (16 rows, {int(qi.is_valid.sum())} valid records): "
          f"every row equal, max abs err {ki_err:.3g} ok; {ki_ms:.4f} ms, plain "
          f"{ki_plain_ms:.3f} ms, bound {ki_bound:.6f} ms ({ki_by})", flush=True)

    # ---- K5 / K6 against the plain version on the stage's query batch
    nets_args = lambda obj: (q.features, obj, q.is_valid)
    t0 = time.perf_counter()
    want_nets = ops.grouped_mlp_dense_plain(models, *nets_args(q.aabb_id))
    torch.cuda.synchronize()
    nets_plain_ms = (time.perf_counter() - t0) * 1e3
    vis, depth = ops.grouped_mlp_dense(models, *nets_args(q.aabb_id))
    k6_err, k6_beyond, k6_fine = compare_nets("K6 mlp_dense", (vis, depth), want_nets)
    k5_err, k5_beyond, k5_fine = compare_nets(
        "K5 mlp_pair", ops.grouped_mlp_pair(models, *nets_args(q.aabb_id)), want_nets)
    # 12 objects: every second query moved to one of the four further nets
    obj12 = torch.where(q.is_valid & (q.path_index % 2 == 1), (q.aabb_id + 8) % 12, q.aabb_id)
    e12, b12, f12 = compare_nets(
        "K5 mlp_pair, 12 objects", ops.grouped_mlp_pair(models12, *nets_args(obj12)),
        ops.grouped_mlp_pair_plain(models12, *nets_args(obj12)))
    k5_err, k5_beyond, k5_fine = max(k5_err, e12), k5_beyond + b12, k5_fine + f12
    # the straddling nets spread their outputs by 0.6: there a wrong object's
    # weights or a dropped layer is far beyond the tolerance, which the plain
    # version with the object ids rotated by one shows
    wide = straddling(pt, torch, models, vis, depth, q.is_valid)
    want_wide = ops.grouped_mlp_dense_plain(wide, *nets_args(q.aabb_id))
    rotated = ops.grouped_mlp_dense_plain(wide, *nets_args((q.aabb_id + 1) % models.num_objects))
    share = {}
    for name, fn in (("K6 mlp_dense", ops.grouped_mlp_dense), ("K5 mlp_pair", ops.grouped_mlp_pair)):
        got_wide = fn(wide, *nets_args(q.aabb_id))
        e, b, f = compare_nets(f"{name}, straddling nets", got_wide, want_wide)
        off = ~torch.isclose(got_wide[0], rotated[0], rtol=2e-2, atol=2e-2)
        share[name] = float(off[q.is_valid].float().mean())
        check(share[name] > 0.5, f"{name}: the check would pass another object's nets "
                                 f"(only {share[name]:.2f} of the rows differ)")
        if name == "K6 mlp_dense":
            k6_err, k6_beyond, k6_fine = max(k6_err, e), k6_beyond + b, k6_fine + f
        else:
            k5_err, k5_beyond, k5_fine = max(k5_err, e), k5_beyond + b, k5_fine + f
    spread = float(want_wide[0][q.is_valid].std())
    k6_ms = cuda_ms(torch, lambda: ops.grouped_mlp_dense(models, *nets_args(q.aabb_id)), reps=7)
    k5_ms = cuda_ms(torch, lambda: ops.grouped_mlp_pair(models, *nets_args(q.aabb_id)), reps=7)
    chain_ms = cuda_ms(torch, matmul_chain(pt, torch, models, q.features, q.aabb_id, q.is_valid),
                       reps=7)
    # chunks of at most 16 rows each kernel runs: K5 per object over the whole
    # sorted batch, K6 per object inside each 256-row tile
    rows_of = lambda key, size: torch.bincount(key[q.is_valid], minlength=size)
    chunks = lambda counts: int(((counts + 15) // 16).sum())
    o_count = models.num_objects
    k5_chunks = chunks(rows_of(q.aabb_id.to(torch.int64), o_count))
    tile = torch.arange(q_rows, device=dev) // 256
    k6_chunks = chunks(rows_of(tile * o_count + q.aabb_id, (q_rows // 256 + 1) * o_count))
    n_work = nets_work(pt, models, q_rows, n_valid)
    n_bound, n_by, n_fp32 = nets_bound(n_work)
    print(f"phase6 K6 mlp_dense vs plain (seeded and straddling nets): max abs err "
          f"{k6_err:.3g}, {k6_beyond} beyond 2e-2, {k6_fine} beyond 1e-3 ok; K5 mlp_pair (also "
          f"12 objects): max abs err {k5_err:.3g}, {k5_beyond} beyond 2e-2, {k5_fine} beyond "
          f"1e-3 ok; straddling vis deviates by {spread:.3f}, and against the plain version "
          f"with rotated object ids {share['K6 mlp_dense']:.3f} / {share['K5 mlp_pair']:.3f} of "
          f"the valid rows differ beyond 2e-2", flush=True)
    print(f"phase6 nets on {n_valid} valid rows: K6 {k6_ms:.3f} ms, K5 {k5_ms:.3f} ms "
          f"(sort and un-sort included), plain {nets_plain_ms:.1f} ms (one run), per-object "
          f"bf16 matmul chain {chain_ms:.3f} ms; bound {n_bound:.6f} ms ({n_by}: "
          f"{n_work['flops']} FLOPs at the bf16 tensor rate, {n_work['bytes']} bytes), "
          f"{n_fp32:.4f} ms at the FP32 rate; chunks of 16 rows: K5 {k5_chunks} "
          f"(fill {n_valid / (16 * k5_chunks):.2f}), K6 {k6_chunks} "
          f"(fill {n_valid / (16 * k6_chunks):.2f})", flush=True)

    # ---- K7 against its plain version and against the composed stage
    sec_args = (paths.origin, paths.direction, MARCH_EPS, paths.tmax, live, my_id,
                MAX_HITS, MARCH_EPS)
    shd_args = (shadow.origin, shadow.direction, MARCH_EPS, shd_rays[3], live, my_id,
                MAX_HITS, MARCH_EPS)
    sec_fields = ("settled_node", "has_node", "env_miss", "no_route", "local_hit")
    shd_fields = ("occluded_local", "survives")
    k7_err, k7_dis, k7_plain_ms, k7s_plain_ms = 0.0, 0, 0.0, 0.0
    vis_shd, depth_shd = ops.grouped_mlp_dense(models, q_shd.features, q_shd.aabb_id,
                                               q_shd.is_valid)
    for label, m in (("seeded nets", models), ("straddling nets", wide)):
        nets = lambda qq: ops.grouped_mlp_dense(m, qq.features, qq.aabb_id, qq.is_valid)
        v1, d1 = nets(q)
        edge = knife_edges(torch, q, v1, d1, local_t, shadow=False)
        dec = ops.route_fused(scene, proxies, m, *sec_args)
        as_given = ops.route_fused(scene, proxies, m, *sec_args, sort_rays=False)
        check(all(torch.equal(dec[f], as_given[f]) for f in dec),
              f"K7 secondary, {label}: decisions in schedule order differ from those without")
        t0 = time.perf_counter()
        ref = ops.route_fused_plain(scene, proxies, m, *sec_args)
        torch.cuda.synchronize()
        k7_plain_ms = (time.perf_counter() - t0) * 1e3
        out_p, in_p, e = compare_decisions(f"K7 secondary vs plain, {label}", dec, ref, edge,
                                           sec_fields, "new_t", diag)
        composed = ops.route.consume_secondary(q, v1, d1, live, local_hit, local_t, my_id,
                                               MAX_HITS)
        out_c, in_c, e_c = compare_decisions(f"K7 secondary vs composed, {label}", dec, composed,
                                             edge, sec_fields, "new_t", diag)
        k7_err, k7_dis = max(k7_err, e, e_c), k7_dis + out_p + out_c
        remote = dec["has_node"] & ~dec["local_hit"] & (dec["settled_node"] != my_id)
        print(f"phase6 K7 route_secondary, {label}: {int(edge.sum())} knife-edge rays set "
              f"aside; outside them {out_p} disagreements vs plain, {out_c} vs composed "
              f"(inside: {in_p}, {in_c}); max abs err of t {max(e, e_c):.3g}; "
              f"{int(remote.sum())} rays settled on a proxy's node, "
              f"{int(dec['env_miss'].sum())} env misses, {int(dec['no_route'].sum())} "
              f"without route ok", flush=True)
        v2, d2 = nets(q_shd)
        edge_s = knife_edges(torch, q_shd, v2, d2, shd_rays[3], shadow=True)
        dec_s = ops.shadow_route_fused(scene, proxies, m, *shd_args)
        t0 = time.perf_counter()
        ref_s = ops.shadow_route_fused_plain(scene, proxies, m, *shd_args)
        torch.cuda.synchronize()
        k7s_plain_ms = (time.perf_counter() - t0) * 1e3
        survives = live & ~occ
        composed_s = {"weight": ops.route.consume_shadow(q_shd, v2, d2, survives, MAX_HITS),
                      "occluded_local": occ, "survives": survives}
        out_p, in_p, _ = compare_decisions(f"K7 shadow vs plain, {label}", dec_s, ref_s, edge_s,
                                           shd_fields, "weight", 0.0)
        out_c, in_c, _ = compare_decisions(f"K7 shadow vs composed, {label}", dec_s, composed_s,
                                           edge_s, shd_fields, "weight", 0.0)
        k7_dis += out_p + out_c
        print(f"phase6 K7 route_shadow, {label}: {int(edge_s.sum())} knife-edge rays set aside; "
              f"outside them {out_p} disagreements vs plain, {out_c} vs composed (inside: "
              f"{in_p}, {in_c}); {int((dec_s['weight'] > 0).sum())} rays lit of "
              f"{int(dec_s['survives'].sum())} survivors ok", flush=True)

    # the stages as a whole, fused against composed (seeded nets)
    edge = knife_edges(torch, q, vis, depth, local_t, shadow=False)
    for f in ("target_node", "current_node", "is_hit", "is_valid", "visited_mask"):
        bad = (getattr(new_paths, f) != getattr(c_paths, f)) & ~edge
        check(not bool(bad.any()), f"stage paths differ in {f} on {int(bad.sum())} rays")
    ok = torch.isclose(new_paths.tmax, c_paths.tmax, rtol=2e-2, atol=2e-2 * diag) | edge
    check(bool(ok.all()), f"stage tmax differs on {int((~ok).sum())} rays")
    ok = torch.isclose(env_add, c_env, rtol=1e-5, atol=1e-6).all(1) | edge
    check(bool(ok.all()), f"env_add differs on {int((~ok).sum())} rays")
    edge_s = knife_edges(torch, q_shd, vis_shd, depth_shd, shd_rays[3], shadow=True)
    ok = torch.isclose(light, c_light, rtol=1e-5, atol=1e-6).all(1) | edge_s
    check(bool(ok.all()), f"the light image differs on {int((~ok).sum())} rays")
    print("phase6 stages fused vs composed: paths, env_add and the light image agree ok",
          flush=True)

    # ---- times of K7 and of the stages; K7's parts from the composed kernels
    k7_sched_ms = cuda_ms(torch, lambda: ops.route_fused(scene, proxies, models, *sec_args),
                          reps=7)
    k7_given_ms = cuda_ms(torch, lambda: ops.route_fused(
        scene, proxies, models, *sec_args, sort_rays=False), reps=7)
    order_args = (in_order[0], in_order[1], MARCH_EPS, in_order[3], in_order[4], my_id,
                  MAX_HITS, MARCH_EPS)
    k7_ms = cuda_ms(torch, lambda: ops.route_fused(
        scene, proxies, models, *order_args, sort_rays=False), reps=7)
    k7s_ms = cuda_ms(torch, lambda: ops.shadow_route_fused(scene, proxies, models, *shd_args),
                     reps=7)
    k7s_sched_ms = cuda_ms(torch, lambda: ops.shadow_route_fused(
        scene, proxies, models, *shd_args, sort_rays=True), reps=7)
    k2_ms = cuda_ms(torch, lambda: ops.resident_anyhit(scene, *shd_rays), reps=7)
    stage_ms = {"secondary fused": cuda_ms(torch, secondary, reps=7),
                "shadow fused": cuda_ms(torch, shadowed, reps=7)}
    with composed_route(pt):
        stage_ms["secondary composed"] = cuda_ms(torch, secondary, reps=7)
        stage_ms["shadow composed"] = cuda_ms(torch, shadowed, reps=7)
    parts = k1_ms + k4_ms + k6_ms
    print(f"phase6 K7: route_secondary on the wavefront in schedule order {k7_ms:.3f} ms (as "
          f"given {k7_given_ms:.3f} ms; with K8, sort, gather and un-sort {k7_sched_ms:.3f} ms), "
          f"route_shadow {k7s_ms:.3f} ms (with the schedule sort {k7s_sched_ms:.3f} ms) "
          f"(medians of 7); plain versions {k7_plain_ms:.1f} / {k7s_plain_ms:.1f} ms (one run); "
          f"the composed kernels on the rays as given: K1 {k1_ms:.3f} + K4 {k4_ms:.3f} + K6 "
          f"{k6_ms:.3f} = {parts:.3f} ms (trace {k1_ms / parts:.2f}, march "
          f"{k4_ms / parts:.3f}, nets {k6_ms / parts:.2f}); K2 {k2_ms:.3f} ms", flush=True)
    print("phase6 stages (medians of 7): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()), flush=True)

    # ---- K7's bound: the trace's operations + the march's + the nets'
    t_work = closest_work(pt, scene, sec_rays, ops.resident_closest_plain(scene, *sec_rays))
    s_work = anyhit_work(pt, scene, shd_rays, ops.resident_anyhit_plain(scene, *shd_rays))
    bounds = {}
    for name, tw, rows, recs in (("secondary", t_work, n_valid, n_valid),
                                 ("shadow", s_work, n_valid_shd, n_valid_shd)):
        nw = nets_work(pt, models, 0, rows)
        op_s = ((tw["tests"] * MT_OPS + tw["slabs"] * SLAB_OPS
                 + march_work(proxies, n, n, recs)["ops"]) / FP32_FLOP_PER_S
                + nw["flops"] / BF16_TENSOR_FLOP_PER_S)
        byte_s = (tw["bytes"] + nw["bytes"] + proxies.num_partitions * 36) / HBM_BYTES_PER_S
        bounds[name] = (max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes")
        print(f"phase6 work route_{name}: {tw['tests']} ray-triangle tests, {tw['slabs']} "
              f"slab tests, {rows} net rows ({nw['flops']} FLOPs), "
              f"{tw['bytes'] + nw['bytes']} bytes; bound {bounds[name][0]:.6f} ms "
              f"({bounds[name][1]})", flush=True)

    csrc = "pg2024_dprt_tpu_torch/csrc/"
    return [
        {"name": "proxy_march", "route": "cuda", "source": csrc + "proxy_march.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_march.py:42 (_march_kernel, pallas_call :240)",
         "launches": comp_sec["proxy_march"], "max_abs_err": max(k4_err, ki_err),
         "disagreements": k4_dis, "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None, "instanced_ms": ki_ms,
         "instanced_plain_ms": ki_plain_ms, "instanced_bound_ms": ki_bound},
        {"name": "mlp_pair", "route": "cuda", "source": csrc + "proxy_mlp.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_mlp.py:52 (_pair_kernel, pallas_call :113)",
         "launches": comp12["mlp_pair"], "max_abs_err": k5_err, "disagreements": k5_beyond,
         "ms": k5_ms, "plain_ms": nets_plain_ms, "bound_ms": n_bound, "bound_by": n_by,
         "library_ms": None, "matmul_chain_ms": chain_ms, "fp32_rate_ms": n_fp32},
        {"name": "mlp_dense", "route": "cuda", "source": csrc + "proxy_mlp.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_mlp.py:129 (_dense_kernel, pallas_call :203)",
         "launches": comp_sec["mlp_dense"], "max_abs_err": k6_err, "disagreements": k6_beyond,
         "ms": k6_ms, "plain_ms": nets_plain_ms, "bound_ms": n_bound, "bound_by": n_by,
         "library_ms": None, "matmul_chain_ms": chain_ms, "fp32_rate_ms": n_fp32},
        {"name": "route", "route": "cuda", "source": csrc + "route.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_route.py:196 (_route_kernel, pallas_call :729)",
         "launches": main_sec["route_secondary"] + main_shd["route_shadow"],
         "max_abs_err": k7_err, "disagreements": k7_dis, "ms": k7_ms, "plain_ms": k7_plain_ms,
         "bound_ms": bounds["secondary"][0], "bound_by": bounds["secondary"][1],
         "library_ms": None, "as_given_ms": k7_given_ms, "with_schedule_ms": k7_sched_ms,
         "shadow_ms": k7s_ms, "shadow_plain_ms": k7s_plain_ms,
         "shadow_bound_ms": bounds["shadow"][0]},
        {"name": "schedule_keys", "route": "cuda", "source": csrc + "resident_trace.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1167 (_sched_kernel, "
                     "pallas_call :1221)",
         "launches": main_sec["schedule_keys"],
         "max_abs_err": float((key.to(torch.int64) - want_key.to(torch.int64)).abs().max()),
         "disagreements": k8_dis, "ms": k8_ms, "plain_ms": k8_plain_ms, "bound_ms": k8_bound,
         "bound_by": k8_by, "library_ms": None, "key_and_sort_ms": order_ms},
    ]


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
        import pg2024_dprt_tpu_torch.models
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
        after; returns (result, the counts that are not 0)."""
        pt.ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in launches.items() if v}

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
                ("fused", cfg, {"frame_sample": 1})):
            img, counts2 = counted(lambda: pt.render.render_image(scene, lights, env, cam, c2))
            img = img.cpu().numpy()
            err2 = float(np.abs(img - golden).max())
            check(np.allclose(img, golden, rtol=1e-3, atol=1e-4),
                  f"cornell ({path}) differs from the golden EXR (max abs err {err2:.3g})")
            if want_counts is None:
                check(set(counts2) == {"resident_closest", "resident_anyhit"},
                      f"cornell composed launches {counts2}")
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
        check(main_counts == {"frame_sample": 1}, f"main frame launches {main_counts}")
        check(tuple(img.shape) == (256, 256, 3) and bool(torch.isfinite(img).all())
              and bool((img >= 0).all()) and float(img.max()) > 0.0,
              "frame image is not finite, nonnegative and lit")
        _, composed_counts = counted(
            lambda: pt.render.render_image(scene, lights, env, cam, off(cfg)))
        check(composed_counts == {"resident_closest": cfg.bounces,
                                  "resident_anyhit": cfg.bounces},
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

        # ---- phase 6: the neural-proxy routing stage
        kernels += route_phase(pt, torch, np, dev, counted)
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
