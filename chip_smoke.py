#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg2024_dprt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the nvcc build of every
     kernel source in pg2024_dprt_tpu_torch/csrc/ (sm_90a, into
     pg2024_dprt_tpu_torch/build/);
  2. cornell 32x32 spp2 b3 rendered with the kernels, held against the
     golden EXR (rtol 1e-3 / atol 1e-4);
  3. the full-size frame — a 65,536-triangle soup (512 triangles per
     cluster) under an area light, 256x256, spp 1, 4 bounces, RIS NEE —
     rendered through render_image with the launch counts reset just before
     and read just after; frame ms (CUDA events, median of 7 after a
     warm-up), per-wavefront kernel ms and Mrays/s, and the frame with the
     plain versions in place of the kernels;
  4. each kernel against its plain version on the card, on the frame's
     camera, first-bounce and first-shadow wavefronts: hit flags agree on
     >= 99.99 % of rays, every disagreement is an edge hit (min barycentric
     < 1e-5) or lies at the ray's tmax, ids agree wherever both hit and the
     plain t is unique, t/u/v within rtol 1e-4 / atol 1e-5;
  5. per wavefront, the work the query needs (ray-triangle tests, slab
     tests, bytes), the bound it gives, and for K1 the slab tests it runs;
     then the kernels line (JSON, with each kernel's flag disagreements on
     the phase-4 wavefronts), the card line, and the final
     {"ok": true, "device": {...}} line.

Without CUDA, or run alone outside the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
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


def wavefronts(pt, scene, lights, env, camera, cfg):
    """The frame's first three trace inputs: camera rays, the first shadow
    rays, the first-bounce rays — each (origin, direction, tmin, tmax,
    active) as the engine passes them."""
    import torch

    paths = pt.render.generate_camera_paths(camera, 0)
    n = paths.capacity
    eps = torch.full((n,), cfg.t_epsilon, device=paths.origin.device)
    cam = (paths.origin, paths.direction, eps, paths.tmax, paths.is_valid)
    hits = pt.ops.resident_closest(scene, *cam)
    nxt, shadow, _ = pt.render.shade(scene, lights, env, paths, hits, 0, 0,
                                     cfg.shadow_path_count, cfg.frame_buffer_size,
                                     nee_mode=cfg.nee_mode)
    shd = (shadow.origin, shadow.direction, eps[:shadow.capacity],
           shadow.tmax * (1.0 - 1e-3), shadow.is_valid)
    b1 = (nxt.origin, nxt.direction, eps, nxt.tmax, nxt.is_valid)
    return {"camera": cam, "shadow0": shd, "bounce1": b1}


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
            "slabs_run": run_passes * k}


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
    return {"tests": tests, "slabs": slabs, "bytes": nbytes}


def bound(work):
    """(bound_ms, bound_by): the larger of the bytes the query must move
    over HBM bandwidth and its FP32 operations over the FP32 peak."""
    byte_s = work["bytes"] / HBM_BYTES_PER_S
    op_s = (work["tests"] * MT_OPS + work["slabs"] * SLAB_OPS) / FP32_FLOP_PER_S
    return max(byte_s, op_s) * 1e3, ("operations" if op_s >= byte_s else "bytes")


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
    try:
        # ---- phase 1: card + build
        card = card_line()
        t0 = time.perf_counter()
        report = _build.build(force=True)
        build_s = time.perf_counter() - t0
        print(f"phase1 card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
              f"| kernel build {build_s:.2f} s ({', '.join(report)})", flush=True)
        for name, (_, log) in report.items():
            regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
            print(f"phase1 ptxas {name}: {' | '.join(regs)}", flush=True)

        # ---- phase 2: cornell golden with the kernels
        meshes, lights = pt.scene.cornell_box(device=dev)
        scene = pt.scene.device_scene_from_meshes(meshes, device=dev)
        env = pt.scene.EnvironmentMap.constant((0.2, 0.3, 0.4), device=dev)
        cam = pt.core.Camera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0],
                                     40.0, 32, 32, device=dev)
        cfg = pt.render.RenderConfig(width=32, height=32, spp=2, bounces=3)
        pt.ops.reset_launch_counts()
        img = pt.render.render_image(scene, lights, env, cam, cfg).cpu().numpy()
        torch.cuda.synchronize()
        counts2 = dict(launches)
        golden, names = pt.utils.read_exr(GOLDEN)
        golden = golden[:, :, [names.index(ch) for ch in "RGB"]]
        err2 = float(np.abs(img - golden).max())
        check(np.allclose(img, golden, rtol=1e-3, atol=1e-4),
              f"cornell differs from the golden EXR (max abs err {err2:.3g})")
        check(all(v > 0 for v in counts2.values()), f"cornell launches {counts2}")
        print(f"phase2 cornell 32x32 spp2 b3 vs golden: max abs err {err2:.3g} "
              f"(rtol 1e-3 / atol 1e-4) ok; launches {counts2}", flush=True)

        # ---- phase 3: the full-size frame (the main path)
        scene, lights, env, cam, cfg = pt.scene.soup_frame(device=dev)
        builder = "native" if native_bvh.available() else "python"
        print(f"phase3 scene: {scene.num_triangles} tris, K={scene.num_clusters} "
              f"clusters of C={scene.tris_per_cluster} ({builder} BVH builder)", flush=True)
        pt.ops.reset_launch_counts()
        img = pt.render.render_image(scene, lights, env, cam, cfg)
        torch.cuda.synchronize()
        main_counts = dict(launches)
        check(all(v > 0 for v in main_counts.values()), f"frame launches {main_counts}")
        check(tuple(img.shape) == (256, 256, 3) and bool(torch.isfinite(img).all())
              and bool((img >= 0).all()) and float(img.max()) > 0.0,
              "frame image is not finite, nonnegative and lit")
        seeds = iter(range(1, 1000))
        frame_ms = cuda_ms(torch, lambda: pt.render.render_image(
            scene, lights, env, cam, cfg, base_sample=next(seeds)), reps=7)
        with plain_traces(pt):
            plain_frame_ms = cuda_ms(torch, lambda: pt.render.render_image(
                scene, lights, env, cam, cfg, base_sample=next(seeds)), reps=3)
        print(f"phase3 frame 256x256 spp1 b4 ris: {frame_ms:.3f} ms (median of 7); "
              f"plain versions {plain_frame_ms:.1f} ms (median of 3); "
              f"launches {main_counts}", flush=True)

        waves = wavefronts(pt, scene, lights, env, cam, cfg)
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

        # ---- phase 5: the kernels line
        b1, b1_by = bound(work["camera"])
        b2, b2_by = bound(work["shadow0"])
        src = "pg2024_dprt_tpu_torch/csrc/resident_trace.cu"
        kernels = [
            {"name": "resident_closest", "route": "cuda", "source": src,
             "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1372 (_kernel; "
                         "also _kernel_tiny :1114, _kernel_tiny_t :1284)",
             "launches": main_counts["resident_closest"], "max_abs_err": k1_err,
             "disagreements": k1_dis,
             "ms": timings["camera"][0], "plain_ms": timings["camera"][1],
             "bound_ms": b1, "bound_by": b1_by, "library_ms": None},
            {"name": "resident_anyhit", "route": "cuda", "source": src,
             "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1773 (_occl_kernel; "
                         "also _occl_kernel_tiny :1153, _occl_kernel_tiny_t :1361)",
             "launches": main_counts["resident_anyhit"], "max_abs_err": k2_err,
             "disagreements": k2_dis,
             "ms": timings["shadow0"][0], "plain_ms": timings["shadow0"][1],
             "bound_ms": b2, "bound_by": b2_by, "library_ms": None},
        ]
        for wname, w in work.items():
            run = (f", K1 runs {w['slabs_run']} slab tests "
                   f"({w['slabs_run'] / max(w['slabs'], 1):.1f}x)" if "slabs_run" in w else "")
            print(f"phase5 work {wname}: {w['tests']} ray-triangle tests, "
                  f"{w['slabs']} slab tests, {w['bytes']} bytes needed{run}; "
                  f"bound {bound(w)[0]:.6f} ms ({bound(w)[1]})", flush=True)
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
