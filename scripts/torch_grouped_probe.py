#!/usr/bin/env python3
"""Where the port's grouped trace kernels K9 (grouped_closest) and K10
(grouped_anyhit) spend their time, and what the large-scene frames pay for
them, on one GPU.

    python scripts/torch_grouped_probe.py [--root DIR ...]
        [--parts waves,frame,dist,rule,route,k3,nets,tiles,keys,march,flat,pairs,anyhit]
        [--ablate]

Each --root is a checkout of this repository (default: the one holding this
script). Each runs in a process of its own, in the order given (to compare
two trees on one card, give them as A B B A), builds its own kernels, imports
its own pg2024_dprt_tpu_torch and prints one line `probe {json}`; the lines
are also appended to chiprun_out/grouped_probe.jsonl. The scenes and rays are
chip_smoke.py's (phase 7 and phase 9), from this script's checkout. Parts:

  waves  K1 / K9 and K2 / K10 on the large-scene wavefronts of chip_smoke.py
         phase 7 (PERF.md section 5): CUDA-event medians of 7; K9 equal to
         K1 and K10 equal to K2 on every ray.
  frame  the instanced frame (render_image, 256x256, spp 1, 4 bounces):
         frame ms (median of 7) and one profiled frame
         (utils/profile.py render_device_profile): its idle share and the
         device ms of K9 and K10 summed over their launches.
  dist   phase 9's frames, rooms_p8 exact, rooms_p8 neural (8 PROD pairs) and
         instanced_p8: frame ms (medians of 3) and the stage ms, idle share
         and K9 / K10 device ms of one profiled frame.
  rule   the dispatch rule (ops/resident.py GROUPED_MIN_CLUSTERS and the
         trace kernels' constants) at small K: the 64k soup of the soup
         frame cut at 2048 .. 128 triangles a cluster, and the cornell box:
         K1 / K9 and K2 / K10 on its camera and incoherent wavefronts (device
         ms and CUDA events around the wrappers), the frame kernel K3 in its grouped and
         flat modes on the soup frame's light, sky, camera and config, and
         the composed frame with the rule's threshold just above and at K
         (medians of 7; K3 and the frames of 5); K7 (the fused route) in its
         grouped and flat modes on neural_route_64k's rays over each cut,
         where the tree's route_fused takes a `grouped` argument.
  route  where K7 (csrc/route.cu) spends its time: a build of route.cu with
         the cycle counters of csrc/cycles.cuh (-DPG_CYCLES, into
         build/cycles/) counts the thread cycles of phase 1's trace and
         march, the block cycles of phase 1 and of phase 2 (the nets) and
         the thread cycles of phase 3 (consumption), with the rows, live
         rays, valid records and 16-row net chunks; secondary (K8's schedule
         order, as the stage runs it) and shadow, on neural_route_64k
         (K = 735), neural_route_1m (K = 3,028), the bounce-1 wavefronts of
         the rooms_p8 neural partition with the most live rays (8 PROD pairs,
         as parallel/distributed.py hands them to the stages, dead rows
         included) and K7's multi-geo mode on neural_route_64k. Beside the
         counts, the stage's and K7's ms with the package's own build.
  k3     where K3 (csrc/frame.cu) spends its time: the same counters in a
         build of frame.cu give, for each bounce, the paths alive and the
         share of the bounce's thread cycles spent in the closest-hit and
         the any-hit calls, on the 64k frame (soup_frame, K = 185) and
         frame_1m (K = 3,028), by the dispatch rule; K3's ms beside them.
  nets   the proxy nets (csrc/proxy_mlp.cuh): K6 (mlp_dense), K5 (mlp_pair,
         with its sort and un-sort) and the per-object bf16 matmul chain on
         phase 6's query batch (neural_route_64k: 8 PROD pairs), with each
         kernel's chunks, rows per weight fetch and fill by the tree's own
         plan, and, where the tree's forward has the counters of
         csrc/cycles.cuh, a build of proxy_mlp.cu with them (build/cycles/):
         the cycles of each Linear group's k-loop and epilogue, per chunk
         the block's; K7 on the route part's wavefronts: secondary in K8's schedule
         order (as the stage runs it) and as given, shadow (CUDA-event
         medians of 7).
  tiles  K7's tile size and register budget: copies of route.cu with
         kTileRays set to 64, 128 and 256, and with every instance held to 1
         or to 2 blocks an SM (kMinBlocks; build/tiles/), each with ptxas'
         registers and spills, timed on the route part's secondary and
         shadow wavefronts (CUDA-event medians of 7) and held equal to the
         package's K7 on every ray.

  keys   K8 (schedule_keys) on the secondary wavefronts of the route part
         (neural_route_64k, neural_route_1m, the rooms_p8 partition's sparse
         bounce-1 wavefront, dead rows included): the kernel's own device
         ms (torch.profiler) beside its wrapper's ms (CUDA events around the
         call), key + sort ms, the bound, the slab tests the keys need (the
         least cull, chip_smoke.py keys_work) against the flat count and
         those a thread per ray runs, the group boxes a live ray enters,
         the keys' digest (two trees'
         keys equal bit for bit where the digests are) and their equality
         with the plain version; where the tree's resident_trace.cu has
         counters in K8, a build with them (build/cycles/): the warps'
         cycles in the box loop against their whole time.
  flat   K1 (resident_closest) and K2 (resident_anyhit) where the dispatch
         rule takes them (ops/resident.py trace_grouped: under its cluster
         count): a K sweep at 128 triangles a cluster (random_tri_soup(n,
         seed=0) with n chosen for K = 1, 2, 4, 6, 12, 24, 36, 45, 46 and,
         past the rule's 47, 62, 90, 129, 239, 368, 533; and 40,000
         triangles at 2048 a cluster, K = 32), the cornell box at 32x32,
         64x64, 128x128, 181x181 and 256x256 (1,024 to 65,536 camera rays),
         partition 0 of the CLI's rooms:2, the CLI's instanced:4,512, the
         statues statue_mesh(32, seed=i) for i = 0, 1, 4, the eight
         partitions of the statue row (chip_smoke.py statue_row; its
         datagen wavefront only) and the 64k frame (soup_frame, K = 185 at
         512 a cluster; camera and first shadow, and its composed frame by
         the tree's rule: frame ms and the trace kernels' device ms).
         Wavefronts: the camera (tiled order) and the first shadow
         wavefront of a 1-bounce frame, 65,536 random rays in schedule
         order and 65,536 datagen entry rays (train/datagen.py
         _sample_entry_rays, seed 0, into the scene box). Per wavefront: K1
         and K9 (closest) or K2 and K10 (shadow), each kernel's device ms
         (torch.profiler) and wrapper ms (CUDA events), the bound
         (chip_smoke.py large_work), digests of K1's records and K2's flags
         (two trees equal bit for bit where the digests are), K9 = K1 / K10
         = K2; where the tree's resident_trace.cu has the counters of
         csrc/cycles.cuh, K1's cycle split (box passes, visits, refine; a
         -DPG_CYCLES build into build/cycles/); where the tree's K1/K2 pick
         their walk per launch (ops/resident.py flat_lanes), the device ms
         of each walk forced: a lane a ray, a team a ray.
  march  K4 (proxy_march) on neural_route_64k's secondary rays (capped at
         the local hit) and on the march_instanced table: device and
         wrapper ms, the bound, every output's digest and chip_smoke.py's
         compare_march against the plain version; where the tree's
         proxy_march.cu has counters, the threads' cycles in the march
         against those in the record stores; phase 6's secondary and shadow
         stages fused and composed (CUDA-event medians of 7).

  pairs  the streaming pair tracer K11 (pair_closest), K12 (pair_anyhit) and
         K13 (pair_woop) on chip_smoke.py phase 8's five runs (the 64k soup
         at 128 a cluster, K = 735; camera and random wavefronts, unsorted
         and sorted, region 96, and random at region 768; 512 rays a tile):
         each kernel's device ms and the method that read it
         (torch.profiler, the sum over the walk and resolve kernels where
         the tree has them; CUDA events where the profiler drops a long
         kernel's launches), its CUDA-graph ms and
         its wrapper's ms, the digest of every output (two trees equal bit
         for bit where the digests are); where the tree's walks count
         them (its tracer's pair_walk_tests, and its any_hit mode for K12),
         the walk's ray-triangle tests and their floor at 40 operations each at the
         card's FP32 rate without FMA; where the tree has a walk and a
         resolve kernel, each one's device ms. Each tree's kernels are
         matched by the CUDA function names its own chip_smoke.py gives
         (PAIR_FUNCTIONS). Then
         the digests of the three kernels on every case of
         tests/test_torch_kernels_gpu.py PAIR_CASES, and K12's on its
         ANYHIT_EDGES.
  anyhit K12 built with other walk constants (ANYHIT_VARIANTS: its shares
         of a cluster's triangles, the pieces of a region), each from a
         copy of csrc/pair_trace.cu under build/variants/, on phase 8's
         five runs: device and CUDA-graph ms, lane tests, flags equal to
         the package's K12.

--ablate measures, on a tree whose K9 / K10 run the per-thread walks of
csrc/resident_trace.cuh (closest_hit_grouped / any_hit_grouped), where those
walks spend their time: it builds a copy of csrc/resident_trace.cu whose K9 /
K10 run the same walks with clock64() counters around each pick pass and each
cluster visit (into build/ablate/, not a source of the package), and reports
on the instanced camera wavefront, its first shadow wavefront and
incoherent_1m the share of thread cycles in the passes and in the triangle
loops, passes, visits and triangles per active ray, and the occupancy the
launch reaches (resident blocks per SM by the occupancy API, the warps the
launch brings against the card's 64 per SM). Needs CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import inspect
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "chiprun_out", "grouped_probe.jsonl")

# the CUDA functions of K1 / K2 / K9 / K10 (a template instance matches), by
# the probe's short names and the wrappers that launch them
FLAT_FUNCTIONS = {"k1": "closest_kernel", "k2": "anyhit_kernel", "k9": "grouped_closest_kernel",
                  "k10": "grouped_anyhit_kernel"}
FLAT_WRAPPERS = {"k1": "resident_closest", "k2": "resident_anyhit", "k9": "grouped_closest",
                 "k10": "grouped_anyhit"}
# the flat part's K sweep: (K, triangles of random_tri_soup(n, seed=0),
# triangles a cluster)
FLAT_SWEEP = ((1, 70, 128), (2, 140, 128), (4, 280, 128), (6, 480, 128), (12, 1008, 128),
              (24, 2080, 128), (36, 3440, 128), (45, 4036, 128), (46, 4140, 128),
              (32, 40000, 2048), (62, 5000, 128), (90, 8000, 128), (129, 12000, 128),
              (239, 20000, 128), (368, 32000, 128), (533, 48000, 128))
# the CLI's automatic light (render/__main__.py --light-intensity)
AUTO_LIGHT = 8.0

# the CUDA functions of K11-K13 in a tree whose csrc/pair_trace.cu is the
# first design's (one template, pair_kernel<mode>, a block a tile)
PAIR_FUNCTIONS_FIRST = {n: ("pair_kernel",) for n in ("pair_closest", "pair_anyhit", "pair_woop")}

# K12 built with other walk constants of csrc/pair_trace.cu (--parts
# anyhit): (name, {constant: value})
ANYHIT_VARIANTS = (("as built", {}), ("shares 1", {"kAnyShares": 1}),
                   ("shares 2", {"kAnyShares": 2}), ("shares 4", {"kAnyShares": 4}),
                   ("shares 1, pieces 16", {"kAnyShares": 1, "kPieces": 16}),
                   ("shares 1, pieces 64", {"kAnyShares": 1, "kPieces": 64}))

# the CUDA functions of K9 / K10
K9_FUNCTIONS = ("grouped_closest_kernel",)
K10_FUNCTIONS = ("grouped_anyhit_kernel",)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_probe",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profile(pt, cs, render, stages):
    prof = pt.utils.profile.render_device_profile(render, stages, top=256, reps=3)
    device_ms = lambda functions: sum(cs.kernel_device_ms(prof, f) for f in functions)
    return {"idle_share_unprofiled": prof["idle_share_unprofiled"],
            "busy_ms": prof["busy_ms"], "unprofiled_wall_ms": prof["unprofiled_wall_ms"],
            "stages_ms": prof["stages_ms"], "k9_device_ms": device_ms(K9_FUNCTIONS),
            "k10_device_ms": device_ms(K10_FUNCTIONS)}


def _scenes(pt, dev, instanced=True):
    soup = pt.scene.random_tri_soup
    frame64 = pt.scene.soup_frame(device=dev)
    scene64 = pt.scene.device_scene_from_meshes([soup(65536, seed=0)], tris_per_cluster=128,
                                                device=dev)
    scene1m = pt.scene.device_scene_from_meshes([soup(1 << 20, seed=3)], device=dev)
    inst = pt.scene.instanced_frame(device=dev) if instanced else None
    return frame64, scene64, scene1m, inst


def _waves(pt, torch, np, cs, dev, scenes):
    """chip_smoke.py phase 7's wavefronts, by name: (scene, rays)."""
    frame64, scene64, scene1m, inst = scenes
    scene185, scene_i = frame64[0], inst[0]
    lo_i, hi_i = scene_i.scene_aabb.cpu().numpy()
    cam = lambda eye, target, fov, tiled: cs.camera_wavefront(pt, torch, dev, eye, target, fov,
                                                             tiled=tiled)
    w = {"camera_64k_c512": (scene185, cam([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], 45.0, True)),
         "camera_64k": (scene64, cam([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], 45.0, True)),
         "incoherent_64k": (scene64, cs.random_wavefront(pt, torch, np, dev, scene64, -0.2,
                                                         1.4, 1)),
         "camera_1m": (scene1m, cam([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], 45.0, True)),
         "incoherent_1m": (scene1m, cs.random_wavefront(pt, torch, np, dev, scene1m, -0.2,
                                                        1.4, 1)),
         "camera_4m_instanced": (scene_i, cam([3.3, 1.5, 9.0], [3.3, 0.5, 1.0], 55.0, False)),
         "incoherent_4m_instanced": (scene_i, cs.random_wavefront(
             pt, torch, np, dev, scene_i, lo_i, hi_i - lo_i, 2))}
    first = cs.frame_wavefronts(pt, scene_i, *inst[1:4], dataclasses.replace(inst[4], bounces=1),
                                closest=pt.ops.grouped_closest)[0]
    w["frame_4m_camera"] = (scene_i, first["closest"])
    w["frame_4m_shadow0"] = (scene_i, first["shadow"])
    return w


def part_waves(pt, torch, cs, waves):
    ops = pt.ops
    out = {}
    for name, (scene, rays) in waves.items():
        k1, k9 = ops.resident_closest(scene, *rays), ops.grouped_closest(scene, *rays)
        k2, k10 = ops.resident_anyhit(scene, *rays), ops.grouped_anyhit(scene, *rays)
        dis9 = int(sum((getattr(k9, f) != getattr(k1, f)).sum() for f in k1._fields))
        dis10 = int((k10 != k2).sum())
        ms = {k: cs.cuda_ms(torch, lambda fn=fn: fn(scene, *rays), reps=7)
              for k, fn in (("k1", ops.resident_closest), ("k9", ops.grouped_closest),
                            ("k2", ops.resident_anyhit), ("k10", ops.grouped_anyhit))}
        out[name] = {"rays": int(rays[4].sum()), "rows": int(rays[0].shape[0]),
                     "k": scene.num_clusters, **{f"{k}_ms": v for k, v in ms.items()},
                     "k9_differs": dis9, "k10_differs": dis10}
        print(f"probe wave {name}: {out[name]}", flush=True)
    return out


def part_frame(pt, torch, cs, inst):
    scene_i, lights_i, env_i, cam_i, cfg_i = inst
    render = lambda s: pt.render.render_image(scene_i, lights_i, env_i, cam_i, cfg_i,
                                              base_sample=s)
    seeds = iter(range(1, 1000))
    ms = cs.cuda_ms(torch, lambda: render(next(seeds)), reps=7)
    out = {"frame_ms": ms, **_profile(pt, cs, render, pt.utils.profile.STAGES)}
    print(f"probe instanced frame: {out}", flush=True)
    return out


def part_rule(pt, torch, np, cs, dev, frame64):
    ops, res = pt.ops, pt.ops.resident
    _, lights, env, cam, cfg = frame64
    # K7 on neural_route_64k's rays and nets over each cut, in schedule order
    route = None
    if "grouped" in inspect.signature(ops.route_fused).parameters:
        _, proxies, models, paths, shadow, _ = cs.route_config(pt, torch, np, dev)
        route = (_route_args(paths, False, 8, cs), _route_args(shadow, True, 8, cs),
                 (proxies, models))
    soup = pt.scene.random_tri_soup(65536, seed=0)
    meshes, c_lights = pt.scene.cornell_box(device=dev)
    scenes = [("cornell", pt.scene.device_scene_from_meshes(meshes, device=dev), c_lights)]
    scenes += [(f"soup64k_c{tpc}", pt.scene.device_scene_from_meshes(
        [soup], tris_per_cluster=tpc, device=dev), lights) for tpc in (2048, 1024, 512, 256, 128)]
    seeds = iter(range(1, 10000))
    limits = [n for n in ("GROUPED_MIN_CLUSTERS", "CLOSEST_GROUPED_MIN_CLUSTERS",
                          "ANYHIT_GROUPED_MIN_CLUSTERS") if hasattr(res, n)]
    saved = {n: getattr(res, n) for n in limits}
    out = {}
    try:
        for name, scene, li in scenes:
            k = scene.num_clusters
            rec = {"k": k, "c": scene.tris_per_cluster}
            for wname, rays in (
                    ("camera", cs.camera_wavefront(pt, torch, dev, [0.5, 0.5, 3.0],
                                                   [0.5, 0.5, 0.5], 45.0, tiled=True)),
                    ("incoherent", cs.random_wavefront(pt, torch, np, dev, scene, -0.2, 1.4,
                                                       1))):
                for kn in ("k1", "k9", "k2", "k10"):
                    fn = getattr(ops, FLAT_WRAPPERS[kn])
                    rec[f"{wname}_{kn}_device_ms"], rec[f"{wname}_{kn}_ms"] = cs.split_ms(
                        torch, lambda: fn(scene, *rays), FLAT_FUNCTIONS[kn])
            for mode in (True, False):
                rec[f"k3_{'grouped' if mode else 'flat'}_ms"] = cs.cuda_ms(
                    torch, lambda: ops.render_frame_fused(scene, li, env, cam, next(seeds), cfg,
                                                          grouped=mode), reps=5)
            if route is not None and scene.cl_gboxes is not None:
                for kind, fn, args in (("secondary", ops.route_fused, route[0]),
                                       ("shadow", ops.shadow_route_fused, route[1])):
                    for mode in (True, False):
                        rec[f"k7_{kind}_{'grouped' if mode else 'flat'}_ms"] = cs.cuda_ms(
                            torch, lambda: fn(scene, *route[2], *args, grouped=mode), reps=7)
            off = dataclasses.replace(cfg, fused_frame="off")
            for label, limit in (("flat", k + 1), ("grouped", k)):
                for n in limits:
                    setattr(res, n, limit)
                rec[f"composed_{label}_ms"] = cs.cuda_ms(torch, lambda: pt.render.render_image(
                    scene, li, env, cam, off, base_sample=next(seeds)), reps=5)
            for n, v in saved.items():
                setattr(res, n, v)
            out[name] = rec
            print(f"probe rule {name}: {rec}", flush=True)
    finally:
        for n, v in saved.items():
            setattr(res, n, v)
    return out


def part_dist(pt, torch, np, cs, dev, inst):
    dist = pt.parallel
    P, side = 8, 256
    env = pt.scene.EnvironmentMap.constant(cs.ROOMS_ENV, device=dev)
    cam = pt.core.Camera.look_at(*cs.ROOMS_CAMERA, side, side, device=dev)
    cfg = pt.render.RenderConfig(width=side, height=side, spp=1, bounces=4)
    meshes, lights = pt.scene.two_room_scene(num_rooms=P, tris_per_room=131072, seed=2,
                                             device=dev)
    part = pt.scene.build_partitioned_scene(meshes, P, device=dev)
    prod = pt.models.random_proxy_models(np.random.RandomState(1), P, device=dev)
    _, lights_i, env_i, cam_i, cfg_i = inst
    i_meshes, grid = pt.scene.instance_grid()
    part_i = pt.scene.build_partitioned_scene_instanced(i_meshes, grid, P, device=dev)
    runs = (("rooms_p8_exact", part, None, lights, env, cam, cfg),
            ("rooms_p8_neural_prod", part, prod, lights, env, cam,
             dataclasses.replace(cfg, use_neural_proxies=True)),
            ("instanced_p8", part_i, None, lights_i, env_i, cam_i, cfg_i))
    out = {}
    for name, pa, models, li, en, ca, c in runs:
        frame = lambda s, pa=pa, models=models, li=li, en=en, ca=ca, c=c: \
            dist.render_image_distributed(pa, models, li, en, ca, c, base_sample=s,
                                          return_stats=True, device=dev)
        seeds = iter(range(1, 1000))
        ms = cs.cuda_ms(torch, lambda: frame(next(seeds)), reps=3)
        out[name] = {"frame_ms": ms, **_profile(pt, cs, frame, dist.distributed.STAGES)}
        print(f"probe {name}: {out[name]}", flush=True)
    return out


# --------------------------------------------------------------------------
# --ablate: the per-thread walks with cycle counters

_PROF_CUH = r"""
namespace resident {
// cycle counters of the probe: closest 0 pass cycles, 1 visit cycles,
// 2 passes, 3 visits, 4 rays, 5 triangles; any-hit 6 cull cycles, 7 visit
// cycles, 8 visits, 9 rays, 10 triangles
__device__ unsigned long long g_prof[12];

__device__ __forceinline__ Hit closest_hit_grouped_prof(const Ray& r, const Tables& s) {
  const int kg = s.kg;
  float best_t = kF32Max;
  long long best_slot = -1;
  float last_en = -1.0f;
  int last_k = -1;
  unsigned long long cp = 0, cv = 0, np_ = 0, nv = 0, nt = 0;
  for (;;) {
    const long long t0 = clock64();
    const float hz = horizon(r, best_t, best_slot);
    float next_en = CUDART_INF_F;
    int next_k = -1;
    for (int g = 0; g < kg; ++g) {
      const float eg = cluster_enter(r, s.gboxes, g, kg);
      if (!(eg <= hz) || eg > next_en) continue;
      const float* mb = s.mboxes + static_cast<size_t>(g) * kGroup * 8;
      const int cid0 = group_cid0(s, g);
#pragma unroll
      for (int m = 0; m < kGroup; ++m) {
        const float en = slab_enter(r, mb + 8 * m, 1);
        const int k = cid0 + m;
        if (!(en <= hz)) continue;
        if (en < last_en || (en == last_en && k <= last_k)) continue;
        if (en < next_en || (en == next_en && k < next_k)) {
          next_en = en;
          next_k = k;
        }
      }
    }
    const long long t1 = clock64();
    cp += t1 - t0;
    ++np_;
    if (next_k < 0) break;
    const Ray l = s.xf ? object_ray(r, s, next_k / s.kb) : r;
    visit_closest(l, s, next_k, best_t, best_slot);
    cv += clock64() - t1;
    ++nv;
    nt += s.counts[next_k];
    last_en = next_en;
    last_k = next_k;
  }
  atomicAdd(&g_prof[0], cp);
  atomicAdd(&g_prof[1], cv);
  atomicAdd(&g_prof[2], np_);
  atomicAdd(&g_prof[3], nv);
  atomicAdd(&g_prof[4], 1ull);
  atomicAdd(&g_prof[5], nt);
  return refine(r, s, best_slot);
}

__device__ __forceinline__ bool any_hit_grouped_prof(const Ray& r, const Tables& s) {
  const int kg = s.kg;
  const long long start = clock64();
  unsigned long long cv = 0, nv = 0, nt = 0;
  bool occ = false;
  for (int g = 0; g < kg && !occ; ++g) {
    if (cluster_enter(r, s.gboxes, g, kg) == CUDART_INF_F) continue;
    const float* mb = s.mboxes + static_cast<size_t>(g) * kGroup * 8;
    const int cid0 = group_cid0(s, g);
    const Ray l = s.xf ? object_ray(r, s, cid0 / s.kb) : r;
    for (int m = 0; m < kGroup; ++m) {
      if (slab_enter(r, mb + 8 * m, 1) == CUDART_INF_F) continue;
      const long long t0 = clock64();
      const bool h = visit_any(l, s, cid0 + m);
      cv += clock64() - t0;
      ++nv;
      nt += s.counts[cid0 + m];
      if (h) {
        occ = true;
        break;
      }
    }
  }
  const unsigned long long total = clock64() - start;
  atomicAdd(&g_prof[6], total - cv);
  atomicAdd(&g_prof[7], cv);
  atomicAdd(&g_prof[8], nv);
  atomicAdd(&g_prof[9], 1ull);
  atomicAdd(&g_prof[10], nt);
  return occ;
}
}  // namespace resident
"""

_PROF_CU = r"""
extern "C" int prof_read(unsigned long long* h) {
  return static_cast<int>(cudaMemcpyFromSymbol(h, resident::g_prof, sizeof(resident::g_prof)));
}
extern "C" int prof_clear() {
  unsigned long long z[12] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(resident::g_prof, z, sizeof(z)));
}
extern "C" int prof_occupancy(int* out) {
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], closest_kernel<true>, kThreads, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], anyhit_kernel<true>, kThreads, 0);
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, closest_kernel<true>);
  out[2] = a.numRegs;
  cudaFuncGetAttributes(&a, anyhit_kernel<true>);
  out[3] = a.numRegs;
  out[4] = kThreads;
  return static_cast<int>(cudaGetLastError());
}
"""


def _ablate_lib(root, _build):
    """Build the counter copy of resident_trace.cu; returns the library."""
    src = os.path.join(root, "pg2024_dprt_tpu_torch", "csrc")
    dst = os.path.join(root, "pg2024_dprt_tpu_torch", "build", "ablate")
    os.makedirs(dst, exist_ok=True)
    cu = open(os.path.join(src, "resident_trace.cu")).read()
    calls = ("h = resident::closest_hit_grouped(r, s);", "occ = resident::any_hit_grouped(r, s);")
    if not all(c in cu for c in calls):
        raise SystemExit("--ablate: this tree's K9 / K10 do not run the per-thread walks")
    for c in calls:
        cu = cu.replace(c, c.replace("_grouped(", "_grouped_prof("))
    cu = cu.replace('#include "resident_trace.cuh"',
                    '#include "resident_trace.cuh"\n#include "probe_prof.cuh"') + _PROF_CU
    for f in os.listdir(src):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(src, f), dst)
    with open(os.path.join(dst, "probe_prof.cuh"), "w") as fh:
        fh.write("#pragma once\n#include \"resident_trace.cuh\"\n" + _PROF_CUH)
    with open(os.path.join(dst, "resident_trace_prof.cu"), "w") as fh:
        fh.write(cu)
    so = os.path.join(dst, "libresident_trace_prof.so")
    run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                          os.path.join(dst, "resident_trace_prof.cu")],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit("--ablate: nvcc failed\n" + run.stdout + run.stderr)
    return ctypes.CDLL(so)


def part_ablate(pt, torch, cs, root, waves):
    from pg2024_dprt_tpu_torch.ops import _build

    ops = pt.ops
    base = {name: {k: cs.cuda_ms(torch, lambda fn=fn, w=waves[name]: fn(w[0], *w[1]), reps=7)
                   for k, fn in (("k9", ops.grouped_closest), ("k10", ops.grouped_anyhit))}
            for name in ("frame_4m_camera", "frame_4m_shadow0", "incoherent_1m")}
    lib = _ablate_lib(root, _build)
    saved = _build._LIBS.get("resident_trace")
    _build._LIBS["resident_trace"] = lib
    u64 = ctypes.c_ulonglong * 12
    lib.prof_read.argtypes = [ctypes.c_void_p]
    lib.prof_occupancy.argtypes = [ctypes.c_void_p]
    occ = (ctypes.c_int * 5)()
    lib.prof_occupancy(occ)
    blocks_per_sm = {"k9": occ[0], "k10": occ[1]}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"blocks_per_sm": blocks_per_sm, "registers": {"k9": occ[2], "k10": occ[3]},
           "threads_per_block": occ[4], "sms": sms}
    try:
        for name, (scene, rays) in ((n, waves[n]) for n in base):
            rec = {"rays": int(rays[4].sum()), "rows": int(rays[0].shape[0]),
                   "base_ms": base[name]}
            for key, fn in (("k9", ops.grouped_closest), ("k10", ops.grouped_anyhit)):
                lib.prof_clear()
                fn(scene, *rays)
                torch.cuda.synchronize()
                c = u64()
                lib.prof_read(c)
                c = list(c)
                if key == "k9":
                    cyc, vis = c[0] + c[1], c[1]
                    rec["k9"] = {"pass_cycle_share": c[0] / max(cyc, 1),
                                 "visit_cycle_share": vis / max(cyc, 1),
                                 "passes_per_ray": c[2] / max(c[4], 1),
                                 "visits_per_ray": c[3] / max(c[4], 1),
                                 "triangles_per_ray": c[5] / max(c[4], 1)}
                else:
                    cyc = c[6] + c[7]
                    rec["k10"] = {"cull_cycle_share": c[6] / max(cyc, 1),
                                  "visit_cycle_share": c[7] / max(cyc, 1),
                                  "visits_per_ray": c[8] / max(c[9], 1),
                                  "triangles_per_ray": c[10] / max(c[9], 1)}
                rec[key]["counter_ms"] = cs.cuda_ms(torch, lambda: fn(scene, *rays), reps=3)
                blocks = -(-rec["rows"] // occ[4])
                resident = min(blocks, sms * blocks_per_sm[key])
                rec[key]["blocks"] = blocks
                rec[key]["warps_per_sm_at_start"] = resident * (occ[4] // 32) / sms
                rec[key]["active_rays_per_warp"] = rec["rays"] / max(-(-rec["rows"] // 32), 1)
            out[name] = rec
            print(f"probe ablate {name}: {rec}", flush=True)
    finally:
        _build._LIBS["resident_trace"] = saved
    return out

# --------------------------------------------------------------------------
# route / k3 / tiles: the cycle counters of csrc/cycles.cuh in K7 and K3

MAX_HITS, MARCH_EPS = 3, 1e-3
TILE_LINE = "constexpr int kTileRays = 256;"
# the register budget of route.cu: one line for all instances, or (before
# the nets ran on the tensor cores) one per stage and net mode
BLOCKS_LINES = ("constexpr int kMinBlocks = 1;", "return kShadow && !kMultiGeo ? 2 : 1;")
# (name, the lines of route.cu (the first present is replaced), its replacement)
ROUTE_VARIANTS = [(f"tile{t}", (TILE_LINE,), f"constexpr int kTileRays = {t};")
                  for t in (64, 128, 256)]
ROUTE_VARIANTS += [(f"blocks{b}", BLOCKS_LINES, f"constexpr int kMinBlocks = {b};")
                   for b in (1, 2)]


def _nvcc_lib(_build, src, so, *flags):
    os.makedirs(os.path.dirname(so), exist_ok=True)
    run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so, src],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}\n" + run.stdout + run.stderr)
    return ctypes.CDLL(so)


def _cycles_lib(root, _build, name):
    """csrc/<name>.cu built with its cycle counters (-DPG_CYCLES) into
    build/cycles/."""
    pkg = os.path.join(root, "pg2024_dprt_tpu_torch")
    lib = _nvcc_lib(_build, os.path.join(pkg, "csrc", _build.SOURCES[name]),
                    os.path.join(pkg, "build", "cycles", f"lib{name}.so"), "-DPG_CYCLES")
    lib.cycles_read.argtypes = [ctypes.c_void_p]
    return lib


@contextlib.contextmanager
def _swapped(_build, name, lib):
    """The package's wrappers launch from `lib` instead of their own build."""
    saved = _build._LIBS.get(name)
    _build._LIBS[name] = lib
    try:
        yield
    finally:
        if saved is None:
            _build._LIBS.pop(name, None)
        else:
            _build._LIBS[name] = saved


def _cycles(torch, lib, fn):
    lib.cycles_clear()
    fn()
    torch.cuda.synchronize()
    c = (ctypes.c_ulonglong * 64)()
    lib.cycles_read(c)
    return list(c)


def _route_args(paths, shadow, my_id, cs):
    """K7's arguments after the scene, proxies and models, as the stages
    pass them (render/proxy_stages.py)."""
    if shadow:
        return (paths.origin, paths.direction, MARCH_EPS, paths.tmax * (1.0 - 1e-3),
                paths.is_valid, my_id, MAX_HITS, MARCH_EPS)
    return (paths.origin, paths.direction, MARCH_EPS, paths.tmax,
            paths.is_valid & ~paths.is_shadow, my_id, MAX_HITS, MARCH_EPS)


def _route_split(c, threads=256):
    """K7's counters as shares of the block cycles: phase 1 split between
    trace and march by their thread cycles, phase 2 (nets), phase 3
    (consumption, thread cycles over the block's threads)."""
    p1, p2, p3 = c[2], c[3], c[4] / threads
    ts = c[0] / max(c[0] + c[1], 1)
    total = max(p1 + p2 + p3, 1)
    return {"trace": p1 * ts / total, "march": p1 * (1 - ts) / total, "nets": p2 / total,
            "consume": p3 / total, "phase1_block_cycles": p1, "phase2_block_cycles": p2,
            "trace_thread_cycles": c[0], "march_thread_cycles": c[1], "blocks": c[6],
            "rows": c[9], "live_rays": c[5], "records": c[7], "chunks": c[8]}


def _route_cases(pt, torch, np, cs, dev, scene1m):
    """(label, scene, proxies, models, secondary paths, shadow paths, my_id)
    of the route part."""
    r64 = cs.route_config(pt, torch, np, dev)
    r1m = cs.route_config(pt, torch, np, dev, scene=scene1m)
    rng = np.random.RandomState(4)
    mg = pt.models.multigeo_proxy_models(
        pt.models.init_mlp(rng, pt.models.MULTIGEO_VIS, device=dev),
        pt.models.init_mlp(rng, pt.models.MULTIGEO_DEPTH, device=dev), 8,
        pt.models.MULTIGEO_VIS, pt.models.MULTIGEO_DEPTH)
    # the rooms_p8 neural frame's bounce-1 stage calls (chip_smoke.py phase 9)
    P, side = 8, 256
    env = pt.scene.EnvironmentMap.constant(cs.ROOMS_ENV, device=dev)
    cam = pt.core.Camera.look_at(*cs.ROOMS_CAMERA, side, side, device=dev)
    cfg = pt.render.RenderConfig(width=side, height=side, spp=1, bounces=4,
                                 use_neural_proxies=True)
    meshes, lights = pt.scene.two_room_scene(num_rooms=P, tris_per_room=131072, seed=2,
                                             device=dev)
    part = pt.scene.build_partitioned_scene(meshes, P, device=dev)
    prod = pt.models.random_proxy_models(np.random.RandomState(1), P, device=dev)
    store = {}
    with cs.captured_stages(pt, store):
        pt.parallel.render_image_distributed(part, prod, lights, env, cam, cfg, device=dev)
    busiest = max(range(P), key=lambda i: int(store["secondary"][i][2].is_valid.sum()))
    sec, shd = store["secondary"][busiest], store["shadow"][P + busiest]
    return [("neural_route_64k", r64[0], r64[1], r64[2], r64[3], r64[4], 8),
            ("neural_route_1m", r1m[0], r1m[1], r1m[2], r1m[3], r1m[4], 8),
            (f"rooms_p8_partition{busiest}_bounce1", sec[0], sec[1], prod, sec[2], shd[2],
             sec[3]),
            ("neural_route_64k_multigeo", r64[0], r64[1], mg, r64[3], r64[4], 8)]


def part_route(pt, torch, np, cs, root, dev, cases):
    from pg2024_dprt_tpu_torch.ops import _build

    ops = pt.ops
    lib = _cycles_lib(root, _build, "route")
    out = {}
    for label, scene, proxies, models, paths, shadow, my_id in cases:
        for kind, fn, rays in (("secondary", ops.route_fused, paths),
                               ("shadow", ops.shadow_route_fused, shadow)):
            args = _route_args(rays, kind == "shadow", my_id, cs)
            call = lambda: fn(scene, proxies, models, *args)
            rec = {"k": scene.num_clusters, "rows": int(rays.capacity),
                   "live": int(args[4].sum()), "grouped_rule": bool(ops.use_grouped(scene)),
                   "ms": cs.cuda_ms(torch, call, reps=7)}
            with _swapped(_build, "route", lib):
                rec["split"] = _route_split(_cycles(torch, lib, call))
                rec["counter_ms"] = cs.cuda_ms(torch, call, reps=3)
            out[f"{label}_{kind}"] = rec
            print(f"probe route {label} {kind}: {rec}", flush=True)
    return out


def part_k3(pt, torch, cs, root, frame64, scene1m):
    from pg2024_dprt_tpu_torch.ops import _build

    ops = pt.ops
    _, lights, env, cam, cfg = frame64
    lib = _cycles_lib(root, _build, "frame")
    seeds = iter(range(1, 1000))
    out = {}
    for name, scene in (("frame_64k", frame64[0]), ("frame_1m", scene1m)):
        call = lambda s=5: ops.render_frame_fused(scene, lights, env, cam, s, cfg)
        rec = {"k": scene.num_clusters, "grouped_rule": bool(ops.use_grouped(scene)),
               "ms": cs.cuda_ms(torch, lambda: call(next(seeds)), reps=5)}
        with _swapped(_build, "frame", lib):
            c = _cycles(torch, lib, call)
            rec["counter_ms"] = cs.cuda_ms(torch, call, reps=3)
        nb = cfg.bounces
        rec["bounces"] = [{"alive": c[24 + b], "closest_share": c[8 + b] / max(c[b], 1),
                           "anyhit_share": c[16 + b] / max(c[b], 1),
                           "thread_cycles": c[b]} for b in range(nb)]
        rec["trace_share"] = sum(c[8 + b] + c[16 + b] for b in range(nb)) / max(c[32], 1)
        rec["kernel_thread_cycles"] = c[32]
        out[name] = rec
        print(f"probe k3 {name}: {rec}", flush=True)
    return out


def _legacy_chunks(torch, models, obj, valid, tile=256, rows=16):
    """The chunks of the nets' first design (before the tensor cores): K5
    16-row chunks of each object's segment, K6 16-row chunks of each object's
    valid rows in each 256-row tile."""
    o_count, q = models.num_objects, obj.shape[0]
    live = valid & (obj >= 0) & (obj < o_count)
    n_valid = int(live.sum())
    chunks = lambda counts: int(((counts + rows - 1) // rows).sum())
    k5 = chunks(torch.bincount(obj[live].long(), minlength=o_count))
    t = torch.arange(q, device=obj.device) // tile
    k6 = chunks(torch.bincount((t * o_count + obj.long())[live],
                               minlength=(q // tile + 1) * o_count))
    out = {"rows": rows, "valid": n_valid}
    for name, c in (("k5", k5), ("k6", k6)):
        out.update({f"{name}_chunks": c, f"{name}_rows_per_fetch": n_valid / max(c, 1),
                    f"{name}_fill": n_valid / max(rows * c, 1)})
    return out


def _nets_split(c):
    """The counters of csrc/proxy_mlp.cuh's forward: per output group of a
    Linear (one warp), the cycles of its k-loop (weight loads, ldmatrix, mma)
    and of its epilogue, and its k-steps x m16 tiles; per chunk, the block's
    cycles."""
    groups = max(c[18], 1)
    return {"chunks": c[21], "chunk_cycles": c[20] / max(c[21], 1), "groups": c[18],
            "kloop_cycles_per_group": c[16] / groups,
            "epilogue_cycles_per_group": c[17] / groups,
            "ktiles_per_group": c[19] / groups,
            "kloop_cycles_per_ktile": c[16] / max(c[19], 1)}


def part_nets(pt, torch, np, cs, root, dev, cases):
    """K5, K6 and the chain on phase 6's batch (with the forward's cycle split
    where the tree's proxy_mlp.cuh has counters); K7 on the route cases."""
    ops = pt.ops
    scene, proxies, models, paths, _, _ = cs.route_config(pt, torch, np, dev)
    live = paths.is_valid
    eps_v = torch.full_like(paths.tmax, MARCH_EPS)
    hits = ops.resident_closest(scene, paths.origin, paths.direction, eps_v, paths.tmax, live)
    local_t = torch.where(live & hits.is_hit, hits.t, paths.tmax)
    q = ops.proxy_march(proxies, paths.origin, paths.direction, local_t, live, 8, MAX_HITS,
                        MARCH_EPS)
    args = (q.features, q.aabb_id, q.is_valid)
    k6 = ops.grouped_mlp_dense(models, *args)
    k5 = ops.grouped_mlp_pair(models, *args)
    out = {"valid_rows": int(q.is_valid.sum()), "rows": int(q.is_valid.shape[0]),
           "k6_ms": cs.cuda_ms(torch, lambda: ops.grouped_mlp_dense(models, *args), reps=7),
           "k5_ms": cs.cuda_ms(torch, lambda: ops.grouped_mlp_pair(models, *args), reps=7),
           "chain_ms": cs.cuda_ms(torch, cs.matmul_chain(pt, torch, models, *args), reps=7),
           "k5_equals_k6": all(torch.equal(a, b) for a, b in zip(k5, k6)),
           "chunks": (cs.nets_chunks(pt, torch, models, q.aabb_id, q.is_valid)
                      if hasattr(ops.mlp, "chunk_rows")
                      else _legacy_chunks(torch, models, q.aabb_id, q.is_valid))}
    src = open(os.path.join(os.path.dirname(pt.__file__), "csrc", "proxy_mlp.cuh")).read()
    if "CYCLES_ADD(16" in src:
        from pg2024_dprt_tpu_torch.ops import _build

        lib = _cycles_lib(root, _build, "proxy_mlp")
        for key, fn in (("k6", ops.grouped_mlp_dense), ("k5", ops.grouped_mlp_pair)):
            with _swapped(_build, "proxy_mlp", lib):
                c = _cycles(torch, lib, lambda: fn(models, *args))
            out[f"{key}_split"] = _nets_split(c)
    print(f"probe nets phase 6 batch: {out}", flush=True)
    for label, scene, proxies, models, paths, shadow, my_id in cases:
        rec = {}
        for kind, fn, rays, extra in (
                ("secondary", ops.route_fused, paths, {}),
                ("secondary_as_given", ops.route_fused, paths, {"sort_rays": False}),
                ("shadow", ops.shadow_route_fused, shadow, {})):
            a = _route_args(rays, kind == "shadow", my_id, cs)
            rec[f"k7_{kind}_ms"] = cs.cuda_ms(
                torch, lambda: fn(scene, proxies, models, *a, **extra), reps=7)
        out[label] = rec
        print(f"probe nets {label}: {rec}", flush=True)
    return out


def part_tiles(pt, torch, cs, root, cases):
    """K7 built as ROUTE_VARIANTS, timed on the route part's wavefronts, each
    equal to the package's K7."""
    from pg2024_dprt_tpu_torch.ops import _build

    ops = pt.ops
    pkg = os.path.join(root, "pg2024_dprt_tpu_torch")
    src = open(os.path.join(pkg, "csrc", "route.cu")).read()
    dst = os.path.join(pkg, "build", "tiles")
    os.makedirs(dst, exist_ok=True)
    out = {}
    for name, lines, repl in ROUTE_VARIANTS:
        line = next((ln for ln in lines if ln in src), None)
        if line is None:
            raise SystemExit(f"--parts tiles: route.cu has none of the lines {lines!r}")
        if line is BLOCKS_LINES[1]:
            repl = "return " + repl.split("= ")[1]  # the older tree's form
        cu = os.path.join(dst, f"route_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src.replace(line, repl))
        so = os.path.join(dst, f"libroute_{name}.so")
        run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", os.path.join(pkg, "csrc"),
                              "-o", so, cu], capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(f"nvcc failed on {cu}\n" + run.stdout + run.stderr)
        lib = ctypes.CDLL(so)
        rec = {"ptxas": cs.ptxas_summary(run.stdout + run.stderr)}
        for label, scene, proxies, models, paths, shadow, my_id in cases:
            for kind, fn, rays in (("secondary", ops.route_fused, paths),
                                   ("shadow", ops.shadow_route_fused, shadow)):
                args = _route_args(rays, kind == "shadow", my_id, cs)
                call = lambda: fn(scene, proxies, models, *args)
                want = call()
                with _swapped(_build, "route", lib):
                    got = call()
                    ms = cs.cuda_ms(torch, call, reps=7)
                differs = int(sum((got[f] != want[f]).sum() for f in want))
                rec[f"{label}_{kind}"] = {"ms": ms, "differs": differs}
        out[name] = rec
        print(f"probe tiles {name}: {rec}", flush=True)
    return out


def _digest(torch, *tensors):
    """sha256 of the tensors' bytes in order: two trees' outputs are equal
    bit for bit when their digests are."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _busy_warps(torch, active):
    """Warps of 32 consecutive rows that hold a live row: a thread-per-ray
    K8 walks all K boxes in each of them."""
    pad = torch.nn.functional.pad(active.to(torch.int8), (0, -active.shape[0] % 32))
    return int(pad.view(-1, 32).any(1).sum())


def _groups_entered(pt, torch, scene, rays):
    """The group boxes the live rays enter, summed (the plain slab test)."""
    res = pt.ops.resident
    inv, _, tcap = res.ray_limits(scene, *rays)
    live = torch.nonzero(rays[4])[:, 0]
    return sum(int(torch.isfinite(res.cluster_enters_plain(
        scene, rays[0][r], inv[r], tcap[r], boxes=scene.cl_gboxes)).sum())
        for r in live.split(4096))


def _counter_lib(pt, root, name, marker):
    """csrc/<name>.cu built with its cycle counters where the tree's source
    has counters in the kernel (`marker`), else None."""
    from pg2024_dprt_tpu_torch.ops import _build

    src = open(os.path.join(os.path.dirname(pt.__file__), "csrc", _build.SOURCES[name])).read()
    return _cycles_lib(root, _build, name) if marker in src else None


def part_keys(pt, torch, cs, root, cases):
    """K8 (schedule_keys) on the secondary wavefront of each route case, as
    the stage hands it over (dead rows included): the kernel's device ms
    (profiler) and its wrapper's ms (CUDA events around the call), key + sort
    ms, the bound, the slab tests the keys need against those a thread per
    ray runs (every warp that holds a live row walks all K boxes), the keys'
    digest and their equality with the plain version; with the tree's
    counters (csrc/cycles.cuh; a sample of rows), the warps' cycles in the
    box tests against their whole time."""
    from pg2024_dprt_tpu_torch.ops import _build

    ops = pt.ops
    lib = _counter_lib(pt, root, "resident_trace", "CYCLES_ADD(kKeysLoop")
    out = {}
    for label, scene, _, _, paths, _, _ in cases:
        if label.endswith("multigeo"):
            continue       # neural_route_64k's rays again
        live = paths.is_valid & ~paths.is_shadow
        rays = (paths.origin, paths.direction, torch.full_like(paths.tmax, MARCH_EPS),
                paths.tmax, live)
        call = lambda: ops.schedule_keys(scene, *rays)
        key = call()
        k, n_live = scene.num_clusters, int(live.sum())
        work = cs.keys_work(pt, scene, rays)
        b_ms, b_by = cs.bound(work)
        dev_ms, wrap_ms = cs.split_ms(torch, call, "schedule_keys_kernel")
        rec = {"k": k, "rows": int(paths.capacity), "live": n_live,
               "equal_to_plain": bool(torch.equal(key, ops.schedule_keys_plain(scene, *rays))),
               "digest": _digest(torch, key), "device_ms": dev_ms, "wrapper_ms": wrap_ms,
               "key_and_sort_ms": cs.cuda_ms(torch, lambda: ops.schedule_order(scene, *rays),
                                             reps=7),
               "bound_ms": b_ms, "bound_by": b_by, "slab_tests_needed": work["slabs"],
               "slab_tests_flat": n_live * k,
               "slab_tests_thread_per_ray": 32 * _busy_warps(torch, live) * k}
        if scene.cl_gboxes is not None:
            rec["groups_entered_per_ray"] = _groups_entered(pt, torch, scene, rays) / max(n_live, 1)
        if lib is not None:
            with _swapped(_build, "resident_trace", lib):
                c = _cycles(torch, lib, call)
            rec["split"] = {"loop_warp_cycles": c[0], "warp_cycles": c[1],
                            "loop_share": c[0] / max(c[1], 1), "live_rays": c[2],
                            "warps": c[3]}
        out[label] = rec
        print(f"probe keys {label}: {rec}", flush=True)
    return out


def part_march(pt, torch, np, cs, root, dev):
    """K4 (proxy_march) on phase 6's secondary rays (neural_route_64k, the
    local trace's t as the cap) and on the instanced table of the
    march_instanced row: device ms (profiler), wrapper ms (CUDA events), the
    bound (every row of the oracle's layout written), every output's digest
    (two trees equal bit for bit where they agree) and chip_smoke.py's
    compare_march against the plain version; with the tree's counters
    (csrc/cycles.cuh), the threads' cycles in the march against those in
    the record stores."""
    from pg2024_dprt_tpu_torch.ops import _build

    ops = pt.ops
    lib = _counter_lib(pt, root, "proxy_march", "CYCLES_ADD(kMarchLoop")
    scene, proxies, models, paths, shadow, env = cs.route_config(pt, torch, np, dev)
    live = paths.is_valid
    eps_v = torch.full_like(paths.tmax, MARCH_EPS)
    hits = ops.resident_closest(scene, paths.origin, paths.direction, eps_v, paths.tmax, live)
    local_t = torch.where(live & hits.is_hit, hits.t, paths.tmax)
    itable, irays, inode = cs.instanced_march_config(pt, torch, np, dev)
    out = {}
    for label, args in (
            ("neural_route_64k", (proxies, paths.origin, paths.direction, local_t, live, 8,
                                  MAX_HITS, MARCH_EPS)),
            ("march_instanced", (itable, *irays, inode, MAX_HITS, MARCH_EPS))):
        call = lambda: ops.proxy_march(*args)
        q = call()
        err, _ = cs.compare_march(f"probe K4 {label}", q, ops.march_proxies_plain(*args))
        n = args[1].shape[0]
        b_ms, b_by = cs.march_bound(cs.march_work(args[0], int(args[4].sum()), n))
        dev_ms, wrap_ms = cs.split_ms(torch, call, "proxy_march_kernel")
        rec = {"rays": n, "rows": int(q.is_valid.shape[0]), "valid": int(q.is_valid.sum()),
               "max_abs_err": err, "digest": _digest(torch, *q), "device_ms": dev_ms,
               "wrapper_ms": wrap_ms, "bound_ms": b_ms, "bound_by": b_by}
        if lib is not None:
            with _swapped(_build, "proxy_march", lib):
                c = _cycles(torch, lib, call)
            rec["split"] = {"march_thread_cycles": c[0], "store_thread_cycles": c[1],
                            "march_share": c[0] / max(c[0] + c[1], 1), "rays": c[2],
                            "blocks": c[3]}
        out[label] = rec
        print(f"probe march {label}: {rec}", flush=True)
    # phase 6's stages on the same rays, by the default dispatch (K8, sort,
    # K7) and composed (K8, sort, the rule's trace kernel, K4, K6)
    stages = pt.render.proxy_stages
    n = paths.capacity
    calls = {"secondary": lambda: stages.secondary_route(scene, proxies, models, env, paths, 8,
                                                         MAX_HITS, MARCH_EPS, n),
             "shadow": lambda: stages.shadow_direct_light_nn(scene, proxies, models, shadow, 8,
                                                             MAX_HITS, MARCH_EPS, 1, n)}
    out["stage_ms"] = {f"{name} fused": cs.cuda_ms(torch, fn, reps=7)
                       for name, fn in calls.items()}
    with cs.composed_route(pt):
        out["stage_ms"].update({f"{name} composed": cs.cuda_ms(torch, fn, reps=7)
                                for name, fn in calls.items()})
    print(f"probe march stages: {out['stage_ms']}", flush=True)
    if hasattr(ops.march, "query_columns"):
        # the host time of the output columns: views of one allocation
        # against one allocation a column (the first design's)
        q = paths.capacity * MAX_HITS
        empties = lambda: [torch.empty(q * w, dtype=dt, device=dev) for dt, w in (
            [(torch.float32, 5)] + [(torch.int32, 1)] * 5 + [(torch.float32, 1)] * 4
            + [(torch.bool, 1)] * 2)]
        out["host_us"] = {name: _host_us(torch, fn) for name, fn in (
            ("query_columns", lambda: ops.march.query_columns(q, dev)),
            ("one_allocation_a_column", empties))}
        print(f"probe march host: {out['host_us']}", flush=True)
    return out


def _host_us(torch, fn, reps=500):
    """Host microseconds of one fn() call, the mean over `reps` calls."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


# --------------------------------------------------------------------------
# flat: K1 and K2 under the dispatch rule's cluster count

def _flat_cycles_lib(root):
    """resident_trace.cu of the tree with the flat part's counters
    (-DPG_CYCLES), or None where its source has none."""
    from pg2024_dprt_tpu_torch.ops import _build

    src = os.path.join(root, "pg2024_dprt_tpu_torch", "csrc")
    text = "".join(open(os.path.join(src, f)).read() for f in ("resident_trace.cu",
                                                                "resident_trace.cuh"))
    return _cycles_lib(root, _build, "resident_trace") if "CYCLES_ADD(kFlatPass" in text else None


def _flat_split(c):
    """K1's counters (one ray in 8): the shares of a walk's cycles in the box
    passes, the visits and the refinement, and per ray the passes, visits,
    triangles and cycles."""
    rays, walk = max(c[11], 1), max(c[14], 1)
    return {"pass_share": c[8] / walk, "visit_share": c[9] / walk,
            "refine_share": c[10] / walk, "passes_per_ray": c[12] / rays,
            "visits_per_ray": c[13] / rays, "triangles_per_ray": c[15] / rays,
            "walk_cycles_per_ray": c[14] / rays, "sampled_rays": c[11]}


def _flat_scenes(pt, np, cs, dev, frame64):
    """(name, scene, lights, env, camera, wavefront names) of the flat part."""
    from pg2024_dprt_tpu_torch.render.__main__ import auto_camera, load_scene

    _, f_lights, f_env, f_cam, _ = frame64
    env = pt.scene.EnvironmentMap.constant((0.2, 0.3, 0.4), device=dev)
    every = ("camera", "shadow0", "incoherent", "datagen")

    def framed(scene):
        lo, hi = scene.scene_aabb.cpu().numpy()
        return (pt.scene.auto_light(lo, hi, AUTO_LIGHT, device=dev), env,
                auto_camera(lo, hi, 45.0, 256, 256, device=dev))

    out = []
    for k, n, c in FLAT_SWEEP:
        s = pt.scene.device_scene_from_meshes([pt.scene.random_tri_soup(n, seed=0)],
                                              tris_per_cluster=c, device=dev)
        out.append((f"soup_k{k}_c{c}", s, f_lights, f_env, f_cam, every))
    meshes, lights = pt.scene.cornell_box(device=dev)
    s = pt.scene.device_scene_from_meshes(meshes, device=dev)
    for side in (32, 64, 128, 181, 256):
        cam = pt.core.Camera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, side,
                                     side, device=dev)
        out.append((f"cornell_{side}", s, lights, env, cam,
                    every if side == 256 else ("camera", "shadow0")))
    meshes, lights = pt.scene.two_room_scene(2, device=dev)
    s = pt.scene.build_partitioned_scene(meshes, 2, device=dev).scenes[0]
    out.append(("rooms_partition0", s, lights, env, framed(s)[2], every))
    (base, tf), _, _ = load_scene("instanced:4,512", device=dev)
    s = pt.scene.device_scene_from_instances(base, tf, device=dev)
    out.append(("instanced_4x512", s, *framed(s), every))
    for i in (0, 1, 4):
        s = pt.scene.device_scene_from_meshes([pt.scene.statue_mesh(32, seed=i)], device=dev)
        out.append((f"statue{i}", s, *framed(s), every))
    for p, s in enumerate(cs.statue_row(pt, np, dev)[0].scenes):
        out.append((f"statue_row_p{p}", s, None, None, None, ("datagen",)))
    out.append(("frame_64k", *frame64[:4], ("camera", "shadow0")))
    return out


def _flat_waves(pt, torch, np, cs, dev, scene, lights, env, cam, names):
    """The flat part's wavefronts of one scene, by name."""
    from pg2024_dprt_tpu_torch.train import datagen

    lo, hi = scene.scene_aabb.cpu().numpy()
    w = {}
    if "camera" in names:
        cfg = pt.render.RenderConfig(width=cam.width, height=cam.height, spp=1, bounces=1)
        first = cs.frame_wavefronts(pt, scene, lights, env, cam, cfg)[0]
        w["camera"], w["shadow0"] = first["closest"], first["shadow"]
    if "incoherent" in names:
        w["incoherent"] = cs.random_wavefront(pt, torch, np, dev, scene, lo, hi - lo, 1)
    if "datagen" in names:
        o, d = datagen._sample_entry_rays(torch.Generator().manual_seed(0), lo, hi, datagen.BATCH)
        n = o.shape[0]
        w["datagen"] = (o.to(dev), d.to(dev), torch.full((n,), 1e-4, device=dev),
                        torch.full((n,), datagen.T_FAR, device=dev),
                        torch.ones(n, dtype=torch.bool, device=dev))
    return {k: v for k, v in w.items() if k in names}


@contextlib.contextmanager
def _flat_walk(res, team):
    """K1/K2 walk each ray with their team (`team`) or a lane whatever their
    rule says."""
    saved = res.flat_lanes
    res.flat_lanes = lambda k, n, any_hit=False: ((res.ANYHIT_TEAM if any_hit else
                                                   res.CLOSEST_TEAM) if team else 1)
    try:
        yield
    finally:
        res.flat_lanes = saved


def _composed_frame(pt, torch, cs, frame64):
    """The 64k frame composed (fused_frame off) by the tree's dispatch rule:
    its frame ms (median of 5, unprofiled) and the device ms of each trace
    kernel summed over one profiled frame."""
    scene, lights, env, cam, cfg = frame64
    off = dataclasses.replace(cfg, fused_frame="off")
    prof = pt.utils.profile.render_device_profile(
        lambda s: pt.render.render_image(scene, lights, env, cam, off, base_sample=s),
        pt.utils.profile.STAGES, top=256, reps=5)
    return {"frame_ms": prof["unprofiled_wall_ms"], "busy_ms": prof["busy_ms"],
            **{f"{kn}_device_ms": cs.kernel_device_ms(prof, fn)
               for kn, fn in FLAT_FUNCTIONS.items()}}


def part_flat(pt, torch, np, cs, root, dev, frame64):
    from pg2024_dprt_tpu_torch.ops import _build

    ops, res = pt.ops, pt.ops.resident
    lib = _flat_cycles_lib(root)
    walks = hasattr(res, "flat_lanes")
    out = {}
    for name, scene, lights, env, cam, names in _flat_scenes(pt, np, cs, dev, frame64):
        rule = getattr(ops, "trace_grouped", None)
        rec = {"k": scene.num_clusters, "c": scene.tris_per_cluster,
               "grouped_rule": ([rule(scene), rule(scene, True)] if rule is not None
                                else ops.use_grouped(scene))}
        for wname, rays in _flat_waves(pt, torch, np, cs, dev, scene, lights, env, cam,
                                       names).items():
            anyhit = wname == "shadow0"
            flat_k, grouped_k = ("k2", "k10") if anyhit else ("k1", "k9")
            flat = getattr(ops, FLAT_WRAPPERS[flat_k])(scene, *rays)
            grouped = getattr(ops, FLAT_WRAPPERS[grouped_k])(scene, *rays)
            fields = (flat,) if anyhit else tuple(flat)
            w = {"rays": int(rays[4].sum()), "rows": int(rays[0].shape[0]),
                 "digest": _digest(torch, *fields),
                 "grouped_equal": all(torch.equal(a, b) for a, b in
                                      zip(fields, (grouped,) if anyhit else tuple(grouped)))}
            if not anyhit:
                w["hits"] = int(flat.is_hit.sum())
            for kn in (flat_k, grouped_k):
                fn = getattr(ops, FLAT_WRAPPERS[kn])
                w[f"{kn}_device_ms"], w[f"{kn}_wrapper_ms"] = cs.split_ms(
                    torch, lambda: fn(scene, *rays), FLAT_FUNCTIONS[kn])
            work = cs.large_work(pt, torch, scene, rays, **({"occ": flat} if anyhit
                                                          else {"hits": flat}))
            w["bound_ms"], w["bound_by"] = work["bound_ms"], work["bound_by"]
            if walks:
                fn = getattr(ops, FLAT_WRAPPERS[flat_k])
                w["lanes_rule"] = res.flat_lanes(scene.num_clusters, rays[0].shape[0], anyhit)
                for team in (False, True):
                    with _flat_walk(res, team):
                        w[f"{flat_k}_{'team' if team else 'lane'}_device_ms"] = cs.device_ms(
                            torch, lambda: fn(scene, *rays), FLAT_FUNCTIONS[flat_k])
            if not anyhit and lib is not None:
                with _swapped(_build, "resident_trace", lib):
                    w["k1_split"] = _flat_split(_cycles(
                        torch, lib, lambda: ops.resident_closest(scene, *rays)))
            rec[wname] = w
        if name == "frame_64k":
            rec["composed"] = _composed_frame(pt, torch, cs, frame64)
        out[name] = rec
        print(f"probe flat {name}: {rec}", flush=True)
    return out


def _gpu_tests():
    spec = importlib.util.spec_from_file_location(
        "gpu_tests_probe", os.path.join(HERE, "tests", "test_torch_kernels_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair_outputs(got, anyhit):
    return (got,) if anyhit else tuple(got)


def _tree_pair_functions(root):
    """The CUDA functions that the tree at `root` launches for K11-K13: its
    chip_smoke.py's PAIR_FUNCTIONS, or the first design's where it has none."""
    spec = importlib.util.spec_from_file_location("chip_smoke_tree",
                                                  os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, "PAIR_FUNCTIONS", PAIR_FUNCTIONS_FIRST)


def part_pairs(pt, torch, np, cs, root, dev):
    trc = pt.ops.tracer
    functions = _tree_pair_functions(root)
    walk_modes = set()
    if hasattr(trc, "pair_walk_tests"):
        walk_modes = {"closest", "woop"}
        if "any_hit" in inspect.signature(trc.pair_walk_tests).parameters:
            walk_modes.add("anyhit")
    scene, _, _, waves = cs.pair_setup(pt, torch, np, dev)
    out = {"runs": {}, "cases": {}}
    for wname, srt, region in cs.PAIR_RUNS:
        kw = dict(cs.PAIR_KW, region=region, sort_rays=srt)
        tm = kw["tile_rays"]
        prep = trc.prepare_pairs(scene, *waves[wname], **kw)
        label = f"{wname}{' sorted' if srt else ''} region {region}"
        rec = {}
        for name, mode in cs.PAIR_KERNELS:
            anyhit = mode == "anyhit"
            call = lambda kern=getattr(trc, name): kern(scene, prep.packed, prep.pairs, tm)
            digest = _digest(torch, *_pair_outputs(call(), anyhit))
            r = {"digest": digest}
            r["device_ms"], r["ms_by"] = cs.device_reading(torch, call, functions[name], 20)
            r["wrapper_ms"] = cs.cuda_ms(torch, call, reps=7)
            r["graph_ms"] = cs.graph_ms(torch, call, reps=20)
            if len(functions[name]) > 1:
                r["functions_ms"] = {f: cs.device_ms(torch, call, f) for f in functions[name]}
            if mode in walk_modes:
                kind = {"any_hit": True} if anyhit else {"woop": mode == "woop"}
                r["walk_tests"] = trc.pair_walk_tests(scene, prep.packed, prep.pairs, tm, **kind)
                r["walk_floor_ms"] = r["walk_tests"] * cs.MT_OPS / cs.FP32_NO_FMA_OPS_PER_S * 1e3
            rec[name] = r
        out["runs"][label] = rec
        print(f"probe pairs {label}: {rec}", flush=True)
    tests = _gpu_tests()
    for case in tests.PAIR_CASES:
        scene_c, _, packed, pairs = tests._pair_case(dev, case[0], 4096, *case[1:])
        out["cases"][str(case)] = {
            name: _digest(torch, *_pair_outputs(
                getattr(trc, name)(scene_c, packed, pairs, case[2]), mode == "anyhit"))
            for name, mode in cs.PAIR_KERNELS}
    for edge in tests.ANYHIT_EDGES:
        scene_e, packed, pairs, tm, _ = tests.anyhit_edge_case(dev, *edge)
        out["cases"][f"anyhit {edge}"] = {
            "pair_anyhit": _digest(torch, trc.pair_anyhit(scene_e, packed, pairs, tm))}
    print(f"probe pairs cases: {out['cases']}", flush=True)
    return out


def part_anyhit(pt, torch, np, cs, root, dev):
    """K12 built as ANYHIT_VARIANTS (copies of csrc/pair_trace.cu with other
    constants, into build/variants/), timed on phase 8's five runs: device
    ms (profiler), CUDA-graph ms, lane tests, and whether its flags equal
    the package's K12."""
    import re

    from pg2024_dprt_tpu_torch.ops import _build

    trc = pt.ops.tracer
    pkg = os.path.join(root, "pg2024_dprt_tpu_torch")
    src = open(os.path.join(pkg, "csrc", "pair_trace.cu")).read()
    dst = os.path.join(pkg, "build", "variants")
    os.makedirs(dst, exist_ok=True)
    scene, _, _, waves = cs.pair_setup(pt, torch, np, dev)
    preps = {}
    for wname, srt, region in cs.PAIR_RUNS:
        kw = dict(cs.PAIR_KW, region=region, sort_rays=srt)
        preps[f"{wname}{' sorted' if srt else ''} region {region}"] = trc.prepare_pairs(
            scene, *waves[wname], **kw)
    tm = cs.PAIR_KW["tile_rays"]
    want = {k: trc.pair_anyhit(scene, p.packed, p.pairs, tm) for k, p in preps.items()}
    out = {}
    for i, (name, consts) in enumerate(ANYHIT_VARIANTS):
        text = src
        for const, value in consts.items():
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if n != 1:
                raise SystemExit(f"--parts anyhit: pair_trace.cu has no constant {const}")
        cu = os.path.join(dst, f"pair_trace_{i}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(dst, f"libpair_trace_{i}.so")
        run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", os.path.join(pkg, "csrc"),
                              "-o", so, cu], capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(f"nvcc failed on {cu}\n" + run.stdout + run.stderr)
        rec = {}
        with _swapped(_build, "pair_trace", ctypes.CDLL(so)):
            for label, prep in preps.items():
                call = lambda prep=prep: trc.pair_anyhit(scene, prep.packed, prep.pairs, tm)
                rec[label] = {
                    "equal": bool(torch.equal(call(), want[label])),
                    "device_ms": cs.device_ms(torch, call, cs.PAIR_FUNCTIONS["pair_anyhit"]),
                    "graph_ms": cs.graph_ms(torch, call, reps=20),
                    "walk_tests": trc.pair_walk_tests(scene, prep.packed, prep.pairs, tm,
                                                      any_hit=True)}
        out[name] = rec
        print(f"probe anyhit {name}: {rec}", flush=True)
    return out


# --------------------------------------------------------------------------

def child(root, parts, ablate):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import pg2024_dprt_tpu_torch as pt
    import pg2024_dprt_tpu_torch.models  # noqa: F401
    import pg2024_dprt_tpu_torch.ops  # noqa: F401
    import pg2024_dprt_tpu_torch.parallel  # noqa: F401
    import pg2024_dprt_tpu_torch.render  # noqa: F401
    import pg2024_dprt_tpu_torch.scene  # noqa: F401
    import pg2024_dprt_tpu_torch.utils.profile  # noqa: F401
    from pg2024_dprt_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA GPU")
    if not os.path.abspath(pt.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {pt.__file__}, not the package under {root}")
    cs = _chip_smoke()
    _build.build(force=True)
    dev = pt.core.resolve_device()
    out = {"root": root, "card": cs.card_line()}
    scenes = (_scenes(pt, dev, instanced=bool({"waves", "frame", "dist"} & parts) or ablate)
              if parts - {"pairs", "anyhit"} or ablate else None)
    waves = _waves(pt, torch, np, cs, dev, scenes) if ("waves" in parts or ablate) else None
    if "waves" in parts:
        out["waves"] = part_waves(pt, torch, cs, waves)
    if "frame" in parts:
        out["instanced_frame"] = part_frame(pt, torch, cs, scenes[3])
    if "dist" in parts:
        out["dist"] = part_dist(pt, torch, np, cs, dev, scenes[3])
    if "rule" in parts:
        out["rule"] = part_rule(pt, torch, np, cs, dev, scenes[0])
    if ablate:
        out["ablate"] = part_ablate(pt, torch, cs, root, waves)
    if "k3" in parts:
        out["k3"] = part_k3(pt, torch, cs, root, scenes[0], scenes[2])
    if "march" in parts:
        out["march"] = part_march(pt, torch, np, cs, root, dev)
    if "flat" in parts:
        out["flat"] = part_flat(pt, torch, np, cs, root, dev, scenes[0])
    if "pairs" in parts:
        out["pairs"] = part_pairs(pt, torch, np, cs, root, dev)
    if "anyhit" in parts:
        out["anyhit"] = part_anyhit(pt, torch, np, cs, root, dev)
    if {"route", "tiles", "nets", "keys"} & parts:
        cases = _route_cases(pt, torch, np, cs, dev, scenes[2])
        if "keys" in parts:
            out["keys"] = part_keys(pt, torch, cs, root, cases)
        if "nets" in parts:
            out["nets"] = part_nets(pt, torch, np, cs, root, dev, cases)
        if "route" in parts:
            out["route"] = part_route(pt, torch, np, cs, root, dev, cases)
        if "tiles" in parts:
            out["tiles"] = part_tiles(pt, torch, cs, root, cases)
    line = json.dumps(out, default=float)
    print("probe " + line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as fh:
        fh.write(line + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", help="checkout to probe (repeatable)")
    ap.add_argument("--parts", default="waves,frame,dist")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    parts = set(a.parts.split(",")) - {""}
    if a.one:
        child(os.path.abspath(a.one), parts, a.ablate)
        return 0
    rc = 0
    for root in a.root or [HERE]:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", os.path.abspath(root),
               "--parts", ",".join(sorted(parts))] + (["--ablate"] if a.ablate else [])
        rc = rc or subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
