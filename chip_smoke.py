#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg2024_dprt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the nvcc build of every
     kernel source in pg2024_dprt_tpu_torch/csrc/ (sm_90a, one nvcc per
     source, all started together, into pg2024_dprt_tpu_torch/build/), with
     ptxas' registers and spills per kernel; the HMMA (tensor-core)
     instructions in the SASS of K5, K6 and the four K7 instances
     (cuobjdump), failing where a kernel has none;
  2. cornell 32x32 spp2 b3 held against the golden EXR (rtol 1e-3 / atol
     1e-4) twice: through the composed path (fused_frame="off": K1/K2
     launched, K3 not) and through the fused frame with the default config
     (one K3 launch, K1/K2 not); K1/K2 on the cornell wavefronts (their
     main path: at K = 1 the rule takes the flat kernels), timed and held
     against their plain versions;
  3. the main path, the full-size frame — a 65,536-triangle soup (512
     triangles per cluster) under an area light, 256x256, spp 1, 4 bounces,
     RIS NEE — through render_image with the default config (the fused frame:
     launches {frame_sample: 1}), with the launch counts reset just before
     and read just after (at K = 185 K3 takes its grouped walks by the
     rule); the same frame through the composed path (fused_frame="off": the
     rule's trace kernels, K9/K10, 4/4); frame ms of both (CUDA events,
     median of 7 after a warm-up), K3's ms at every depth from 1 bounce up
     beside the paths alive per bounce, K3 through the warp walks against
     its flat mode (images bit-identical on the frame and on an odd-sized
     251x247 frame of the same soup with roulette; both timed),
     per-wavefront kernel ms and Mrays/s, and the composed frame with the
     plain versions in place of K1/K2 and K14 (one run);
  4. each kernel against its plain version on the card. K1/K2 on the frame's
     camera, first-bounce and first-shadow wavefronts: hit flags agree on
     >= 99.99 % of rays, every disagreement is an edge hit (min barycentric
     < 1e-5) or lies at the ray's tmax, ids agree wherever both hit and the
     plain t is unique, t/u/v within rtol 1e-4 / atol 1e-5. K3 against its
     plain version on the full frame and on the textured checkerboard
     cornell with the water box, and against the composed path (K1/K2 +
     K14, same seed) in "ris" and "sum" mode, with and without roulette,
     the runs with roulette against the plain version too: at most 0.1 % of the pixels outside |a-b| / max(|a|, 1e-2) <
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
     {route_shadow: 1}. The same stages composed (schedule_keys, the
     closest-hit or any-hit kernel the dispatch rule picks, proxy_march,
     mlp_dense; with a 12-object model set, which is over the dense rule,
     mlp_pair). Each kernel against its plain version on the
     card: K8 on every ray (integer keys, equal), with the times of K1 and
     K7 on the wavefront as given and in schedule order; K4 on
     every row (ids, flags and sequence equal, t rtol 1e-5 / atol 1e-6,
     features rtol 1e-4 / atol 2e-5, phi / 2pi modulo 1), also on the
     instanced table of the march_instanced row; K5 and K6 within rtol / atol
     2e-2 (bf16 operands, sums in another order; the count beyond 1e-3 is
     printed), on the seeded nets and on the straddling nets below, where
     outputs spread by 0.6 and the plain version with the object ids rotated
     by one must differ beyond the tolerance on most rows (a wrong object's
     weights would show); K5 equal to K6 bit for bit (a row's prediction
     does not depend on its chunk), with each kernel's chunks, rows per
     weight fetch and fill; K7 against its plain
     version and against the composed stage, on the seeded nets and on the
     same nets with the heads shifted so that predictions straddle the
     thresholds: 0 disagreeing decisions among the rays none of whose queries
     is at a knife edge (|vis - 0.5| < 0.05, or a predicted t, length or depth
     within 2e-2 relative of what it is compared with), the size of that set
     printed; predicted t within 2e-2 of the box diagonal; K7 through the
     warp walks (the rule's mode at K = 735) equal to its flat mode on every
     ray, both timed. Each kernel's own device ms (the median of its
     launches in a torch.profiler trace of 20 calls) beside its wrapper's
     ms (a CUDA-event median of 7 around the whole call, the wrapper's host
     work included), for K4 and K8 with the bound and the share of it the
     device time reaches (K4's bound charges every one of the N x max_hits
     rows it writes); CUDA-event medians of 7 for each stage, the plain
     versions' times, the bounds, and the per-object bf16 torch.matmul
     chain as K5/K6's yardstick. Then
     the neural stages on a scene with cutout textures (the scene of
     tests/test_torch_route.py::test_cutout_scene_branch_matches_jax, 4,096
     rays, 8 straddling width-64 pairs), which compose (the cutout trace, K4,
     K6), against the same stages on the CPU outside the knife-edge set;
  7. large scenes (the rows of scripts/bench_suite.py, not cut): the 1M soup
     (random_tri_soup(1 << 20, seed=3), 512 per cluster) and the instanced
     scene (8 grid instances of random_tri_soup(1 << 19, seed=9): 4,194,304
     effective triangles over one shared table), with their host build
     seconds, K, KB, Kg, C and device MB. Path 2, the traces: camera and
     incoherent rays over the 64k frame scene (512 per cluster, K = 185),
     camera_64k and incoherent_64k (the 64k soup at 128 per cluster,
     K = 735), camera_1m,
     incoherent_1m, the grazing and the centered view of
     camera_4m_instanced, random rays through the instanced scene, and the
     instanced frame's camera and first shadow wavefronts (random rays in
     schedule order: K8 keys below 4,096 clusters, the Morton key above).
     On each: K9 equal to K1 and K10 equal to K2 on every ray (bit for bit),
     K1, K9 and K10 against the plain version on a seeded 1,024-ray subset
     (phase 4's criterion), CUDA-event medians of 7 and Mrays/s of all four,
     the slab tests K1 and K9 run, the work and the bound (PERF.md's rules:
     each ray's least cull, flat or two-level, and 33 operations per
     instance a ray must open). Also 40 instances of the same 512k base
     over its table (C = 512, K = 59,480): a camera wavefront on the row of
     instances 32-39, whose virtual ids pass 2^24, with the same checks and
     at least one hit id >= 2^24. Path 1, the main
     path of this phase: the instanced frame (256x256, spp 1, 4 bounces,
     RIS, the CLI's auto light) through render_image with the default
     config, counts reset just before and read just after: 4 launches each
     of the closest and any-hit kernels the rule picks, no frame_sample;
     frame ms (median of 7, or of 3 when a frame takes over a second); one
     profiled frame (utils/profile.py render_device_profile): idle share
     and the device ms of the closest and any-hit kernels summed over their
     launches.
     Path 3: frame_1m (soup_frame's light, sky, camera and config over the
     1M soup) by the default config: launches {frame_sample: 1}; K3's
     grouped mode against its flat mode, bit-identical, and both timed;
     K3's bound on that frame. neural_route_1m: the phase-6 stages over the
     1M soup, fused against composed (0 rays outside the knife-edge set),
     stage ms; K7 through the warp walks equal to its flat mode, both
     timed, and its bounds.
  8. the streaming pair tracer at the widths of scripts/bench_tracer.py (not
     cut): random_tri_soup(65536, seed=0) at 128 per cluster (K = 735),
     65,536 camera rays (look-at [0.5, 0.5, 3] -> [0.5, 0.5, 0.5], fov 45,
     16x16-tiled order) and 65,536 random rays (seed 1, origins rand * 1.4 -
     0.2), tmax 3.4e38, region 96, 512 rays a tile, 4 slots a step; each
     wavefront unsorted and Morton-sorted, and the random one at region 768,
     where every tile fits. In each run trace_pairs is the main path of each
     kernel (counts reset just before, read just after: {pair_closest: 1},
     {pair_anyhit: 1}, {pair_woop: 1}); K11, K12 and K13 against their plain
     versions on every ray of the prepared wavefront (every output equal);
     K11 against K1 with its misses split into forced (unfit tile), cull,
     dropped and other, K12 against K2 on the tiles whose every admitted
     pair got a slot, K13's flags
     against K11's (at most 1e-3 of the hits outside the forced, cull and
     dropped misses); dropped pairs per run; each kernel's device ms
     (torch.profiler over 20 calls; K11 / K13: the walk and the resolve
     kernel summed), with the method that read it (profiler or events),
     its CUDA-graph ms, and, in the printed line only, the first design's
     graph ms (PAIR_BEFORE_MS); the ray-triangle tests each walk runs (the
     kernel's counter, one extra launch: K11 / K13 lanes x triangles of
     each walked chunk, K12 open rays x triangles) and their floor at 40
     operations each at the card's FP32 rate without FMA; CUDA-event
     medians of 7, Mrays/s and the bounds of K1's / K2's work on the
     wavefront. The escalating entry (_pairs_escalating from REGION = 32,
     sorted) on both wavefronts, closest and any hit: its launches and
     residue equal what the dropped count at each budget implies, residue
     0 on the camera wavefront, and its any-hit flags equal to K12's at the
     final budget. The stackless and cluster
     back ends: cornell 32x32 spp2 b3 through render_image against the golden
     EXR (no kernel launched), and the 64k frame's camera and first shadow
     wavefronts (phase 3) against K1 / K2 (at most 1e-3 of the rays apart),
     one run each timed on the host clock.
  9. the distributed frame (parallel/distributed.py over the in-process mesh
     of 8 partitions; launch counts reset just before each frame and read
     just after; migration rounds per bounce, paths moved, overflow waits,
     truncated paths, grid-culled candidates; frame ms are CUDA-event
     medians of 3 after a warm-up):
     9a rooms_p8 exact, the main path: two_room_scene(8, 131072, seed=2)
        (1,048,576 triangles) through build_partitioned_scene, the camera of
        scripts/bench_distributed_cpu8.py at 256x256, spp 1, 4 bounces, the
        default config (migration and the exact ring shadows): the trace
        kernels of the rule and K8 only; held against render_image of the
        same meshes on one scene (fused_frame="off") by phase 4's frame
        criterion; truncated 0; the idle share and stage ms of one profiled
        frame (utils/profile.py render_device_profile); with
        bucket_fraction 0.02 (overflow waits > 0) the same image; with
        visibility grids the same image and grid-culled > 0, on the rooms
        at the JAX benchmark's grid cell (128 triangles a room: the dense
        rooms mark nearly every grid bin);
        K14 at the main path's shape: one exact frame of the same rooms at
        the benchmark's 960x540, whose bounce-1 settle_shade buffer with the
        most live rows (518,400 rows) is shaded by K14 and by its plain
        version, in "ris" mode and in "sum" mode with roulette: masks, ids,
        the next tmax and every valid shadow row's fields equal, the live
        next paths and the environment image within rtol 1e-5 / atol 1e-6
        (the GPU tests' criteria); K14's device ms, its wrapper's, the plain
        version's, and the bound from the bytes the buffer needs;
     9b instanced_p8: phase 7's instanced frame (8 instances of a 512k soup)
        through build_partitioned_scene_instanced, held against phase 7's
        single-device image by the same criterion; truncated 0;
     9c rooms_p8 neural (use_neural_proxies) with 8 PROD w256/d4 pairs
        (phase 6's draws) and with the MULTIGEO w512/d3 pair (seeded): the
        launches of route_secondary (P per bounce from 1), route_shadow (P
        per bounce) and, for the multi-geo set, as many route_multigeo; on
        the bounce-1 secondary and shadow wavefronts of the partition with
        the most rays, K7 against its plain version and the composed stage
        (K8, the trace kernel, K4, the nets: K6, or plain apply_multigeo)
        on the seeded and the straddling nets, 0 disagreeing decisions
        outside phase 6's knife-edge set (its size printed), and K7 by the
        rule equal to its flat mode on every ray; stage ms fused and
        composed and, on the busiest partition's wavefronts, K7 through the
        warp walks and flat, and its bounds; K8 on that partition's sparse
        bounce-1 secondary wavefront (dead rows included) against its plain
        version, its device and wrapper ms and bound; K8's launches per
        frame of the exact, instanced and neural frames; K7's multi-geo
        time, plain time and bounds; the idle share of the PROD frame;
     9d the paper's A-B with the trained nets of
        artifacts/ab_scaled/weights.npz (separate, combined, multi-geo;
        w128/d4) on the 8-statue row of scripts/ab_neural_scaled.py (64x64,
        spp 2, 2 bounces) against the port's exact distributed frame: mean
        tone-mapped error x/(1+x) under 3e-4 and mean ratio in (0.99, 1.01)
        for each family; a seeded random-weight control above 5e-4 (the
        gates of tests/test_neural_end_to_end.py).
 10. the proxy-training stack (train/), the sampled grid and the command
     line, each path driven with the launch counts reset just before and
     read just after:
     10a datagen at scripts/ab_neural_scaled.py's sizes: the 8 statue
        partitions, 200,000 rays each (seeds 100 + p), through the trace
        kernels the rule picks (ceil(200,000 / 65,536) launches a
        partition); rays/s and the hit fraction; 65,536 rays of partition 0
        labelled through the kernels and through the plain traverse_bvh on
        the card: hit flags equal, t equal on every hit or within 1e-5
        relative (the largest difference printed), both timed;
     10b the separate family (8 vis + 8 depth nets, w128/d4, batch
        min(4096, max(1024, n)), lr 5e-4, the cosine schedule, the depth
        fallback below 256 rows) through train.fit: ms a step measured
        first (and what 30,000 steps a net would take) and its split (one
        profiled fit: device events and busy ms a step, the idle share),
        then 2,000 steps a net (30,000 cut; PERF.md section 4); each net's
        final test loss beside artifacts/ab_scaled/train_losses.json;
     10c the paper's A-B of phase 9d with these nets: mean tone-mapped
        error under 3e-4 and mean ratio in (0.99, 1.01) against the exact
        distributed frame, route_secondary and route_shadow launched; the
        seeded random-weight control above 5e-4;
     10d the 16 nets through save_checkpoint and convert.load_mlp_checkpoint:
        K6 on 8 x 4,096 rows bit-identical;
     10e build_visibility_grid of partition 0 (16 x 16 x 8, 200,000
        samples) on the card equal to the build on the CPU, every marked bin
        marked in the conservative grid of its triangle boxes, the share of
        marked bins;
     10f the command line through main(argv): cornell --size 256 --spp 1
        --bounces 4 --format both (launches {frame_sample: 1}, a PNG and an
        EXR written) and rooms:8 --partitions 8 at the CLI's defaults, with
        a camera into the lit rooms, exact and --neural (route_secondary
        launched in the neural run only; the exact frame lit; the neural
        frame's mean within 10 % of the exact frame's; seconds of training
        and of the frame).
 11. (run after phase 5) the flat trace kernels K1 / K2 (a lane, or a team
     of 8 (K1) or 32 (K2) lanes a ray, by ops/resident.py flat_lanes) where the
     dispatch rule takes them: cornell (phase 2's 32x32 camera, and at
     256x256), partition 0 of the CLI's rooms:2 (K = 6), the
     CLI's instanced:4,512 (K = 24) and the statues statue_mesh(32, seed)
     for seeds 0, 1, 4 (K = 45-46) on their camera, first shadow and (the
     statues) 65,536 datagen entry rays, and the 64k frame's camera,
     first-shadow and bounce-1 wavefronts with K1 / K2 called directly (K =
     185): each against its plain version by phase 4's criterion, its
     device ms and wrapper ms beside the time before the team walks
     (FLAT_BEFORE_MS) and its bound; K1 = K9 and K2 = K10 bit for bit on
     statues 2 and 3 (K = 49, 47); train/datagen.py label_rays on statue 0
     through K1, launches {resident_closest: 1}. A reading of its timing
     conditions (flat_reading: cornell's and statue 0's device ms, a matmul
     clock probe, the card's clocks, power and limit reasons) is taken
     there and again after phase 10.
 12. (run after phase 9, before phase 10) the curve primitives (round
     B-spline hair; the curve test is plain PyTorch, as it is XLA in the
     JAX package): 12a the fur frame, the cornell box with 1,024 strands of
     5 control points rooted 32 x 32 over the floor (radius 0.004, 8
     pieces a window: 16,384 pieces), 256x256 spp 1 b4 RIS through
     render_image with the default config: launches those of the
     curveless composed frame (K1 4, K2 4) and no frame_sample, tracer_diag
     0, finite, differing from the curveless frame on more pixels than the
     strands' footprint and on 95 % of it; its ms (median of 3), the curve
     test's share of its device time (the `curve_test` profiler range),
     its pairs and peak memory; the curve test on one wavefront against
     its operation bound; 12b intersect_curves (with normals) and
     occlude_curves on the frame's 65,536 camera and first shadow rays,
     equal to the same calls on CPU tensors (flags, pieces, segments; t and
     normals within CURVE_ULPS, measured ulps printed); 12c
     from_bspline(tolerance=1e-3) on tests/test_curve_exact.py's curly
     strand: every cone hit point within the tessellation bound + 1e-3 of
     the exact surface (intersect_bspline_exact on the card); 12d
     tests/test_distributed_curves.py's two rooms and strand at 64x64 spp 1
     b2: exact at P = 2 and 4, and at P = 4 with grids, equal to the card's
     single-device curve frame (rtol 1e-3 / atol 1e-4) with at least two
     partitions owning pieces; neural at P = 2 (seeded nets, heads shifted
     off the thresholds): no route launch (K7 has no curve stage),
     proxy_march and the nets instead (the curveless frame launches K7),
     equal to the port's CPU run of the same frame.
 13. (run right after phase 9, on its scenes) the distributed frame with
     one partition a rank (parallel/mesh.py RankMesh over
     torch.distributed; the ranks spawned by parallel/spawn.py run_ranks,
     joined with a deadline, a rank that fails or hangs failing the phase).
     The parent writes each rank's inputs once (its own partition's scene,
     every proxy and net) and 8 gloo ranks run on cuda:0 (NCCL refuses two
     ranks on one GPU; gloo takes CUDA tensors): 13a 9a's rooms_p8 exact
     frame and its grid variant, 13b 9c's neural frame with the PROD
     pairs. Each image is held against phase 9's in-process frame by phase
     4's criterion and every rank holds the same image; the migration
     rounds per bounce, paths moved, overflow waits, tracer diag, truncated
     paths (0) and grid-culled candidates equal phase 9's; the launches
     summed over the ranks equal the in-process frame's (13b: route_secondary
     3 and route_shadow 4 on every rank); the frame ms (rank 0's CUDA events
     between all-rank barriers, median of 3) beside phase 9's, and the
     collectives and bytes a rank hands them, per frame by stage and per
     migration round. 13c a one-rank NCCL world on cuda:0: the P = 1
     distributed frame of 9a's grid rooms against the single-device
     composed frame by the same criterion; a line says that NCCL with
     several cards was not run. 13d (run after phase 10, whose 10f nets
     and frame it is held against, so no in-process training runs twice):
     10f's rooms:8 --neural through the CLI's main(argv) on 8 gloo ranks on
     cuda:0 (the CLI's mesh with gloo in place of NCCL): each rank trains
     its own partition's pair at 10f's settings (30,000 samples, 25 epochs
     a net), receives the other seven through one all_to_all and renders
     10f's frame. Every rank's gathered nets equal rank 0's bit for bit;
     rank 0's against 10f's in-process nets (the largest absolute
     difference per net, and whether they are bit-equal); the image
     against 10f's by phase 4's criterion, the same on every rank; K7
     launched 3 + 4 a sample on every rank in the frame, one datagen trace
     a rank in training, and the launches summed over the ranks equal to
     10f's; rank 0 alone prints each partition's losses (once) and writes
     the frame; rank 0's Train seconds beside 10f's, both warm (each rank
     fits two small nets before the timed CLI, as phases 10a-10e trained
     before 10f; those fits' seconds are a cold rank's extra cost), with
     the card's name and power limit.
Then the whole script's seconds, the kernels line (JSON, fourteen entries: K1-K13
and K7's multi-geo mode, route_multigeo; `ms` is each kernel's own device
time from the profiler and `wrapper_ms` the CUDA-event time of the call that
launches it;
K1/K2 carry the launches, times and plain-version checks of their main
path, the composed cornell frame, phase 11's numbers under `phase11`, and
the phase-4 numbers of the 64k
frame's wavefronts under frame_64k_*; `disagreements` is the flag
disagreements of K1/K2 against their plain versions, K3's outlier pixels
against its plain version, K4's rows with another id or flag, K5/K6's
values beyond tolerance, K7's decisions outside the knife-edge set, K8's
rays with another key, K9/K10's against the plain
version on the phase-7 subsets; K9 / K10 are timed on the instanced frame's
wavefronts, their plain ms on the 1,024-ray subset; the route_multigeo
entry carries phase 9's and phase 13's numbers, `distributed_phase` and
`rank_phase`, and the route entry 13d's, `phase13d`), the card line, and
the final {"ok": true, "device": {...}} line. No earlier phase was cut to
make room for phases 7-13; K1 / K2's entries carry their launches on the fur frame
(`curve_frame_launches`) and K1's phase 12's numbers (`phase12`).

Without CUDA, or run alone outside the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
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


def kernel_name_matches(name: str, function: str) -> bool:
    """Whether a profiler's (demangled) kernel name is the CUDA function
    `function`, a template instance of it included."""
    import re

    return re.search(rf"(^|[ :]){function}[<(]", name) is not None


def device_ms(torch, fn, function, reps: int = 20):
    """The device ms of `device_reading`, without its method."""
    return device_reading(torch, fn, function, reps)[0]


def device_reading(torch, fn, function, reps: int = 20):
    """(ms, method): the device ms of the CUDA function `function`, which
    fn() launches once: the median of its own durations in torch.profiler
    over `reps` back-to-back calls after a warm-up ("profiler"). The
    kernel's time without its wrapper's host work, which `cuda_ms` around
    the same call includes (the wrapper's time). `function` may be a tuple
    of the CUDA functions that fn() launches once each (a kernel in
    passes): the sum of their medians. Work of fn() that is not one of
    these kernels, such as a cudaMemsetAsync of a kernel's scratch (K11 /
    K13's keys), is left out; `graph_ms` includes it. The trace drops
    launches of kernels of several ms (on the H100: 2 of 7 calls of a 24 ms
    kernel seen, none of 5 of a 4 ms one, against 19-20 of 20 of short
    ones); where it holds none of one of the functions, the time is that of
    `reps` back-to-back calls between two CUDA events ("events"), over
    which such a kernel keeps the device busy while the host enqueues the
    next, and which include all of fn()'s device work."""
    from torch.profiler import ProfilerActivity, profile

    functions = (function,) if isinstance(function, str) else tuple(function)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {f: [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel_name_matches(e.name, f)] for f in functions}
    for f, sp in spans.items():
        check(len(sp) <= reps, f"the profile holds {len(sp)} launches of {f} in {reps} calls")
    if all(spans.values()):
        return sum(statistics.median(sp) for sp in spans.values()) / 1e3, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "events"


def split_ms(torch, fn, function, reps: int = 7, device_reps: int = 20):
    """(device ms, wrapper ms) of one call of fn(): `device_ms` of the
    kernel `function` over `device_reps` calls, and the CUDA-event median
    of `reps` calls around the whole call."""
    return device_ms(torch, fn, function, device_reps), cuda_ms(torch, fn, reps=reps)


# kernel entry functions of csrc/ by their template arguments (ILb0E / ILb1E,
# ILb0ELb1E, ILi0E .. ILi2E or ILi32E in the mangled name: the numbers in order), as
# the kernels line names them
KERNEL_LABELS = {("closest_kernel", "1"): "K1 resident_closest (a lane a ray)",
                 ("closest_kernel", "8"): "K1 resident_closest (teams of 8)",
                 ("grouped_closest_kernel", None): "K9 grouped_closest",
                 ("anyhit_kernel", "1"): "K2 resident_anyhit (a lane a ray)",
                 ("anyhit_kernel", "32"): "K2 resident_anyhit (warp teams)",
                 ("grouped_anyhit_kernel", None): "K10 grouped_anyhit",
                 ("schedule_keys_kernel", None): "K8 schedule_keys",
                 ("frame_sample_kernel", None): "K3 frame_sample",
                 ("proxy_march_kernel", None): "K4 proxy_march",
                 ("mlp_pair_kernel", None): "K5 mlp_pair",
                 ("mlp_dense_kernel", None): "K6 mlp_dense",
                 ("route_kernel", "00"): "K7 route (secondary)",
                 ("route_kernel", "01"): "K7 route (secondary, multi-geo)",
                 ("route_kernel", "10"): "K7 route (shadow)",
                 ("route_kernel", "11"): "K7 route (shadow, multi-geo)",
                 ("pair_walk_kernel", "0"): "K11 pair_closest (walk)",
                 ("pair_resolve_kernel", "0"): "K11 pair_closest (resolve)",
                 ("pair_anyhit_walk_kernel", None): "K12 pair_anyhit (walk)",
                 ("pair_walk_kernel", "1"): "K13 pair_woop (walk)",
                 ("pair_resolve_kernel", "1"): "K13 pair_woop (resolve)"}


def ptxas_summary(log: str) -> str:
    """Registers and spills of each entry function in one nvcc -Xptxas -v
    log, labelled with the kernel's name."""
    import re

    parts, label = [], "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function .*?\d([A-Za-z_]+_kernel)((?:I(?:L[bi][0-9]+E)+)?)", ln)
        if m:
            args = "".join(re.findall(r"L[bi]([0-9]+)E", m.group(2))) or None
            label = KERNEL_LABELS.get((m.group(1), args), m.group(1))
        elif "registers" in ln or "spill" in ln:
            parts.append(f"{label}: {ln.strip().replace('ptxas info    : ', '')}")
    return " | ".join(parts)


# the kernels whose nets must run on the tensor cores: (library, kernel
# entry function)
NET_KERNELS = (("proxy_mlp", "mlp_pair_kernel"), ("proxy_mlp", "mlp_dense_kernel"),
               ("route", "route_kernel"))


def hmma_counts(build_dir):
    """HMMA instructions (tensor-core products) in the SASS of each entry
    function of NET_KERNELS (cuobjdump -sass on the built libraries), by the
    kernels line's label."""
    import re

    from pg2024_dprt_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    counts, label = {}, None
    for lib in sorted({lib for lib, _ in NET_KERNELS}):
        sass = subprocess.run([tool, "-sass", os.path.join(build_dir, f"lib{lib}.so")],
                              check=True, capture_output=True, text=True).stdout
        for ln in sass.splitlines():
            if "Function : " in ln:
                m = re.search(r"\d([A-Za-z_]+_kernel)((?:I(?:L[bi][0-9]+E)+)?)", ln)
                label = None
                if m is not None and (lib, m.group(1)) in NET_KERNELS:
                    args = "".join(re.findall(r"L[bi]([0-9]+)E", m.group(2))) or None
                    label = KERNEL_LABELS.get((m.group(1), args), m.group(1))
                    counts[label] = 0
            elif label is not None and re.search(r"\bHMMA\b", ln):
                counts[label] += 1
    return counts


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def frame_wavefronts(pt, scene, lights, env, camera, cfg, sample=0, closest=None):
    """Every trace input of one composed frame sample, per bounce: the
    closest-hit rays with K1's hits (or those of `closest`) and the shadow
    rays — each ray set as (origin, direction, tmin, tmax, active), as the
    engine passes them."""
    import torch

    closest = closest or pt.ops.resident_closest

    paths = pt.render.generate_camera_paths(camera, sample)
    dev = paths.origin.device
    eps = lambda n: torch.full((n,), cfg.t_epsilon, device=dev)
    out = []
    for b in range(cfg.bounces):
        rays = (paths.origin, paths.direction, eps(paths.capacity), paths.tmax,
                paths.is_valid)
        hits = closest(scene, *rays)
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
def plain_versions(pt):
    """Route the engine's traces and its shading through the plain versions
    (for timing the plain frame)."""
    res = pt.ops.resident
    engine = importlib.import_module("pg2024_dprt_tpu_torch.render.engine")
    names = ("resident_closest", "resident_anyhit", "grouped_closest", "grouped_anyhit")
    saved = {name: getattr(res, name) for name in names}
    shade = engine.shade
    for name in names:
        setattr(res, name, res.resident_anyhit_plain if name.endswith("anyhit")
                else res.resident_closest_plain)
    engine.shade = shade_plain_of(pt)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(res, name, fn)
        engine.shade = shade


def shade_plain_of(pt):
    """render/shade.py `shade_plain`, K14's plain version (the package's
    `render.shade` attribute is the function `shade`, not the module)."""
    return importlib.import_module("pg2024_dprt_tpu_torch.render.shade").shade_plain


def cull_slabs(pt, scene, o, inv, tcap, lim, rows):
    """(slab tests, (N, Kg) needed-group mask): the tests the least cull of
    these rays needs, summed over the rays `rows`. Per ray the smaller of
    the flat cull (each non-empty cluster box once) and the two-level cull
    (each non-empty group box once, then the non-empty member boxes of every
    group the ray must open: those it enters no later than `lim`, or every
    group it enters when `lim` is None)."""
    import torch

    en_g = pt.ops.resident.cluster_enters_plain(scene, o, inv, tcap, boxes=scene.cl_gboxes)
    need_g = (torch.isfinite(en_g) if lim is None else en_g <= lim[:, None]) & rows[:, None]
    members = (scene.cl_mboxes[:, :, 6] > 0.0).to(torch.int64).sum(1)
    two_level = int((scene.cl_gboxes[6] > 0.0).sum()) + (need_g.to(torch.int64)
                                                         * members[None, :]).sum(1)
    flat = int((scene.cl_boxes[6] > 0.0).sum())
    return int(torch.clamp(two_level, max=flat)[rows].sum()), need_g


def closest_work(pt, scene, rays, want):
    """What the closest-hit query needs on these rays, from the plain
    result `want`: ray-triangle tests (every triangle of every cluster the
    ray enters before its final t, before its capped tmax on a miss), slab
    tests (the least cull of each active ray, `cull_slabs`), bytes (the active flag of
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
    tests, slabs, run_passes = 0, 0, 0
    needed = torch.zeros(k, dtype=torch.bool, device=o.device)
    for r0 in range(0, o.shape[0], 8192):
        r = slice(r0, r0 + 8192)
        en = pt.ops.resident.cluster_enters_plain(scene, o[r], inv[r], tcap[r])
        lim = torch.minimum(want.t[r], tcap[r])
        need = (en <= lim[:, None]) & active[r][:, None]
        tests += int((need.to(torch.int64) * counts[None, :]).sum())
        slabs += cull_slabs(pt, scene, o[r], inv[r], tcap[r], lim, active[r])[0]
        needed |= need.any(0)
        horizon = torch.where(want.is_hit[r], want.t[r] * (1.0 + 1e-4) + 1e-7, tcap[r])
        visits = ((en <= horizon[:, None]) & active[r][:, None]).sum(1)
        run_passes += int((visits + 1)[active[r]].sum())
    n, n_act = o.shape[0], int(active.sum())
    nbytes = (n + 32 * n_act + 48 * int(counts[needed].sum()) + 32 * k + 24
              + 4 * int(want.is_hit.sum()) + 17 * n)
    return {"tests": tests, "slabs": slabs, "bytes": nbytes,
            "slabs_run": run_passes * k, "needed": needed}


def anyhit_work(pt, scene, rays, occ):
    """What the any-hit query needs on these rays, from the plain result
    `occ`: an unoccluded ray must test every triangle of every cluster it
    enters, with the least cull that finds them all (`cull_slabs`); an
    occluded ray one triangle and one box, in one
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
        slabs += cull_slabs(pt, scene, o[r], inv[r], tcap[r], None, open_)[0]
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
# bytes of one NNQuery row the march writes (features 20, six 4-byte
# fields, two flags, path_index 4, normalized_t 4, and the zero
# pixel_index / shadow_path_id column 4)
QUERY_BYTES = 58


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


def route_config(pt, torch, np, dev, n=65536, scene=None):
    """The neural_route_64k row of scripts/bench_suite.py, not cut: scene,
    proxy table, models, secondary paths, shadow paths (tmax 2.0), env; with
    `scene`, the same over that scene (neural_route_1m)."""
    if scene is None:
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
    routes, which the seeded nets' small outputs never do. A net that ends in
    a sigmoid is rescaled before it: its logits spread around 0 (vis 0.5)
    with deviation 2."""
    if int(valid.sum()) < 2:
        return models
    w_last = pt.models.param_shapes(models.vis_cfg)[-1][0]
    b_last = pt.models.mlp.bias_name(w_last)
    out = {}
    for key, params, pred, mean, dev_, cfg in (
            ("vis_params", models.vis_params, vis, 0.5, 0.6, models.vis_cfg),
            ("depth_params", models.depth_params, depth, 0.3, 0.15, models.depth_cfg)):
        if cfg.final_activation == "sigmoid":
            pred = torch.logit(pred.clamp(1e-6, 1 - 1e-6))
            mean, dev_ = 0.0, 2.0
        mu, sd = float(pred[valid].mean()), float(pred[valid].std())
        gain = dev_ / max(sd, 1e-6)
        out[key] = {**params, w_last: params[w_last] * gain,
                    b_last: (params[b_last] - mu) * gain + mean}
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
    pairs = 1 if models.multi_geo else models.num_objects
    return {"flops": 2 * macs * valid_rows,
            "bytes": q_rows * 33 + pairs * (2 * macs + 4 * biases)}


def nets_bound(work):
    """(bound_ms, bound_by, FP32-pipe ms): the larger of the FLOPs at the
    dense bf16 tensor-core rate, where the kernels run the nets' products,
    and the bytes over the memory rate; beside it the same FLOPs at the FP32
    rate outside the tensor cores."""
    op_s = work["flops"] / BF16_TENSOR_FLOP_PER_S
    byte_s = work["bytes"] / HBM_BYTES_PER_S
    return (max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes",
            work["flops"] / FP32_FLOP_PER_S * 1e3)


def nets_chunks(pt, torch, models, obj, valid):
    """The chunks K5 and K6 run on a query batch (ops/mlp.py's plan: chunks
    of chunk_rows rows; K5 over each object's sorted segment, K6 over each
    object's valid rows in each of dense_parts parts of the batch), with the
    rows per weight fetch (valid rows / chunks: each chunk reads its
    object's weights once) and the fill (valid rows / chunk capacity)."""
    mlp = pt.ops.mlp
    rows, o_count, q = mlp.chunk_rows(models.vis_cfg), models.num_objects, obj.shape[0]
    live = valid & (obj >= 0) & (obj < o_count)
    n_valid = int(live.sum())
    chunks = lambda counts: int(((counts + rows - 1) // rows).sum())
    k5 = chunks(torch.bincount(obj[live].long(), minlength=o_count))
    parts = mlp.dense_parts(q, o_count, obj.device)
    part = torch.arange(q, device=obj.device) // -(-q // parts)
    k6 = chunks(torch.bincount((part * o_count + obj.long())[live],
                               minlength=parts * o_count))
    out = {"rows": rows, "parts": parts, "valid": n_valid}
    for name, c in (("k5", k5), ("k6", k6)):
        out.update({f"{name}_chunks": c, f"{name}_rows_per_fetch": n_valid / max(c, 1),
                    f"{name}_fill": n_valid / max(rows * c, 1)})
    return out


def march_work(table, n_active: int, n: int):
    """What the march needs: every allowed box once per step and active ray,
    the rays in (29 B), every one of the N x MAX_HITS rows of the oracle's
    layout out (the empty rows too), the table once."""
    p = table.num_partitions
    row_bytes = 36 + (72 if table.instanced else 0)
    return {"ops": n_active * MAX_HITS * p * MARCH_OPS,
            "bytes": n * 29 + n * MAX_HITS * QUERY_BYTES + p * row_bytes}


def keys_work(pt, scene, rays):
    """What the schedule keys need: each active ray's least slab tests, the
    smaller of the K cluster tests and the two-level count (every group box,
    then the 8 members of each group whose masked enter bits do not exceed
    those of the ray's second rank: no member of another group can be one
    of its first two); the active flag of every ray and the rest of the
    active rays' records in (32 B), the box table and the scene box once,
    one key out per ray."""
    import torch

    o, d, tmin, tmax, active = rays
    res = pt.ops.resident
    n, k = o.shape[0], scene.num_clusters
    live = torch.nonzero(active)[:, 0]
    n_live = int(live.numel())
    slabs = n_live * k
    if scene.cl_gboxes is not None and k > 1:
        kg = scene.cl_gboxes.shape[1]
        cmask = ~((1 << res.SCHEDULE_CLUSTER_BITS) - 1)
        inv, _, tcap = res.ray_limits(scene, o, d, tmin, tmax, active)
        lanes = torch.arange(k, dtype=torch.int32, device=o.device)[None, :]
        slabs = 0
        for r0 in range(0, n_live, 4096):
            r = live[r0:r0 + 4096]
            en = res.cluster_enters_plain(scene, o[r], inv[r], tcap[r])
            rank = torch.where(torch.isfinite(en), (en.view(torch.int32) & cmask) | lanes,
                               res._NO_KEY)
            second = rank.topk(2, dim=1, largest=False).values[:, 1]
            eg = res.cluster_enters_plain(scene, o[r], inv[r], tcap[r], boxes=scene.cl_gboxes)
            gbits = torch.where(torch.isfinite(eg), eg.view(torch.int32) & cmask, res._NO_KEY)
            must = torch.isfinite(eg) & (gbits <= (second & cmask)[:, None])
            slabs += int(torch.clamp(kg + 8 * must.sum(1), max=k).sum())
    return {"tests": 0, "slabs": slabs, "bytes": n + 32 * n_live + 32 * k + 24 + 4 * n}


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


def route_modes(pt, torch, tag, scene, proxies, models, sec_args, shd_args, reps=7):
    """K7 through the warp walks (grouped=True) and through the flat walks
    (grouped=False) on one secondary and one shadow wavefront: every decision
    and weight equal (both traces equal K1 / K2 bit for bit), both timed
    (secondary with the schedule sort, as the stage runs it; CUDA-event
    medians of `reps`). Returns the ms by name."""
    ops = pt.ops
    out = {}
    for kind, fn, args in (("secondary", ops.route_fused, sec_args),
                           ("shadow", ops.shadow_route_fused, shd_args)):
        if args is None:
            continue
        got = {mode: fn(scene, proxies, models, *args, grouped=mode) for mode in (True, False)}
        dis = sum(int((got[True][f] != got[False][f]).sum()) for f in got[True])
        check(dis == 0, f"{tag}: K7 {kind} through the warp walks differs from its flat mode "
                        f"in {dis} decisions")
        for mode in (True, False):
            out[f"{kind}_{'grouped' if mode else 'flat'}_ms"] = cuda_ms(
                torch, lambda: fn(scene, proxies, models, *args, grouped=mode), reps=reps)
    print(f"{tag}: K7 through the warp walks equals its flat mode on every ray ok (K="
          f"{scene.num_clusters}, the rule takes the "
          f"{'grouped' if ops.use_grouped(scene) else 'flat'} mode); "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    return out


def route_bound(pt, torch, scene, proxies, models, rays, shadow, records):
    """K7's bound on one wavefront (PERF.md's rules): the trace's work
    (large_work, from the rule's trace kernel, which equals the plain
    version), the march's operations (every box per step and live ray) at
    the FP32 rate and the nets' FLOPs on `records` valid queries at the bf16
    tensor rate; bytes: the trace's, the nets' and the proxy table's.
    Returns (bound_ms, bound_by, the trace's work, the nets' work)."""
    n, live = rays[0].shape[0], int(rays[4].sum())
    traced, _ = pt.ops.trace_resident(scene, *rays, any_hit=shadow)
    tw = (large_work(pt, torch, scene, rays, occ=traced) if shadow
          else large_work(pt, torch, scene, rays, hits=traced))
    nw = nets_work(pt, models, 0, records)
    op_s = ((tw["tests"] * MT_OPS + tw["slabs"] * SLAB_OPS + tw["xforms"] * XFORM_OPS
             + march_work(proxies, live, n)["ops"]) / FP32_FLOP_PER_S
            + nw["flops"] / BF16_TENSOR_FLOP_PER_S)
    byte_s = (tw["bytes"] + nw["bytes"] + proxies.num_partitions * 36) / HBM_BYTES_PER_S
    return max(op_s, byte_s) * 1e3, ("operations" if op_s >= byte_s else "bytes"), tw, nw


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
    # the composed trace takes the kernels of the dispatch rule (ops/resident.py
    # trace_grouped)
    t_closest = "grouped_closest" if ops.trace_grouped(scene) else "resident_closest"
    t_anyhit = "grouped_anyhit" if ops.trace_grouped(scene, True) else "resident_anyhit"
    check(comp_sec == {"schedule_keys": 1, t_closest: 1, "proxy_march": 1,
                       "mlp_dense": 1}, f"composed secondary_route launches {comp_sec}")
    check(comp_shd == {"schedule_keys": 1, t_anyhit: 1, "proxy_march": 1,
                       "mlp_dense": 1}, f"composed shadow_direct_light_nn launches {comp_shd}")
    check(comp12 == {"schedule_keys": 1, t_closest: 1, "proxy_march": 1,
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
    k8_dev, k8_ms = split_ms(torch, lambda: ops.schedule_keys(scene, *sec_rays),
                             "schedule_keys_kernel")
    order_ms = cuda_ms(torch, lambda: ops.schedule_order(scene, *sec_rays), reps=7)
    k8_work = keys_work(pt, scene, sec_rays)
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
          f"distinct keys); device {k8_dev:.4f} ms, wrapper {k8_ms:.4f} ms, plain "
          f"{k8_plain_ms:.1f} ms (one run), bound {k8_bound:.6f} ms ({k8_by}: "
          f"{k8_work['slabs']} slab tests, {k8_work['bytes']} bytes; device time at "
          f"{k8_bound / k8_dev:.3f} of the bound); key + sort {order_ms:.4f} ms; K1 on the "
          f"wavefront as given {k1_ms:.3f} ms, "
          f"in schedule order {k1_order_ms:.3f} ms, with key, sort, gather and un-sort "
          f"{k1_sorted_ms:.3f} ms", flush=True)

    # ---- K4 against its plain version, every row; the instanced table too
    k4_err, k4_dis = compare_march("K4 proxy_march", q, ops.march_proxies_plain(*march_args))
    k4_dev, k4_ms = split_ms(torch, lambda: ops.proxy_march(*march_args), "proxy_march_kernel")
    k4_plain_ms = cuda_ms(torch, lambda: ops.march_proxies_plain(*march_args), reps=3)
    k4_work = march_work(proxies, int(live.sum()), n)
    k4_bound, k4_by = march_bound(k4_work)
    itable, irays, inode = instanced_march_config(pt, torch, np, dev)
    iargs = (itable, *irays, inode, MAX_HITS, MARCH_EPS)
    qi = ops.proxy_march(*iargs)
    ki_err, _ = compare_march("K4 instanced", qi, ops.march_proxies_plain(*iargs))
    ki_dev, ki_ms = split_ms(torch, lambda: ops.proxy_march(*iargs), "proxy_march_kernel")
    ki_plain_ms = cuda_ms(torch, lambda: ops.march_proxies_plain(*iargs), reps=3)
    ki_bound, ki_by = march_bound(march_work(itable, n, n))
    print(f"phase6 K4 proxy_march vs plain: every row equal, max abs err {k4_err:.3g} ok; "
          f"device {k4_dev:.4f} ms, wrapper {k4_ms:.4f} ms, plain {k4_plain_ms:.3f} ms, bound "
          f"{k4_bound:.6f} ms ({k4_by}: {k4_work['bytes']} bytes, {k4_work['ops']} operations; "
          f"device time at {k4_bound / k4_dev:.3f} of the bound)", flush=True)
    print(f"phase6 K4 instanced march (16 rows, {int(qi.is_valid.sum())} valid records): "
          f"every row equal, max abs err {ki_err:.3g} ok; device {ki_dev:.4f} ms, wrapper "
          f"{ki_ms:.4f} ms, plain {ki_plain_ms:.3f} ms, bound {ki_bound:.6f} ms ({ki_by}; "
          f"device time at {ki_bound / ki_dev:.3f} of the bound)", flush=True)

    # ---- K5 / K6 against the plain version on the stage's query batch
    nets_args = lambda obj: (q.features, obj, q.is_valid)
    t0 = time.perf_counter()
    want_nets = ops.grouped_mlp_dense_plain(models, *nets_args(q.aabb_id))
    torch.cuda.synchronize()
    nets_plain_ms = (time.perf_counter() - t0) * 1e3
    vis, depth = ops.grouped_mlp_dense(models, *nets_args(q.aabb_id))
    k6_err, k6_beyond, k6_fine = compare_nets("K6 mlp_dense", (vis, depth), want_nets)
    k5_out = ops.grouped_mlp_pair(models, *nets_args(q.aabb_id))
    k5_err, k5_beyond, k5_fine = compare_nets("K5 mlp_pair", k5_out, want_nets)
    # a row's prediction does not depend on its chunk: K5 (sorted segments)
    # and K6 (rows gathered in ray order) give it the same bits
    k56_dis = sum(int((a != b).sum()) for a, b in zip(k5_out, (vis, depth)))
    check(k56_dis == 0, f"K5 and K6 differ on {k56_dis} predictions")
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
    wide_out = {}
    for name, fn in (("K6 mlp_dense", ops.grouped_mlp_dense), ("K5 mlp_pair", ops.grouped_mlp_pair)):
        got_wide = wide_out[name] = fn(wide, *nets_args(q.aabb_id))
        e, b, f = compare_nets(f"{name}, straddling nets", got_wide, want_wide)
        off = ~torch.isclose(got_wide[0], rotated[0], rtol=2e-2, atol=2e-2)
        share[name] = float(off[q.is_valid].float().mean())
        check(share[name] > 0.5, f"{name}: the check would pass another object's nets "
                                 f"(only {share[name]:.2f} of the rows differ)")
        if name == "K6 mlp_dense":
            k6_err, k6_beyond, k6_fine = max(k6_err, e), k6_beyond + b, k6_fine + f
        else:
            k5_err, k5_beyond, k5_fine = max(k5_err, e), k5_beyond + b, k5_fine + f
    k56_dis = sum(int((a != b).sum()) for a, b in zip(*wide_out.values()))
    check(k56_dis == 0, f"K5 and K6 differ on {k56_dis} predictions of the straddling nets")
    spread = float(want_wide[0][q.is_valid].std())
    k6_dev, k6_ms = split_ms(torch, lambda: ops.grouped_mlp_dense(models, *nets_args(q.aabb_id)),
                             "mlp_dense_kernel")
    k5_dev, k5_ms = split_ms(torch, lambda: ops.grouped_mlp_pair(models, *nets_args(q.aabb_id)),
                             "mlp_pair_kernel")
    chain_ms = cuda_ms(torch, matmul_chain(pt, torch, models, q.features, q.aabb_id, q.is_valid),
                       reps=7)
    plan = nets_chunks(pt, torch, models, q.aabb_id, q.is_valid)
    n_work = nets_work(pt, models, q_rows, n_valid)
    n_bound, n_by, n_fp32 = nets_bound(n_work)
    print(f"phase6 K6 mlp_dense vs plain (seeded and straddling nets): max abs err "
          f"{k6_err:.3g}, {k6_beyond} beyond 2e-2, {k6_fine} beyond 1e-3 ok; K5 mlp_pair (also "
          f"12 objects): max abs err {k5_err:.3g}, {k5_beyond} beyond 2e-2, {k5_fine} beyond "
          f"1e-3 ok; straddling vis deviates by {spread:.3f}, and against the plain version "
          f"with rotated object ids {share['K6 mlp_dense']:.3f} / {share['K5 mlp_pair']:.3f} of "
          f"the valid rows differ beyond 2e-2; K5 equals K6 bit for bit on both nets ok",
          flush=True)
    print(f"phase6 nets on {n_valid} valid rows: K6 device {k6_dev:.3f} ms, wrapper "
          f"{k6_ms:.3f} ms, K5 device {k5_dev:.3f} ms, wrapper {k5_ms:.3f} ms "
          f"(sort and un-sort included), plain {nets_plain_ms:.1f} ms (one run), per-object "
          f"bf16 matmul chain {chain_ms:.3f} ms; bound {n_bound:.6f} ms ({n_by}: "
          f"{n_work['flops']} FLOPs at the bf16 tensor rate, {n_work['bytes']} bytes), "
          f"{n_fp32:.4f} ms at the FP32 rate; chunks of up to {plan['rows']} rows: K5 "
          f"{plan['k5_chunks']} ({plan['k5_rows_per_fetch']:.1f} rows per weight fetch, fill "
          f"{plan['k5_fill']:.2f}), K6 {plan['k6_chunks']} over {plan['parts']} parts "
          f"({plan['k6_rows_per_fetch']:.1f} rows per weight fetch, fill "
          f"{plan['k6_fill']:.2f})", flush=True)

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

    # K7's warp walks (the rule's mode at K = 735) against its flat mode
    modes = route_modes(pt, torch, "phase6", scene, proxies, models, sec_args, shd_args)

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
    k7_dev, k7_ms = split_ms(torch, lambda: ops.route_fused(
        scene, proxies, models, *order_args, sort_rays=False), "route_kernel")
    k7s_dev, k7s_ms = split_ms(torch, lambda: ops.shadow_route_fused(
        scene, proxies, models, *shd_args), "route_kernel")
    k7s_sched_ms = cuda_ms(torch, lambda: ops.shadow_route_fused(
        scene, proxies, models, *shd_args, sort_rays=True), reps=7)
    k2_ms = cuda_ms(torch, lambda: ops.resident_anyhit(scene, *shd_rays), reps=7)
    stage_ms = {"secondary fused": cuda_ms(torch, secondary, reps=7),
                "shadow fused": cuda_ms(torch, shadowed, reps=7)}
    with composed_route(pt):
        stage_ms["secondary composed"] = cuda_ms(torch, secondary, reps=7)
        stage_ms["shadow composed"] = cuda_ms(torch, shadowed, reps=7)
    parts = k1_ms + k4_ms + k6_ms
    print(f"phase6 K7: route_secondary on the wavefront in schedule order device "
          f"{k7_dev:.3f} ms, wrapper {k7_ms:.3f} ms (as given {k7_given_ms:.3f} ms; with K8, "
          f"sort, gather and un-sort {k7_sched_ms:.3f} ms), route_shadow device {k7s_dev:.3f} "
          f"ms, wrapper {k7s_ms:.3f} ms (with the schedule sort {k7s_sched_ms:.3f} ms) "
          f"(medians of 7); plain versions {k7_plain_ms:.1f} / {k7s_plain_ms:.1f} ms (one run); "
          f"the composed kernels on the rays as given: K1 {k1_ms:.3f} + K4 {k4_ms:.3f} + K6 "
          f"{k6_ms:.3f} = {parts:.3f} ms (trace {k1_ms / parts:.2f}, march "
          f"{k4_ms / parts:.3f}, nets {k6_ms / parts:.2f}); K2 {k2_ms:.3f} ms", flush=True)
    print("phase6 stages (medians of 7): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()), flush=True)

    # ---- K7's bound: the trace's operations + the march's + the nets'
    bounds = {}
    for name, rays, rows in (("secondary", sec_rays, n_valid), ("shadow", shd_rays, n_valid_shd)):
        b_ms, b_by, tw, nw = route_bound(pt, torch, scene, proxies, models, rays,
                                         name == "shadow", rows)
        bounds[name] = (b_ms, b_by)
        print(f"phase6 work route_{name}: {tw['tests']} ray-triangle tests, {tw['slabs']} "
              f"slab tests, {rows} net rows ({nw['flops']} FLOPs), "
              f"{tw['bytes'] + nw['bytes']} bytes; bound {bounds[name][0]:.6f} ms "
              f"({bounds[name][1]})", flush=True)

    csrc = "pg2024_dprt_tpu_torch/csrc/"
    return [
        {"name": "proxy_march", "route": "cuda", "source": csrc + "proxy_march.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_march.py:42 (_march_kernel, pallas_call :240)",
         "launches": comp_sec["proxy_march"], "max_abs_err": max(k4_err, ki_err),
         "disagreements": k4_dis, "ms": k4_dev, "wrapper_ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None, "instanced_ms": ki_dev,
         "instanced_wrapper_ms": ki_ms, "instanced_plain_ms": ki_plain_ms,
         "instanced_bound_ms": ki_bound},
        {"name": "mlp_pair", "route": "cuda", "source": csrc + "proxy_mlp.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_mlp.py:52 (_pair_kernel, pallas_call :113)",
         "launches": comp12["mlp_pair"], "max_abs_err": k5_err, "disagreements": k5_beyond,
         "ms": k5_dev, "wrapper_ms": k5_ms, "plain_ms": nets_plain_ms, "bound_ms": n_bound,
         "bound_by": n_by,
         "library_ms": None, "matmul_chain_ms": chain_ms, "fp32_rate_ms": n_fp32,
         "chunks": plan["k5_chunks"], "rows_per_fetch": plan["k5_rows_per_fetch"]},
        {"name": "mlp_dense", "route": "cuda", "source": csrc + "proxy_mlp.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_mlp.py:129 (_dense_kernel, pallas_call :203)",
         "launches": comp_sec["mlp_dense"], "max_abs_err": k6_err, "disagreements": k6_beyond,
         "ms": k6_dev, "wrapper_ms": k6_ms, "plain_ms": nets_plain_ms, "bound_ms": n_bound,
         "bound_by": n_by,
         "library_ms": None, "matmul_chain_ms": chain_ms, "fp32_rate_ms": n_fp32,
         "chunks": plan["k6_chunks"], "rows_per_fetch": plan["k6_rows_per_fetch"]},
        {"name": "route", "route": "cuda", "source": csrc + "route.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_route.py:196 (_route_kernel, pallas_call :729)",
         "launches": main_sec["route_secondary"] + main_shd["route_shadow"],
         "max_abs_err": k7_err, "disagreements": k7_dis, "ms": k7_dev, "wrapper_ms": k7_ms,
         "plain_ms": k7_plain_ms,
         "bound_ms": bounds["secondary"][0], "bound_by": bounds["secondary"][1],
         "library_ms": None, "as_given_ms": k7_given_ms, "with_schedule_ms": k7_sched_ms,
         "shadow_ms": k7s_dev, "shadow_wrapper_ms": k7s_ms, "shadow_plain_ms": k7s_plain_ms,
         "shadow_bound_ms": bounds["shadow"][0], "modes_ms": modes, "stage_ms": stage_ms},
        {"name": "schedule_keys", "route": "cuda", "source": csrc + "resident_trace.cu",
         "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1167 (_sched_kernel, "
                     "pallas_call :1221)",
         "launches": main_sec["schedule_keys"],
         "max_abs_err": float((key.to(torch.int64) - want_key.to(torch.int64)).abs().max()),
         "disagreements": k8_dis, "ms": k8_dev, "wrapper_ms": k8_ms, "plain_ms": k8_plain_ms,
         "bound_ms": k8_bound,
         "bound_by": k8_by, "library_ms": None, "key_and_sort_ms": order_ms},
    ]


def cutout_phase(pt, torch, np, dev, counted, n=4096):
    """The neural stages on a scene with a cutout texture (the scene of
    tests/test_torch_route.py::test_cutout_scene_branch_matches_jax: two
    stacked unit quads whose centres are transparent, between the rays and
    the 8 unit proxy boxes of phase 6), which never take the fused route:
    the cutout trace's kernels, K4 and K6 on the card, held against the same
    stages on the CPU (each kernel's plain version), with seeded width-64 nets
    whose heads straddle the thresholds (phase 6's straddling rule); 0
    disagreements outside the knife-edge set, the same criteria as phase 6's
    stages fused against composed. Returns the launch counts of both stages."""
    stages = pt.render.proxy_stages
    img = np.ones((16, 16, 4), np.float32)
    img[4:12, 4:12, 3] = 0.0
    meshes = []
    for i in range(2):
        z = 0.1 * (i + 1)
        p = np.asarray([[0, 0, z], [1, 0, z], [1, 1, z], [0, 1, z]], np.float32)
        meshes.append(pt.scene.MeshGeometry(
            v0=np.stack([p[0], p[0]]), v1=np.stack([p[1], p[2]]), v2=np.stack([p[2], p[3]]),
            uv0=np.zeros((2, 2), np.float32), uv1=np.asarray([[1, 0], [1, 1]], np.float32),
            uv2=np.asarray([[1, 1], [0, 1]], np.float32), texture_index=0, name=f"q{i}"))
    rng = np.random.default_rng(13)
    o = np.concatenate([rng.uniform(0.02, 0.98, (n, 2)), np.full((n, 1), -0.5)],
                       1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    d[:, :2] += rng.normal(0, 0.05, (n, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = rng.uniform(size=n) > 0.1
    offs = np.asarray(UNIT_PROXY_OFFSETS, np.float32)

    def setup(device):
        on = lambda a: torch.as_tensor(a, device=device)
        scene = pt.scene.device_scene_from_meshes(meshes, textures=[img], device=device)
        table = pt.scene.ProxyTable(aabb_min=on(offs), aabb_max=on(offs + 1.0),
                                    max_length=on(np.full((8,), np.sqrt(3.0), np.float32)))
        paths = pt.core.PathState.empty(n, device=device)._replace(
            origin=on(o), direction=on(d), tmax=torch.full((n,), 3.4e38, device=device),
            throughput=torch.ones((n, 3), device=device),
            pixel_index=torch.arange(n, device=device), is_valid=on(valid))
        env = pt.scene.EnvironmentMap.constant((0.4, 0.5, 0.7), device=device)
        return scene, table, paths, paths._replace(tmax=torch.full((n,), 2.0, device=device)), env

    cpu = setup("cpu")
    card = setup(dev)
    check(card[0].has_cutout, "the cutout scene has no cutout texture")
    cfg = pt.models.MLPConfig(width=64, depth=2)
    models = pt.models.random_proxy_models(np.random.RandomState(21), 8, cfg, cfg, device="cpu")
    # the composed stages' queries and predictions on the CPU, for the
    # straddling heads and the knife edges
    scene, table, paths, shadow, _ = cpu
    live = paths.is_valid
    hits, _ = stages.trace_closest(scene, paths.origin, paths.direction, MARCH_EPS, paths.tmax,
                                   live, sort_rays=True)
    local_hit = live & hits.is_hit
    local_t = torch.where(local_hit, hits.t, paths.tmax)
    q = stages.march_proxies(table, paths.origin, paths.direction, local_t, live, 8, MAX_HITS,
                             MARCH_EPS)
    vis, depth = stages._nn_pair(models, q.features, q.aabb_id, q.is_valid)
    models = straddling(pt, torch, models, vis, depth, q.is_valid)
    vis, depth = stages._nn_pair(models, q.features, q.aabb_id, q.is_valid)
    edge = knife_edges(torch, q, vis, depth, local_t, shadow=False)
    t_shd = shadow.tmax * (1.0 - 1e-3)
    occ, _ = stages.trace_occlusion(scene, shadow.origin, shadow.direction, MARCH_EPS, t_shd,
                                    live, sort_rays=True)
    q_s = stages.march_proxies(table, shadow.origin, shadow.direction, t_shd, live & ~occ, 8,
                               MAX_HITS, MARCH_EPS)
    v_s, d_s = stages._nn_pair(models, q_s.features, q_s.aabb_id, q_s.is_valid)
    edge_s = knife_edges(torch, q_s, v_s, d_s, t_shd, shadow=True)

    run = lambda c, m: (
        stages.secondary_route(c[0], c[1], m, c[4], c[2], 8, MAX_HITS, MARCH_EPS, n),
        stages.shadow_direct_light_nn(c[0], c[1], m, c[3], 8, MAX_HITS, MARCH_EPS, 1, n))
    on_card = models.to(dev)
    ((g_paths, g_env, _), (g_light, _)), launches = counted(lambda: run(card, on_card))
    (w_paths, w_env, _), (w_light, _) = run(cpu, models)
    check(launches.get("mlp_dense") == 2 and launches.get("proxy_march") == 2
          and not {"route_secondary", "route_shadow"} & set(launches),
          f"the cutout scene's stages launch {launches}")
    diag = float(np.sqrt(3.0))
    for f in ("target_node", "current_node", "is_hit", "is_valid", "visited_mask"):
        bad = (getattr(g_paths, f).cpu() != getattr(w_paths, f)) & ~edge
        check(not bool(bad.any()), f"cutout scene: paths differ in {f} on {int(bad.sum())} rays")
    ok = torch.isclose(g_paths.tmax.cpu(), w_paths.tmax, rtol=2e-2, atol=2e-2 * diag) | edge
    check(bool(ok.all()), f"cutout scene: tmax differs on {int((~ok).sum())} rays")
    ok = torch.isclose(g_env.cpu(), w_env, rtol=1e-5, atol=1e-6).all(1) | edge
    check(bool(ok.all()), f"cutout scene: env_add differs on {int((~ok).sum())} rays")
    ok = torch.isclose(g_light.cpu(), w_light, rtol=1e-5, atol=1e-6).all(1) | edge_s
    check(bool(ok.all()), f"cutout scene: the light image differs on {int((~ok).sum())} rays")
    stopped = int((w_paths.target_node == 8).sum())
    through = int((w_paths.is_valid & ~w_paths.is_hit).sum())
    check(stopped > 50 and through > 20, "the cutout scene's rays do not take both branches")
    print(f"phase6 cutout scene ({n} rays, two textured quads with transparent centres, 8 "
          f"straddling width-64 pairs): composed on the card, secondary and shadow stage "
          f"launches {launches}; {int(edge.sum())} / {int(edge_s.sum())} knife-edge rays set "
          f"aside; outside them paths, env_add and the light image equal the stages' plain "
          f"versions ok ({stopped} rays settled on a quad, {through} through both holes, "
          f"{int((w_light.sum(1) > 0).sum())} lit)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: large scenes — the grouped trace (K9/K10), instanced K1/K2, K3's
# grouped mode

# FP32 operations of one object-space ray transform: 18 multiplies, 15 adds
XFORM_OPS = 33
# instances of the 512k base whose virtual ids pass 2^24 (instances 32-39)
MANY_INSTANCES = 40
# the CUDA function each trace wrapper launches, as a profile names it
KERNEL_FUNCTIONS = {"resident_closest": "closest_kernel", "grouped_closest":
                    "grouped_closest_kernel", "resident_anyhit": "anyhit_kernel",
                    "grouped_anyhit": "grouped_anyhit_kernel"}


def kernel_device_ms(prof, function):
    """Device ms of one CUDA function summed over its launches in a
    render_device_profile (its names are demangled signatures)."""
    return sum(v for k, v in prof["top_kernels_ms"].items() if kernel_name_matches(k, function))
# rays of the seeded subset each kernel is held against the plain version on
SUBSET = 1024


def wavefront(torch, o, d, dev):
    n = o.shape[0]
    return (o.contiguous(), d.contiguous(), torch.full((n,), 1e-3, device=dev),
            torch.full((n,), 3.4e38, device=dev), torch.ones((n,), dtype=torch.bool, device=dev))


def camera_wavefront(pt, torch, dev, eye, target, fov, tiled, side=256):
    """side x side pixel-center camera rays (scripts/bench_suite.py
    camera_rays: 16x16-tiled pixel order; the instanced rows: row order)."""
    from pg2024_dprt_tpu_torch.render.pathgen import tiled_pixel_order

    cam = pt.core.Camera.look_at(eye, target, [0, 1, 0], fov, side, side, device=dev)
    pix = (tiled_pixel_order(side, side, device=dev) if tiled
           else torch.arange(side * side, device=dev))
    zeros = torch.zeros(side * side, device=dev)
    return wavefront(torch, *cam.generate_rays(pix // side, pix % side, zeros, zeros), dev)


def random_wavefront(pt, torch, np, dev, scene, lo, span, seed, n=65536):
    """n random rays, origins lo + rand * span, in schedule order (K8 keys
    below 4096 clusters, else the Morton key), as a sorted trace runs them."""
    rng = np.random.RandomState(seed)
    o = rng.rand(n, 3).astype(np.float32) * span + lo
    d = rng.randn(n, 3).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays = wavefront(torch, torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev), dev)
    perm = pt.ops.schedule_order(scene, *rays)
    return tuple(x[perm] for x in rays)


def large_work(pt, torch, scene, rays, hits=None, occ=None):
    """What one query needs on these rays by PERF.md's rules (closest_work,
    anyhit_work), for flat and instanced scenes, from K1's hits or K2's flags
    (held equal to K9's / K10's on every ray and to the plain version on a
    subset): the ray-triangle tests of the clusters a ray must enter (closest
    hit: enter <= final t; any-hit: every entered cluster of an unoccluded
    ray, one triangle of an occluded one), the slab tests of each ray's least
    cull (`cull_slabs`; one box of an occluded ray), and for an instanced
    scene one object-space transform per instance a ray must open (a group
    it needs lies in it; one for an occluded ray). Bytes: the
    active flag of every ray and the rest of
    the active rays' records, table rows 0-11 of the triangles of the base
    clusters unoccluded or closest-hit rays need, boxes, counts, scene box,
    transform rows, the records out. Also the slab tests each closest-hit
    walk runs: K1 one pass over the K boxes per cluster it visits plus the
    pass that finds none; K9 at least one pass over the Kg group boxes and
    the 8 member boxes of each group the ray enters before its tmax (a ray
    whose candidates overflow K9's buffer passes again after a visit)."""
    o, d, tmin, tmax, active = rays
    res = pt.ops.resident
    inv, _, tcap = res.ray_limits(scene, o, d, tmin, tmax, active)
    counts = scene.cl_count.to(torch.int64)
    k, kb = scene.num_clusters, scene.cl_mt_table.shape[0]
    kg = scene.cl_gboxes.shape[1]
    group_inst = scene.cl_mboxes[:, 0, 7].to(torch.int64) // kb
    tests = slabs = xforms = slabs_k1 = slabs_k9 = 0
    needed = torch.zeros(k, dtype=torch.bool, device=o.device)
    for r0 in range(0, o.shape[0], 4096):
        r = slice(r0, r0 + 4096)
        act = active[r]
        en = res.cluster_enters_plain(scene, o[r], inv[r], tcap[r])
        if hits is not None:
            lim = torch.where(hits.is_hit[r], torch.minimum(hits.t[r], tcap[r]), tcap[r])
            need = (en <= lim[:, None]) & act[:, None]
            cull, need_g = cull_slabs(pt, scene, o[r], inv[r], tcap[r], lim, act)
            en_g = res.cluster_enters_plain(scene, o[r], inv[r], tcap[r], boxes=scene.cl_gboxes)
            hz = torch.where(hits.is_hit[r], hits.t[r] * (1.0 + 1e-4) + 1e-7, tcap[r])
            visits = ((en <= hz[:, None]) & act[:, None]).sum(1)
            entered_g = (torch.isfinite(en_g) & act[:, None]).sum(1)
            slabs_k1 += int((visits + 1)[act].sum()) * k
            slabs_k9 += int(act.sum()) * kg + 8 * int(entered_g.sum())
        else:
            open_ = act & ~occ[r]
            need = torch.isfinite(en) & open_[:, None]
            cull, need_g = cull_slabs(pt, scene, o[r], inv[r], tcap[r], None, open_)
        tests += int((need.to(torch.int64) * counts[None, :]).sum())
        slabs += cull
        if scene.instanced:
            xforms += sum(int(need_g[:, group_inst == i].any(1).sum())
                          for i in range(scene.cl_xf.shape[0]))
        needed |= need.any(0)
    n, n_act = o.shape[0], int(active.sum())
    if occ is not None:
        n_occ = int(occ.sum())
        tests += n_occ
        slabs += n_occ
        xforms += n_occ if scene.instanced else 0
    base_counts = counts.view(-1, kb).amax(0)
    base_needed = needed.view(-1, kb).any(0)
    out_bytes = (17 * n + 4 * int(hits.is_hit.sum())) if hits is not None else n
    xf_bytes = 64 * scene.cl_xf.shape[0] if scene.instanced else 0
    nbytes = (n + 32 * n_act + 48 * int(base_counts[base_needed].sum()) + 36 * k + 24
              + xf_bytes + out_bytes)
    op_s = (tests * MT_OPS + slabs * SLAB_OPS + xforms * XFORM_OPS) / FP32_FLOP_PER_S
    byte_s = nbytes / HBM_BYTES_PER_S
    return {"tests": tests, "slabs": slabs, "xforms": xforms, "bytes": nbytes,
            "bound_ms": max(op_s, byte_s) * 1e3,
            "bound_by": "operations" if op_s >= byte_s else "bytes",
            "slabs_k1": slabs_k1, "slabs_k9": slabs_k9}


def trace_pair(pt, torch, np, name, scene, rays):
    """K1 against K9 and K2 against K10 on every ray of one wavefront (equal
    field by field), each against the plain version on the seeded 1,024-ray
    subset (phase 4's criterion), medians of 7, Mrays/s, work and bound.
    Returns a dict of the numbers; prints one line per query."""
    ops = pt.ops
    n = rays[0].shape[0]
    n_act = int(rays[4].sum())
    k1 = ops.resident_closest(scene, *rays)
    k9 = ops.grouped_closest(scene, *rays)
    k2 = ops.resident_anyhit(scene, *rays)
    k10 = ops.grouped_anyhit(scene, *rays)
    dis9 = int(sum((getattr(k9, f) != getattr(k1, f)).sum() for f in k1._fields))
    dis10 = int((k10 != k2).sum())
    check(dis9 == 0, f"{name}: K9 differs from K1 in {dis9} fields of rays")
    check(dis10 == 0, f"{name}: K10 differs from K2 on {dis10} rays")
    idx = torch.as_tensor(np.sort(np.random.RandomState(7).choice(n, SUBSET, replace=False)),
                          device=rays[0].device)
    sub = tuple(x[idx] for x in rays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ops.resident_closest_plain(scene, *sub)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want_occ = ops.resident_anyhit_plain(scene, *sub)
    torch.cuda.synchronize()
    plain_any_ms = (time.perf_counter() - t0) * 1e3
    err, ndis, nid = compare_closest(pt, scene, sub, ops.grouped_closest(scene, *sub), want)
    e1, ndis1, _ = compare_closest(pt, scene, sub, ops.resident_closest(scene, *sub), want)
    aerr, adis = compare_anyhit(pt, scene, sub, ops.grouped_anyhit(scene, *sub), want_occ)
    aerr2, adis2 = compare_anyhit(pt, scene, sub, ops.resident_anyhit(scene, *sub), want_occ)
    ms, dev_ms = {}, {}
    for kname, wrapper in (("k1", "resident_closest"), ("k9", "grouped_closest"),
                           ("k2", "resident_anyhit"), ("k10", "grouped_anyhit")):
        fn = getattr(ops, wrapper)
        dev_ms[kname], ms[kname] = split_ms(torch, lambda: fn(scene, *rays),
                                            KERNEL_FUNCTIONS[wrapper], device_reps=7)
    cw = large_work(pt, torch, scene, rays, hits=k1)
    aw = large_work(pt, torch, scene, rays, occ=k2)
    rate = lambda t: n_act / t / 1e3
    print(f"phase7 {name}: {n_act} rays, K={scene.num_clusters} Kg={scene.cl_gboxes.shape[1]}, "
          f"{int(k1.is_hit.sum())} hits; closest K1 {ms['k1']:.3f} ms ({rate(ms['k1']):.1f} "
          f"Mrays/s), K9 {ms['k9']:.3f} ms ({rate(ms['k9']):.1f} Mrays/s; device K1 "
          f"{dev_ms['k1']:.3f}, K9 {dev_ms['k9']:.3f} ms), K9 == K1 on every ray "
          f"ok; slab tests run K1 {cw['slabs_k1']}, K9 at least {cw['slabs_k9']}; needed "
          f"{cw['tests']} ray-triangle tests, {cw['xforms']} transforms, bound "
          f"{cw['bound_ms']:.6f} ms ({cw['bound_by']}); subset vs plain: K9 {ndis} / K1 {ndis1} "
          f"flag disagreements, {nid} tie ids, max abs err {max(err, e1):.3g} ok; plain "
          f"{plain_ms:.1f} ms on {SUBSET} rays", flush=True)
    print(f"phase7 {name} any-hit: {int(k2.sum())} occluded; K2 {ms['k2']:.3f} ms "
          f"({rate(ms['k2']):.1f} Mrays/s), K10 {ms['k10']:.3f} ms ({rate(ms['k10']):.1f} "
          f"Mrays/s; device K2 {dev_ms['k2']:.3f}, K10 {dev_ms['k10']:.3f} ms), K10 == K2 on "
          f"every ray ok; needed {aw['tests']} ray-triangle tests, bound "
          f"{aw['bound_ms']:.6f} ms ({aw['bound_by']}); subset vs plain: K10 {adis} / K2 "
          f"{adis2} disagreements ok; plain {plain_any_ms:.1f} ms on {SUBSET} rays", flush=True)
    return {"rays": n_act, "k": scene.num_clusters, "max_id": int(k1.tri_index.max()),
            **{f"{kn}_ms": v for kn, v in ms.items()},
            **{f"{kn}_device_ms": v for kn, v in dev_ms.items()},
            "plain_ms": plain_ms, "plain_anyhit_ms": plain_any_ms,
            "max_abs_err": max(err, e1), "anyhit_max_abs_err": max(aerr, aerr2),
            "flag_disagreements": ndis + ndis1, "anyhit_disagreements": adis + adis2,
            "bound_ms": cw["bound_ms"], "bound_by": cw["bound_by"],
            "anyhit_bound_ms": aw["bound_ms"], "anyhit_bound_by": aw["bound_by"],
            "slabs_k1": cw["slabs_k1"], "slabs_k9": cw["slabs_k9"]}


def table_mb(torch, fn):
    """(result of fn(), host seconds, MB of device memory it allocated)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (torch.cuda.memory_allocated() - before) / 2**20


def frame_ms(torch, fn):
    """(median ms, runs): 7 runs after a warm-up, 3 when one frame takes
    more than a second."""
    first = cuda_ms(torch, fn, reps=1, warmup=0)
    reps = 3 if first > 1000.0 else 7
    return cuda_ms(torch, fn, reps=reps, warmup=0), reps


def large_phase(pt, torch, np, dev, counted, frame_setup):
    """Phase 7; returns the kernels-line entries of K9 and K10 and the
    phase's numbers for the K1/K2/K3 entries."""
    ops, res = pt.ops, pt.ops.resident
    soup = pt.scene.random_tri_soup
    scene185, lights, env, cam, cfg = frame_setup
    scene64 = pt.scene.device_scene_from_meshes([soup(65536, seed=0)], tris_per_cluster=128,
                                                device=dev)
    scene1m, s1m, mb1m = table_mb(torch, lambda: pt.scene.device_scene_from_meshes(
        [soup(1 << 20, seed=3)], device=dev))
    (scene_i, lights_i, env_i, cam_i, cfg_i), si, mbi = table_mb(
        torch, lambda: pt.scene.instanced_frame(device=dev))
    # instanced ids past 2^24: 40 instances of the same 512k base over the
    # same base table (C = 512), ids up to 40 * 524,288 = 20,971,520
    base_meshes, _ = pt.scene.instance_grid()
    grid40 = np.zeros((MANY_INSTANCES, 3, 4), np.float32)
    grid40[:, :, :3] = np.eye(3, dtype=np.float32)
    grid40[:, 0, 3] = 2.2 * (np.arange(MANY_INSTANCES) % 8)
    grid40[:, 2, 3] = 2.2 * (np.arange(MANY_INSTANCES) // 8)
    scene40, s40, mb40 = table_mb(torch, lambda: pt.scene.device_scene_from_instances(
        base_meshes, grid40, tris_per_cluster=scene_i.tris_per_cluster, device=dev))
    for label, sc, secs, mb in (("1M soup", scene1m, s1m, mb1m),
                                ("8 x 512k instances", scene_i, si, mbi),
                                (f"{MANY_INSTANCES} x 512k instances", scene40, s40, mb40)):
        print(f"phase7 scene {label}: K={sc.num_clusters} KB={sc.cl_mt_table.shape[0]} "
              f"Kg={sc.cl_gboxes.shape[1]} C={sc.tris_per_cluster}, "
              f"{sc.num_base_tris * (sc.cl_xf.shape[0] if sc.instanced else 1)} effective "
              f"triangles; host build {secs:.1f} s, {mb:.1f} MB of device tables; the rule "
              f"takes the {'grouped' if res.trace_grouped(sc) else 'flat'} trace kernels "
              f"(CLOSEST_GROUPED_MIN_CLUSTERS {res.CLOSEST_GROUPED_MIN_CLUSTERS}, "
              f"ANYHIT_GROUPED_MIN_CLUSTERS {res.ANYHIT_GROUPED_MIN_CLUSTERS})", flush=True)

    # ---- path 2: the large-scene traces, K1 / K9 and K2 / K10 on each
    lo_i, hi_i = scene_i.scene_aabb.cpu().numpy()
    ci = 0.5 * (lo_i + hi_i)
    ext = float(np.max(hi_i - lo_i))
    waves = [
        ("camera_64k_c512", scene185, camera_wavefront(
            pt, torch, dev, [0.5, 0.5, 3.0], [0.5, 0.5, 0.5], 45.0, tiled=True)),
        ("incoherent_64k_c512", scene185, random_wavefront(
            pt, torch, np, dev, scene185, -0.2, 1.4, 1)),
        ("camera_64k", scene64, camera_wavefront(
            pt, torch, dev, [0.5, 0.5, 3.0], [0.5, 0.5, 0.5], 45.0, tiled=True)),
        ("incoherent_64k", scene64, random_wavefront(pt, torch, np, dev, scene64, -0.2, 1.4, 1)),
        ("camera_1m", scene1m, camera_wavefront(
            pt, torch, dev, [0.5, 0.5, 3.0], [0.5, 0.5, 0.5], 45.0, tiled=True)),
        ("incoherent_1m", scene1m, random_wavefront(pt, torch, np, dev, scene1m, -0.2, 1.4, 1)),
        ("camera_4m_instanced", scene_i, camera_wavefront(
            pt, torch, dev, [3.3, 1.5, 9.0], [3.3, 0.5, 1.0], 55.0, tiled=False)),
        ("camera_4m_instanced_centered", scene_i, camera_wavefront(
            pt, torch, dev, [ci[0], ci[1] + 0.5 * ext, ci[2] + 2.2 * ext], list(ci), 55.0,
            tiled=False)),
        ("incoherent_4m_instanced", scene_i, random_wavefront(
            pt, torch, np, dev, scene_i, lo_i, hi_i - lo_i, 2)),
    ]
    first = frame_wavefronts(pt, scene_i, lights_i, env_i, cam_i,
                             dataclasses.replace(cfg_i, bounces=1), closest=ops.grouped_closest)[0]
    waves += [("frame_4m_camera", scene_i, first["closest"]),
              ("frame_4m_shadow0", scene_i, first["shadow"]),
              # the front row holds instances 32-39, whose ids pass 2^24
              (f"camera_{MANY_INSTANCES}_instances", scene40, camera_wavefront(
                  pt, torch, dev, [8.2, 1.5, 16.0], [8.2, 0.5, 8.8], 55.0, tiled=False))]
    results = {name: trace_pair(pt, torch, np, name, sc, rays) for name, sc, rays in waves}
    top_id = results[f"camera_{MANY_INSTANCES}_instances"]["max_id"]
    check(top_id >= 2**24, f"the {MANY_INSTANCES}-instance camera wavefront hits no id past "
          f"2^24 (largest {top_id})")
    print(f"phase7 camera_{MANY_INSTANCES}_instances: largest virtual id hit {top_id} "
          f"(2^24 = {2**24}), K9 == K1 and K10 == K2 on every ray ok", flush=True)
    del scene40
    sorted_ms = cuda_ms(torch, lambda: ops.trace_resident(
        scene1m, *waves[3][2], sort_rays=True), reps=7)
    print(f"phase7 incoherent_1m through trace_resident(sort_rays=True) by the default rule "
          f"(K8 keys, sort, gather, un-sort): {sorted_ms:.3f} ms", flush=True)
    for name in ("camera", "incoherent"):
        row = [(k, results[w]["k1_ms"], results[w]["k9_ms"]) for w, k in (
            (f"{name}_64k_c512", scene185.num_clusters), (f"{name}_64k", scene64.num_clusters),
            (f"{name}_1m", scene1m.num_clusters),
            (f"{name}_4m_instanced", scene_i.num_clusters))]
        print(f"phase7 rule, {name} wavefronts: " + "; ".join(
            f"K={k}: K1 {a:.3f} ms, K9 {b:.3f} ms (K9/K1 {b / a:.2f})" for k, a, b in row),
            flush=True)

    # ---- path 1: the instanced frame through render_image (the main path)
    closest = "grouped_closest" if res.trace_grouped(scene_i) else "resident_closest"
    anyhit = "grouped_anyhit" if res.trace_grouped(scene_i, True) else "resident_anyhit"
    render = lambda s=0: pt.render.render_image(scene_i, lights_i, env_i, cam_i, cfg_i,
                                                base_sample=s)
    img, counts_i = counted(render)
    check(counts_i == {closest: cfg_i.bounces, anyhit: cfg_i.bounces,
                       "shade_paths": cfg_i.spp * cfg_i.bounces},
          f"instanced frame launches {counts_i}")
    check(tuple(img.shape) == (256, 256, 3) and bool(torch.isfinite(img).all())
          and bool((img >= 0).all()) and float(img.max()) > 0.0,
          "instanced frame image is not finite, nonnegative and lit")
    seeds = iter(range(1, 1000))
    inst_ms, inst_reps = frame_ms(torch, lambda: render(next(seeds)))
    print(f"phase7 instanced frame 256x256 spp1 b4 ris, 4.2M effective triangles: launches "
          f"{counts_i} (no frame_sample: the frame gate sends instanced scenes to the composed "
          f"path); {inst_ms:.1f} ms (median of {inst_reps}); image mean "
          f"{float(img.mean()):.5f}", flush=True)
    prof_i = pt.utils.profile.render_device_profile(render, top=256, reps=3)
    trace_ms = {name: kernel_device_ms(prof_i, KERNEL_FUNCTIONS[name]) for name in (closest,
                                                                                   anyhit)}
    print(f"phase7 instanced frame profile: idle share {prof_i['idle_share_unprofiled']:.3f} "
          f"(profiled {prof_i['idle_share_profiled']:.3f}), busy {prof_i['busy_ms']:.1f} ms of "
          f"{prof_i['unprofiled_wall_ms']:.1f}; device ms of {closest} over its "
          f"{counts_i[closest]} launches {trace_ms[closest]:.3f}, of {anyhit} over its "
          f"{counts_i[anyhit]} {trace_ms[anyhit]:.3f}; stages "
          + json.dumps({k: round(v, 3) for k, v in prof_i["stages_ms"].items()}), flush=True)

    # ---- path 3: the 1M frame through K3, and K3's grouped mode both ways
    img1m, counts1m = counted(lambda: pt.render.render_image(scene1m, lights, env, cam, cfg))
    check(counts1m == {"frame_sample": 1}, f"1M frame launches {counts1m}")
    check(bool(torch.isfinite(img1m).all()) and bool((img1m >= 0).all())
          and float(img1m.max()) > 0.0, "1M frame image is not finite, nonnegative and lit")
    f1m_ms, f1m_reps = frame_ms(torch, lambda: pt.render.render_image(
        scene1m, lights, env, cam, cfg, base_sample=next(seeds)))
    k3 = {}
    for mode in (True, False):
        k3[mode] = ops.render_frame_fused(scene1m, lights, env, cam, 5, cfg, grouped=mode)
    check(torch.equal(k3[True][0], k3[False][0]) and torch.equal(k3[True][1], k3[False][1]),
          "K3 grouped and flat images differ on the 1M frame")
    k3_ms = {mode: cuda_ms(torch, lambda m=mode: ops.render_frame_fused(
        scene1m, lights, env, cam, next(seeds), cfg, grouped=m), reps=5) for mode in (True, False)}
    b3_1m, b3_1m_by = bound(frame_work(pt, scene1m, lights, env, cfg, frame_wavefronts(
        pt, scene1m, lights, env, cam, cfg, closest=ops.grouped_closest)))
    print(f"phase7 frame_1m 256x256 spp1 b4 ris: launches {counts1m}; frame {f1m_ms:.1f} ms "
          f"(median of {f1m_reps}; K3 takes the {'grouped' if res.use_grouped(scene1m) else 'flat'} "
          f"walks by the rule); K3 grouped {k3_ms[True]:.3f} ms, flat {k3_ms[False]:.3f} ms "
          f"(medians of 5), images bit-identical ok; K3's bound {b3_1m:.6f} ms ({b3_1m_by})",
          flush=True)

    # ---- neural_route_1m: K7 at K ~ 2,850, fused against composed
    route = route_1m(pt, torch, np, dev, counted, scene1m)

    csrc = "pg2024_dprt_tpu_torch/csrc/resident_trace.cu"
    cam_w, shd_w = results["frame_4m_camera"], results["frame_4m_shadow0"]
    waves_out = {w: {k: (round(v, 6) if isinstance(v, float) else v) for k, v in r.items()}
                 for w, r in results.items()}
    entries = [
        {"name": "grouped_closest", "route": "cuda", "source": csrc,
         "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1626 (_kernel_grouped; also "
                     "_kernel_grouped_hbm :1657; pallas_call :2269)",
         "launches": counts_i.get("grouped_closest", 0),
         "max_abs_err": max(r["max_abs_err"] for r in results.values()),
         "disagreements": sum(r["flag_disagreements"] for r in results.values()),
         "ms": cam_w["k9_device_ms"], "wrapper_ms": cam_w["k9_ms"],
         "plain_ms": cam_w["plain_ms"], "plain_rays": SUBSET,
         "bound_ms": cam_w["bound_ms"], "bound_by": cam_w["bound_by"], "library_ms": None,
         "wavefront": "frame_4m_camera", "k1_ms": cam_w["k1_ms"]},
        {"name": "grouped_anyhit", "route": "cuda", "source": csrc,
         "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1068 (_occl_kernel_grouped; also "
                     "_occl_kernel_grouped_hbm :1086; pallas_call :2269)",
         "launches": counts_i.get("grouped_anyhit", 0),
         "max_abs_err": max(r["anyhit_max_abs_err"] for r in results.values()),
         "disagreements": sum(r["anyhit_disagreements"] for r in results.values()),
         "ms": shd_w["k10_device_ms"], "wrapper_ms": shd_w["k10_ms"],
         "plain_ms": shd_w["plain_anyhit_ms"], "plain_rays": SUBSET,
         "bound_ms": shd_w["anyhit_bound_ms"], "bound_by": shd_w["anyhit_bound_by"],
         "library_ms": None, "wavefront": "frame_4m_shadow0", "k2_ms": shd_w["k2_ms"]},
    ]
    entries[0]["frame_device_ms"] = trace_ms[closest]
    entries[1]["frame_device_ms"] = trace_ms[anyhit]
    extra = {"wavefronts": waves_out, "instanced_frame_ms": inst_ms,
             "instanced_frame_launches": counts_i,
             "instanced_frame_profile": {**profile_summary(prof_i),
                                         "trace_device_ms": trace_ms},
             "frame_1m_ms": f1m_ms,
             "k3_1m_grouped_ms": k3_ms[True], "k3_1m_flat_ms": k3_ms[False],
             "k3_1m_bound_ms": b3_1m, "k3_1m_bound_by": b3_1m_by,
             "neural_route_1m": route,
             "instanced_frame_setup": (img, lights_i, env_i, cam_i, cfg_i)}
    return entries, extra


def route_1m(pt, torch, np, dev, counted, scene):
    """neural_route_1m (scripts/bench_suite.py:137-163): the routing stages
    of phase 6 over the 1M scene, fused (K8 + K7, K7) against composed;
    0 disagreeing rays outside the knife-edge set. Returns the stage ms."""
    ops, stages = pt.ops, pt.render.proxy_stages
    _, proxies, models, paths, shadow, env = route_config(pt, torch, np, dev, scene=scene)
    n, my_id = paths.capacity, 8
    diag = float(proxies.max_length.max())
    secondary = lambda: stages.secondary_route(scene, proxies, models, env, paths, my_id,
                                               MAX_HITS, MARCH_EPS, n)
    shadowed = lambda: stages.shadow_direct_light_nn(scene, proxies, models, shadow, my_id,
                                                     MAX_HITS, MARCH_EPS, 1, n)
    (new_paths, env_add, _), c_sec = counted(secondary)
    (light, _), c_shd = counted(shadowed)
    check(c_sec == {"schedule_keys": 1, "route_secondary": 1} and c_shd == {"route_shadow": 1},
          f"neural_route_1m launches {c_sec}, {c_shd}")
    with composed_route(pt):
        (c_paths, c_env, _), cc_sec = counted(secondary)
        (c_light, _), cc_shd = counted(shadowed)
    live = paths.is_valid
    eps_v = torch.full((n,), MARCH_EPS, device=dev)
    sec_rays = (paths.origin, paths.direction, eps_v, paths.tmax, live)
    shd_t = shadow.tmax * (1.0 - 1e-3)
    hits = ops.resident_closest(scene, *sec_rays)
    local_t = torch.where(live & hits.is_hit, hits.t, paths.tmax)
    q = ops.proxy_march(proxies, paths.origin, paths.direction, local_t, live, my_id,
                        MAX_HITS, MARCH_EPS)
    vis, depth = ops.grouped_mlp_dense(models, q.features, q.aabb_id, q.is_valid)
    occ = ops.resident_anyhit(scene, shadow.origin, shadow.direction, eps_v, shd_t, live)
    q_s = ops.proxy_march(proxies, shadow.origin, shadow.direction, shd_t, live & ~occ, my_id,
                          MAX_HITS, MARCH_EPS)
    vis_s, depth_s = ops.grouped_mlp_dense(models, q_s.features, q_s.aabb_id, q_s.is_valid)
    edge = knife_edges(torch, q, vis, depth, local_t, shadow=False)
    edge_s = knife_edges(torch, q_s, vis_s, depth_s, shd_t, shadow=True)
    bad = torch.zeros_like(edge)
    for f in ("target_node", "current_node", "is_hit", "is_valid", "visited_mask"):
        bad |= getattr(new_paths, f) != getattr(c_paths, f)
    bad |= ~torch.isclose(new_paths.tmax, c_paths.tmax, rtol=2e-2, atol=2e-2 * diag)
    bad |= ~torch.isclose(env_add, c_env, rtol=1e-5, atol=1e-6).all(1)
    bad_s = ~torch.isclose(light, c_light, rtol=1e-5, atol=1e-6).all(1)
    outside = int((bad & ~edge).sum()) + int((bad_s & ~edge_s).sum())
    check(outside == 0, f"neural_route_1m: {outside} rays disagree outside the knife-edge set")
    ms = {"secondary fused": cuda_ms(torch, secondary, reps=7),
          "shadow fused": cuda_ms(torch, shadowed, reps=7)}
    with composed_route(pt):
        ms["secondary composed"] = cuda_ms(torch, secondary, reps=7)
        ms["shadow composed"] = cuda_ms(torch, shadowed, reps=7)
    print(f"phase7 neural_route_1m (K={scene.num_clusters}): launches fused {c_sec}, {c_shd}; "
          f"composed {cc_sec}, {cc_shd}; fused vs composed: {outside} rays disagree outside the "
          f"knife-edge set ({int(edge.sum())} / {int(edge_s.sum())} set aside) ok; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()) + " (medians of 7)", flush=True)
    # K7's warp walks against its flat mode, and K7's bound on both wavefronts
    shd_rays = (shadow.origin, shadow.direction, eps_v, shd_t, live)
    modes = route_modes(pt, torch, "phase7 neural_route_1m", scene, proxies, models,
                        (paths.origin, paths.direction, MARCH_EPS, paths.tmax, live, my_id,
                         MAX_HITS, MARCH_EPS),
                        (*shd_rays[:2], MARCH_EPS, shd_t, live, my_id, MAX_HITS, MARCH_EPS))
    b_sec = route_bound(pt, torch, scene, proxies, models, sec_rays, False,
                        int(q.is_valid.sum()))[:2]
    b_shd = route_bound(pt, torch, scene, proxies, models, shd_rays, True,
                        int(q_s.is_valid.sum()))[:2]
    print(f"phase7 neural_route_1m K7 bound: secondary {b_sec[0]:.6f} ms ({b_sec[1]}), shadow "
          f"{b_shd[0]:.6f} ms ({b_shd[1]})", flush=True)
    return {**{k.replace(" ", "_") + "_ms": v for k, v in ms.items()}, "disagreements": outside,
            "k7_modes_ms": modes, "k7_bound_ms": b_sec[0], "k7_bound_by": b_sec[1],
            "k7_shadow_bound_ms": b_shd[0]}


# ---------------------------------------------------------------------------
# phase 8: the streaming pair tracer (K11-K13); the stackless and cluster
# back ends

# scripts/bench_tracer.py's settings: 96 average pair slots a tile, 512 rays a
# tile, 4 slots a step
PAIR_KW = dict(region=96, tile_rays=512, pairs_per_step=4)
PAIR_KERNELS = (("pair_closest", "closest"), ("pair_anyhit", "anyhit"), ("pair_woop", "woop"))
# the CUDA functions each wrapper launches once (K11 / K13: the walk and the
# resolve pass, told apart by their template argument)
PAIR_FUNCTIONS = {"pair_closest": ("pair_walk_kernel", "pair_resolve_kernel"),
                  "pair_anyhit": ("pair_anyhit_walk_kernel",),
                  "pair_woop": ("pair_walk_kernel", "pair_resolve_kernel")}
# the card's FP32 rate for the tests' arithmetic: built without FMA
# contraction, a mul-add is two instructions, half the FMA peak
FP32_NO_FMA_OPS_PER_S = FP32_FLOP_PER_S / 2
# (wavefront, sorted, region): bench_tracer's four runs, and the random
# wavefront at a budget every tile fits (its tiles admit all K clusters)
PAIR_RUNS = (("camera", False, 96), ("camera", True, 96), ("random", False, 96),
             ("random", True, 96), ("random", False, 768))


# K11 / K12 / K13 in their first design (a block a tile, a thread a ray; the
# tree at 0eb7a16, whose K12 stayed so until the tree at f2d3876), by run: CUDA-graph
# ms (graph_ms of 20 calls, the method of the kernels' "graph_ms"), the mean
# of the two parent readings of a P A A P run of
# scripts/torch_grouped_probe.py --parts pairs on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md section 6)
PAIR_BEFORE_MS = {
    "camera region 96": {"pair_closest": 4.3501, "pair_anyhit": 3.5218,
                         "pair_woop": 4.1711},
    "camera sorted region 96": {"pair_closest": 9.4803, "pair_anyhit": 7.0929,
                                "pair_woop": 9.0965},
    "random region 96": {"pair_closest": 22.6576, "pair_anyhit": 21.8043,
                         "pair_woop": 21.6902},
    "random sorted region 96": {"pair_closest": 22.6523, "pair_anyhit": 21.7995,
                                "pair_woop": 21.6832},
    "random region 768": {"pair_closest": 22.7497, "pair_anyhit": 21.8931,
                          "pair_woop": 21.7793}}


def host_ms(torch, fn):
    """(fn(), ms of that one run on the host clock, synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def pair_vs_resident(torch, scene, prep, rays, hits, ref):
    """K11 (through trace_pairs) against K1 on one wavefront. The rays K1
    hits and K11 does not, or hits at a t more than 1e-4 apart, split by
    the cause at K1's cluster: their tile did not fit the budget (forced
    misses); the interval cull did not admit the cluster for their tile
    (cull misses); the pair was admitted but its slot lay past the budget
    (dropped); the rest. Rays only K11 hits. The rest and these are edge
    hits, where the two Moller-Trumbore forms round otherwise."""
    n = rays[0].shape[0]
    tm = PAIR_KW["tile_rays"]
    order = prep.perm if prep.perm is not None else torch.arange(n, device=rays[0].device)
    tile = torch.empty(n, dtype=torch.int64, device=order.device)
    tile[order] = torch.arange(n, device=order.device) // tm
    pairs = prep.pairs
    listed = torch.zeros_like(prep.possible)
    real = (pairs.pair_flags & 2) != 0
    listed[pairs.pair_tile[real].long(), pairs.pair_cluster[real].long()] = True
    tri_map = scene.cl_tri_map.to(torch.int64)
    slot_of = torch.full((int(tri_map.max()) + 1,), -1, dtype=torch.int64, device=tri_map.device)
    slot_of[tri_map[tri_map >= 0]] = torch.arange(tri_map.shape[0],
                                                  device=tri_map.device)[tri_map >= 0]
    cl = slot_of[ref.tri_index.clamp(min=0).long()] // scene.tris_per_cluster
    apart = hits.is_hit & ref.is_hit & ~torch.isclose(hits.t, ref.t, rtol=1e-4)
    lost = ref.is_hit & (~hits.is_hit | apart)
    fit = pairs.tile_fit[tile]
    admitted = prep.possible[tile, cl]
    return {"forced": int((lost & ~fit).sum()), "cull": int((lost & fit & ~admitted).sum()),
            "dropped": int((lost & fit & admitted & ~listed[tile, cl]).sum()),
            "other": int((lost & fit & admitted & listed[tile, cl]).sum()),
            "extra": int((hits.is_hit & ~ref.is_hit).sum()), "t_apart": int(apart.sum())}


def pair_run(pt, torch, counted, scene, wname, rays, srt, region, ref, ref_occ):
    """One run of bench_tracer's: trace_pairs for each kernel, counts reset
    just before and read just after; each kernel against its plain version
    on every ray of the prepared wavefront (equal field by field); K11
    against K1, K12 against K2, K13's flags against K11's; CUDA-event
    medians of 7. Returns the numbers."""
    trc = pt.ops.tracer
    kw = dict(PAIR_KW, region=region, sort_rays=srt)
    tm = kw["tile_rays"]
    n_act = int(rays[4].sum())
    prep = trc.prepare_pairs(scene, *rays, **{k: kw[k] for k in (
        "tile_rays", "region", "pairs_per_step", "sort_rays")})
    dropped = int(prep.pairs.dropped)
    (hits, d1), c1 = counted(lambda: trc.trace_pairs(scene, *rays, **kw))
    (occ, d2), c2 = counted(lambda: trc.trace_pairs(scene, *rays, any_hit=True, **kw))
    (wh, d3), c3 = counted(lambda: trc.trace_pairs(scene, *rays, woop=True, **kw))
    label = f"{wname}{' sorted' if srt else ''} region {region}"
    check(c1 == {"pair_closest": 1} and c2 == {"pair_anyhit": 1} and c3 == {"pair_woop": 1},
          f"{label}: launches {c1}, {c2}, {c3}")
    check(d1 == d2 == d3 == dropped, f"{label}: dropped {d1} / {d2} / {d3} / {dropped}")
    out = {"dropped": dropped, "unfit_tiles": int((~prep.pairs.tile_fit).sum()),
           "partial_tiles": int((prep.pairs.tile_fit & (prep.pairs.tile_offset
                                                       + prep.pairs.tile_region
                                                       > prep.pairs.budget)).sum()),
           "launches": {**c1, **c2, **c3}}
    for name, mode in PAIR_KERNELS:
        call = lambda kern=getattr(trc, name): kern(scene, prep.packed, prep.pairs, tm)
        got = call()
        want, out[f"{name}_plain_ms"] = host_ms(torch, lambda: trc.pair_trace_plain(
            scene, prep.packed, prep.pairs, tm, mode=mode))
        got, want = (got,) if mode == "anyhit" else got, (want,) if mode == "anyhit" else want
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same, f"{label}: {name} differs from its plain version")
        out[f"{name}_err"] = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                                 for a, b in zip(got, want))
        out[f"{name}_device_ms"], out[f"{name}_ms_by"] = device_reading(
            torch, call, PAIR_FUNCTIONS[name], 20)
        out[f"{name}_ms"] = cuda_ms(torch, call, reps=7)
        out[f"{name}_graph_ms"] = graph_ms(torch, call, reps=20)
        tests = trc.pair_walk_tests(scene, prep.packed, prep.pairs, tm, woop=mode == "woop",
                                    any_hit=mode == "anyhit")
        out[f"{name}_walk_tests"] = tests
        out[f"{name}_walk_floor_ms"] = tests * MT_OPS / FP32_NO_FMA_OPS_PER_S * 1e3
    out["trace_ms"] = cuda_ms(torch, lambda: trc.trace_pairs(scene, *rays, **kw), reps=7)
    cmp = pair_vs_resident(torch, scene, prep, rays, hits, ref)
    n_hit = int(ref.is_hit.sum())
    edge = cmp["other"] + cmp["extra"]
    check(edge <= 1e-3 * n_hit + 4, f"{label}: K11 and K1 disagree on {edge} rays outside "
          "the forced, cull and dropped misses")
    # K12 against K2 on the rays of tiles whose every admitted pair got a slot
    pairs = prep.pairs
    whole = pairs.tile_fit & (pairs.tile_offset + pairs.tile_region <= pairs.budget)
    whole_rays = whole.repeat_interleave(tm)[:rays[0].shape[0]]
    if prep.perm is not None:
        whole_rays = pt.ops.resident.unsorted(whole_rays, prep.perm)
    occ_dis = int((occ != ref_occ)[whole_rays].sum())
    woop_dis = int((wh.is_hit != hits.is_hit).sum())
    check(occ_dis <= 1e-3 * n_hit + 4 and woop_dis <= 1e-3 * n_hit + 4,
          f"{label}: K12 / K2 disagree on {occ_dis}, K13 / K11 flags on {woop_dis} rays")
    rate = lambda t: n_act / t / 1e3
    ms = lambda name: (f"{out[name + '_device_ms']:.4f} (by {out[name + '_ms_by']}; graph "
                       f"{out[name + '_graph_ms']:.4f}, the parent's "
                       f"{PAIR_BEFORE_MS[label][name]:.4f})")
    walk = lambda name: (f"{out[name + '_walk_tests']} tests, floor "
                         f"{out[name + '_walk_floor_ms']:.4f} ms")
    print(f"phase8 {label}: dropped {dropped} pairs ({out['unfit_tiles']} of "
          f"{prep.pairs.tile_fit.shape[0]} tiles unfit, {out['partial_tiles']} partly listed); "
          f"launches {out['launches']}; K11 / K12 "
          f"/ K13 equal their plain versions on every ray ok; device ms K11 "
          f"{ms('pair_closest')} / K12 {ms('pair_anyhit')} / K13 {ms('pair_woop')}; walks "
          f"K11 {walk('pair_closest')}, K12 {walk('pair_anyhit')} (K11's x"
          f"{out['pair_anyhit_walk_tests'] / max(out['pair_closest_walk_tests'], 1):.3f}), "
          f"K13 {walk('pair_woop')}; wrappers K11 "
          f"{out['pair_closest_ms']:.3f} ms ({rate(out['pair_closest_ms']):.1f} Mrays/s), K12 "
          f"{out['pair_anyhit_ms']:.3f} ms, K13 {out['pair_woop_ms']:.3f} ms, trace_pairs "
          f"{out['trace_ms']:.3f} ms (medians of 7); plain {out['pair_closest_plain_ms']:.1f} / "
          f"{out['pair_anyhit_plain_ms']:.1f} / {out['pair_woop_plain_ms']:.1f} ms; K11 vs K1 "
          f"({n_hit} K1 hits): misses forced {cmp['forced']}, cull {cmp['cull']}, dropped "
          f"{cmp['dropped']}, other {cmp['other']} ({cmp['t_apart']} of these rays hit at "
          f"another t); only K11 {cmp['extra']}; K12 vs K2 on wholly listed tiles {occ_dis}, K13 vs K11 flags "
          f"{woop_dis}", flush=True)
    out.update(cull_misses=cmp["cull"], k1_compare=cmp, occ_disagreements=occ_dis,
               woop_flag_disagreements=woop_dis)
    return out


def pair_setup(pt, torch, np, dev, tris=65536, side=256):
    """Phase 8's scene and wavefronts: (scene, host build s, device MB,
    {"camera": rays, "random": rays})."""
    scene, build_s, mb = table_mb(torch, lambda: pt.scene.device_scene_from_meshes(
        [pt.scene.random_tri_soup(tris, seed=0)], tris_per_cluster=128, device=dev))
    rng = np.random.RandomState(1)
    ro = rng.rand(side * side, 3).astype(np.float32) * 1.4 - 0.2
    rd = rng.randn(side * side, 3).astype(np.float32)
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    waves = {"camera": camera_wavefront(pt, torch, dev, [0.5, 0.5, 3.0], [0.5, 0.5, 0.5], 45.0,
                                        tiled=True, side=side),
             "random": wavefront(torch, torch.as_tensor(ro, device=dev),
                                 torch.as_tensor(rd, device=dev), dev)}
    return scene, build_s, mb, waves


def pair_phase(pt, torch, np, dev, counted, frame_scene, frame_waves, tris=65536, side=256):
    """Phase 8; returns the kernels-line entries of K11-K13. `tris` and
    `side` (the soup and the camera wavefront's side) are cut only to
    rehearse the phase on the CPU."""
    ops, trc = pt.ops, pt.ops.tracer
    from pg2024_dprt_tpu_torch.ops.trace_api import _pairs_escalating

    scene, build_s, mb, waves = pair_setup(pt, torch, np, dev, tris, side)
    print(f"phase8 scene: {tris}-triangle soup, K={scene.num_clusters} C="
          f"{scene.tris_per_cluster}; host build {build_s:.1f} s, {mb:.1f} MB of device tables "
          f"(cl_tri_table {scene.cl_tri_table.numel() * 4 / 2**20:.1f} MB, cl_woop_table "
          f"{scene.cl_woop_table.numel() * 4 / 2**20:.1f} MB)", flush=True)
    refs = {w: (ops.resident_closest(scene, *r), ops.resident_anyhit(scene, *r))
            for w, r in waves.items()}
    runs = {}
    for wname, srt, region in PAIR_RUNS:
        runs[(wname, srt, region)] = pair_run(pt, torch, counted, scene, wname, waves[wname],
                                              srt, region, *refs[wname])
    bounds = {w: (bound(closest_work(pt, scene, waves[w], refs[w][0])),
                  bound(anyhit_work(pt, scene, waves[w], refs[w][1]))) for w in waves}
    for w, ((cb, cby), (ab, aby)) in bounds.items():
        print(f"phase8 bound {w} (K1's / K2's work on it): closest {cb:.6f} ms ({cby}), any-hit "
              f"{ab:.6f} ms ({aby})", flush=True)

    # the escalating entry, from REGION: 4x, then 16x the budget
    escalation = {}
    for wname, rays in waves.items():
        regions = [trc.REGION * f for f in (1, 4, 16)]
        drops = [int(trc.prepare_pairs(scene, *rays, region=r, sort_rays=True).pairs.dropped)
                 for r in regions]
        runs_needed = next((i + 1 for i, dr in enumerate(drops) if dr == 0), 3)
        for any_hit, kern in ((False, "pair_closest"), (True, "pair_anyhit")):
            label = f"{wname}{' any-hit' if any_hit else ''}"
            (res, resid), c = counted(lambda: _pairs_escalating(scene, *rays, any_hit=any_hit))
            check(c == {kern: runs_needed} and resid == drops[runs_needed - 1],
                  f"escalation {label}: launches {c}, residue {resid}, dropped per budget "
                  f"{drops}")
            if wname == "camera":
                check(resid == 0, f"escalation on the camera wavefront leaves {resid} pairs")
            escalation[label] = {"dropped_per_region": dict(zip(regions, drops)),
                                 "residue": resid, "launches": c[kern]}
            extra = ""
            if any_hit:  # K12's flags at the final budget, traced directly
                occ, _ = trc.trace_pairs(scene, *rays, any_hit=True, sort_rays=True,
                                         region=regions[runs_needed - 1])
                check(torch.equal(res, occ), f"escalation {label}: flags differ from K12's at "
                      f"region {regions[runs_needed - 1]}")
                extra = f"; flags equal K12's at region {regions[runs_needed - 1]} ok"
            print(f"phase8 escalation {label} (sorted, regions {regions}): dropped {drops}; "
                  f"{c[kern]} launches, residue {resid} pairs{extra}", flush=True)

    # the stackless and cluster back ends: cornell through render_image
    # (composed path, no trace kernel: K14 shades) and the 64k frame's
    # wavefronts against K1/K2
    meshes, lights = pt.scene.cornell_box(device=dev)
    cscene = pt.scene.device_scene_from_meshes(meshes, device=dev)
    env = pt.scene.EnvironmentMap.constant((0.2, 0.3, 0.4), device=dev)
    cam = pt.core.Camera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, 32, 32,
                                 device=dev)
    golden, names = pt.utils.read_exr(GOLDEN)
    golden = golden[:, :, [names.index(ch) for ch in "RGB"]]
    back_ends = {}
    for tracer in ("stackless", "cluster"):
        cfg = pt.render.RenderConfig(width=32, height=32, spp=2, bounces=3, tracer=tracer)
        img, counts = counted(lambda: pt.render.render_image(cscene, lights, env, cam, cfg,
                                                             device=dev))
        img = img.cpu().numpy()
        err = float(np.abs(img - golden).max())
        check(counts == {"shade_paths": cfg.spp * cfg.bounces}
              and np.allclose(img, golden, rtol=1e-3, atol=1e-4),
              f"cornell through {tracer}: launches {counts}, max abs err {err:.3g}")
        back_ends[tracer] = {"cornell_max_abs_err": err}
        print(f"phase8 cornell 32x32 spp2 b3 tracer={tracer} vs golden: max abs err {err:.3g} "
              f"(rtol 1e-3 / atol 1e-4) ok; launches {counts}", flush=True)
    fscene = frame_scene[0]
    for wname, any_hit in (("camera", False), ("shadow0", True)):
        rays = frame_waves[wname]
        n_act = int(rays[4].sum())
        ref = (ops.resident_anyhit if any_hit else ops.resident_closest)(fscene, *rays)
        ref_hit = ref if any_hit else ref.is_hit
        for tracer, fn in (("stackless", lambda: ops.traverse_bvh(fscene, *rays)),
                           ("cluster", lambda: (ops.occlusion_clusters(fscene, *rays), 0)
                            if any_hit else ops.traverse_clusters(fscene, *rays,
                                                                  return_dropped=True))):
            got, ms = host_ms(torch, fn)
            if tracer == "cluster":
                got, dropped = got
            else:
                dropped = 0
            hit = got.is_hit if not (any_hit and tracer == "cluster") else got
            dis = int((hit != ref_hit).sum())
            apart = 0 if any_hit else int((~torch.isclose(
                got.t[got.is_hit & ref.is_hit], ref.t[got.is_hit & ref.is_hit], rtol=1e-4)).sum())
            check(dropped == 0 and dis + apart <= 1e-3 * n_act + 4,
                  f"{tracer} {wname}: {dis} flags and {apart} t disagree with "
                  f"{'K2' if any_hit else 'K1'}, {dropped} pairs dropped")
            back_ends[tracer][f"{wname}_ms"] = ms
            back_ends[tracer][f"{wname}_disagreements"] = dis + apart
            print(f"phase8 {tracer} on the 64k frame's {wname} wavefront ({n_act} rays, "
                  f"{'any-hit' if any_hit else 'closest'}): {ms:.1f} ms (one run, host clock); "
                  f"{dis} flag and {apart} t disagreements with {'K2' if any_hit else 'K1'} ok",
                  flush=True)

    src = "pg2024_dprt_tpu_torch/csrc/pair_trace.cu"
    main = runs[("camera", False, 96)]
    (cb, cby), (ab, aby) = bounds["camera"]
    per_run = {f"{w}{' sorted' if s else ''} region {r}": {
        k: v for k, v in out.items() if k not in ("k1_compare", "launches")}
        for (w, s, r), out in runs.items()}

    def entry(name, line, launches, bnd, by):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"pg2024_dprt_tpu/ops/pallas_tracer.py:{line}",
                "launches": launches,
                "max_abs_err": max(out[f"{name}_err"] for out in runs.values()),
                "disagreements": 0,
                "ms": main[f"{name}_device_ms"], "wrapper_ms": main[f"{name}_ms"],
                "ms_by": main[f"{name}_ms_by"], "graph_ms": main[f"{name}_graph_ms"],
                **{k: main[f"{name}_{k}"] for k in ("walk_tests", "walk_floor_ms")
                   if f"{name}_{k}" in main},
                "plain_ms": main[f"{name}_plain_ms"],
                "bound_ms": bnd, "bound_by": by, "library_ms": None,
                "wavefront": "camera, unsorted, region 96",
                "runs": {k: {m: v[m] for m in (f"{name}_device_ms", f"{name}_ms_by",
                                               f"{name}_ms", f"{name}_graph_ms",
                                               f"{name}_walk_tests", f"{name}_walk_floor_ms",
                                               "dropped", "trace_ms") if m in v}
                         for k, v in per_run.items()}}

    entries = [entry("pair_closest", "186 (_kernel; pallas_call :540)",
                     main["launches"]["pair_closest"], cb, cby),
               entry("pair_anyhit", "124 (_occl_kernel; pallas_call :540)",
                     main["launches"]["pair_anyhit"], ab, aby),
               entry("pair_woop", "53 (_woop_kernel; pallas_call :530)",
                     main["launches"]["pair_woop"], cb, cby)]
    entries[0]["pair_phase"] = {"runs": per_run, "escalation": escalation,
                                "back_ends": back_ends,
                                "cull_misses": {k: v["cull_misses"] for k, v in per_run.items()}}
    return entries


# ---------------------------------------------------------------------------
# phase 11: the flat trace kernels K1 / K2 (flat team walks) under the
# dispatch rule's cluster count

# K1 / K2 device ms of their thread walks, before the team walks (PERF.md
# section 6): chip_smoke.py's own run for cornell and the 64k frame's
# wavefronts, scripts/torch_grouped_probe.py --parts flat for the others;
# all on an NVIDIA H100 80GB HBM3 at 700 W
FLAT_BEFORE_MS = {"cornell camera": 0.01069, "cornell shadow0": 0.00861,
                  "cornell_256 camera": 0.0143, "cornell_256 shadow0": 0.0126,
                  "frame_64k camera": 1.1417, "frame_64k shadow0": 0.9756,
                  "rooms_partition0 camera": 0.12913, "rooms_partition0 shadow0": 0.10136,
                  "instanced_4x512 camera": 0.17454, "instanced_4x512 shadow0": 0.11354,
                  "statue0 camera": 0.17744, "statue0 shadow0": 0.14743,
                  "statue0 datagen": 0.49544, "statue1 camera": 0.18927,
                  "statue1 shadow0": 0.14860, "statue1 datagen": 0.49484,
                  "statue4 camera": 0.18190, "statue4 shadow0": 0.15206,
                  "statue4 datagen": 0.52433}


def entry_wavefront(pt, torch, dev, scene, n=65536, seed=0):
    """n datagen entry rays into the scene box (train/datagen.py
    _sample_entry_rays, seeded; tmin 1e-4, tmax T_FAR), as label_rays
    traces them."""
    from pg2024_dprt_tpu_torch.train import datagen

    lo, hi = scene.scene_aabb.cpu().numpy()
    o, d = datagen._sample_entry_rays(torch.Generator().manual_seed(seed), lo, hi, n)
    return (o.to(dev), d.to(dev), torch.full((n,), 1e-4, device=dev),
            torch.full((n,), datagen.T_FAR, device=dev), torch.ones(n, dtype=torch.bool,
                                                                    device=dev))


def card_state():
    """The card's SM and memory clocks (MHz), power draw (W), performance
    state and active clock-limit reasons as nvidia-smi reads them now."""
    fields = "clocks.sm,clocks.mem,power.draw,pstate,temperature.gpu"
    err = ""
    for extra in (",clocks_throttle_reasons.active", ""):
        try:
            run = subprocess.run(["nvidia-smi", f"--query-gpu={fields}{extra}",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True)
        except OSError as e:
            return {"nvidia-smi": str(e)}
        if run.returncode == 0:
            keys = fields.split(",") + (["limit_reasons"] if extra else [])
            return dict(zip(keys, (v.strip() for v in run.stdout.splitlines()[0].split(","))))
        err = run.stderr.strip() or run.stdout.strip()
    return {"nvidia-smi": err[:200]}


def graph_ms(torch, fn, reps: int = 50):
    """Device ms of one fn() call without the profiler and without its host
    work: `reps` calls captured in one CUDA graph, the CUDA-event median of
    5 replays over `reps`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay, reps=5) / reps


def compute_apps():
    """The processes nvidia-smi sees on the card (pid, MiB)."""
    try:
        run = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True)
    except OSError as e:
        return str(e)
    return run.stdout.strip().splitlines() if run.returncode == 0 else run.stderr.strip()[:200]


def flat_reading(pt, torch, dev, cases, tag):
    """One reading of phase 11's timing conditions: each case's device ms
    by the profiler (as split_ms) and from a CUDA graph of its calls
    (graph_ms), with the card's state just after; the CUDA-event ms of 20
    back-to-back bf16 4096^3 matmuls, a clock probe that no wrapper paces;
    the processes on the card and this process's allocator. Prints one
    line; returns the numbers."""
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(0))
    out = {"matmul_ms": cuda_ms(torch, lambda: [a @ a for _ in range(20)], reps=5) / 20,
           "matmul_state": card_state(), "compute_apps": compute_apps(),
           "allocated_gib": torch.cuda.memory_allocated() / 2**30,
           "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    for label, scene, rays, anyhit in cases:
        name = "resident_anyhit" if anyhit else "resident_closest"
        call = lambda kern=getattr(pt.ops, name): kern(scene, *rays)
        out[label] = {"ms": device_ms(torch, call, KERNEL_FUNCTIONS[name]),
                      "graph_ms": graph_ms(torch, call), "state": card_state()}
    print(f"phase11 reading {tag}: {json.dumps(out)}", flush=True)
    return out


def flat_case(pt, torch, label, scene, rays, anyhit):
    """One K1 or K2 wavefront: the kernel against its plain version (phase
    4's criterion), its device and wrapper ms, the bound (large_work). Prints
    one line; returns the numbers."""
    ops = pt.ops
    name = "resident_anyhit" if anyhit else "resident_closest"
    kern, plain = getattr(ops, name), getattr(ops, f"{name}_plain")
    got, want = kern(scene, *rays), plain(scene, *rays)
    if anyhit:
        err, ndis = compare_anyhit(pt, scene, rays, got, want)
        work = large_work(pt, torch, scene, rays, occ=want)
    else:
        err, ndis, _ = compare_closest(pt, scene, rays, got, want)
        work = large_work(pt, torch, scene, rays, hits=want)
    d_ms, w_ms = split_ms(torch, lambda: kern(scene, *rays), KERNEL_FUNCTIONS[name], reps=7)
    before = FLAT_BEFORE_MS.get(label)
    lanes = ops.resident.flat_lanes(scene.num_clusters, rays[0].shape[0], anyhit)
    print(f"phase11 {label}: K={scene.num_clusters} C={scene.tris_per_cluster}, "
          f"{int(rays[4].sum())} rays, {'K2' if anyhit else 'K1'} ({lanes} lanes a ray) device "
          f"{d_ms:.5f} ms (before {before if before is not None else 'not measured'}), "
          f"wrapper {w_ms:.4f} ms, bound {work['bound_ms']:.6f} ms ({work['bound_by']}); vs plain: "
          f"{ndis} disagreements, max abs err {err:.3g} ok", flush=True)
    return {"ms": d_ms, "wrapper_ms": w_ms, "bound_ms": work["bound_ms"],
            "bound_by": work["bound_by"], "max_abs_err": err, "disagreements": ndis,
            "k": scene.num_clusters, "lanes": lanes}


def flat_phase(pt, torch, np, dev, counted):
    """Phase 11: K1 / K2 on the scenes that trace through them by the rule
    (cornell, partition 0 of the CLI's rooms:2, the CLI's instanced:4,512,
    the statues statue_mesh(32, seed=i) for i = 0, 1, 4) and on the 64k
    frame's wavefronts with K1 / K2 forced (K = 185): every record against
    the plain version, device / wrapper ms and bound beside the time before
    the redesign; K1 = K9 and K2 = K10 bit for bit on statues 2 and 3 (K =
    49, 47; K3 and K7 take their grouped modes there); the main path of a statue:
    train/datagen.py label_rays on statue 0 (K = 45), launches
    {resident_closest: 1}. Returns ({label: numbers}, the cases of
    `flat_reading`: cornell's and statue 0's camera and shadow rays)."""
    from pg2024_dprt_tpu_torch.render.__main__ import auto_camera, load_scene

    ops = pt.ops
    env = pt.scene.EnvironmentMap.constant((0.2, 0.3, 0.4), device=dev)

    def framed(scene):
        lo, hi = scene.scene_aabb.cpu().numpy()
        return (pt.scene.auto_light(lo, hi, 8.0, device=dev), env,
                auto_camera(lo, hi, 45.0, 256, 256, device=dev))

    meshes, lights = pt.scene.cornell_box(device=dev)
    cornell = pt.scene.device_scene_from_meshes(meshes, device=dev)
    cases = [(label, cornell, lights, env, pt.core.Camera.look_at(
        [0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, side, side, device=dev))
        for label, side in (("cornell", 32), ("cornell_256", 256))]
    meshes, lights = pt.scene.two_room_scene(2, device=dev)
    rooms = pt.scene.build_partitioned_scene(meshes, 2, device=dev).scenes[0]
    cases.append(("rooms_partition0", rooms, lights, env, framed(rooms)[2]))
    (base, tf), _, _ = load_scene("instanced:4,512", device=dev)
    inst = pt.scene.device_scene_from_instances(base, tf, device=dev)
    cases.append(("instanced_4x512", inst, *framed(inst)))
    statues = {i: pt.scene.device_scene_from_meshes([pt.scene.statue_mesh(32, seed=i)],
                                                    device=dev) for i in (0, 1, 2, 3, 4)}
    cases += [(f"statue{i}", statues[i], *framed(statues[i])) for i in (0, 1, 4)]
    out, reading = {}, []
    for label, scene, li, en, cam in cases:
        check(not ops.trace_grouped(scene) and not ops.trace_grouped(scene, True),
              f"{label}: K = {scene.num_clusters} is not under the dispatch rule")
        cfg = pt.render.RenderConfig(width=cam.width, height=cam.height, spp=1, bounces=1)
        first = frame_wavefronts(pt, scene, li, en, cam, cfg)[0]
        waves = {"camera": first["closest"], "shadow0": first["shadow"]}
        if label.startswith("statue"):
            waves["datagen"] = entry_wavefront(pt, torch, dev, scene)
        for wname, rays in waves.items():
            out[f"{label} {wname}"] = flat_case(pt, torch, f"{label} {wname}", scene, rays,
                                                wname == "shadow0")
            if label in ("cornell", "cornell_256", "statue0") and wname != "datagen":
                reading.append((f"{label} {wname}", scene, rays, wname == "shadow0"))
    scene, lights, env64, cam, cfg = pt.scene.soup_frame(device=dev)
    for wname, rays in named_wavefronts(frame_wavefronts(pt, scene, lights, env64, cam,
                                                         cfg)).items():
        out[f"frame_64k {wname}"] = flat_case(pt, torch, f"frame_64k {wname}", scene, rays,
                                              wname == "shadow0")
    for i in (2, 3):
        scene = statues[i]
        lo, hi = scene.scene_aabb.cpu().numpy()
        cfg = pt.render.RenderConfig(width=256, height=256, spp=1, bounces=1)
        first = frame_wavefronts(pt, scene, *framed(scene), cfg)[0]
        for wname, rays in (("camera", first["closest"]), ("shadow0", first["shadow"]),
                            ("datagen", entry_wavefront(pt, torch, dev, scene))):
            if wname == "shadow0":
                dis = int((ops.resident_anyhit(scene, *rays)
                           != ops.grouped_anyhit(scene, *rays)).sum())
            else:
                k1, k9 = ops.resident_closest(scene, *rays), ops.grouped_closest(scene, *rays)
                dis = int(sum((getattr(k1, f) != getattr(k9, f)).sum() for f in k1._fields))
            check(dis == 0, f"statue{i} {wname}: K1/K2 differ from K9/K10 in {dis} fields")
        print(f"phase11 statue{i} (K={scene.num_clusters}): K1 == K9 and K2 == K10 on every "
              f"ray of its camera, shadow and datagen wavefronts ok", flush=True)
    # the main path of a statue partition: datagen's labels (K1 at K = 45)
    scene = statues[0]
    lo, hi = scene.scene_aabb.cpu().numpy()
    o, d = entry_wavefront(pt, torch, dev, scene)[:2]
    (feats, depth), counts = counted(lambda: pt.train.datagen.label_rays(scene, o, d, lo, hi))
    check(counts == {"resident_closest": 1} and bool(torch.isfinite(depth).all())
          and tuple(feats.shape) == (o.shape[0], 5),
          f"statue0 datagen labels: launches {counts}")
    print(f"phase11 statue0 datagen labels (label_rays, {o.shape[0]} rays): launches {counts} "
          f"ok; {float((depth < 1.0).float().mean()):.4f} of the rays hit", flush=True)
    return out, reading


# ---------------------------------------------------------------------------
# phase 9: the distributed frame (partitions, migration, ring shadows, neural
# routing in a frame) and K7's multi-geo mode

ROOMS_CAMERA = ([5.0, 1.4, 6.0], [5.0, 0.8, 0.5], [0, 1, 0], 60.0)
ROOMS_ENV = (0.25, 0.25, 0.3)
# the A-B gates of tests/test_neural_end_to_end.py:24-77
AB_MEAN_ERR, AB_CONTROL_ERR = 3e-4, 5e-4
STATUE_PARTS = 8


def profile_summary(prof):
    """The profile's numbers the kernels line keeps (no kernel list)."""
    return {k: prof[k] for k in ("idle_share_unprofiled", "idle_share_profiled", "busy_ms",
                                 "unprofiled_wall_ms", "stages_ms")}


def as_pixels(img):
    """An (H, W, 3) image as compare_frames' (direct, env) pair."""
    import torch

    flat = img.reshape(-1, 3)
    return flat, torch.zeros_like(flat)


@contextlib.contextmanager
def captured_stages(pt, store):
    """Record the arguments of every neural stage call the distributed frame
    makes (store["secondary"], store["shadow"]: (scene, proxies, paths,
    my_id) in call order)."""
    dist = pt.parallel.distributed
    sec0, shd0 = dist.secondary_route, dist.shadow_direct_light_nn

    def sec(scene, proxies, models, env, paths, my_id, *a, **k):
        store.setdefault("secondary", []).append((scene, proxies, paths, my_id))
        return sec0(scene, proxies, models, env, paths, my_id, *a, **k)

    def shd(scene, proxies, models, sp, my_id, *a, **k):
        store.setdefault("shadow", []).append((scene, proxies, sp, my_id))
        return shd0(scene, proxies, models, sp, my_id, *a, **k)

    dist.secondary_route, dist.shadow_direct_light_nn = sec, shd
    try:
        yield store
    finally:
        dist.secondary_route, dist.shadow_direct_light_nn = sec0, shd0


def statue_meshes(pt, np):
    """The meshes of scripts/ab_neural_scaled.py::_scene: statue_mesh(32,
    seed=i) 1.1 apart along x, one per partition."""
    meshes = []
    for i in range(STATUE_PARTS):
        m = pt.scene.statue_mesh(32, seed=i)
        off = np.asarray([1.1 * i, 0.0, 0.0], np.float32)
        meshes.append(pt.scene.MeshGeometry(v0=m.v0 + off, v1=m.v1 + off, v2=m.v2 + off,
                                            base_color=(0.75, 0.70, 0.62), name=f"statue{i}"))
    return meshes


def statue_row(pt, np, dev, side=64):
    """The 8-statue row of scripts/ab_neural_scaled.py::_scene: statue_meshes,
    one per partition, a side-grazing area light past the row's end, a
    constant sky, the camera over the row. Returns (partitioned scene,
    lights, env, camera)."""
    part = pt.scene.build_partitioned_scene(statue_meshes(pt, np), STATUE_PARTS, device=dev)
    cx = 1.1 * (STATUE_PARTS - 1) * 0.5 + 0.5
    xe = 1.1 * (STATUE_PARTS - 1) + 2.5
    quad = np.asarray(
        [[[xe - 0.4, 0.2, 0.1], [xe + 0.4, 0.2, 0.1], [xe + 0.4, 1.0, 0.9]],
         [[xe - 0.4, 0.2, 0.1], [xe + 0.4, 1.0, 0.9], [xe - 0.4, 1.0, 0.9]]], np.float32)
    lights = pt.scene.LightTable.from_arrays(quad, np.full((2, 3), 60.0, np.float32),
                                             device=dev)
    env = pt.scene.EnvironmentMap.constant((0.25, 0.25, 0.3), device=dev)
    cam = pt.core.Camera.look_at([cx, 1.5, 4.6], [cx, 0.5, 0.5], [0, 1, 0], 60.0, side, side,
                                 device=dev)
    return part, lights, env, cam


def query_rays(pt, torch, call, shadow: bool):
    """One captured stage call's wavefront cut to the rays that carry a proxy
    query (after the local trace) and up to 256 other live rays, the
    decisions' inputs on it: (scene, proxies, paths, my_id, q, local flags,
    local t or tmax)."""
    ops = pt.ops
    scene, proxies, paths, my_id = call
    live = paths.is_valid & ~paths.is_shadow if not shadow else paths.is_valid
    eps_v = torch.full((paths.capacity,), MARCH_EPS, device=paths.origin.device)
    t_cap = paths.tmax * (1.0 - 1e-3) if shadow else paths.tmax
    if shadow:
        occ, _ = ops.trace_occlusion_checked(scene, paths.origin, paths.direction, eps_v,
                                             t_cap, live, sort_rays=True)
        act = live & ~occ
    else:
        hits, _ = ops.trace_closest_checked(scene, paths.origin, paths.direction, eps_v,
                                            t_cap, live, sort_rays=True)
        act = live
        t_cap = torch.where(live & hits.is_hit, hits.t, paths.tmax)
    q = ops.proxy_march(proxies, paths.origin, paths.direction, t_cap, act, my_id, MAX_HITS,
                        MARCH_EPS)
    has_q = q.is_valid.reshape(-1, MAX_HITS).any(1)
    others = torch.nonzero(live & ~has_q)[:256, 0]
    idx = torch.sort(torch.cat([torch.nonzero(has_q)[:, 0], others])).values
    sub = paths.gather(idx)
    return (scene, proxies, sub, my_id), int(has_q.sum()), int(q.is_valid.sum())


def route_checks(pt, torch, label, models, cases):
    """K7 against its plain version and against the composed stage (K8, the
    trace kernel, K4, the nets: K6, or plain apply_multigeo for a multi-geo
    set) on each case's secondary and shadow wavefront (captured stage
    calls, cut by query_rays), on the seeded nets and on the straddling ones
    (made on the first case's queries); phase 6's knife-edge criterion.
    Returns (max abs err of new_t, disagreements outside the knife-edge
    sets, their sizes, the valid queries checked: secondary, shadow)."""
    ops, stages = pt.ops, pt.render.proxy_stages
    prepared = []
    for name, sec, shd in cases:
        prepared.append((name, query_rays(pt, torch, sec, False),
                         query_rays(pt, torch, shd, True)))
    # the straddling nets are fitted to the case with the most queries
    prepared.sort(key=lambda c: -c[1][2])
    err, outside = 0.0, 0
    edges = {"seeded": [0, 0], "straddling": [0, 0]}
    counts = [0, 0]
    wide = None
    for nets in ("seeded", "straddling"):
        for name, (sec, _, _), (shd, _, _) in prepared:
            tag = f"{label} {name}, {nets} nets"
            scene, proxies, paths, my_id = sec
            if paths.capacity:     # a partition without live rays has nothing to decide
                diag = float(proxies.max_length.max())
                live = paths.is_valid & ~paths.is_shadow
                eps_v = torch.full((paths.capacity,), MARCH_EPS, device=paths.origin.device)
                hits, _ = ops.trace_closest_checked(scene, paths.origin, paths.direction, eps_v,
                                                    paths.tmax, live, sort_rays=True)
                local_hit = live & hits.is_hit
                local_t = torch.where(local_hit, hits.t, paths.tmax)
                q = ops.proxy_march(proxies, paths.origin, paths.direction, local_t, live,
                                    my_id, MAX_HITS, MARCH_EPS)
                if wide is None:
                    v0, d0 = stages._nn_pair(models, q.features, q.aabb_id, q.is_valid)
                    wide = straddling(pt, torch, models, v0, d0, q.is_valid)
                m = models if nets == "seeded" else wide
                vis, depth = stages._nn_pair(m, q.features, q.aabb_id, q.is_valid)
                edge = knife_edges(torch, q, vis, depth, local_t, shadow=False)
                args = (paths.origin, paths.direction, MARCH_EPS, paths.tmax, live, my_id,
                        MAX_HITS, MARCH_EPS)
                dec = ops.route_fused(scene, proxies, m, *args)
                flat = ops.route_fused(scene, proxies, m, *args, grouped=False)
                nflat = sum(int((flat[f] != dec[f]).sum()) for f in dec)
                check(nflat == 0, f"{tag}: K7 secondary by the rule differs from its flat mode "
                                  f"in {nflat} decisions")
                fields = ("settled_node", "has_node", "env_miss", "no_route", "local_hit")
                o1, _, e1 = compare_decisions(f"{tag}: K7 secondary vs plain", dec,
                                              ops.route_fused_plain(scene, proxies, m, *args),
                                              edge, fields, "new_t", diag)
                o2, _, e2 = compare_decisions(
                    f"{tag}: K7 secondary vs composed", dec,
                    ops.route.consume_secondary(q, vis, depth, live, local_hit, local_t, my_id,
                                                MAX_HITS), edge, fields, "new_t", diag)
                err, outside = max(err, e1, e2), outside + o1 + o2
                edges[nets][0] += int(edge.sum())
                if nets == "seeded":
                    counts[0] += int(q.is_valid.sum())
            s_scene, s_proxies, sp, s_id = shd
            if sp.capacity:
                m = models if nets == "seeded" or wide is None else wide
                s_live = sp.is_valid
                s_t = sp.tmax * (1.0 - 1e-3)
                s_eps = torch.full((sp.capacity,), MARCH_EPS, device=sp.origin.device)
                occ, _ = ops.trace_occlusion_checked(s_scene, sp.origin, sp.direction, s_eps,
                                                     s_t, s_live, sort_rays=True)
                survives = s_live & ~occ
                q_s = ops.proxy_march(s_proxies, sp.origin, sp.direction, s_t, survives, s_id,
                                      MAX_HITS, MARCH_EPS)
                vs, ds = stages._nn_pair(m, q_s.features, q_s.aabb_id, q_s.is_valid)
                edge_s = knife_edges(torch, q_s, vs, ds, s_t, shadow=True)
                s_args = (sp.origin, sp.direction, MARCH_EPS, s_t, s_live, s_id, MAX_HITS,
                          MARCH_EPS)
                dec_s = ops.shadow_route_fused(s_scene, s_proxies, m, *s_args)
                flat_s = ops.shadow_route_fused(s_scene, s_proxies, m, *s_args, grouped=False)
                nflat = sum(int((flat_s[f] != dec_s[f]).sum()) for f in dec_s)
                check(nflat == 0, f"{tag}: K7 shadow by the rule differs from its flat mode in "
                                  f"{nflat} decisions")
                f_s = ("occluded_local", "survives")
                o3, _, _ = compare_decisions(
                    f"{tag}: K7 shadow vs plain", dec_s,
                    ops.shadow_route_fused_plain(s_scene, s_proxies, m, *s_args),
                    edge_s, f_s, "weight", 0.0)
                o4, _, _ = compare_decisions(
                    f"{tag}: K7 shadow vs composed", dec_s,
                    {"weight": ops.route.consume_shadow(q_s, vs, ds, survives, MAX_HITS),
                     "occluded_local": occ, "survives": survives}, edge_s, f_s, "weight", 0.0)
                outside += o3 + o4
                edges[nets][1] += int(edge_s.sum())
                if nets == "seeded":
                    counts[1] += int(q_s.is_valid.sum())
    print(f"phase9 {label}: K7 by the rule equal to its flat mode on every ray, and against "
          f"its plain version and the composed stage on "
          f"{len(cases)} wavefront pair(s) ({counts[0]} secondary and {counts[1]} shadow "
          f"queries): {outside} disagreements outside the knife-edge sets (set aside: seeded "
          f"{edges['seeded'][0]} / {edges['seeded'][1]} rays, straddling "
          f"{edges['straddling'][0]} / {edges['straddling'][1]}); max abs err of t {err:.3g} "
          f"ok", flush=True)
    return err, outside, edges, counts


def settle_buffer(pt, torch, dev, part, lights, env, cfg, width=960, height=540, bounce=1):
    """What one settle_shade call of an exact frame of `part` at width x
    height shades: of the calls at `bounce`, the one with the most live
    rows, its inputs as the stage hands them over (copied). Returns a dict
    of scene, paths, hits, sample, bounce, rr, partition, live, calls (the
    frame's shade calls)."""
    dist = importlib.import_module("pg2024_dprt_tpu_torch.parallel.distributed")
    cam = pt.core.Camera.look_at(*ROOMS_CAMERA, width, height, device=dev)
    c = dataclasses.replace(cfg, width=width, height=height, use_neural_proxies=False)
    real, seen, best = dist.shade, [], {"live": -1}
    copy = lambda t: t._replace(**{k: x.clone() for k, x in t._asdict().items()
                                   if torch.is_tensor(x)})

    def spy(scene, lights_, env_, paths, hits, sample, b, *a, **k):
        if b == bounce:
            live = int((paths.is_valid & ~paths.is_shadow).sum())
            if live > best["live"]:
                best.update(live=live, scene=scene, paths=copy(paths), hits=copy(hits),
                            sample=sample, rr=k["rr"], partition=len(seen) % part.num_partitions)
        seen.append(b)
        return real(scene, lights_, env_, paths, hits, sample, b, *a, **k)

    dist.shade = spy
    try:
        dist.render_image_distributed(part, None, lights, env, cam, c, base_sample=5, device=dev)
    finally:
        dist.shade = real
    torch.cuda.synchronize()
    return {**best, "bounce": bounce, "calls": len(seen)}


def shade_bytes(torch, scene, paths, hits, s: int, ris: bool) -> int:
    """The bytes K14 must move on one buffer of a flat scene (csrc/shade.cu's
    header): per row 34 B read (flags, pixel id, origin, direction), the
    next path's 51 B written, and one shadow row of 51 B ("ris") or S rows
    of 59 B ("sum"); per live row 13 B more (throughput, hit flag); per live
    hit 16 B (t, id, u, v), and once per distinct triangle the 52 B of its
    tri_shade row that shading reads (56 with textures); per live miss the
    12 B of its environment-image pixel."""
    live = paths.is_valid & ~paths.is_shadow
    hit = live & hits.is_hit
    per_row = 34 + 51 + (51 if ris else 59 * s)
    tris = int(torch.unique(hits.tri_index[hit]).numel())
    return (per_row * paths.capacity + 13 * int(live.sum()) + 16 * int(hit.sum())
            + (56 if scene.textured else 52) * tris + 12 * int((live & ~hits.is_hit).sum()))


def shade_mismatches(torch, got, want):
    """(fields that differ, max abs err): K14's outputs against its plain
    version's by the GPU tests' criteria: masks, ids, the next tmax and
    every field of a valid shadow row equal; the next path's origin,
    direction and throughput on its live rows, and the environment image,
    within rtol 1e-5 / atol 1e-6; a dead row's throughput 0, every origin
    and direction finite."""
    bad, err = [], 0.0
    for tag, g, w in (("next", got[0], want[0]), ("shadow", got[1], want[1])):
        if g.capacity != w.capacity:
            bad.append(f"{tag}.capacity")
            continue
        bad += [f"{tag}.{f}" for f in ("is_valid", "is_delta", "is_shadow", "pixel_index",
                                       "shadow_path_id")
                if not torch.equal(getattr(g, f), getattr(w, f))]
        if not bool((g.throughput[~g.is_valid] == 0).all()):
            bad.append(f"{tag}.throughput of dead rows")
        if not bool(torch.isfinite(g.origin).all() and torch.isfinite(g.direction).all()):
            bad.append(f"{tag}.origin / direction not finite")
    if bad:
        return bad, err
    (gn, gs, genv), (wn, ws, wenv) = got, want
    if not torch.equal(gn.tmax, wn.tmax):
        bad.append("next.tmax")
    live, valid = wn.is_valid, ws.is_valid
    pairs = [(f"next.{f}", getattr(gn, f)[live], getattr(wn, f)[live])
             for f in ("origin", "direction", "throughput")] + [("env", genv, wenv)]
    for name, a, b in pairs:
        if a.numel():
            err = max(err, float((a - b).abs().max()))
        if not bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6)):
            bad.append(name)
    bad += [f"shadow.{f}" for f in ("origin", "direction", "tmax", "throughput")
            if not torch.equal(getattr(gs, f)[valid], getattr(ws, f)[valid])]
    return bad, err


def shade_phase(pt, torch, dev, part, lights, env, cfg, width=960, height=540):
    """Phase 9's K14 check at the main path's shape (the benchmark's
    960x540); returns K14's kernels-line entry."""
    ops, plain = pt.ops, shade_plain_of(pt)
    buf = settle_buffer(pt, torch, dev, part, lights, env, cfg, width, height)
    scene, paths, hits = buf["scene"], buf["paths"], buf["hits"]
    n, s = paths.capacity, cfg.shadow_path_count
    args = (scene, lights, env, paths, hits, buf["sample"], buf["bounce"], s, width * height)
    where = (f"partition {buf['partition']}'s bounce-{buf['bounce']} settle_shade buffer of a "
             f"{width}x{height} exact rooms_p8 frame ({buf['live']} live of {n} rows)")
    check(n == width * height and buf["live"] > 0, f"K14's buffer: {where}")
    modes = {}
    for mode, rr in (("ris", buf["rr"]), ("sum", True)):
        call = lambda: ops.shade_paths(*args, nee_mode=mode, rr=rr)
        before = ops.LAUNCHES["shade_paths"]
        got = call()
        check(ops.LAUNCHES["shade_paths"] == before + 1, "K14 is not one launch a call")
        want = plain(*args, nee_mode=mode, rr=rr)
        torch.cuda.synchronize()
        bad, err = shade_mismatches(torch, got, want)
        check(not bad, f"K14 vs its plain version on {where}, {mode} roulette {int(rr)}: "
                       f"{', '.join(bad)} differ")
        check(bool(want[0].is_valid.any() and want[1].is_valid.any()),
              f"K14's buffer, {mode} roulette {int(rr)}: no next path or no shadow row is valid")
        d_ms, how = device_reading(torch, call, "shade_paths_kernel", reps=20)
        w_ms = cuda_ms(torch, call, reps=7)
        p_ms = cuda_ms(torch, lambda: plain(*args, nee_mode=mode, rr=rr), reps=3)
        nbytes = shade_bytes(torch, scene, paths, hits, s, mode == "ris")
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        modes[mode] = {"ms": d_ms, "ms_by": how, "wrapper_ms": w_ms, "plain_ms": p_ms,
                       "bound_ms": b_ms, "bound_by": "bytes", "bytes": nbytes,
                       "max_abs_err": err, "roulette": bool(rr),
                       "shadow_rows": int(want[1].is_valid.sum())}
        print(f"phase9 K14 shade_paths vs its plain version on {where}, {mode} roulette "
              f"{int(rr)}: masks, ids and valid shadow rows equal, live next paths and the "
              f"environment image within 1e-5 (max abs err {err:.3g}) ok; device {d_ms:.4f} ms "
              f"({how}), wrapper {w_ms:.4f} ms, plain {p_ms:.2f} ms, bound {b_ms:.6f} ms "
              f"({nbytes} B; device time at {b_ms / d_ms:.3f} of the bound)", flush=True)
    ris = modes.pop("ris")
    return {"name": "shade_paths", "route": "cuda",
            "source": "pg2024_dprt_tpu_torch/csrc/shade.cu",
            "replaces": "none: the JAX package shades with XLA-fused jnp code "
                        "(pg2024_dprt_tpu/render/shade.py:174)",
            "launches": buf["calls"], **ris, "disagreements": 0, "library_ms": None,
            "wavefront": where, "sum_mode": modes["sum"]}


def distributed_phase(pt, torch, np, dev, counted, inst, tris_per_room=131072, side=256,
                      grid_tris=128, bucket_fraction=0.02, statue_side=64, route_rays=65536,
                      min_frame_queries=1, min_queries=1000, shade_size=(960, 540)):
    """Phase 9; returns the kernels-line entry of K7's multi-geo mode and the
    phase's numbers. `inst` is phase 7's instanced frame (its single-device
    image, lights, env, camera, config)."""
    ops, dist = pt.ops, pt.parallel
    P = 8
    out = {}
    env = pt.scene.EnvironmentMap.constant(ROOMS_ENV, device=dev)
    cam = pt.core.Camera.look_at(*ROOMS_CAMERA, side, side, device=dev)
    cfg = pt.render.RenderConfig(width=side, height=side, spp=1, bounces=4)
    npix = cfg.frame_buffer_size

    def frame(part, models, c, s=0):
        return dist.render_image_distributed(part, models, lights, env, cam, c,
                                             base_sample=s, return_stats=True, device=dev)

    def timed(part, models, c):
        seeds = iter(range(1, 1000))
        return cuda_ms(torch, lambda: frame(part, models, c, next(seeds)), reps=3)

    def report(name, st, counts, ms=None):
        print(f"phase9 {name}: launches {counts}; migration rounds per bounce "
              f"{st['migration_rounds'][0]}, paths moved {st['paths_moved']}, overflow waits "
              f"{st['migration_overflow_waits']}, truncated {st['migration_truncated']}, "
              f"grid-culled {st['grid_culled']}"
              + (f"; frame {ms:.3f} ms (median of 3 after a warm-up)" if ms else ""), flush=True)

    # ---- 9a rooms_p8, exact mode, full size
    meshes, lights = pt.scene.two_room_scene(num_rooms=P, tris_per_room=tris_per_room, seed=2,
                                             device=dev)
    part, build_s, mb = table_mb(torch, lambda: pt.scene.build_partitioned_scene(
        meshes, P, device=dev))
    single = pt.scene.device_scene_from_meshes(meshes, device=dev)
    want = pt.render.render_image(single, lights, env, cam,
                                  dataclasses.replace(cfg, fused_frame="off"), device=dev)
    print(f"phase9 rooms_p8: {P} partitions of {part.scenes[0].num_triangles} triangles "
          f"(K={part.scenes[0].num_clusters} clusters of C={part.scenes[0].tris_per_cluster} "
          f"each; the rule takes the {'grouped' if ops.trace_grouped(part.scenes[0]) else 'flat'} "
          f"kernels), host build {build_s:.1f} s, {mb:.1f} MB of device tables; reference: "
          f"render_image of the same meshes on one scene, fused_frame='off'", flush=True)
    (img, st), counts = counted(lambda: frame(part, None, cfg))
    t_closest = "grouped_closest" if ops.trace_grouped(part.scenes[0]) else "resident_closest"
    t_anyhit = "grouped_anyhit" if ops.trace_grouped(part.scenes[0], True) else "resident_anyhit"
    check(set(counts) == {t_closest, t_anyhit, "schedule_keys", "shade_paths"}
          and counts[t_anyhit] == P * 4 and counts["shade_paths"] == P * cfg.bounces,
          f"rooms_p8 exact launches {counts}")
    check(tuple(img.shape) == (side, side, 3) and st["migration_truncated"] == 0,
          f"rooms_p8 exact: shape {tuple(img.shape)}, truncated {st['migration_truncated']}")
    ndis, err = compare_frames("rooms_p8 distributed vs single device", as_pixels(img),
                               as_pixels(want), npix)
    ms = timed(part, None, cfg)
    report("9a rooms_p8 exact", st, counts, ms)
    print(f"phase9 9a distributed vs single device: {ndis} outlier pixels of {npix}, max abs err "
          f"elsewhere {err:.3g} ok", flush=True)
    out["rooms_p8_exact"] = {"ms": ms, "launches": counts, **st}
    # phase 13 runs these frames again, one partition a rank
    rank_cases = {"exact": (part, None, cfg, img, st, counts, ms)}
    prof = pt.utils.profile.render_device_profile(
        lambda s: frame(part, None, cfg, s), reps=3)
    print(f"phase9 9a profile: idle share {prof['idle_share_unprofiled']:.3f} (profiled "
          f"{prof['idle_share_profiled']:.3f}), busy {prof['busy_ms']:.1f} ms of "
          f"{prof['unprofiled_wall_ms']:.1f}, stages "
          + json.dumps({k: round(v, 3) for k, v in prof["stages_ms"].items()}), flush=True)
    out["rooms_p8_exact"]["profile"] = profile_summary(prof)
    out["_shade_entry"] = shade_phase(pt, torch, dev, part, lights, env, cfg, *shade_size)

    # bucket pressure: small buckets overflow and retry; the same image
    cfg_b = dataclasses.replace(cfg, bucket_fraction=bucket_fraction, max_migrations=512)
    (img_b, st_b), counts_b = counted(lambda: frame(part, None, cfg_b))
    check(st_b["migration_overflow_waits"] > 0 and st_b["migration_truncated"] == 0,
          f"bucket pressure: overflow waits {st_b['migration_overflow_waits']}, truncated "
          f"{st_b['migration_truncated']}")
    ndis_b, _ = compare_frames("rooms_p8 bucket pressure vs single device", as_pixels(img_b),
                               as_pixels(want), npix)
    report(f"9a rooms_p8 exact, bucket_fraction {bucket_fraction}", st_b, counts_b)
    print(f"phase9 9a bucket pressure vs single device: {ndis_b} outlier pixels ok", flush=True)
    out["rooms_p8_bucket_pressure"] = st_b

    # the grids: at tris_per_room the soups fill their boxes and nearly every
    # bin is marked (shown on a subset of room 0: a bin's marking only grows
    # with content), so the grid variant runs the rooms at the JAX benchmark's own
    # grid cell (scripts/bench_distributed_cpu8.py: 128 triangles a room)
    room = meshes[0]
    k = min(4096, room.num_triangles)
    lo_r, hi_r = room.aabb()
    t0 = time.perf_counter()
    sub_grid = pt.scene.build_conservative_grid(
        np.minimum(np.minimum(room.v0[:k], room.v1[:k]), room.v2[:k]),
        np.maximum(np.maximum(room.v0[:k], room.v1[:k]), room.v2[:k]), lo_r, hi_r)
    print(f"phase9 9a grid of {k} of room 0's {room.num_triangles} triangles (16 x 16 cells, "
          f"16 azimuth bins a face): {float(sub_grid.mean()):.4f} of the bins marked "
          f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)
    out["rooms_p8_subset_grid_marked"] = float(sub_grid.mean())
    g_meshes, _ = pt.scene.two_room_scene(num_rooms=P, tris_per_room=grid_tris, seed=2,
                                          device=dev)
    part_g = pt.scene.build_partitioned_scene(g_meshes, P, visibility_grids=True, device=dev)
    want_g = pt.render.render_image(pt.scene.device_scene_from_meshes(g_meshes, device=dev),
                                    lights, env, cam, dataclasses.replace(cfg, fused_frame="off"),
                                    device=dev)
    cfg_g = dataclasses.replace(cfg, use_visibility_grids=True)
    (img_g, st_g), counts_g = counted(lambda: frame(part_g, None, cfg_g))
    (img_n, st_n), _ = counted(lambda: frame(part_g, None, cfg))
    check(st_g["grid_culled"] > 0 and st_g["migration_truncated"] == 0,
          f"grids: culled {st_g['grid_culled']}, truncated {st_g['migration_truncated']}")
    ndis_g, _ = compare_frames("rooms_p8 grids vs single device", as_pixels(img_g),
                               as_pixels(want_g), npix)
    ndis_n, _ = compare_frames("rooms_p8 (grid cell) without grids vs single device",
                               as_pixels(img_n), as_pixels(want_g), npix)
    report(f"9a rooms_p8 with visibility grids ({grid_tris} triangles a room)", st_g, counts_g)
    print(f"phase9 9a grids: {ndis_g} outlier pixels with grids, {ndis_n} without, against the "
          f"single device ok; paths moved {st_g['paths_moved']} with grids, {st_n['paths_moved']} "
          f"without", flush=True)
    out["rooms_p8_grids"] = {**st_g, "paths_moved_without": st_n["paths_moved"]}
    rank_cases["grids"] = (part_g, None, cfg_g, img_g, st_g, counts_g, None)

    # ---- 9b instanced_p8: phase 7's instanced frame over 8 partitions
    inst_img, lights_i, env_i, cam_i, cfg_i = inst
    i_meshes, grid = pt.scene.instance_grid()
    part_i, build_i, mb_i = table_mb(torch, lambda: pt.scene.build_partitioned_scene_instanced(
        i_meshes, grid, P, device=dev))
    frame_i = lambda s=0: dist.render_image_distributed(part_i, None, lights_i, env_i, cam_i,
                                                        cfg_i, base_sample=s, return_stats=True,
                                                        device=dev)
    (img_i, st_i), counts_i = counted(frame_i)
    check(st_i["migration_truncated"] == 0 and tuple(img_i.shape) == tuple(inst_img.shape),
          f"instanced_p8: truncated {st_i['migration_truncated']}")
    ndis_i, err_i = compare_frames("instanced_p8 vs the single-device instanced frame",
                                   as_pixels(img_i), as_pixels(inst_img),
                                   cfg_i.frame_buffer_size)
    seeds = iter(range(1, 1000))
    ms_i = cuda_ms(torch, lambda: frame_i(next(seeds)), reps=3)
    print(f"phase9 9b instanced_p8: {P} partitions of {part_i.scenes[0].cl_xf.shape[0]} instance "
          f"(K={part_i.scenes[0].num_clusters}), host build {build_i:.1f} s, {mb_i:.1f} MB",
          flush=True)
    report("9b instanced_p8 exact", st_i, counts_i, ms_i)
    print(f"phase9 9b vs phase 7's single-device instanced frame: {ndis_i} outlier pixels, max "
          f"abs err elsewhere {err_i:.3g} ok", flush=True)
    out["instanced_p8"] = {"ms": ms_i, "launches": counts_i, **st_i}

    # ---- 9c rooms_p8, neural mode, full width: 8 PROD pairs and MULTIGEO
    cfg_n = dataclasses.replace(cfg, use_neural_proxies=True)
    prod = pt.models.random_proxy_models(np.random.RandomState(1), P, device=dev)
    rng = np.random.RandomState(4)
    mg = pt.models.multigeo_proxy_models(
        pt.models.init_mlp(rng, pt.models.MULTIGEO_VIS, device=dev),
        pt.models.init_mlp(rng, pt.models.MULTIGEO_DEPTH, device=dev), P,
        pt.models.MULTIGEO_VIS, pt.models.MULTIGEO_DEPTH)
    mg_entry = {}
    stages = pt.render.proxy_stages
    for label, m in (("PROD w256/d4 x 8", prod), ("MULTIGEO w512/d3", mg)):
        store = {}
        with captured_stages(pt, store):
            (img_n, st_n), counts_n = counted(lambda: frame(part, m, cfg_n))
        want_counts = {"route_secondary": P * (cfg.bounces - 1), "route_shadow": P * cfg.bounces}
        if m.multi_geo:
            want_counts["route_multigeo"] = sum(want_counts.values())
        check(all(counts_n.get(k) == v for k, v in want_counts.items())
              and (m.multi_geo or "route_multigeo" not in counts_n),
              f"rooms_p8 neural ({label}) launches {counts_n}")
        check(bool(torch.isfinite(img_n).all()) and float(img_n.mean()) > 0.0
              and st_n["migration_truncated"] == 0, f"rooms_p8 neural ({label}) image")
        ms_n = timed(part, m, cfg_n)
        report(f"9c rooms_p8 neural, {label}", st_n, counts_n, ms_n)
        # every partition's bounce-1 wavefronts (the stage calls of bounce 1)
        cases = [(f"partition {i}", store["secondary"][i], store["shadow"][P + i])
                 for i in range(P)]
        err, outside, edges, (nq, nq_s) = route_checks(
            pt, torch, f"9c {label}, bounce-1 wavefronts", m, cases)
        check(nq >= min_frame_queries,
              f"{label}: {nq} secondary queries on the bounce-1 wavefronts")
        # the stages on the partition whose bounce-1 wavefront carries the most queries
        counted_q = [query_rays(pt, torch, c[1], False)[2] for c in cases]
        busiest = max(range(P), key=lambda i: counted_q[i])
        scene, proxies, paths, my_id = cases[busiest][1]
        s_scene, s_proxies, sp, s_id = cases[busiest][2]
        sec_stage = lambda: stages.secondary_route(scene, proxies, m, env, paths, my_id,
                                                   MAX_HITS, MARCH_EPS, npix)
        shd_stage = lambda: stages.shadow_direct_light_nn(
            s_scene, s_proxies, m, sp, s_id, MAX_HITS, MARCH_EPS, cfg.shadow_path_count, npix)
        stage_ms = {"secondary": cuda_ms(torch, sec_stage, reps=7),
                    "shadow": cuda_ms(torch, shd_stage, reps=7)}
        with composed_route(pt):
            stage_ms["secondary composed"] = cuda_ms(torch, sec_stage, reps=7)
            stage_ms["shadow composed"] = cuda_ms(torch, shd_stage, reps=7)
        print(f"phase9 9c {label}: bounce-1 queries per partition {counted_q}; stages on "
              f"partition {my_id} ({int(paths.is_valid.sum())} secondary, "
              f"{int(sp.is_valid.sum())} shadow rays; medians of 7): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()), flush=True)
        # K7 on that partition's wavefronts: the warp walks against the flat
        # mode, and K7's bound there
        live_b = paths.is_valid & ~paths.is_shadow
        eps_b = torch.full((paths.capacity,), MARCH_EPS, device=dev)
        eps_s = torch.full((sp.capacity,), MARCH_EPS, device=dev)
        sec_b = (paths.origin, paths.direction, eps_b, paths.tmax, live_b)
        shd_b = (sp.origin, sp.direction, eps_s, sp.tmax * (1.0 - 1e-3), sp.is_valid)
        k7_args = lambda rays, node: (rays[0], rays[1], MARCH_EPS, *rays[3:], node, MAX_HITS,
                                      MARCH_EPS)
        modes = route_modes(pt, torch, f"phase9 9c {label}, partition {my_id}", scene, proxies,
                            m, k7_args(sec_b, my_id), k7_args(shd_b, s_id))
        b_sec = route_bound(pt, torch, scene, proxies, m, sec_b, False, counted_q[busiest])[:2]
        b_shd = route_bound(pt, torch, s_scene, s_proxies, m, shd_b, True,
                            query_rays(pt, torch, cases[busiest][2], True)[2])[:2]
        print(f"phase9 9c {label}: K7's bound on partition {my_id}'s bounce-1 wavefronts: "
              f"secondary {b_sec[0]:.6f} ms ({b_sec[1]}), shadow {b_shd[0]:.6f} ms "
              f"({b_shd[1]})", flush=True)
        if not m.multi_geo:
            rank_cases["neural"] = (part, m, cfg_n, img_n, st_n, counts_n, ms_n)
        row = {"ms": ms_n, "launches": counts_n, "stage_ms": stage_ms, "knife_edges": edges,
               "bounce1_queries": counted_q, "disagreements": outside, **st_n,
               "k7_modes_ms": modes, "k7_bound_ms": b_sec[0], "k7_bound_by": b_sec[1],
               "k7_shadow_bound_ms": b_shd[0]}
        k8_frames = {"rooms_p8 exact": counts.get("schedule_keys", 0),
                     "instanced_p8": counts_i.get("schedule_keys", 0),
                     f"rooms_p8 neural {label}": counts_n.get("schedule_keys", 0)}
        check(k8_frames["rooms_p8 exact"] > 0, f"K8 launches per frame {k8_frames}")
        print("phase9 K8 schedule_keys launches per frame: "
              + ", ".join(f"{k} {v}" for k, v in k8_frames.items()), flush=True)
        row["k8_launches_per_frame"] = k8_frames
        if not m.multi_geo:
            # K8 on the partition's sparse bounce-1 wavefront, as the stage
            # hands it over (dead rows included)
            key_b = ops.schedule_keys(scene, *sec_b)
            kb_dis = int((key_b != ops.schedule_keys_plain(scene, *sec_b)).sum())
            check(kb_dis == 0, f"K8 on partition {my_id}'s bounce-1 wavefront: {kb_dis} rays "
                               f"with another key than the plain version")
            kb_dev, kb_ms = split_ms(torch, lambda: ops.schedule_keys(scene, *sec_b),
                                     "schedule_keys_kernel")
            kb_work = keys_work(pt, scene, sec_b)
            kb_bound, kb_by = bound(kb_work)
            print(f"phase9 9c K8 on partition {my_id}'s bounce-1 secondary wavefront "
                  f"({int(live_b.sum())} live of {paths.capacity} rows, K="
                  f"{scene.num_clusters}): every key equal to the plain version ok; device "
                  f"{kb_dev:.4f} ms, wrapper {kb_ms:.4f} ms, bound {kb_bound:.6f} ms ({kb_by}; "
                  f"device time at {kb_bound / kb_dev:.3f} of the bound)", flush=True)
            row["k8_sparse"] = {"live": int(live_b.sum()), "rows": paths.capacity,
                                "k": scene.num_clusters, "device_ms": kb_dev,
                                "wrapper_ms": kb_ms, "bound_ms": kb_bound, "bound_by": kb_by}
        if not m.multi_geo:
            prof = pt.utils.profile.render_device_profile(
                lambda s: frame(part, m, cfg_n, s), reps=3)
            print(f"phase9 9c profile ({label}): idle share {prof['idle_share_unprofiled']:.3f} "
                  f"(profiled {prof['idle_share_profiled']:.3f}), stages "
                  + json.dumps({k: round(v, 3) for k, v in prof["stages_ms"].items()}),
                  flush=True)
            row["profile"] = profile_summary(prof)
            out["rooms_p8_neural_prod"] = row
            continue
        out["rooms_p8_neural_multigeo"] = row

        # K7's multi-geo mode at phase 6's full width: the neural_route_64k
        # wavefronts (65,536 random rays, 8 proxy boxes) with the MULTIGEO pair
        r_scene, r_proxies, r_prod, r_paths, r_shadow, _ = route_config(pt, torch, np, dev,
                                                                       n=route_rays)
        e64, o64, edges64, (nq64, nqs64) = route_checks(
            pt, torch, "K7 multi-geo mode on neural_route_64k", m,
            [("neural_route_64k", (r_scene, r_proxies, r_paths, 8),
              (r_scene, r_proxies, r_shadow, 8))])
        check(nq64 >= min_queries, f"neural_route_64k: {nq64} secondary queries")
        live = r_paths.is_valid
        eps_v = torch.full((r_paths.capacity,), MARCH_EPS, device=dev)
        rays = (r_paths.origin, r_paths.direction, eps_v, r_paths.tmax, live)
        perm = ops.schedule_order(r_scene, *rays)
        in_order = tuple(x[perm] for x in rays)
        k_args = (in_order[0], in_order[1], MARCH_EPS, in_order[3], in_order[4], 8, MAX_HITS,
                  MARCH_EPS)
        k_dev, k_ms = split_ms(torch, lambda: ops.route_fused(r_scene, r_proxies, m, *k_args,
                                                              sort_rays=False), "route_kernel")
        sep_ms = cuda_ms(torch, lambda: ops.route_fused(r_scene, r_proxies, r_prod, *k_args,
                                                        sort_rays=False), reps=7)
        s_args = (r_shadow.origin, r_shadow.direction, MARCH_EPS, r_shadow.tmax * (1.0 - 1e-3),
                  r_shadow.is_valid, 8, MAX_HITS, MARCH_EPS)
        ks_ms = cuda_ms(torch, lambda: ops.shadow_route_fused(r_scene, r_proxies, m, *s_args),
                        reps=7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.route_fused_plain(r_scene, r_proxies, m, *k_args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # the bound: the trace's and the march's operations at the FP32 rate,
        # the multi-geo nets' FLOPs per valid query at the bf16 rate
        b_ms, b_by, tw, nw = route_bound(pt, torch, r_scene, r_proxies, m, in_order, False, nq64)
        s_rays = (r_shadow.origin, r_shadow.direction, eps_v, r_shadow.tmax * (1.0 - 1e-3),
                  r_shadow.is_valid)
        bs_ms, bs_by, _, _ = route_bound(pt, torch, r_scene, r_proxies, m, s_rays, True, nqs64)
        print(f"phase9 K7 multi-geo mode, shadow: bound {bs_ms:.6f} ms ({bs_by}) on {nqs64} valid "
              f"queries", flush=True)
        print(f"phase9 K7 multi-geo mode on neural_route_64k in schedule order ({nq64} valid "
              f"queries): device {k_dev:.3f} ms, wrapper {k_ms:.3f} ms (the 8 PROD pairs on the "
              f"same rays: {sep_ms:.3f} ms), "
              f"shadow {ks_ms:.3f} ms (medians of 7); plain {plain_ms:.1f} ms (one run); bound "
              f"{b_ms:.6f} ms ({b_by}: {tw['tests']} ray-triangle tests, {tw['slabs']} slab "
              f"tests, {nw['flops']} net FLOPs at the bf16 rate)", flush=True)
        mg_entry = {
            "name": "route_multigeo", "route": "cuda",
            "source": "pg2024_dprt_tpu_torch/csrc/route.cu",
            "replaces": "pg2024_dprt_tpu/ops/pallas_route.py:196 (_route_kernel, multi_geo "
                        "mode: :202, :212-214, :354-355, :411-415, :426-427; pallas_call :729)",
            "launches": counts_n["route_multigeo"], "max_abs_err": max(err, e64),
            "disagreements": outside + o64, "ms": k_dev, "wrapper_ms": k_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "wavefront": "neural_route_64k, schedule order", "shadow_ms": ks_ms,
            "shadow_bound_ms": bs_ms, "shadow_bound_by": bs_by,
            "separate_nets_ms": sep_ms, "knife_edges": {"rooms_bounce1": edges,
                                                        "neural_route_64k": edges64}}

    # ---- 9d trained nets: the paper's A-B on the card
    part_s, lights_s, env_s, cam_s = statue_row(pt, np, dev, statue_side)
    cfg_e = pt.render.RenderConfig(width=statue_side, height=statue_side, spp=2, bounces=2)
    cfg_s = dataclasses.replace(cfg_e, use_neural_proxies=True)
    families = pt.scene.load_ab_scaled_models(
        os.path.join(ROOT, "artifacts", "ab_scaled", "weights.npz"), device=dev)
    control = pt.models.random_proxy_models(3, STATUE_PARTS, families[0].vis_cfg,
                                            families[0].depth_cfg, device=dev)
    exact = dist.render_image_distributed(part_s, families[0], lights_s, env_s, cam_s, cfg_e,
                                          device=dev)
    tm = lambda x: x / (1.0 + x)
    ab = {}
    for name, m in zip(("separate", "combined", "multigeo", "random control"),
                       (*families, control)):
        nn, counts_s = counted(lambda: dist.render_image_distributed(
            part_s, m, lights_s, env_s, cam_s, cfg_s, device=dev))
        e = float((tm(nn) - tm(exact)).abs().mean())
        ratio = float(nn.mean() / exact.mean())
        ab[name] = {"mean_err": e, "ratio": ratio, "launches": counts_s}
        if name == "random control":
            check(e > AB_CONTROL_ERR, f"A-B control too weak: {e:.3g}")
        else:
            check(e < AB_MEAN_ERR and 0.99 < ratio < 1.01,
                  f"A-B {name}: mean tone-mapped error {e:.3g}, ratio {ratio:.6f}")
        if name == "multigeo":
            check(counts_s.get("route_multigeo", 0) > 0, f"A-B multigeo launches {counts_s}")
        print(f"phase9 9d A-B {name} (w{m.vis_cfg.width}/d{m.vis_cfg.depth}): mean tone-mapped "
              f"error {e:.3g}, mean ratio {ratio:.6f} (gates: < {AB_MEAN_ERR} and (0.99, 1.01); "
              f"control > {AB_CONTROL_ERR}) ok; launches {counts_s}", flush=True)
    out["ab_trained"] = ab
    out["_rank_setup"] = {"lights": lights, "env": env, "cam": cam, "cases": rank_cases,
                          "grid_meshes": g_meshes, "single_grid_frame": want_g}
    return mg_entry, out


# ---------------------------------------------------------------------------
# phase 13: the distributed frame with one partition a rank (parallel/mesh.py
# RankMesh over torch.distributed): 8 gloo ranks on the one card, and a
# one-rank NCCL world

RANK_DEADLINE_S = 420
NCCL_DEADLINE_S = 180
RANK_REPS = 3


class CountingMesh:
    """A mesh that counts its collectives and the bytes each rank hands to
    them, by the stage that called them (`tag`: migration, exchange, ring,
    or frame: the psums that end a sample)."""

    def __init__(self, mesh):
        self.mesh, self.tag = mesh, "frame"
        self.calls, self.bytes = {}, {}

    def __getattr__(self, name):
        return getattr(self.mesh, name)

    def _count(self, op, x):
        key = f"{self.tag} {op}"
        self.calls[key] = self.calls.get(key, 0) + 1
        self.bytes[key] = self.bytes.get(key, 0) + x.numel() * x.element_size()

    def all_to_all(self, x):
        self._count("all_to_all", x)
        return self.mesh.all_to_all(x)

    def psum(self, x):
        self._count("psum", x)
        return self.mesh.psum(x)


@contextlib.contextmanager
def tagged(pt, mesh):
    """Tag the collectives of the migration loop (its termination psums),
    exchange_paths and ring_shadow_occlusion; the rest are the frame's."""
    dist = pt.parallel.distributed
    saved = {name: getattr(dist, name) for name in
             ("_migration_loop", "exchange_paths", "ring_shadow_occlusion")}

    def wrap(fn, tag):
        def call(*a, **k):
            outer, mesh.tag = mesh.tag, tag
            try:
                return fn(*a, **k)
            finally:
                mesh.tag = outer
        return call

    for name, tag in (("_migration_loop", "migration"), ("exchange_paths", "exchange"),
                      ("ring_shadow_occlusion", "ring")):
        setattr(dist, name, wrap(saved[name], tag))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def rank_worker(workdir: str, device: str, backend: str, labels, reps: int):
    """What each rank of phase 13 runs: its own inputs from workdir (its
    partition's scene, every proxy and net), then per case one counted frame
    and `reps` timed frames (CUDA events between all-rank barriers).
    Returns per case the stats, this rank's launches, the collectives and
    bytes by stage, the frame ms, and (rank 0) the image."""
    import torch
    import torch.distributed as tdist

    import pg2024_dprt_tpu_torch as pt
    import pg2024_dprt_tpu_torch.ops
    import pg2024_dprt_tpu_torch.parallel

    rank = tdist.get_rank()
    inputs = torch.load(os.path.join(workdir, f"rank{rank}.pt"), weights_only=False)
    out = {}
    for label in labels:
        part, models, lights, env, cam, cfg = inputs[label]
        mesh = CountingMesh(pt.parallel.make_rank_mesh(part.num_partitions, device=device,
                                                       backend=backend))

        def frame(s=0):
            return pt.parallel.render_image_distributed(part, models, lights, env, cam, cfg,
                                                        mesh=mesh, base_sample=s,
                                                        return_stats=True)

        tdist.barrier()
        pt.ops.reset_launch_counts()
        with tagged(pt, mesh):
            img, stats = frame()
        torch.cuda.synchronize()
        launches = {k: v for k, v in pt.ops.LAUNCHES.items() if v}
        calls, nbytes = dict(mesh.calls), dict(mesh.bytes)
        times = []
        for s in range(1, reps + 1):
            tdist.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            frame(s)
            end.record()
            end.synchronize()
            tdist.barrier()
            times.append(start.elapsed_time(end))
        out[label] = {"stats": stats, "launches": launches, "calls": calls, "bytes": nbytes,
                      "ms": times, "image_sum": float(img.double().sum()),
                      "image": img.cpu() if rank == 0 else None}
    return out


def rank_inputs(pt, torch, workdir, setup, labels, ranks):
    """Each rank's inputs on the host, written once: the case's partitioned
    scene with only that rank's partition scene (the others None), every
    proxy and net, lights, env, camera and config."""
    host = lambda x: pt.render.engine._on("cpu", x)
    os.makedirs(workdir, exist_ok=True)
    for r in range(ranks):
        per_rank = {}
        for label in labels:
            part, models, cfg = setup["cases"][label][:3]
            mine = part._replace(
                scenes=[host(s) if i == r else None for i, s in enumerate(part.scenes)],
                proxies=part.proxies.to("cpu"),
                nn_proxies=None if part.nn_proxies is None else part.nn_proxies.to("cpu"))
            per_rank[label] = (mine, None if models is None else models.to("cpu"),
                               host(setup["lights"]), host(setup["env"]), host(setup["cam"]),
                               cfg)
        torch.save(per_rank, os.path.join(workdir, f"rank{r}.pt"))


def rank_phase(pt, torch, dev, setup, workdir):
    """Phase 13: 13a / 13b phase 9's rooms_p8 frames (exact, exact with
    grids, neural with the PROD pairs) with one partition a gloo rank on the
    one card, held against phase 9's in-process frames; 13c a one-rank NCCL
    world's P = 1 frame against the single-device composed frame. Returns
    the phase's numbers."""
    import shutil

    labels = ("exact", "grids", "neural")
    cases = setup["cases"]
    ranks = cases["exact"][0].num_partitions
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    rank_inputs(pt, torch, os.path.join(workdir, "inputs"), setup, labels, ranks)
    hand_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_rank = pt.parallel.run_ranks(
        rank_worker, ranks, (os.path.join(workdir, "inputs"), "cuda:0", "gloo", labels,
                             RANK_REPS), os.path.join(workdir, "gloo"), backend="gloo",
        deadline_s=RANK_DEADLINE_S)
    world_s = time.perf_counter() - t0
    print(f"phase13 {ranks} gloo ranks on cuda:0: inputs written in {hand_s:.1f} s, the world "
          f"ran {world_s:.1f} s (spawn, imports, 1 + {RANK_REPS} frames a case)", flush=True)
    out = {"ranks": ranks, "backend": "gloo", "handoff_s": hand_s, "world_s": world_s}
    for label in labels:
        part, models, cfg, want, want_st, want_counts, want_ms = cases[label]
        rows = [r[label] for r in per_rank]
        npix = cfg.frame_buffer_size
        name = f"13{'b' if label == 'neural' else 'a'} rooms_p8 {label}"
        st = rows[0]["stats"]
        check(all(r["stats"] == st for r in rows), f"{name}: the ranks' stats differ")
        check(all(r["image_sum"] == rows[0]["image_sum"] for r in rows),
              f"{name}: the ranks hold different images")
        img = rows[0]["image"].to(dev)
        ndis, err = compare_frames(f"{name} ranks vs in-process", as_pixels(img),
                                   as_pixels(want), npix)
        keys = ("migration_rounds", "paths_moved", "migration_overflow_waits", "tracer_diag",
                "migration_truncated", "grid_culled")
        check({k: st[k] for k in keys} == {k: want_st[k] for k in keys},
              f"{name}: stats {({k: st[k] for k in keys})} against in-process "
              f"{({k: want_st[k] for k in keys})}")
        check(st["migration_truncated"] == 0 and (label != "grids" or st["grid_culled"] > 0),
              f"{name}: truncated {st['migration_truncated']}, culled {st['grid_culled']}")
        launches = [r["launches"] for r in rows]
        summed = {}
        for c in launches:
            for k, v in c.items():
                summed[k] = summed.get(k, 0) + v
        check(summed == want_counts, f"{name}: launches over the ranks {summed} against the "
                                     f"in-process frame's {want_counts}")
        if label == "neural":
            check(all(c.get("route_secondary") == cfg.bounces - 1
                      and c.get("route_shadow") == cfg.bounces for c in launches),
                  f"{name}: K7 launches per rank {launches}")
        rounds = sum(st["migration_rounds"][0])
        calls, nbytes = rows[0]["calls"], rows[0]["bytes"]
        ms = statistics.median(rows[0]["ms"])
        per_round = {k: (calls[k] / rounds, nbytes[k] / rounds) for k in calls
                     if k.startswith(("exchange", "migration"))}
        kinds = {json.dumps(c, sort_keys=True) for c in launches}
        print(f"phase13 {name}: {ndis} outlier pixels of {npix} against phase 9's in-process "
              f"frame, max abs err elsewhere {err:.3g}; rounds per bounce "
              f"{st['migration_rounds'][0]}, paths moved {st['paths_moved']}, overflow waits "
              f"{st['migration_overflow_waits']}, tracer diag {st['tracer_diag']}, truncated "
              f"{st['migration_truncated']}, grid-culled {st['grid_culled']}: equal to phase 9 "
              f"ok", flush=True)
        print(f"phase13 {name}: launches per rank "
              + (f"{launches[0]} on each of the {ranks}" if len(kinds) == 1 else f"{launches}")
              + " (their sum equals the in-process frame's) ok", flush=True)
        print(f"phase13 {name}: frame {ms:.3f} ms (rank 0, median of {RANK_REPS} between "
              f"all-rank barriers; ranks' medians "
              f"{[round(statistics.median(r['ms']), 3) for r in rows]})"
              + (f", in-process {want_ms:.3f} ms (phase 9)" if want_ms else "")
              + "; per frame on rank 0: "
              + ", ".join(f"{k} {calls[k]} calls {nbytes[k]} B" for k in sorted(calls))
              + "; per migration round: "
              + ", ".join(f"{k} {c:g} calls {b:.0f} B" for k, (c, b) in sorted(per_round.items())),
              flush=True)
        out[label] = {"ms": ms, "rank_ms": [r["ms"] for r in rows], "in_process_ms": want_ms,
                      "launches_per_rank": launches, "outliers": ndis, "max_abs_err": err,
                      "collectives": calls, "bytes": nbytes, "rounds": rounds,
                      **{k: st[k] for k in keys}}

    # 13c: the one NCCL run one card allows: a world of one rank, P = 1
    meshes = setup["grid_meshes"]
    part1 = pt.scene.build_partitioned_scene(meshes, 1, device=dev)
    cfg1 = cases["grids"][2]
    cfg1 = dataclasses.replace(cfg1, use_visibility_grids=False)
    setup1 = {"lights": setup["lights"], "env": setup["env"], "cam": setup["cam"],
              "cases": {"p1": (part1, None, cfg1)}}
    rank_inputs(pt, torch, os.path.join(workdir, "inputs1"), setup1, ("p1",), 1)
    t0 = time.perf_counter()
    (one,) = pt.parallel.run_ranks(
        rank_worker, 1, (os.path.join(workdir, "inputs1"), "cuda:0", "nccl", ("p1",), 1),
        os.path.join(workdir, "nccl"), backend="nccl", deadline_s=NCCL_DEADLINE_S)
    row = one["p1"]
    npix = cfg1.frame_buffer_size
    ndis, err = compare_frames("13c NCCL P = 1 vs the single-device composed frame",
                               as_pixels(row["image"].to(dev)),
                               as_pixels(setup["single_grid_frame"]), npix)
    check(row["stats"]["migration_truncated"] == 0 and row["stats"]["paths_moved"] == 0,
          f"13c: stats {row['stats']}")
    print(f"phase13 13c one NCCL rank, P = 1 (one partition of "
          f"{sum(m.num_triangles for m in meshes)} triangles): {ndis} outlier pixels of "
          f"{npix} against render_image of the same meshes (fused_frame='off'), max abs err "
          f"elsewhere {err:.3g} ok; collectives {row['calls']}; world "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("phase13 NCCL with several cards was not run: this machine has one card, and NCCL "
          "refuses two ranks on one GPU", flush=True)
    out["nccl_p1"] = {"outliers": ndis, "max_abs_err": err, "collectives": row["calls"],
                      "bytes": row["bytes"], "ms": row["ms"]}
    return out


# ---------------------------------------------------------------------------
# phase 10: the proxy-training stack, the sampled visibility grid and the
# command-line renderer

# scripts/ab_neural_scaled.py's recipe: rays a partition, target steps a
# net, the nets' width and depth
TRAIN_RAYS = 200_000
TARGET_STEPS = 30_000
TRAIN_WIDTH, TRAIN_DEPTH = 128, 4
# steps a net in 10b: TARGET_STEPS cut, because the step is paced by the host
# (its ms a step and the 16 nets' seconds on an H100 are in PERF.md
# section 4); the A-B of 10c passes with nets trained this far
TRAIN_STEPS = 2_000
# rays of partition 0 labelled through the kernels and through traverse_bvh
LABEL_RAYS = 65536
# phase 10's files (checkpoints, the CLI's images), beside the kernels'
# build (gitignored)
SMOKE_OUT = os.path.join(ROOT, "pg2024_dprt_tpu_torch", "build", "chip_smoke")
# 10f's rooms:8 camera: into rooms 0 and 1 under the light (the automatic
# camera frames all 8 rooms from afar, and lights about 1 % of its pixels);
# the exact frame must be lit, and the neural frame's mean within a loose
# ratio of it (the CLI's nets are w64/d2, 25 epochs)
ROOMS_CAM = ("1.75,1.8,3.6", "1.75,0.5,0.5")
ROOMS_MIN_MEAN, ROOMS_MIN_LIT, ROOMS_RATIO = 1e-3, 0.05, (0.9, 1.1)
# largest relative difference of a hit's t between the trace kernels and
# traverse_bvh (their Moller-Trumbore forms differ: the kernels read
# precomputed edges of cl_mt_table, traverse_bvh the vertices)
LABEL_T_RTOL = 1e-5


def synced_s(torch, fn):
    """(fn(), seconds) with the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def recipe(pt, nn_type: str, n_rows: int, steps: int):
    """ab_neural_scaled.py::phase_train's TrainConfig for `steps` steps:
    batch min(4096, max(1024, n)), epochs to reach the step count, lr 5e-4,
    the cosine schedule. Returns (config, the steps fit will take)."""
    batch = min(4096, max(1024, n_rows))
    per_epoch = max(1, (n_rows * 4) // (5 * batch))
    cfg = pt.train.TrainConfig(nn_type=nn_type, epochs=max(1, steps // per_epoch), batch=batch,
                               learn_rate=5e-4)
    n_train = int(n_rows * 0.8)
    return cfg, cfg.epochs * max(1, n_train // min(batch, n_train))


def cli_run(torch, counted, cli, argv):
    """The CLI's main(argv) with the launch counts reset just before and read
    just after; returns (images, counts, seconds, the timing sections in ms)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (images, counts), secs = synced_s(torch, lambda: counted(lambda: cli(argv)))
    sections = {}
    for line in buf.getvalue().splitlines():
        name, _, rest = line.partition(": ")
        if rest.endswith(" calls") and " ms over " in rest:
            sections[name] = float(rest.split(" ms over ")[0])
    return images, counts, secs, sections


@contextlib.contextmanager
def captured_training(pt, torch, cli):
    """Wrap the CLI module's train_partition_proxies: the dict it yields
    gets the nets it returned (on their device: the caller copies them to
    the host after the CLI, outside its Train section), its seconds, the
    seconds spent in train.fit and train.generate_proxy_dataset (the rest
    is the host build and the nets' exchange; a synchronize closes each of
    those calls, as each ends by reading results on the host anyway) and
    the launch counts at its end (the CLI launches nothing before it)."""
    saved = cli.train_partition_proxies
    inner = {"fit": pt.train.fit, "generate_proxy_dataset": pt.train.generate_proxy_dataset}
    rec, spent = {}, dict.fromkeys(inner, 0.0)

    def timed(name):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[name](*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    def call(*a, **k):
        t0 = time.perf_counter()
        models = saved(*a, **k)
        torch.cuda.synchronize()
        rec.update(models=models, train_s=time.perf_counter() - t0,
                   fit_s=spent["fit"], datagen_s=spent["generate_proxy_dataset"],
                   train_launches={n: v for n, v in pt.ops.LAUNCHES.items() if v})
        return models

    cli.train_partition_proxies = call
    for name in inner:
        setattr(pt.train, name, timed(name))
    try:
        yield rec
    finally:
        cli.train_partition_proxies = saved
        for name, fn in inner.items():
            setattr(pt.train, name, fn)


def training_phase(pt, torch, np, dev, counted, side=64, rays=TRAIN_RAYS,
                   steps=TRAIN_STEPS, cli_size=256):
    """Phase 10 (10a-10f; see the module docstring). Returns its numbers."""
    train, datagen = pt.train, pt.train.datagen
    out = {}
    meshes = statue_meshes(pt, np)
    part, lights_s, env_s, cam_s = statue_row(pt, np, dev, side)
    assignment = pt.scene.partition_meshes(meshes, STATUE_PARTS)

    # ---- 10a: datagen through the trace kernels
    subs, boxes, data = [], [], []
    for p, idxs in enumerate(assignment):
        sub = pt.scene.device_scene_from_meshes([meshes[i] for i in idxs], device=dev)
        lo = part.proxies.aabb_min[p].cpu().numpy()
        hi = part.proxies.aabb_max[p].cpu().numpy()
        ((f, d), secs), counts = counted(lambda: synced_s(torch, lambda: (
            datagen.generate_proxy_dataset(sub, lo, hi, rays, seed=100 + p))))
        kern = "grouped_closest" if pt.ops.trace_grouped(sub) else "resident_closest"
        n_launch = -(-rays // datagen.BATCH)
        hit = float((d != 1.0).mean())
        check(counts == {kern: n_launch}, f"datagen partition {p} launches {counts}")
        check(f.shape == (rays, 5) and d.shape == (rays,) and bool(np.isfinite(f).all())
              and 0.0 < hit < 1.0, f"datagen partition {p}: shapes {f.shape} {d.shape}, "
              f"hit fraction {hit}")
        print(f"phase10 10a datagen partition {p} (K={sub.num_clusters}): {rays} rays in "
              f"{secs:.3f} s ({rays / secs / 1e6:.2f} Mrays/s), hit fraction {hit:.4f}, "
              f"launches {counts}", flush=True)
        subs.append(sub)
        boxes.append((lo, hi))
        data.append((f, d))
        out.setdefault("datagen", []).append({"seconds": secs, "hit_fraction": hit,
                                              "launches": counts})
    # partition 0's first batch, labelled through the kernels and through
    # the plain stackless walk on the card
    sub0, (lo0, hi0) = subs[0], boxes[0]
    o, d = datagen._sample_entry_rays(torch.Generator().manual_seed(100), lo0, hi0,
                                      LABEL_RAYS)
    o, d = o.to(dev), d.to(dev)
    (t_k, h_k), counts = counted(lambda: datagen.trace_labels(sub0, o, d, 1e-4))
    k_ms = cuda_ms(torch, lambda: datagen.trace_labels(sub0, o, d, 1e-4), reps=7)
    far = torch.full((LABEL_RAYS,), datagen.T_FAR, device=dev)
    live = torch.ones((LABEL_RAYS,), dtype=torch.bool, device=dev)
    plain, p_s = synced_s(torch, lambda: pt.ops.traverse_bvh(sub0, o, d, 1e-4, far, live))
    flags = int((h_k != plain.is_hit).sum())
    both = h_k & plain.is_hit
    t_rel = float(((t_k - plain.t).abs() / plain.t.abs().clamp(min=1e-30))[both].max())
    t_equal = bool(torch.equal(t_k[both], plain.t[both]))
    check(flags == 0, f"labels: {flags} hit flags differ between the kernels and traverse_bvh")
    check(t_rel <= LABEL_T_RTOL, f"labels: t differs by {t_rel:.3g} relative")
    print(f"phase10 10a labels of {LABEL_RAYS} rays of partition 0: hit flags equal "
          f"({int(h_k.sum())} hits) ok; t {'equal on every hit' if t_equal else 'largest relative difference %.3g (bound %g)' % (t_rel, LABEL_T_RTOL)} ok; "
          f"kernel path {k_ms:.3f} ms (median of 7, launches {counts}), plain traverse_bvh on "
          f"the card {p_s * 1e3:.1f} ms (one run)", flush=True)
    out["labels"] = {"flags_differ": flags, "t_max_rel": t_rel, "kernel_ms": k_ms,
                     "plain_ms": p_s * 1e3, "launches": counts}

    # ---- 10b: the separate family, 8 vis + 8 depth nets
    cfg_m = pt.models.MLPConfig(width=TRAIN_WIDTH, depth=TRAIN_DEPTH)
    xv0, yv0 = train.balance_vis(*data[0])
    warm, _ = recipe(pt, "vis", xv0.shape[0], 1)
    train.fit(xv0, yv0, cfg_m, warm, device=dev)
    probe, probe_steps = recipe(pt, "vis", xv0.shape[0], 80)
    _, probe_s = synced_s(torch, lambda: train.fit(xv0, yv0, cfg_m, probe, device=dev))
    ms_step = probe_s * 1e3 / probe_steps
    nets = 2 * STATUE_PARTS
    print(f"phase10 10b step: {ms_step:.3f} ms a step (w{TRAIN_WIDTH}/d{TRAIN_DEPTH}, batch "
          f"{probe.batch}, {probe_steps} steps, per-epoch reads and reshuffles included); "
          f"{nets} x {TARGET_STEPS} steps would take {nets * TARGET_STEPS * ms_step / 1e3:.0f} s, "
          f"{nets} x {steps} about {nets * steps * ms_step / 1e3:.0f} s: {steps} steps a net"
          + ("" if steps == TARGET_STEPS else f" (cut from {TARGET_STEPS})"), flush=True)
    # where a step's time goes: one profiled fit of the probe's steps, its
    # device events and their busy time against the wall
    split = pt.utils.profile.render_device_profile(
        lambda _s: train.fit(xv0, yv0, cfg_m, probe, device=dev), top=3, reps=1)
    busy_step = split["busy_ms"] / probe_steps
    wall_step = split["unprofiled_wall_ms"] / probe_steps
    print(f"phase10 10b step split (one profiled fit of {probe_steps} steps): "
          f"{split['device_events'] / probe_steps:.1f} device events a step, device busy "
          f"{busy_step:.4f} ms a step of {wall_step:.3f} ms (idle share "
          f"{split['idle_share_unprofiled']:.3f}); top kernels (ms over the fit) "
          + "; ".join(f"{k[:48]} {v:.2f}" for k, v in split["top_kernels_ms"].items()),
          flush=True)
    with open(os.path.join(ROOT, "artifacts", "ab_scaled", "train_losses.json")) as fh:
        jax_losses = json.load(fh)
    vis_list, depth_list, losses, total_steps = [], [], {}, 0
    t_train = time.perf_counter()
    for p, (f, d) in enumerate(data):
        xv, yv = train.balance_vis(f, d)
        xd, yd = train.depth_only(f, d)
        if xd.shape[0] < 256:
            xd, yd = f, d
        row = {}
        for nn_type, (x, y), dest in (("vis", (xv, yv), vis_list), ("depth", (xd, yd), depth_list)):
            tcfg, n_steps = recipe(pt, nn_type, x.shape[0], steps)
            (params, hist), secs = synced_s(torch, lambda: train.fit(x, y, cfg_m, tcfg, device=dev))
            loss = hist["test_loss"][-1]
            check(np.isfinite(loss) and loss < hist["test_loss"][0],
                  f"{nn_type} net {p}: test loss {hist['test_loss'][0]} -> {loss}")
            dest.append(params)
            total_steps += n_steps
            row[nn_type] = {"test_loss": loss, "jax_test_loss": jax_losses[f"p{p}"][nn_type],
                            "rows": int(x.shape[0]), "steps": n_steps, "seconds": secs}
        losses[f"p{p}"] = row
        print(f"phase10 10b partition {p}: vis test loss {row['vis']['test_loss']:.5f} (JAX's "
              f"30,000-step net: {row['vis']['jax_test_loss']:.5f}; {row['vis']['rows']} rows, "
              f"{row['vis']['steps']} steps, {row['vis']['seconds']:.1f} s), depth "
              f"{row['depth']['test_loss']:.5f} ({row['depth']['jax_test_loss']:.5f}; "
              f"{row['depth']['rows']} rows, {row['depth']['steps']} steps, "
              f"{row['depth']['seconds']:.1f} s)", flush=True)
    train_s = time.perf_counter() - t_train
    print(f"phase10 10b trained {nets} nets: {total_steps} steps in {train_s:.1f} s "
          f"({train_s * 1e3 / total_steps:.3f} ms a step)", flush=True)
    out["train"] = {"ms_per_step_probe": ms_step, "steps_per_net": steps, "total_steps": total_steps,
                    "seconds": train_s, "nets": losses,
                    "step_split": {"device_events_per_step": split["device_events"] / probe_steps,
                                   "busy_ms_per_step": busy_step, "wall_ms_per_step": wall_step,
                                   "idle_share": split["idle_share_unprofiled"]}}
    models = pt.models.ProxyModels(pt.models.stack_params(vis_list),
                                   pt.models.stack_params(depth_list), STATUE_PARTS, cfg_m, cfg_m)

    # ---- 10c: the paper's A-B with the nets trained here
    dist = pt.parallel.distributed
    cfg_e = pt.render.RenderConfig(width=side, height=side, spp=2, bounces=2)
    cfg_s = dataclasses.replace(cfg_e, use_neural_proxies=True)
    control = pt.models.random_proxy_models(3, STATUE_PARTS, cfg_m, cfg_m, device=dev)
    exact = dist.render_image_distributed(part, models, lights_s, env_s, cam_s, cfg_e, device=dev)
    tm = lambda x: x / (1.0 + x)
    ab = {}
    for name, m in (("port-trained separate", models), ("random control", control)):
        nn, counts_s = counted(lambda: dist.render_image_distributed(
            part, m, lights_s, env_s, cam_s, cfg_s, device=dev))
        e = float((tm(nn) - tm(exact)).abs().mean())
        ratio = float(nn.mean() / exact.mean())
        ab[name] = {"mean_err": e, "ratio": ratio, "launches": counts_s}
        if name == "random control":
            check(e > AB_CONTROL_ERR, f"A-B control too weak: {e:.3g}")
        else:
            check(e < AB_MEAN_ERR and 0.99 < ratio < 1.01,
                  f"A-B {name}: mean tone-mapped error {e:.3g}, ratio {ratio:.6f}")
            check(counts_s.get("route_secondary", 0) > 0 and counts_s.get("route_shadow", 0) > 0,
                  f"A-B {name}: launches {counts_s}")
        print(f"phase10 10c A-B {name} (w{TRAIN_WIDTH}/d{TRAIN_DEPTH}, {steps} steps a net): "
              f"mean tone-mapped error {e:.3g}, mean ratio {ratio:.6f} (gates: < {AB_MEAN_ERR} "
              f"and (0.99, 1.01); control > {AB_CONTROL_ERR}) ok; launches {counts_s}",
              flush=True)
    out["ab"] = ab

    # ---- 10d: the checkpoints round trip, bit for bit through K6
    ck_dir = os.path.join(SMOKE_OUT, "checkpoints")
    back_v, back_d = [], []
    for p in range(STATUE_PARTS):
        for kind, src, dest in (("vis", vis_list, back_v), ("depth", depth_list, back_d)):
            path = os.path.join(ck_dir, f"{kind}{p}")
            train.loop.save_checkpoint(path, src[p])
            dest.append(pt.scene.load_mlp_checkpoint(path + ".npz", cfg_m, device=dev))
    back = pt.models.ProxyModels(pt.models.stack_params(back_v), pt.models.stack_params(back_d),
                                 STATUE_PARTS, cfg_m, cfg_m)
    nq = min(4096, rays)
    xq = torch.as_tensor(np.concatenate([f[:nq] for f, _ in data]), device=dev)
    obj = torch.arange(STATUE_PARTS, device=dev, dtype=torch.int32).repeat_interleave(nq)
    valid = torch.ones_like(obj, dtype=torch.bool)
    (a_v, a_d), counts = counted(lambda: pt.ops.grouped_mlp_dense(models, xq, obj, valid))
    b_v, b_d = pt.ops.grouped_mlp_dense(back, xq, obj, valid)
    check(counts == {"mlp_dense": 1} and torch.equal(a_v, b_v) and torch.equal(a_d, b_d),
          f"checkpoint round trip: K6 outputs differ (launches {counts})")
    print(f"phase10 10d checkpoints: {2 * STATUE_PARTS} nets saved (save_checkpoint) and read "
          f"back (convert.load_mlp_checkpoint); K6 on {xq.shape[0]} rows bit-identical ok",
          flush=True)

    # ---- 10e: the sampled visibility grid of partition 0
    sub0_cpu = pt.scene.device_scene_from_meshes([meshes[i] for i in assignment[0]],
                                                 device="cpu")
    (vg, counts), g_s = synced_s(torch, lambda: counted(
        lambda: pt.scene.build_visibility_grid(sub0, lo0, hi0)))
    vg_cpu, c_s = synced_s(torch, lambda: pt.scene.build_visibility_grid(sub0_cpu, lo0, hi0))
    check(torch.equal(vg.grid.cpu(), vg_cpu.grid), "sampled grid: the card's differs from the CPU's")
    tri = [meshes[i] for i in assignment[0]]
    tmin = np.concatenate([np.minimum(np.minimum(m.v0, m.v1), m.v2) for m in tri])
    tmax = np.concatenate([np.maximum(np.maximum(m.v0, m.v1), m.v2) for m in tri])
    cons = pt.scene.build_conservative_grid(tmin, tmax, lo0, hi0, vg.width, vg.height, vg.angle)
    marked = vg_cpu.grid.numpy().reshape(cons.shape)
    outside = int((marked & ~cons).sum())
    check(outside == 0, f"sampled grid: {outside} marked bins outside the conservative grid")
    share = float(marked.mean())
    print(f"phase10 10e sampled grid of partition 0 ({vg.width}x{vg.height}x{vg.angle}, 200,000 "
          f"samples): equal to the CPU build ok; every marked bin in the conservative grid ok; "
          f"{share:.4f} of the bins marked ({float(cons.mean()):.4f} conservative); card "
          f"{g_s:.3f} s (launches {counts}), CPU {c_s:.1f} s", flush=True)
    out["grid"] = {"share_marked": share, "share_conservative": float(cons.mean()),
                   "card_s": g_s, "cpu_s": c_s, "launches": counts}

    # ---- 10f: the command-line renderer on the card, in-process
    from pg2024_dprt_tpu_torch.render import __main__ as cli_module

    cli = cli_module.main

    cli_out = os.path.join(SMOKE_OUT, "cli")
    imgs, counts, secs, sections = cli_run(torch, counted, cli, [
        "cornell", "--size", str(cli_size), "--spp", "1", "--bounces", "4", "--format", "both",
        "--out", cli_out])
    check(counts == {"frame_sample": 1} and len(imgs) == 1, f"CLI cornell launches {counts}")
    check(all(os.path.getsize(os.path.join(cli_out, f"frame0.{ext}")) > 0
              for ext in ("png", "exr")), "CLI cornell wrote no PNG or EXR")
    check(imgs[0].shape == (cli_size, cli_size, 3) and bool(np.isfinite(imgs[0]).all())
          and float(imgs[0].mean()) > 0.0, "CLI cornell image is not finite and lit")
    print(f"phase10 10f CLI cornell --size {cli_size} --spp 1 --bounces 4 --format both: "
          f"launches {counts} ok, PNG and EXR written, mean {float(imgs[0].mean()):.4f}; "
          f"{secs:.2f} s in all, frame {sections.get('Sample', 0.0):.1f} ms", flush=True)
    out["cli_cornell"] = {"launches": counts, "seconds": secs, "frame_ms": sections.get("Sample")}
    rooms = ["rooms:8", "--partitions", "8", "--size", str(cli_size), "--cam-pos", ROOMS_CAM[0],
             "--cam-target", ROOMS_CAM[1], "--out", cli_out]
    ex_imgs, counts_e, secs_e, _ = cli_run(torch, counted, cli, rooms)
    with captured_training(pt, torch, cli_module) as trained:
        imgs, counts, secs, sections = cli_run(torch, counted, cli, rooms + ["--neural"])
    trained["models"] = trained["models"].to("cpu")
    ex, nn = ex_imgs[0], imgs[0]
    lit = float((ex.sum(-1) > 0).mean())
    ratio = float(nn.mean() / ex.mean())
    tm_err = float(np.abs(nn / (1 + nn) - ex / (1 + ex)).mean())
    check(counts.get("route_secondary", 0) > 0 and "route_secondary" not in counts_e
          and nn.shape == ex.shape == (cli_size, cli_size, 3) and bool(np.isfinite(nn).all()),
          f"CLI rooms:8 launches: neural {counts}, exact {counts_e}")
    check(float(ex.mean()) > ROOMS_MIN_MEAN and lit > ROOMS_MIN_LIT,
          f"CLI rooms:8 exact frame: mean {float(ex.mean()):.3g}, lit share {lit:.3f}")
    check(ROOMS_RATIO[0] < ratio < ROOMS_RATIO[1],
          f"CLI rooms:8 neural / exact mean ratio {ratio:.4f}")
    print(f"phase10 10f CLI rooms:8 --partitions 8 --neural (30,000 samples, 25 epochs a net, "
          f"{cli_size}x{cli_size}, spp 4, camera {ROOMS_CAM[0]} -> {ROOMS_CAM[1]}): mean "
          f"{float(nn.mean()):.5f} against the exact frame's {float(ex.mean()):.5f} ({lit:.3f} of "
          f"its pixels lit): ratio {ratio:.5f} (gate {ROOMS_RATIO}), tone-mapped error "
          f"{tm_err:.3g} ok; training {sections.get('Train', 0.0) / 1e3:.2f} s, frame "
          f"{sections.get('Sample', 0.0) / 1e3:.2f} s, {secs:.1f} s in all (exact: {secs_e:.1f} s); "
          f"launches {counts}", flush=True)
    out["cli_rooms8_neural"] = {"launches": counts, "seconds": secs, "ratio": ratio,
                                "tm_err": tm_err, "exact_seconds": secs_e,
                                "train_s": sections.get("Train", 0.0) / 1e3,
                                "frame_s": sections.get("Sample", 0.0) / 1e3}
    # what 13d holds its ranks against
    out["_rank_training"] = {"argv": rooms + ["--neural"], "image": nn, "launches": counts,
                             "train_section_s": sections.get("Train", 0.0) / 1e3, **trained}
    return out


# ---------------------------------------------------------------------------
# phase 13d: the CLI's --neural with one partition a rank, after 10f

def rank_cli_worker(argv):
    """What each rank of 13d runs: the CLI's main(argv) as under torchrun,
    its RankMesh on cuda:0 over gloo (LOCAL_RANK 0 on every rank: NCCL, the
    CLI's backend for a CUDA device, refuses two ranks on one GPU), with
    the launch counts reset just before and read just after. Returns its
    stdout, launches, seconds and image, and the nets it gathered with its
    training seconds and the launches up to their end."""
    import functools
    import io

    import numpy as np
    import torch
    import torch.distributed as tdist

    import pg2024_dprt_tpu_torch as pt
    import pg2024_dprt_tpu_torch.models
    import pg2024_dprt_tpu_torch.ops
    import pg2024_dprt_tpu_torch.parallel.mesh
    import pg2024_dprt_tpu_torch.train
    from pg2024_dprt_tpu_torch.render import __main__ as cli

    os.environ.update(RANK=str(tdist.get_rank()), WORLD_SIZE=str(tdist.get_world_size()),
                      LOCAL_RANK="0")
    mesh_mod = pt.parallel.mesh
    mesh_mod.make_rank_mesh = functools.partial(mesh_mod.make_rank_mesh, backend="gloo")
    # one small fit of each kind first, so that the timed Train counts no
    # first call (cuBLAS's, the optimizer's), as 10f's does not: phases
    # 10a-10e trained in its process before it; their seconds are what a
    # cold rank pays
    dev = argv[argv.index("--device") + 1] if "--device" in argv else "cuda:0"
    rng = np.random.RandomState(tdist.get_rank())
    x, y = rng.rand(8192, 5).astype(np.float32), (rng.rand(8192) > 0.5).astype(np.float32)
    t0 = time.perf_counter()
    for kind in ("vis", "depth"):
        pt.train.fit(x, y, pt.models.MLPConfig(width=64, depth=2),
                     pt.train.TrainConfig(nn_type=kind, epochs=1, batch=4096, learn_rate=5e-3),
                     device=dev)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    buf = io.StringIO()
    tdist.barrier()
    pt.ops.reset_launch_counts()
    t0 = time.perf_counter()
    with captured_training(pt, torch, cli) as rec, contextlib.redirect_stdout(buf):
        images = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec["models"] = rec["models"].to("cpu")
    return {"stdout": buf.getvalue(), "seconds": seconds, "warmup_s": warmup_s,
            "launches": {k: v for k, v in pt.ops.LAUNCHES.items() if v},
            "image": torch.as_tensor(images[0]), **rec}


def flat_nets(torch, models):
    """{(partition, kind): one net's params} of a ProxyModels."""
    return {(p, kind): {k: v[p] for k, v in params.items()}
            for kind, params in (("vis", models.vis_params), ("depth", models.depth_params))
            for p in range(models.num_objects)}


def same_bits(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
        for k in a)


def rank_training_phase(pt, torch, dev, ten, workdir):
    """Phase 13d: 10f's rooms:8 --neural through the CLI with one partition
    a gloo rank on the one card: each rank trains its own partition's nets,
    receives the others' and renders 10f's frame. Held against 10f's
    in-process nets, image and launches. Returns the phase's numbers."""
    import shutil

    argv = list(ten["argv"])
    argv[argv.index("--out") + 1] = os.path.join(workdir, "out")
    ranks = int(argv[argv.index("--partitions") + 1])
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    rows = pt.parallel.run_ranks(rank_cli_worker, ranks, (argv,), os.path.join(workdir, "gloo"),
                                 backend="gloo", deadline_s=RANK_DEADLINE_S)
    world_s = time.perf_counter() - t0
    name = f"13d CLI rooms:{ranks} --neural, one partition a rank"

    # the nets: every rank's bit for bit rank 0's; each against 10f's
    nets = [flat_nets(torch, r["models"]) for r in rows]
    check(all(n.keys() == nets[0].keys() and all(same_bits(torch, n[k], nets[0][k]) for k in n)
              for n in nets), f"{name}: the ranks gathered different nets")
    want = flat_nets(torch, ten["models"])
    check(nets[0].keys() == want.keys(), f"{name}: nets {sorted(nets[0])} against 10f's")
    diffs = {k: max(float((nets[0][k][n] - want[k][n]).abs().max()) for n in want[k])
             for k in want}
    equal = {k: same_bits(torch, nets[0][k], want[k]) for k in want}
    row_floats = 2 * pt.models.flatten_params(want[(0, "vis")], ten["models"].vis_cfg).numel() + 2
    print(f"phase13 {name}: {ranks} gloo ranks on cuda:0, the world ran {world_s:.1f} s (spawn, "
          f"imports, the host build, training, one frame); every rank gathered the same "
          f"{len(want)} nets bit for bit ok; each rank hands the nets' all_to_all "
          f"{ranks * row_floats * 4} B ({ranks} rows of {row_floats} f32)", flush=True)
    print(f"phase13 {name}: against 10f's in-process nets: "
          + ("bit-equal, every net" if all(equal.values()) else
             f"{sum(equal.values())} of {len(equal)} bit-equal")
          + "; largest abs difference per net "
          + ", ".join(f"p{p} {kind} {diffs[(p, kind)]:.3g}" for p, kind in sorted(want)),
          flush=True)

    # the frame: rank 0's against 10f's; every rank holds the same image
    img0 = rows[0]["image"]
    check(all(torch.equal(r["image"], img0) for r in rows), f"{name}: the ranks' images differ")
    npix = img0.shape[0] * img0.shape[1]
    ndis, err = compare_frames(f"{name} vs 10f's in-process frame", as_pixels(img0.to(dev)),
                               as_pixels(torch.as_tensor(ten["image"]).to(dev)), npix)

    # the launches: the frame's K7 on every rank; over the ranks, 10f's
    spp = int(argv[argv.index("--spp") + 1]) if "--spp" in argv else 4
    bounces = int(argv[argv.index("--bounces") + 1]) if "--bounces" in argv else 4
    frame = [{k: v - r["train_launches"].get(k, 0) for k, v in r["launches"].items()
              if v != r["train_launches"].get(k, 0)} for r in rows]
    check(all(f.get("route_secondary") == (bounces - 1) * spp
              and f.get("route_shadow") == bounces * spp for f in frame),
          f"{name}: K7 launches of the frame per rank {frame}")
    summed, trained = {}, {}
    for r in rows:
        for k, v in r["launches"].items():
            summed[k] = summed.get(k, 0) + v
        for k, v in r["train_launches"].items():
            trained[k] = trained.get(k, 0) + v
    check(summed == ten["launches"], f"{name}: launches over the ranks {summed} against 10f's "
                                     f"{ten['launches']}")
    check(trained == ten["train_launches"] and all(r["train_launches"] for r in rows),
          f"{name}: training launches over the ranks {trained} against 10f's "
          f"{ten['train_launches']}")

    # the report: rank 0 alone prints the losses (each partition's once),
    # its Train section and the one frame it writes
    outs = [r["stdout"] for r in rows]
    for p in range(ranks):
        for kind in ("vis", "depth"):
            check(outs[0].count(f"partition {p}: {kind} loss") == 1,
                  f"{name}: rank 0 printed partition {p}'s {kind} loss "
                  f"{outs[0].count(f'partition {p}: {kind} loss')} times")
    check(outs[0].count("wrote 1 frame(s)") == 1 and not any(
        "loss" in o or "wrote" in o for o in outs[1:]), f"{name}: the other ranks printed")
    check(os.path.getsize(os.path.join(workdir, "out", "frame0.png")) > 0,
          f"{name}: rank 0 wrote no frame")
    sections = {}
    for line in outs[0].splitlines():
        label, _, rest = line.partition(": ")
        if rest.endswith(" calls") and " ms over " in rest:
            sections[label] = float(rest.split(" ms over ")[0]) / 1e3
    train_s = sections.get("Train", 0.0)
    rank_train = [r["train_s"] for r in rows]
    span = lambda key: f"{min(r[key] for r in rows):.2f}-{max(r[key] for r in rows):.2f}"
    print(f"phase13 {name}: {ndis} outlier pixels of {npix} against 10f's in-process frame, "
          f"max abs err elsewhere {err:.3g} ok; launches per rank {rows[0]['launches']}"
          + ("" if len({json.dumps(r['launches'], sort_keys=True) for r in rows}) == 1
             else f" (ranks differ: {[r['launches'] for r in rows]})")
          + f", of them training {rows[0]['train_launches']}; K7 {(bounces - 1) * spp} + "
          f"{bounces * spp} a rank ({bounces - 1} + {bounces} a sample); sums over the ranks "
          f"equal 10f's ok; rank 0 alone printed the losses (each once) and wrote the frame ok",
          flush=True)
    print(f"phase13 {name}: Train {train_s:.2f} s on rank 0 (each rank's training "
          f"{min(rank_train):.2f}-{max(rank_train):.2f} s, its gather included) against 10f's "
          f"in-process {ten['train_section_s']:.2f} s for all {ranks} partitions: "
          f"{ten['train_section_s'] / max(train_s, 1e-9):.2f}x; a rank's 2 fits took "
          f"{span('fit_s')} s and its datagen {span('datagen_s')} s, 10f's {2 * ranks} fits "
          f"{ten['fit_s']:.2f} s and its {ranks} datagens {ten['datagen_s']:.2f} s; a rank's "
          f"warm-up (its process's first 2 fits, 8,192 rows, 1 epoch, before the timed CLI) "
          f"{span('warmup_s')} s; frame "
          f"{sections.get('Sample', 0.0):.2f} s on rank 0; the CLI {rows[0]['seconds']:.1f} s on "
          f"rank 0; {card_line()}", flush=True)
    return {"ranks": ranks, "world_s": world_s, "train_s_rank0": train_s,
            "train_s_ranks": rank_train, "train_s_in_process": ten["train_section_s"],
            "fit_s_ranks": [r["fit_s"] for r in rows], "fit_s_in_process": ten["fit_s"],
            "datagen_s_ranks": [r["datagen_s"] for r in rows],
            "datagen_s_in_process": ten["datagen_s"],
            "warmup_s_ranks": [r["warmup_s"] for r in rows],
            "frame_s_rank0": sections.get("Sample"), "outliers": ndis, "max_abs_err": err,
            "nets_bit_equal_to_10f": all(equal.values()),
            "max_abs_diff_per_net": {f"p{p} {k}": v for (p, k), v in sorted(diffs.items())},
            "launches_per_rank": [r["launches"] for r in rows],
            "train_launches_per_rank": [r["train_launches"] for r in rows],
            "share_bytes_per_rank": ranks * row_floats * 4}


# ---------------------------------------------------------------------------
# phase 12: curve primitives (round B-spline hair, ops/curve_intersect.py)
# through the composed frame, the partitioner and the distributed frame. The
# curve test is plain PyTorch (XLA in the JAX package, outside any Pallas
# kernel); this phase runs the existing kernels beside it (K1 / K2 on the fur
# frame; K1 / K2, K8, K4, K5 / K6 on the distributed frames) and shows that
# K3 and K7, which have no curve stage, are not launched on curve scenes.

FUR_CAMERA = ([0.5, 0.9, 2.2], [0.5, 0.2, 0.0], [0, 1, 0], 45.0)
FUR_ENV = (0.2, 0.3, 0.4)
FUR_COLOR = (0.35, 0.22, 0.12)
# control-point heights of a fur strand: the first lies under the floor, so
# the spline (which does not pass through its end points) starts at it
FUR_HEIGHTS = (-0.04, 0.0, 0.05, 0.11, 0.19)
# f32 operations per (ray, piece) pair of ops/curve_intersect.py
# _ray_round_cone, counted from its expressions (sqrt, compare and select
# one each) with the argmin: the curve test's operation bound
CURVE_OPS_PER_PAIR = 120
# the curve test on the card against the CPU: flags, pieces and segments
# equal; t and normals within this many ulps
CURVE_ULPS = 4
CURVE_CTRL = ([0.2, 0.9, 0.5], [1.0, 1.4, 0.5], [2.2, 1.5, 0.4], [3.4, 1.2, 0.5],
              [4.0, 0.8, 0.6])
CURVE_ROOMS_CAMERA = ([2.0, 1.6, 5.2], [2.0, 0.8, 0.3], [0, 1, 0], 55.0)
CURVE_ROOMS_ENV = (0.22, 0.24, 0.3)


def fur_patch(pt, np, dev, grid=32, radius=0.004, pieces=8, seed=12):
    """grid x grid strands rooted on a regular grid over the cornell floor,
    5 control points each rising about 0.15 with seeded jitter: 2 B-spline
    windows a strand, `pieces` round cones a window."""
    rng = np.random.RandomState(seed)
    u = 0.05 + 0.9 * (np.arange(grid) + 0.5) / grid
    x, z = np.meshgrid(u, u, indexing="ij")
    s = grid * grid
    pts = np.zeros((s, len(FUR_HEIGHTS), 3))
    pts[:, :, 0] = x.reshape(s, 1)
    pts[:, :, 2] = z.reshape(s, 1)
    pts[:, :, 1] = np.asarray(FUR_HEIGHTS)[None] + rng.uniform(-0.01, 0.01, (s, 5))
    pts[:, 2:, [0, 2]] += rng.normal(0.0, 0.01, (s, 3, 2)).cumsum(axis=1)
    windows = np.stack([pts[:, 0:4], pts[:, 1:5]], axis=1).reshape(-1, 4, 3)
    return pt.scene.CurveSet.from_bspline(windows, np.full(windows.shape[:2], radius),
                                          pieces, color=FUR_COLOR, device=dev)


@contextlib.contextmanager
def counting_pairs(pt, tally):
    """Count the (ray, piece) pairs the trace entry points send to the curve
    test, closest and any-hit apart."""
    api = pt.ops.trace_api
    orig = {"intersect_curves": api.intersect_curves, "occlude_curves": api.occlude_curves}

    def wrap(name):
        def call(curves, origin, *args, **kw):
            tally[name] = tally.get(name, 0) + origin.shape[0] * curves.num_pieces
            return orig[name](curves, origin, *args, **kw)
        return call

    for name in orig:
        setattr(api, name, wrap(name))
    try:
        yield tally
    finally:
        for name, fn in orig.items():
            setattr(api, name, fn)


def max_ulps(torch, a, b):
    """Largest distance in units of the last place between two f32 tensors
    of the same shape (0 where both are equal, NaN where one is)."""
    a, b = a.float().cpu(), b.float().cpu()
    same = a == b
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    d = torch.where(same, 0.0, (a - b).abs() / ulp)
    return float(d.max()) if d.numel() else 0.0


def curve_phase(pt, torch, np, dev, counted, side=256, grid=32, cpu_rays=None,
                dist_side=64, reps=3):
    """Phase 12; returns its numbers. `cpu_rays` (None: all) cuts the
    wavefront of 12b, `grid` and `side` the fur frame, to rehearse on the
    CPU."""
    out = {}
    off = lambda c: dataclasses.replace(c, fused_frame="off")
    # ---- 12a the fur frame: cornell plus 1,024 strands, the main path
    meshes, lights = pt.scene.cornell_box(device=dev)
    env = pt.scene.EnvironmentMap.constant(FUR_ENV, device=dev)
    cam = pt.core.Camera.look_at(*FUR_CAMERA, side, side, device=dev)
    cfg = pt.render.RenderConfig(width=side, height=side, spp=1, bounces=4, nee_mode="ris")
    curves = fur_patch(pt, np, dev, grid=grid)
    scene = pt.scene.device_scene_from_meshes(meshes, curves=curves, device=dev)
    bare = scene._replace(curves=None)
    npix = cfg.frame_buffer_size
    render = lambda sc, c, s=0: pt.render.render_image(sc, lights, env, cam, c, base_sample=s,
                                                       return_stats=True, device=dev)
    tally = {}
    with counting_pairs(pt, tally):
        (img, st), counts = counted(lambda: render(scene, cfg))
    _, bare_counts = counted(lambda: render(bare, off(cfg)))
    _, bare_auto = counted(lambda: render(bare, cfg))
    check("frame_sample" not in counts and counts == bare_counts and bare_auto ==
          {"frame_sample": 1},
          f"fur frame launches {counts}; the curveless composed frame {bare_counts}, fused "
          f"{bare_auto}")
    check(st["tracer_diag"] == 0 and tuple(img.shape) == (side, side, 3)
          and bool(torch.isfinite(img).all()) and float(img.max()) > 0.0,
          f"fur frame: tracer_diag {st['tracer_diag']}, finite {bool(torch.isfinite(img).all())}")
    # the strands' footprint: pixels whose camera ray's closest hit is a piece
    paths = pt.render.generate_camera_paths(cam, 0)
    eps = torch.full((paths.capacity,), cfg.t_epsilon, device=dev)
    cam_rays = (paths.origin, paths.direction, eps, paths.tmax, paths.is_valid)
    first, _ = pt.ops.trace_closest_checked(scene, *cam_rays)
    foot = torch.zeros(npix, dtype=torch.bool, device=dev)
    foot[paths.pixel_index[first.tri_index <= -2]] = True
    img_bare, _ = render(bare, off(cfg))
    diff = ((img - img_bare).abs().sum(-1) > 1e-4).reshape(-1)
    n_foot, n_diff = int(foot.sum()), int(diff.sum())
    foot_diff = int((diff & foot).sum())
    # at 1 spp a path whose light samples are all blocked adds nothing in
    # either frame, so a few footprint pixels stay black in both
    check(n_foot > 0.01 * npix and n_diff >= n_foot and foot_diff >= 0.95 * n_foot,
          f"fur frame vs the curveless frame: {n_diff} pixels differ, footprint {n_foot}, "
          f"{foot_diff} of it differs")
    seeds = iter(range(1, 1000))
    fur_ms = cuda_ms(torch, lambda: render(scene, cfg, next(seeds)), reps=reps)
    bare_ms = cuda_ms(torch, lambda: render(bare, off(cfg), next(seeds)), reps=reps)
    fused_ms = cuda_ms(torch, lambda: render(bare, cfg, next(seeds)), reps=reps)
    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    render(scene, cfg, 7)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    prof = pt.utils.profile.render_device_profile(lambda s: render(scene, cfg, s), reps=1)
    curve_dev = prof["stages_ms"].get(pt.ops.curve_intersect.CURVE_RANGE, 0.0)
    share = curve_dev / prof["busy_ms"]
    pairs = sum(tally.values())
    m = curves.num_pieces
    print(f"phase12 12a fur frame {side}x{side} spp1 b4 ris: cornell + {grid * grid} strands, "
          f"{m} pieces; launches {counts} (no frame_sample; the curveless frame: composed "
          f"{bare_counts}, auto {bare_auto}); tracer_diag 0, finite; {n_diff} pixels differ "
          f"from the curveless frame, footprint {n_foot} ({foot_diff} of it differs) ok",
          flush=True)
    print(f"phase12 12a frame {fur_ms:.1f} ms (median of {reps}), the curveless frame composed "
          f"{bare_ms:.2f} ms, fused {fused_ms:.3f} ms; curve test {curve_dev:.1f} ms of "
          f"{prof['busy_ms']:.1f} ms device busy (share {share:.3f}; idle share "
          f"{prof['idle_share_unprofiled']:.3f} of the unprofiled "
          f"{prof['unprofiled_wall_ms']:.1f} ms); pairs {pairs} ({tally}); peak memory "
          f"{peak_mb:.0f} MiB ({base_mb:.0f} MiB before the frame)", flush=True)
    # one full wavefront of each kind: the camera rays, the first shadow rays
    waves = named_wavefronts(frame_wavefronts(
        pt, scene, lights, env, cam, cfg,
        closest=lambda sc, *r: pt.ops.trace_closest_checked(sc, *r)[0]))
    shadow0 = waves["shadow0"]
    ic = lambda rays, **kw: pt.ops.intersect_curves(curves, *rays, **kw)
    oc = lambda rays: pt.ops.occlude_curves(curves, *rays)
    cam_ms = cuda_ms(torch, lambda: ic(cam_rays, with_normal=False), reps=reps)
    shd_ms = cuda_ms(torch, lambda: oc(shadow0), reps=reps)
    k1_ms = cuda_ms(torch, lambda: pt.ops.trace_resident(bare, *cam_rays), reps=reps)
    wave_pairs = cam_rays[0].shape[0] * m
    c_bound = wave_pairs * CURVE_OPS_PER_PAIR / FP32_FLOP_PER_S * 1e3
    big = pt.ops.curve_intersect.PAIR_BUDGET["cuda"] * 4
    big_ms = cuda_ms(torch, lambda: ic(cam_rays, with_normal=False, pair_budget=big),
                     reps=reps)
    print(f"phase12 12a curve test on one wavefront ({cam_rays[0].shape[0]} rays x {m} pieces "
          f"= {wave_pairs} pairs): closest {cam_ms:.2f} ms, any-hit on shadow0 {shd_ms:.2f} ms "
          f"(medians of {reps}); at a 4x chunk {big_ms:.2f} ms; K1 on the same camera rays "
          f"{k1_ms:.3f} ms; operation bound {c_bound:.3f} ms ({CURVE_OPS_PER_PAIR} f32 "
          f"operations a pair)", flush=True)
    out["fur_frame"] = {"launches": counts, "ms": fur_ms, "bare_composed_ms": bare_ms,
                        "bare_fused_ms": fused_ms, "curve_device_ms": curve_dev,
                        "busy_ms": prof["busy_ms"], "curve_share": share,
                        "idle_share_unprofiled": prof["idle_share_unprofiled"],
                        "pairs": pairs, "pairs_by_test": dict(tally), "peak_mib": peak_mb,
                        "base_mib": base_mb, "footprint": n_foot, "pixels_differ": n_diff,
                        "wavefront_closest_ms": cam_ms, "wavefront_anyhit_ms": shd_ms,
                        "wavefront_closest_4x_chunk_ms": big_ms, "k1_camera_ms": k1_ms,
                        "wavefront_pairs": wave_pairs, "wavefront_bound_ms": c_bound}

    # ---- 12b the curve test on the card against the same call on the CPU
    n_b = cam_rays[0].shape[0] if cpu_rays is None else cpu_rays
    rays_b = tuple(x[:n_b] for x in cam_rays)
    shd_b = tuple(x[:n_b] for x in shadow0)
    to_cpu = lambda rays: tuple(x.cpu() for x in rays)
    cpu_curves = curves.to("cpu")
    t0 = time.perf_counter()
    want = pt.ops.intersect_curves(cpu_curves, *to_cpu(rays_b), with_normal=True)
    want_occ = pt.ops.occlude_curves(cpu_curves, *to_cpu(shd_b))
    cpu_s = time.perf_counter() - t0
    got = pt.ops.intersect_curves(curves, *rays_b, with_normal=True)
    got_occ = pt.ops.occlude_curves(curves, *shd_b)
    for f in ("is_hit", "piece", "seg"):
        check(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
              f"curve test on the card vs the CPU: {f} differs")
    check(torch.equal(got_occ.cpu(), want_occ), "curve any-hit on the card vs the CPU differs")
    ulps_t = max_ulps(torch, got.t, want.t)
    ulps_n = max_ulps(torch, got.normal, want.normal)
    check(ulps_t <= CURVE_ULPS and ulps_n <= CURVE_ULPS,
          f"curve test on the card vs the CPU: t {ulps_t} ulps, normals {ulps_n} ulps")
    n_hit = int(want.is_hit.sum())
    print(f"phase12 12b curve test on the card vs the CPU ({n_b} camera rays, {n_hit} hits; "
          f"{int(want_occ.sum())} of {n_b} shadow0 rays occluded; chunks of "
          f"{pt.ops.curve_intersect.PAIR_BUDGET} pairs): flags, pieces and segments equal, t "
          f"{ulps_t:.0f} ulps, normals {ulps_n:.0f} ulps (bound {CURVE_ULPS}) ok; the CPU "
          f"calls {cpu_s:.1f} s", flush=True)
    out["card_vs_cpu"] = {"rays": n_b, "hits": n_hit, "t_ulps": ulps_t, "normal_ulps": ulps_n,
                          "cpu_s": cpu_s}

    # ---- 12c the tessellation bound on the card (tests/test_curve_exact.py)
    tt = np.linspace(0, 1.5 * np.pi, 8)
    cp = np.stack([np.cos(tt) * 0.4, tt * 0.15, np.sin(tt) * 0.4], axis=-1)
    rad = 0.06 + 0.03 * np.sin(tt * 2.0)
    win = np.stack([cp[i:i + 4] for i in range(5)])
    rwin = np.stack([rad[i:i + 4] for i in range(5)])
    tol = 1e-3
    cones = pt.scene.CurveSet.from_bspline(win, rwin, tolerance=tol, device=dev)
    rng = np.random.RandomState(1)
    n_c = 256
    uu = rng.rand(n_c)
    w = np.stack([np.ones_like(uu), uu, uu * uu, uu ** 3], -1) @ pt.scene.curves._BSPLINE
    target = np.einsum("nc,ncd->nd", w, win[rng.randint(0, 5, n_c)])
    phi, cz = rng.rand(n_c) * 2 * np.pi, rng.rand(n_c) * 2 - 1
    sz = np.sqrt(1 - cz ** 2)
    o = target + 2.0 * np.stack([sz * np.cos(phi), cz, sz * np.sin(phi)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o_t = torch.as_tensor(o, dtype=torch.float32, device=dev)
    d_t = torch.as_tensor(d, dtype=torch.float32, device=dev)
    exact = pt.ops.intersect_bspline_exact(win, rwin, o_t, d_t, 1e-3, 100.0)
    ch = pt.ops.intersect_curves(cones, o_t, d_t, 1e-3, 100.0,
                                 torch.ones(n_c, dtype=torch.bool, device=dev))
    x = o_t + ch.t[:, None] * d_t
    _, dist = pt.ops.curve_exact._closest_u(
        torch.as_tensor(win, dtype=torch.float32, device=dev),
        torch.as_tensor(rwin, dtype=torch.float32, device=dev),
        x[:, None, :].expand(n_c, 5, 3))
    dev_max = float(dist.amin(dim=1)[ch.is_hit].abs().max())
    t_bound = float(pt.ops.tessellation_error_bound(
        win, rwin, pt.ops.pieces_for_tolerance(win, rwin, tol)).max())
    both = ch.is_hit & exact["is_hit"]
    t_gap = float((ch.t - exact["t"])[both].abs().median())
    check(int(ch.is_hit.sum()) > 0.8 * n_c and int(both.sum()) > 0.8 * n_c
          and dev_max <= t_bound + 1e-3,
          f"tessellation bound: {int(ch.is_hit.sum())} cone hits, {int(both.sum())} with the "
          f"exact hit, deviation {dev_max:.3g} against the bound {t_bound:.3g} + 1e-3")
    print(f"phase12 12c from_bspline(tolerance={tol}) on the curly strand ({cones.num_pieces} "
          f"pieces), {n_c} rays: {int(ch.is_hit.sum())} cone hits, {int(both.sum())} also exact "
          f"hits; the cone hit points lie within {dev_max:.3g} of the exact surface (bound "
          f"{t_bound:.3g} + 1e-3); median |t_cone - t_exact| {t_gap:.3g} ok", flush=True)
    out["bound"] = {"deviation": dev_max, "bound": t_bound, "median_t_gap": t_gap}

    # ---- 12d the distributed frame (tests/test_distributed_curves.py's scene)
    meshes, lights = pt.scene.two_room_scene(num_rooms=2, tris_per_room=96, seed=5, device=dev)
    strand = pt.scene.CurveSet.from_strand(np.asarray(CURVE_CTRL), 0.12,
                                           color=(0.8, 0.25, 0.1), device=dev)
    env = pt.scene.EnvironmentMap.constant(CURVE_ROOMS_ENV, device=dev)
    cam = pt.core.Camera.look_at(*CURVE_ROOMS_CAMERA, dist_side, dist_side, device=dev)
    cfg = pt.render.RenderConfig(width=dist_side, height=dist_side, spp=1, bounces=2)
    single = pt.render.render_image(
        pt.scene.device_scene_from_meshes(meshes, curves=strand, device=dev), lights, env,
        cam, cfg, device=dev)

    def dist_frame(part, models, c, device=dev):
        return pt.parallel.render_image_distributed(part, models, lights, env, cam, c,
                                                    return_stats=True, device=device)

    dist_out = {}
    for parts, grids in ((2, False), (4, False), (4, True)):
        part = pt.scene.build_partitioned_scene(meshes, parts, curves=strand,
                                                visibility_grids=grids, device=dev)
        owners = sum(s.curves is not None for s in part.scenes)
        (img_d, st_d), counts_d = counted(lambda: dist_frame(
            part, None, dataclasses.replace(cfg, use_visibility_grids=grids)))
        err = float((img_d - single).abs().max())
        check(owners >= 2 and torch.allclose(img_d, single, rtol=1e-3, atol=1e-4)
              and st_d["tracer_diag"] == 0 and st_d["migration_truncated"] == 0,
              f"distributed curve frame P={parts} grids {grids}: {owners} partitions own pieces, "
              f"max abs err {err:.3g} against the single-device frame, stats {st_d}")
        label = f"exact_p{parts}" + ("_grids" if grids else "")
        dist_out[label] = {"owners": owners, "launches": counts_d, "max_abs_err": err,
                           "grid_culled": st_d["grid_culled"], "paths_moved": st_d["paths_moved"]}
        print(f"phase12 12d {label}: {owners} of {parts} partitions own pieces; vs the card's "
              f"single-device curve frame max abs err {err:.3g} (rtol 1e-3 / atol 1e-4) ok; "
              f"launches {counts_d}; paths moved {st_d['paths_moved']}, grid-culled "
              f"{st_d['grid_culled']}", flush=True)
    # neural mode: the nets' heads shifted (every marched box predicts a hit,
    # far behind the local one), as the CPU tests do, so that no decision sits
    # within the bf16 rounding of the card's nets
    models = pt.models.random_proxy_models(np.random.RandomState(31), 2, device=dev)
    shift = lambda p: {k: (v + 10.0 if k == "head_b1" else v) for k, v in p.items()}
    models = dataclasses.replace(models, vis_params=shift(models.vis_params),
                                 depth_params=shift(models.depth_params))
    ncfg = dataclasses.replace(cfg, use_neural_proxies=True)
    part = pt.scene.build_partitioned_scene(meshes, 2, curves=strand, device=dev)
    owners = sum(s.curves is not None for s in part.scenes)
    (img_n, st_n), counts_n = counted(lambda: dist_frame(part, models, ncfg))
    img_c, _ = dist_frame(part, models.to("cpu"), ncfg, device="cpu")
    bare_part = pt.scene.build_partitioned_scene(meshes, 2, device=dev)
    _, counts_bare = counted(lambda: dist_frame(bare_part, models, ncfg))
    err_n = float((img_n.cpu() - img_c).abs().max())
    k7 = counts_n.get("route_secondary", 0) + counts_n.get("route_shadow", 0)
    check(owners == 2 and k7 == 0 and counts_n.get("proxy_march", 0) > 0
          and counts_n.get("mlp_dense", 0) + counts_n.get("mlp_pair", 0) > 0
          and counts_bare.get("route_secondary", 0) > 0,
          f"neural curve frame launches {counts_n} ({owners} partitions own pieces); the "
          f"curveless frame {counts_bare}")
    check(torch.allclose(img_n.cpu(), img_c, rtol=1e-3, atol=1e-4) and st_n["tracer_diag"] == 0
          and bool(torch.isfinite(img_n).all()),
          f"neural curve frame on the card vs the CPU: max abs err {err_n:.3g}")
    print(f"phase12 12d neural_p2: both partitions own pieces; launches {counts_n} (no K7; the "
          f"curveless frame {counts_bare}); vs the port's CPU run max abs err {err_n:.3g} "
          f"(rtol 1e-3 / atol 1e-4) ok", flush=True)
    dist_out["neural_p2"] = {"launches": counts_n, "bare_launches": counts_bare,
                             "max_abs_err_vs_cpu": err_n}
    out["distributed"] = dist_out
    return out


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
        import pg2024_dprt_tpu_torch.parallel
        import pg2024_dprt_tpu_torch.render
        import pg2024_dprt_tpu_torch.scene
        import pg2024_dprt_tpu_torch.train
        import pg2024_dprt_tpu_torch.train.datagen
        import pg2024_dprt_tpu_torch.train.loop
        import pg2024_dprt_tpu_torch.utils
        import pg2024_dprt_tpu_torch.utils.profile
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

    t_start = time.perf_counter()
    try:
        # ---- phase 1: card + build
        card = card_line()
        t0 = time.perf_counter()
        report = _build.build(force=True)
        build_s = time.perf_counter() - t0
        print(f"phase1 card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
              f"| kernel build {build_s:.2f} s ({', '.join(report)})", flush=True)
        for name, (_, log) in report.items():
            print(f"phase1 ptxas {name}: {ptxas_summary(log)}", flush=True)
        hmma = hmma_counts(_build.BUILD_DIR)
        check(len(hmma) == 6 and all(hmma.values()),
              f"the nets' kernels lack tensor-core products in their SASS: {hmma}")
        print("phase1 HMMA instructions in the SASS: "
              + ", ".join(f"{k} {v}" for k, v in hmma.items()) + " ok", flush=True)

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
                check(set(counts2) == {"resident_closest", "resident_anyhit", "shade_paths"},
                      f"cornell composed launches {counts2}")
                cornell_counts = counts2
            else:
                check(counts2 == want_counts, f"cornell fused launches {counts2}")
            print(f"phase2 cornell 32x32 spp2 b3 {path} vs golden: max abs err {err2:.3g} "
                  f"(rtol 1e-3 / atol 1e-4) ok; launches {counts2}", flush=True)
        # K1 / K2 at the shapes of their main path (the composed cornell
        # frame: at K = 1 the rule takes the flat kernels)
        cwaves = named_wavefronts(frame_wavefronts(pt, scene, lights, env, cam, cfg))
        cornell = {}
        for wname, kern, plain, work_fn in (
                ("camera", pt.ops.resident_closest, pt.ops.resident_closest_plain, closest_work),
                ("shadow0", pt.ops.resident_anyhit, pt.ops.resident_anyhit_plain, anyhit_work)):
            rays = cwaves[wname]
            want = plain(scene, *rays)
            if wname == "camera":
                err, ndis, _ = compare_closest(pt, scene, rays, kern(scene, *rays), want)
            else:
                err, ndis = compare_anyhit(pt, scene, rays, kern(scene, *rays), want)
            d_ms, k_ms = split_ms(torch, lambda: kern(scene, *rays),
                                  KERNEL_FUNCTIONS[kern.__name__], reps=20)
            p_ms = cuda_ms(torch, lambda: plain(scene, *rays), reps=3)
            b_ms, b_by = bound(work_fn(pt, scene, rays, want))
            cornell[wname] = {"ms": d_ms, "wrapper_ms": k_ms, "plain_ms": p_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                              "disagreements": ndis}
            print(f"phase2 cornell wavefront {wname}: {int(rays[4].sum())} active rays, "
                  f"{kern.__name__} device {d_ms:.4f} ms, wrapper {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, "
                  f"bound {b_ms:.6f} ms ({b_by}); vs plain: {ndis} flag disagreements, max "
                  f"abs err {err:.3g} ok", flush=True)

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
        check(composed_counts == {
            "grouped_closest" if pt.ops.trace_grouped(scene) else "resident_closest": cfg.bounces,
            "grouped_anyhit" if pt.ops.trace_grouped(scene, True)
            else "resident_anyhit": cfg.bounces, "shade_paths": cfg.spp * cfg.bounces},
              f"composed frame launches {composed_counts}")
        seeds = iter(range(1, 1000))
        frame_ms = cuda_ms(torch, lambda: pt.render.render_image(
            scene, lights, env, cam, cfg, base_sample=next(seeds)), reps=7)
        composed_ms = cuda_ms(torch, lambda: pt.render.render_image(
            scene, lights, env, cam, off(cfg), base_sample=next(seeds)), reps=7)
        with plain_versions(pt):
            plain_frame_ms = cuda_ms(torch, lambda: pt.render.render_image(
                scene, lights, env, cam, off(cfg), base_sample=next(seeds)), reps=1, warmup=0)
        print(f"phase3 frame 256x256 spp1 b4 ris: fused {frame_ms:.3f} ms, composed "
              f"{composed_ms:.3f} ms (medians of 7); composed with the plain versions "
              f"{plain_frame_ms:.1f} ms (one run); launches fused {main_counts}, "
              f"composed {composed_counts}", flush=True)
        k3_dev, k3_ms = split_ms(torch, lambda: samples(cfg, True, next(seeds)),
                                 "frame_sample_kernel", device_reps=7)
        # K3's mode by the rule (the warp walks at K = 185) against its flat
        # mode: bit-identical images, on the frame and on an odd-sized frame
        # of the same soup (251 x 247 pixels: its last warp holds lanes past
        # the last pixel)
        fused = lambda c, cm, s, mode: pt.ops.render_frame_fused(scene, lights, env, cm, s, c,
                                                                 grouped=mode)
        cam_odd = pt.core.Camera.look_at([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0,
                                         251, 247, device=dev)
        cfg_odd = dataclasses.replace(cfg, width=251, height=247, russian_roulette=2)
        for label, c3, cm in (("64k frame", cfg, cam), ("odd-sized frame 251x247", cfg_odd,
                                                        cam_odd)):
            g3, f3 = fused(c3, cm, 3, True), fused(c3, cm, 3, False)
            check(torch.equal(g3[0], f3[0]) and torch.equal(g3[1], f3[1])
                  and bool(torch.isfinite(g3[0]).all()) and float(g3[0].sum()) > 0.0,
                  f"K3 through the warp walks and in its flat mode differ on the {label}")
        k3_flat_ms = cuda_ms(torch, lambda: fused(cfg, cam, next(seeds), False), reps=7)
        k3_grouped_ms = cuda_ms(torch, lambda: fused(cfg, cam, next(seeds), True), reps=7)
        print(f"phase3 K3 through the warp walks vs its flat mode: images bit-identical on the "
              f"64k frame and the odd-sized frame 251x247 (roulette 2) ok; warp walks "
              f"{k3_grouped_ms:.3f} ms, flat {k3_flat_ms:.3f} ms (medians of 7; the rule takes "
              f"the {'grouped' if pt.ops.use_grouped(scene) else 'flat'} mode)", flush=True)
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
            kname = "resident_anyhit" if wname == "shadow0" else "resident_closest"
            k_fn = lambda: getattr(pt.ops, kname)(scene, *rays)
            p_fn = lambda: getattr(pt.ops, f"{kname}_plain")(scene, *rays)
            d_ms, k_ms = split_ms(torch, k_fn, KERNEL_FUNCTIONS[kname], reps=20)
            p_ms = cuda_ms(torch, p_fn, reps=3)
            timings[wname] = (d_ms, p_ms, n_act, k_ms)
            print(f"phase3 wavefront {wname}: {n_act} active rays, kernel device {d_ms:.4f} ms "
                  f"({n_act / d_ms / 1e3:.1f} Mrays/s), wrapper {k_ms:.4f} ms, plain "
                  f"{p_ms:.2f} ms", flush=True)

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
        # the composed path shades with K14, which shares K3's shading
        # functions, so the runs with roulette face the plain version too
        for mode, rr in (("ris", 0), ("ris", 2), ("sum", 2)):
            c4 = dataclasses.replace(cfg, nee_mode=mode, russian_roulette=rr, spp=2)
            got4 = samples(c4, True, 3)
            ndis, e = compare_frames(f"K3 vs composed, {mode} rr{rr}", got4,
                                     samples(c4, False, 3), npix)
            vs_plain = ""
            if rr:
                ndis_p, e_p = compare_frames(
                    f"K3 vs plain, {mode} rr{rr}", got4,
                    pt.ops.render_frame_fused_plain(scene, lights, env, cam, 3, c4, spp=2), npix)
                vs_plain = (f"; vs its plain version {ndis_p} outlier pixels, max abs err "
                            f"elsewhere {e_p:.3g}")
            print(f"phase4 K3 vs the composed path, 64k frame spp2 {mode} roulette {rr}: "
                  f"{ndis} outlier pixels of {npix}, max abs err elsewhere {e:.3g}{vs_plain} ok",
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
             "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1372 (_kernel, flat and "
                         "instanced; also _kernel_hbm :1495, _kernel_tiny :1114, "
                         "_kernel_tiny_t :1284)",
             "launches": cornell_counts["resident_closest"], **cornell["camera"],
             "library_ms": None, "wavefront": "cornell camera",
             "frame_64k_camera": {"ms": timings["camera"][0], "wrapper_ms": timings["camera"][3],
                                  "plain_ms": timings["camera"][1],
                                  "bound_ms": b1, "bound_by": b1_by, "max_abs_err": k1_err,
                                  "disagreements": k1_dis}},
            {"name": "resident_anyhit", "route": "cuda", "source": src,
             "replaces": "pg2024_dprt_tpu/ops/pallas_resident.py:1773 (_occl_kernel, flat "
                         "and instanced; also _occl_kernel_hbm :1698, _occl_kernel_tiny "
                         ":1153, _occl_kernel_tiny_t :1361)",
             "launches": cornell_counts["resident_anyhit"], **cornell["shadow0"],
             "library_ms": None, "wavefront": "cornell shadow0",
             "frame_64k_shadow0": {"ms": timings["shadow0"][0],
                                   "wrapper_ms": timings["shadow0"][3],
                                   "plain_ms": timings["shadow0"][1], "bound_ms": b2,
                                   "bound_by": b2_by, "max_abs_err": k2_err,
                                   "disagreements": k2_dis}},
            {"name": "frame_sample", "route": "cuda",
             "source": "pg2024_dprt_tpu_torch/csrc/frame.cu",
             "replaces": "pg2024_dprt_tpu/ops/pallas_frame.py:228 (_frame_kernel with its "
                         "grouped and HBM modes, pallas_call :1087)",
             "launches": main_counts["frame_sample"], "max_abs_err": k3_err,
             "disagreements": k3_dis,
             "ms": k3_dev, "wrapper_ms": k3_ms, "plain_ms": k3_plain_ms,
             "bound_ms": b3, "bound_by": b3_by, "library_ms": None,
             "grouped_ms": k3_grouped_ms, "flat_ms": k3_flat_ms},
        ]
        for wname, w in work.items():
            run = (f", K1 runs {w['slabs_run']} slab tests "
                   f"({w['slabs_run'] / max(w['slabs'], 1):.1f}x)" if "slabs_run" in w else "")
            print(f"phase5 work {wname}: {w['tests']} ray-triangle tests, "
                  f"{w['slabs']} slab tests, {w['bytes']} bytes needed{run}; "
                  f"bound {bound(w)[0]:.6f} ms ({bound(w)[1]})", flush=True)
        print(f"phase5 work fused frame (all {cfg.bounces} bounces): {k3_work['tests']} "
              f"ray-triangle tests, {k3_work['slabs']} slab tests, {k3_work['bytes']} bytes "
              f"needed; bound {b3:.6f} ms ({b3_by}); K3 device {k3_dev:.3f} ms, wrapper "
              f"{k3_ms:.3f} ms", flush=True)

        # ---- phase 11: K1 / K2 (flat walks) under the dispatch rule, with a
        # reading of its timing conditions here and one after phase 10
        flat, reading_cases = flat_phase(pt, torch, np, dev, counted)
        kernels[0]["phase11"] = {k: v for k, v in flat.items() if not k.endswith("shadow0")}
        kernels[1]["phase11"] = {k: v for k, v in flat.items() if k.endswith("shadow0")}
        readings = {"after_phase5": flat_reading(pt, torch, dev, reading_cases, "after phase 5")}

        # ---- phase 6: the neural-proxy routing stage
        kernels += route_phase(pt, torch, np, dev, counted)
        cutout_phase(pt, torch, np, dev, counted)

        # ---- phase 7: large scenes (grouped trace, instancing, K3 grouped)
        large, extra = large_phase(pt, torch, np, dev, counted,
                                   (scene, lights, env, cam, cfg))
        waves = extra.pop("wavefronts")
        inst = extra.pop("instanced_frame_setup")
        kernels[0]["large_scene_ms"] = {w: r["k1_ms"] for w, r in waves.items()}
        kernels[1]["large_scene_ms"] = {w: r["k2_ms"] for w, r in waves.items()}
        kernels[2].update(frame_1m_grouped_ms=extra["k3_1m_grouped_ms"],
                          frame_1m_flat_ms=extra["k3_1m_flat_ms"],
                          frame_1m_bound_ms=extra["k3_1m_bound_ms"],
                          frame_1m_bound_by=extra["k3_1m_bound_by"])
        route_entry = next(e for e in kernels if e["name"] == "route")
        route_entry["neural_route_1m"] = extra.pop("neural_route_1m")
        large[0]["large_scene"] = {"wavefronts": waves, **extra}
        kernels += large

        # ---- phase 8: the pair tracer (K11-K13), the stackless and cluster back ends
        kernels += pair_phase(pt, torch, np, dev, counted, (scene, lights, env, cam, cfg),
                              named_wavefronts(per_bounce))

        # ---- phase 9: the distributed frame, K7's multi-geo mode
        mg_entry, dist_out = distributed_phase(pt, torch, np, dev, counted, inst)
        rank_setup = dist_out.pop("_rank_setup")
        kernels.append(dist_out.pop("_shade_entry"))
        mg_entry["distributed_phase"] = json.loads(json.dumps(dist_out, default=float))
        kernels.append(mg_entry)

        # ---- phase 13: the distributed frame with one partition a rank
        thirteen = rank_phase(pt, torch, dev, rank_setup, os.path.join(SMOKE_OUT, "ranks"))
        del rank_setup
        mg_entry["rank_phase"] = json.loads(json.dumps(thirteen, default=float))

        # ---- phase 12: curves through the composed frame, the partitioner
        # and the distributed frame (before phase 10, whose aftermath makes
        # the profiler's short spans read high)
        twelve = curve_phase(pt, torch, np, dev, counted)
        fur_launches = twelve["fur_frame"]["launches"]
        kernels[0]["phase12"] = twelve
        kernels[0]["curve_frame_launches"] = fur_launches.get("resident_closest", 0)
        kernels[1]["curve_frame_launches"] = fur_launches.get("resident_anyhit", 0)

        # ---- phase 10: training, the sampled grid, the command line
        ten = training_phase(pt, torch, np, dev, counted)
        kernels[0]["phase10"] = {"datagen_launches": [r["launches"] for r in ten["datagen"]],
                                 "labels": ten["labels"], "grid_launches": ten["grid"]["launches"]}
        route_entry["phase10"] = {"ab": ten["ab"], "cli_rooms8_neural": ten["cli_rooms8_neural"]}
        kernels[2]["phase10_cli_cornell"] = ten["cli_cornell"]

        # ---- phase 11's reading again, after phase 10
        readings["after_phase10"] = flat_reading(pt, torch, dev, reading_cases, "after phase 10")
        kernels[0]["phase11_readings"] = readings

        # ---- phase 13d: 10f's --neural frame with one partition a rank,
        # held against 10f's nets and frame (so no training runs twice)
        route_entry["phase13d"] = json.loads(json.dumps(rank_training_phase(
            pt, torch, dev, ten.pop("_rank_training"), os.path.join(SMOKE_OUT, "ranks_cli")),
            default=float))
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
