"""The distributed frame (counterpart of pg2024_dprt_tpu/parallel/distributed.py):
the paper's system of partitions, path migration, proxies and a summed
image, on either mesh of parallel/mesh.py: all partitions in one process
(InProcessMesh) or one partition a rank of torch.distributed (RankMesh).

Per sample:
  * camera paths are generated on partition 0 only;
  * per bounce:
      - from bounce 1 with neural proxies, `secondary_route` decides every
        path's destination from its local hit and the vis/depth nets
        (render/proxy_stages.py: K7 on CUDA tensors, the composed stage
        where its gate says so);
      - the migration loop: every partition traces its live paths against
        its own geometry, bounded by the nearest hit so far
        (`_trace_and_route`: the local closest hit, this partition's bit
        set in the visited mask, the nearest unvisited partition box as
        the next target, the environment on a global miss, the winning
        hit's payload carried with the path), then `exchange_paths` moves
        the paths, until no path waits or arrives (one host sync per round
        on that count) or `max_migrations` rounds have run;
      - shading at the partition that owns the nearest hit: exact mode
        shades from the carried payload (no second trace); neural mode
        re-traces at the destination, as JAX does;
      - shadows: the neural stage (`shadow_direct_light_nn`) or the exact
        ring (`ring_shadow_occlusion`);
  * at the end of the sample the images and the stats go through one
    `mesh.psum` each, as JAX's do, so every process holds the whole image.

Each partition runs JAX's per-device program on its own path buffer of
npix rows; a process runs the partitions it holds (`mesh.local`) one after
another on its device, and the collectives are the mesh's. Every trace
passes `sort_rays` as JAX does (the migration loop and the neural re-trace
sort from bounce 1 on, the ring always).

A frame runs under the root span "render_image_distributed", whose id is
its base_sample, and each bounce's stages under the spans "neural_route",
"migration", "settle_shade" and "shadows" (utils/timing.py; the profiler
annotations whose device time the benchmark reads). Inside them:
  * migration: one "migration.round" a round, holding "migration.trace"
    (every local partition's `_trace_and_route`), "migration.exchange"
    (`exchange_paths`) and "migration.sync" (the termination test's read);
  * settle_shade: "settle_shade.retrace" (neural mode, from bounce 1) and
    "settle_shade.shade", per local partition;
  * shadows: "shadows.nn" or "shadows.ring";
and "reduce" around the end-of-sample psums and the stats read. The kernel
wrappers' spans sit inside these (utils/profile.py credits each device
operation and idle gap to the innermost span).

Beside JAX's counts the stats count the bytes handed to the mesh's
`all_to_all` and the bytes of the rows their receivers use
(`exchange_bytes`, `exchange_useful_bytes`: parallel/exchange.py), the live
paths routed by `secondary_route` and those it settles on another
partition (`route_queries`, `route_remote`), all summed over every
partition by the stats' psum, and the frame's host syncs (`host_syncs`:
utils/timing.py, every place this process's host waited for the card, the
stats read included).
"""
from __future__ import annotations

import torch

from ..core.types import HitRecord, PathState
from ..ops.trace_api import trace_closest_cutout as trace_closest
from ..render.config import RenderConfig
from ..render.engine import _on
from ..render.pathgen import generate_camera_paths
from ..render.proxy_stages import _segment_sum, secondary_route, shadow_direct_light_nn
from ..render.shade import shade
from ..scene.visibility_grid import query_conservative_grids
from ..utils.timing import host_read, host_syncs, span
from .exchange import exchange_bytes, exchange_paths, ring_bytes, ring_shadow_occlusion
from .mesh import make_mesh

F32_MAX = 3.402823466e38


def _trace_and_route(scene, proxies, env, paths: PathState, my_id: int, eps: float,
                     npix: int, tracer: str = "auto", sort_rays: bool = True,
                     use_grids: bool = False):
    """One partition's step of the migration loop. Returns (paths,
    env_image_add, diag, grid_culled)."""
    paths = paths.with_routing()
    live = paths.is_valid & (~paths.is_shadow)
    my_bit = ((paths.visited_mask >> my_id) & 1).bool()
    do_local = live & (~my_bit)

    hits, diag = trace_closest(scene, paths.origin, paths.direction, eps, paths.tmax,
                               do_local, tracer=tracer, sort_rays=sort_rays)
    upd = do_local & hits.is_hit
    new_tmax = torch.where(upd, hits.t, paths.tmax)
    current = torch.where(upd, my_id, paths.current_node)
    is_hit = paths.is_hit | upd
    visited = torch.where(live, paths.visited_mask | (1 << my_id), paths.visited_mask)

    # the nearest unvisited partition box in (eps, tmax)
    p = proxies.num_partitions
    d = paths.direction
    inv_dir = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    t0 = (proxies.aabb_min[None] - paths.origin[:, None, :]) * inv_dir[:, None, :]
    t1 = (proxies.aabb_max[None] - paths.origin[:, None, :]) * inv_dir[:, None, :]
    t_near = torch.minimum(t0, t1)
    t_enter = t_near.amax(dim=-1)
    t_exit = torch.maximum(t0, t1).amin(dim=-1)
    part_ids = torch.arange(p, device=d.device)
    unvisited = ((visited[:, None] >> part_ids[None]) & 1) == 0
    # a segment that starts inside a box may hit its geometry arbitrarily
    # close: route at ~eps
    cand = torch.clamp(t_enter, min=eps * 1.5)
    # empty partitions carry inverted infinite boxes
    nonempty = (proxies.max_length > 0.0)[None, :]
    ok = (live[:, None] & unvisited & nonempty & (part_ids[None] != my_id)
          & (t_exit >= t_enter) & (t_exit > eps) & (cand < new_tmax[:, None]))
    grid_culled = 0
    if use_grids and proxies.vis_grid is not None:
        # a partition whose grid bin at the entry is empty cannot be hit
        vis = query_conservative_grids(proxies.vis_grid, proxies.aabb_min, proxies.aabb_max,
                                       paths.origin, d, t_enter, t_near)
        grid_ok = vis | (t_enter <= eps)
        grid_culled = (ok & ~grid_ok).sum()
        ok = ok & grid_ok
    cand = torch.where(ok, cand, F32_MAX)
    best = torch.argmin(cand, dim=-1)           # the first of equal candidates
    found = torch.gather(cand, 1, best[:, None])[:, 0] < F32_MAX
    target = torch.where(live & found, best, current)

    # global miss: no hit anywhere visited and no unvisited box left
    env_miss = live & (~found) & (~is_hit)
    env_add = _segment_sum(
        torch.where(env_miss[:, None], paths.throughput * env.sample(d), 0.0),
        paths.pixel_index, npix)
    new_paths = paths._replace(
        tmax=torch.where(live, new_tmax, paths.tmax),
        current_node=current,
        target_node=torch.where(live, target, paths.target_node),
        visited_mask=visited,
        is_hit=is_hit,
        is_valid=paths.is_valid & (~env_miss),
        hit_tri=torch.where(upd, hits.tri_index.to(torch.int32), paths.hit_tri),
        hit_u=torch.where(upd, hits.u, paths.hit_u),
        hit_v=torch.where(upd, hits.v, paths.hit_v))
    return new_paths, env_add, diag, grid_culled


def _bucket(paths, cfg: RenderConfig, p: int) -> int:
    """Rows a partition ships to each destination a round."""
    return max(1, int(paths[0].capacity * cfg.bucket_fraction) // max(1, p))


def _migration_loop(mesh, scenes, proxies, env, paths, cfg: RenderConfig,
                    sort_rays: bool = True):
    """The migration loop over the buffers of the partitions this process
    holds (a list). Returns (paths, env_image_add, diag, truncated,
    overflow_waits, grid_culled, rounds, moved), the counts this process's:
    `truncated` counts paths still bound elsewhere when `max_migrations`
    stops the loop (they shade as misses), `overflow_waits` the path-rounds
    denied by a full bucket or a receiver without room (each retried),
    `moved` the paths shipped over all rounds. The rounds are the same in
    every process: the termination test is a psum."""
    npix = cfg.frame_buffer_size
    bucket = _bucket(paths, cfg, mesh.size)
    env_img = 0
    diag = culled = overflow = moved = 0
    rounds = 0
    pending = 1
    while pending > 0 and rounds < cfg.max_migrations:
        with span("migration.round"):
            with span("migration.trace"):
                step = [_trace_and_route(scenes[i], proxies, env, pi, i, cfg.t_epsilon, npix,
                                         cfg.tracer, sort_rays, cfg.use_visibility_grids)
                        for i, pi in zip(mesh.local, paths)]
            paths = [s[0] for s in step]
            for _, env_add, d, gc in step:
                env_img = env_img + env_add
                diag = diag + d
                culled = culled + gc
            with span("migration.exchange"):
                paths, moved_now, waiting, arrivals = exchange_paths(mesh, paths,
                                                                     bucket_size=bucket)
            # the loop's one host read: the termination test
            with span("migration.sync"):
                pending = host_read(mesh.psum(waiting + arrivals))
            overflow = overflow + waiting.sum()
            moved = moved + moved_now.sum()
            rounds += 1
    truncated = sum(((b.is_valid & (b.target_node >= 0) & (b.target_node != i)).sum()
                     for i, b in zip(mesh.local, paths)), 0)
    return paths, env_img, diag, truncated, overflow, culled, rounds, moved


def _settle_and_shade(mesh, scenes, lights, env, paths, sample_count: int, bounce: int,
                      cfg: RenderConfig, stats: dict):
    """Every local partition shades the paths settled on it. Returns (next
    paths, shadow paths, env image add), one list entry per local
    partition."""
    npix = cfg.frame_buffer_size
    rr = bool(cfg.russian_roulette) and cfg.russian_roulette <= bounce + 1 < cfg.bounces
    next_paths, shadows, env_img = [], [], 0
    for i, pi in zip(mesh.local, paths):
        live = pi.is_valid & (~pi.is_shadow)
        if cfg.use_neural_proxies and bounce > 0:
            # the nets decided only where a path settles: the real closest
            # hit is a full trace at the destination
            with span("settle_shade.retrace"):
                hits, d = trace_closest(
                    scenes[i], pi.origin, pi.direction, cfg.t_epsilon,
                    torch.full((pi.capacity,), F32_MAX, device=pi.origin.device), live,
                    tracer=cfg.tracer, sort_rays=True)
            stats["tracer_diag"] = stats["tracer_diag"] + d
        else:
            # exact mode shades from the carried payload; a truncated path
            # parked elsewhere shades as a miss
            here = live & pi.is_hit & (pi.current_node == i)
            hits = HitRecord(t=pi.tmax, tri_index=torch.where(here, pi.hit_tri, -1),
                             u=pi.hit_u, v=pi.hit_v, is_hit=here)
        with span("settle_shade.shade"):
            nxt, shadow, env_add = shade(
                scenes[i], lights, env, pi, hits, sample_count, bounce,
                cfg.shadow_path_count, npix, nee_mode=cfg.nee_mode, rr=rr)
        env_img = env_img + env_add
        next_paths.append(nxt.with_routing())
        shadows.append(shadow)
    return next_paths, shadows, env_img


def _shadows(mesh, scenes, proxies, nn_prox, models, shadows, cfg: RenderConfig,
             stats: dict):
    """The direct light of the local partitions' shadow rays: the neural
    stage per partition, or the exact ring over all of them."""
    npix = cfg.frame_buffer_size
    direct = torch.zeros((npix, 3), dtype=torch.float32, device=shadows[0].origin.device)
    if cfg.use_neural_proxies:
        with span("shadows.nn"):
            for i, sp in zip(mesh.local, shadows):
                add, d = shadow_direct_light_nn(
                    scenes[i], nn_prox, models, sp, i, cfg.max_proxy_hits, cfg.t_epsilon,
                    cfg.shadow_path_count, npix, tracer=cfg.tracer)
                direct += add
                stats["tracer_diag"] = stats["tracer_diag"] + d
        return direct
    with span("shadows.ring"):
        shadows, occ, d, gc = ring_shadow_occlusion(
            mesh, scenes, shadows, cfg.t_epsilon, tracer=cfg.tracer,
            proxies=proxies if cfg.use_visibility_grids else None)
    # every partition receives each valid ray and returns its flag
    shipped, row = ring_bytes(mesh, shadows)
    stats["exchange_bytes"] += shipped
    stats["exchange_useful_bytes"] = stats["exchange_useful_bytes"] + (
        torch.stack([sp.is_valid for sp in shadows]).sum() * (mesh.size * row))
    stats["tracer_diag"] = stats["tracer_diag"] + d
    stats["grid_culled"] = stats["grid_culled"] + gc
    for sp, oc in zip(shadows, occ):
        contrib = torch.where((sp.is_valid & ~oc)[:, None],
                              sp.throughput / cfg.shadow_path_count, 0.0)
        direct.index_add_(0, sp.pixel_index, contrib)
    return direct


def render_sample_distributed(partitioned, models, lights, env, camera, sample_count: int,
                              cfg: RenderConfig, mesh):
    """One spp over the mesh's partitions. Returns (direct image, env image,
    stats): the images (npix, 3) summed over every partition; stats a dict
    of tracer_diag, migration_truncated, migration_overflow_waits,
    grid_culled, paths_moved, exchange_bytes, exchange_useful_bytes,
    route_queries and route_remote (0-d int64 tensors, summed over every
    partition) and migration_rounds (one count per bounce). Only the scenes
    of the partitions this process holds (`mesh.local`) are read."""
    p = mesh.size
    if partitioned.num_partitions != p:
        raise ValueError(f"{partitioned.num_partitions} partitions on a mesh of {p}")
    scenes, proxies = partitioned.scenes, partitioned.proxies
    # the neural stages read the instance-level rows of an instance
    # partitioning; the migration loop always routes through partition boxes
    nn_prox = partitioned.nn_proxies if partitioned.nn_proxies is not None else proxies
    npix = cfg.frame_buffer_size
    dev = camera.origin.device

    cam_paths = generate_camera_paths(camera, sample_count).with_routing()
    none_valid = torch.zeros_like(cam_paths.is_valid)
    # camera paths start valid on partition 0 only
    paths = [cam_paths if i == 0 else cam_paths._replace(is_valid=none_valid)
             for i in mesh.local]
    direct = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    env_img = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    stats = dict(tracer_diag=0, migration_truncated=0, migration_overflow_waits=0,
                 grid_culled=0, paths_moved=0, exchange_bytes=0, exchange_useful_bytes=0,
                 route_queries=0, route_remote=0)
    rounds_per_bounce, routed = [], []

    for bounce in range(cfg.bounces):
        if bounce > 0 and cfg.use_neural_proxies:
            with span("neural_route"):
                for n, i in enumerate(mesh.local):
                    paths[n], env_add, d = secondary_route(
                        scenes[i], nn_prox, models, env, paths[n], i, cfg.max_proxy_hits,
                        cfg.t_epsilon, npix, tracer=cfg.tracer, routed=routed)
                    env_img += env_add
                    stats["tracer_diag"] = stats["tracer_diag"] + d
        with span("migration"):
            shipped, row = exchange_bytes(mesh, paths, _bucket(paths, cfg, p))
            # bounce-0 wavefronts are camera coherent: no schedule sort there
            paths, env_add, d, tr, ov, gc, rounds, moved = _migration_loop(
                mesh, scenes, proxies, env, paths, cfg, sort_rays=bounce >= 1)
            env_img += env_add
        stats["exchange_bytes"] += rounds * shipped
        stats["exchange_useful_bytes"] = stats["exchange_useful_bytes"] + moved * row
        for k, v in (("tracer_diag", d), ("migration_truncated", tr),
                     ("migration_overflow_waits", ov), ("grid_culled", gc),
                     ("paths_moved", moved)):
            stats[k] = stats[k] + v
        rounds_per_bounce.append(rounds)
        with span("settle_shade"):
            paths, shadows, env_add = _settle_and_shade(mesh, scenes, lights, env, paths,
                                                        sample_count, bounce, cfg, stats)
            env_img += env_add
        with span("shadows"):
            direct += _shadows(mesh, scenes, proxies, nn_prox, models, shadows, cfg, stats)

    # the image and stats reduce across partitions (JAX's psums), once each;
    # a count still on the host goes to the device by a fill, not a copy
    with span("reduce"):
        if routed:
            # (the routed live paths, those settled elsewhere) of every call
            stats["route_queries"], stats["route_remote"] = torch.stack(
                [torch.stack(masks) for masks in zip(*routed)]).sum(dim=(1, 2))
        direct, env_img = mesh.psum(torch.stack([direct, env_img])[None])
        keys = list(stats)
        totals = mesh.psum(torch.stack([
            stats[k].to(torch.int64) if torch.is_tensor(stats[k])
            else torch.full((), stats[k], dtype=torch.int64, device=dev)
            for k in keys])[None])
    return direct, env_img, {**dict(zip(keys, totals)), "migration_rounds": rounds_per_bounce}


def render_image_distributed(partitioned, models, lights, env, camera, cfg: RenderConfig,
                             mesh=None, base_sample: int = 0, return_stats: bool = False,
                             device=None):
    """Full frame over the partitions: the average over spp. Returns
    (height, width, 3) float32, or (image, stats) with return_stats: stats
    has tracer_diag, migration_truncated, migration_overflow_waits and
    grid_culled (ints, summed over samples and partitions, as JAX reports
    them), migration_rounds (per sample, per bounce), paths_moved, the
    counters of the module docstring (exchange_bytes,
    exchange_useful_bytes, route_queries, route_remote, summed the same
    way) and host_syncs (this process's, the stats read included; the
    stats are read with one copy). On a RankMesh every rank returns the
    whole image and the same stats but host_syncs.

    Runs on the mesh's device; without a mesh, on a new in-process mesh of
    the scene's partitions on `device` (CUDA unless the caller passes
    another). The inputs are moved there: of the partition scenes only
    those of the partitions this process holds (`mesh.local`); the others
    may be None. Every process keeps every partition's proxies and nets:
    any path may route through any partition's box."""
    with span("render_image_distributed", frame=base_sample):
        syncs = host_syncs()
        mesh = mesh or make_mesh(partitioned.num_partitions, device)
        dev = mesh.device
        partitioned = partitioned._replace(
            scenes=[_on(dev, s) if i in mesh.local else s
                    for i, s in enumerate(partitioned.scenes)],
            proxies=partitioned.proxies.to(dev),
            nn_proxies=(None if partitioned.nn_proxies is None
                        else partitioned.nn_proxies.to(dev)))
        models = models.to(dev) if models is not None else None
        lights, env, camera = (_on(dev, r) for r in (lights, env, camera))
        npix = cfg.frame_buffer_size
        direct = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        env_img = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        totals, rounds = {}, []
        for s in range(cfg.spp):
            d, e, st = render_sample_distributed(partitioned, models, lights, env, camera,
                                                 base_sample + s, cfg, mesh)
            direct += d
            env_img += e
            rounds.append(st.pop("migration_rounds"))
            for k, v in st.items():
                totals[k] = totals[k] + v if k in totals else v
        img = ((direct + env_img) / cfg.spp).reshape(cfg.height, cfg.width, 3)
        if not return_stats:
            return img
        with span("reduce"):
            values = host_read(torch.stack(list(totals.values())))
        return img, {**dict(zip(totals, values)), "host_syncs": host_syncs() - syncs,
                     "migration_rounds": rounds}
