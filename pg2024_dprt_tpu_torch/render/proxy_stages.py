"""Neural-proxy stages (counterpart of pg2024_dprt_tpu/render/proxy_stages.py):
from bounce 1 on, secondary and shadow rays never leave their partition.
The proxy boxes of the other partitions are marched and per-object vis/depth
nets predict the remote hit.

  * `secondary_route`: local closest hit + proxy march + nets -> per-path
    routing decision (target node, tmax, is_hit) and the environment
    radiance of paths that miss everything;
  * `shadow_direct_light_nn`: local occlusion + proxy march + nets ->
    max-occlusion blend -> direct-light image.

On CUDA tensors the default path of both is the fused route kernel
(ops/route.py, one launch, for secondary rays after the schedule-key kernel
and sort); the composed path (schedule sort -> trace kernel -> march kernel
-> net kernel -> consumption in PyTorch) serves what `_use_fused_route`
rejects. CPU tensors always compose, through the kernels' plain versions.
"""
from __future__ import annotations

import torch

from ..core.types import NNQuery, PathState
from ..models.proxy import ProxyModels, apply_grouped, apply_grouped_all, apply_multigeo
from ..ops import march as _march
from ..ops import mlp as _mlp
from ..ops import route as _route
from ..ops.trace_api import (
    trace_closest_cutout as trace_closest,
    trace_occlusion_cutout as trace_occlusion,
)
from ..scene.geometry import DeviceScene, ProxyTable

# every partition marked visited: routing is fully decided by the stage
ALL_VISITED = 0xFFFFFFFF


def march_proxies(proxies: ProxyTable, origin, direction, t_cap, active, my_node,
                  max_hits: int, eps: float) -> NNQuery:
    """March up to `max_hits` proxy-box hits per ray (ops/march.py): the
    march kernel for CUDA tensors, its plain version for CPU tensors.
    Returns an NNQuery of N * max_hits rows (row n * max_hits + k = ray n's
    k-th hit); a ray without any valid row hit no proxy at all."""
    return _march.proxy_march(proxies, origin, direction, t_cap, active, my_node,
                              max_hits, eps)


def _use_fused_route(scene: DeviceScene, models: ProxyModels, tracer: str,
                     proxies: ProxyTable = None, max_hits: int = 1) -> bool:
    """True when the one-kernel routing stage (ops/route.py) applies: CUDA
    tensors with the resident tracer, a scene without cutout textures,
    curves or instanced local geometry, separate vis/depth nets of one
    architecture (per-object pairs, or the shared multi-geo pair, which K7
    runs in its multi-geo mode). The semantic conditions of the JAX gate;
    its weight budget is a limit of the TPU kernel's fast memory and is
    dropped (the kernel reads the nets from global memory). What the
    kernel's wrapper would refuse for its shape composes
    (`fused_route_takes`: a proxy row without a net pair, a tile beyond
    shared memory)."""
    if models.combined:
        return False  # the combined double-output net runs the composed path
    if scene.cl_mt_table.device.type != "cuda" or tracer not in ("auto", "resident"):
        return False
    if getattr(scene, "cl_xf", None) is not None:
        return False
    if scene.has_cutout:
        return False
    if getattr(scene, "curves", None) is not None:
        # K7's in-kernel trace has no curve stage: curve scenes compose, so
        # that the hair stays in the frame. (The JAX gate lacks this test,
        # and a TPU route kernel would drop the curves.)
        return False
    return _route.fused_route_takes(models, proxies, max_hits)


def _nn_pair(models: ProxyModels, feats, obj_id, valid):
    """vis + depth inference for one query batch. Separate nets of one
    architecture that the pair kernels take, on CUDA tensors, run a pair kernel (ops/mlp.py: the dense
    kernel when the weights are within DENSE_WEIGHT_LIMIT, else the grouped
    one); everything else runs the plain grouped engine (models/proxy.py).
    Depth is computed wherever vis is; consumers mask inside-hits
    themselves."""
    c_v, c_d = models.vis_cfg, models.depth_cfg
    if models.combined:
        # ONE double-output grouped sweep yields both predictions (channel
        # 0 = vis, 1 = depth)
        out = apply_grouped_all(models.vis_params, c_v, feats, obj_id, valid,
                                models.num_objects)
        return out[:, 0], out[:, 1]
    if models.multi_geo:
        # one shared 6-feature net for every object: no grouping
        return (apply_multigeo(models.vis_params, c_v, feats, obj_id, valid),
                apply_multigeo(models.depth_params, c_d, feats, obj_id, valid))
    if feats.device.type != "cpu" and _mlp.pair_refusal(c_v, c_d) is None:
        kernel = (_mlp.grouped_mlp_dense
                  if _mlp.use_dense(models.vis_params, models.depth_params)
                  else _mlp.grouped_mlp_pair)
        return kernel(models, feats, obj_id, valid)
    return (apply_grouped(models.vis_params, c_v, feats, obj_id, valid, models.num_objects),
            apply_grouped(models.depth_params, c_d, feats, obj_id, valid, models.num_objects))


def _segment_sum(values, index, num_segments: int):
    out = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, index.to(torch.int64), values)


def secondary_route(scene: DeviceScene, proxies: ProxyTable, models: ProxyModels,
                    env, paths: PathState, my_id: int, max_hits: int, eps: float,
                    frame_buffer_size: int, tracer: str = "auto", routed: list = None):
    """Local closest hit + proxy march + vis/depth nets -> per-path routing
    decision (target_node / tmax / is_hit). Returns (updated paths,
    env_image_add (frame_buffer_size, 3), diag). With `routed` (a list),
    appends this call's (live, remote) path masks: the live paths it routed
    and those it settled on another partition, for the caller to count
    (parallel/distributed.py counts a sample's at once, with no sync)."""
    paths = paths.with_routing()
    live = paths.is_valid & (~paths.is_shadow)
    diag = 0

    if _use_fused_route(scene, models, tracer, proxies, max_hits):
        dec = _route.route_fused(scene, proxies, models, paths.origin, paths.direction,
                                 eps, paths.tmax, live, my_id, max_hits, eps)
    else:
        # secondary wavefronts are scattered: trace them in schedule order
        hits, diag = trace_closest(scene, paths.origin, paths.direction, eps,
                                   paths.tmax, live, tracer=tracer, sort_rays=True)
        local_hit = live & hits.is_hit
        local_t = torch.where(local_hit, hits.t, paths.tmax)
        q = march_proxies(proxies, paths.origin, paths.direction, local_t, live,
                          my_id, max_hits, eps)
        vis, depth = _nn_pair(models, q.features, q.aabb_id, q.is_valid)
        dec = _route.consume_secondary(q, vis, depth, live, local_hit, local_t,
                                       my_id, max_hits)

    has_node, env_miss, no_route = dec["has_node"], dec["env_miss"], dec["no_route"]
    if routed is not None:
        routed.append((live, has_node & (dec["settled_node"] != my_id)))
    # environment fallback: no local hit, no proxy hit at all -> radiance + kill
    env_add = _segment_sum(
        torch.where(env_miss[:, None], paths.throughput * env.sample(paths.direction), 0.0),
        paths.pixel_index, frame_buffer_size)
    settled = dec["settled_node"].to(torch.int64)
    # no route: stay local with tmax = 0; the shade stage's re-trace then
    # resolves the environment for the remaining misses
    node = lambda old: torch.where(has_node, settled, torch.where(no_route, int(my_id), old))
    new_paths = paths._replace(
        tmax=torch.where(live, dec["new_t"], paths.tmax),
        current_node=node(paths.current_node),
        target_node=node(paths.target_node),
        is_hit=torch.where(live, has_node, paths.is_hit),
        is_valid=paths.is_valid & (~env_miss),
        visited_mask=torch.where(live, ALL_VISITED, paths.visited_mask))
    return new_paths, env_add, diag


def shadow_direct_light_nn(scene: DeviceScene, proxies: ProxyTable,
                           models: ProxyModels, shadow_paths: PathState, my_id: int,
                           max_hits: int, eps: float, shadow_path_count: int,
                           frame_buffer_size: int, tracer: str = "auto"):
    """Local occlusion kill, proxy march, vis nets (+ depth nets for
    inside-hits), max-occlusion blend, direct-light image add. Returns
    (direct-light increment (frame_buffer_size, 3), diag)."""
    valid = shadow_paths.is_valid
    t_max = shadow_paths.tmax * (1.0 - 1e-3)
    diag = 0

    if _use_fused_route(scene, models, tracer, proxies, max_hits):
        weight = _route.shadow_route_fused(
            scene, proxies, models, shadow_paths.origin, shadow_paths.direction,
            eps, t_max, valid, my_id, max_hits, eps)["weight"]
    else:
        occluded_local, diag = trace_occlusion(
            scene, shadow_paths.origin, shadow_paths.direction, eps, t_max, valid,
            tracer=tracer, sort_rays=True)
        survives = valid & (~occluded_local)
        q = march_proxies(proxies, shadow_paths.origin, shadow_paths.direction,
                          t_max, survives, my_id, max_hits, eps)
        # the pair computes depth wherever vis is; the blend reads it only
        # for inside-hits. The combined nets compare with a slack of 0.1.
        vis, depth = _nn_pair(models, q.features, q.aabb_id, q.is_valid)
        weight = _route.consume_shadow(q, vis, depth, survives, max_hits,
                                       depth_slack=0.1 if models.combined else 0.0)

    contrib = shadow_paths.throughput * weight[:, None] / shadow_path_count
    return _segment_sum(contrib, shadow_paths.pixel_index, frame_buffer_size), diag
