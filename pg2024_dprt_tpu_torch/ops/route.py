"""Fused neural routing (counterpart of pg2024_dprt_tpu/ops/pallas_route.py):
local trace + proxy march + vis/depth nets + prediction consumption in ONE
kernel launch per stage call.

The kernel, K7 `route` in csrc/route.cu (entry points `route_secondary` and
`route_shadow`), is written by hand for Hopper and replaces
pallas_route.py::_route_kernel; its source says what it computes, how, and
what bounds it. It is built from the device functions of K1/K2
(csrc/resident_trace.cuh), K4 (csrc/proxy_march.cuh) and K5/K6
(csrc/proxy_mlp.cuh), so the fused and the composed stage share their
arithmetic.

`route_fused` returns the per-ray routing decisions of a secondary
wavefront, `shadow_route_fused` the per-ray light weight of a shadow
wavefront; render/proxy_stages.py applies them. Beside them are their plain
PyTorch versions (`route_fused_plain`, `shadow_route_fused_plain`): the
trace's plain version, the march's, the nets', and the consumption block
(`consume_secondary`, `consume_shadow`, which the composed stage shares). A
wrapper runs the plain version only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.

With `sort_rays` the wrapper runs K7 on the wavefront in schedule order
(ops/resident.py::schedule_order: the cluster-schedule keys of K8, one stable
sort, one gather) and returns the decisions in the caller's order. The
decisions are per ray and do not depend on it; it is on by default for
secondary rays, which are scattered, and off for shadow rays, as in the JAX
package. Combined models, nets of different architectures and shapes
beyond the kernel's shared memory are not taken (`fused_route_takes`): the
stage composes for them.

Multi-geo models (one shared vis/depth pair whose sixth input is the
record's object id / INSTANCE_DIVISOR, the JAX kernel's multi_geo mode) run
K7's multi-geo mode: every valid record goes through the one pair. Those
launches also count under `route_multigeo`. The plain version runs
models/proxy.py::apply_multigeo, the composed stage's function.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .march import ProxyTableArgs, march_proxies_plain
from ..models.proxy import apply_multigeo
from .mlp import (
    ACTIVATIONS, KERNEL_THREADS, SMEM_LIMIT, forward_smem_bytes,
    grouped_mlp_dense_plain, packed_pair, pair_refusal,
)
from .resident import (
    F32_MAX, LAUNCHES, _check, _kernel_inputs, _ptr, _stream, group_args,
    resident_anyhit_plain, resident_closest_plain, scene_tables, schedule_order, unsorted,
    use_grouped,
)

F32_EPS = 1.1920929e-7
# csrc/route.cu kTileRays: the rays of one K7 tile (a block of KERNEL_THREADS)
TILE_RAYS = 256
# csrc/route.cu kNetRows: the records of one K7 nets chunk
NET_ROWS = 32
# csrc/resident_trace.cuh Team: the shared memory of one warp's walk (ring of
# 64 group ids, 512 buffered (enter, cluster) candidates)
TEAM_BYTES = 4 * (64 + 2 * 512)


def net_pairs(models) -> int:
    """Net pairs K7 holds: one per object, one shared multi-geo pair."""
    return 1 if models.multi_geo else models.num_objects


def route_smem_bytes(cfg, max_hits: int, num_nets: int) -> int:
    """Bytes of shared memory of one K7 tile (csrc/route.cu smem_bytes): the
    nets' forward planes for chunks of NET_ROWS, which the warps' team
    buffers of the grouped trace alias in phase 1 (the larger of the two), 11
    words per query record, 3 per net pair."""
    front = max(forward_smem_bytes(cfg, NET_ROWS), KERNEL_THREADS // 32 * TEAM_BYTES)
    return front + TILE_RAYS * max_hits * 11 * 4 + 3 * num_nets * 4


def fused_route_takes(models, proxies=None, max_hits: int = 1) -> bool:
    """What K7 runs: separate single-output vis and depth nets of one
    architecture the pair kernels take, either one 5-feature pair per
    object (with a proxy table, a pair for every row of a table without
    instancing) or one shared 6-feature multi-geo pair; a tile (nets,
    `max_hits` records per ray) within shared memory."""
    if models.combined:
        return False
    cfg = models.vis_cfg
    if pair_refusal(cfg, models.depth_cfg, multi_geo=models.multi_geo):
        return False
    if cfg.in_features != (6 if models.multi_geo else 5):
        return False
    if (not models.multi_geo and proxies is not None and not proxies.instanced
            and proxies.num_partitions > models.num_objects):
        return False
    return max_hits >= 1 and route_smem_bytes(cfg, max_hits, net_pairs(models)) <= SMEM_LIMIT


# --------------------------------------------------------------------------
# the consumption block (shared by the composed stage and the plain versions)

def consume_secondary(q, vis, depth, live, local_hit, local_t, my_id: int,
                      max_hits: int) -> dict:
    """Per-ray routing decisions from the queries' predictions: the nearest
    visible predicted hit below the local bound settles the ray on that
    proxy's node, else a local hit settles it on this partition; no local
    hit and no query at all is an environment miss; what is left has no
    route. Returns settled_node (-1 none), new_t, has_node, env_miss,
    no_route, local_hit."""
    pred_hit = q.is_valid & (vis > 0.5)
    pred_len = q.t_ratio * q.max_length * depth
    pred_t = torch.where(
        q.is_inside,
        torch.where(pred_len > q.aabb_t, 0.0, q.aabb_t - pred_len),
        q.aabb_t + pred_len)
    pred_t = torch.where(pred_hit & (pred_t > F32_EPS), pred_t, F32_MAX)
    # the routing target is the owning node of the winning proxy; the first
    # of equal predictions wins
    q_node = q.node_id if q.node_id is not None else q.aabb_id
    n = live.shape[0]
    pred_t = pred_t.reshape(n, max_hits)
    first = torch.argmin(pred_t, dim=1, keepdim=True)
    best_pred_t = pred_t.gather(1, first)[:, 0]
    best_pred_node = q_node.reshape(n, max_hits).gather(1, first)[:, 0]
    any_query = q.is_valid.reshape(n, max_hits).any(dim=1)

    use_pred = live & (best_pred_t < local_t)
    settled = torch.where(use_pred, best_pred_node.to(torch.int64),
                          torch.where(local_hit, int(my_id), -1))
    has_node = settled >= 0
    env_miss = live & (~local_hit) & (~any_query) & (~has_node)
    return dict(
        settled_node=settled,
        new_t=torch.where(has_node, torch.where(use_pred, best_pred_t, local_t), 0.0),
        has_node=has_node,
        env_miss=env_miss,
        no_route=live & (~has_node) & (~env_miss),
        local_hit=local_hit)


def consume_shadow(q, vis, depth, survives, max_hits: int,
                   depth_slack: float = 0.0) -> torch.Tensor:
    """Per-ray light weight: survives * (1 - any occluding query). A query
    occludes when vis > 0.5 and, for an inside hit, the predicted depth (plus
    the combined nets' slack) is at most the object-space entry depth."""
    occluded_q = q.is_valid & (vis > 0.5) & (
        (~q.is_inside) | (depth + depth_slack <= q.normalized_t))
    max_occ = occluded_q.reshape(-1, max_hits).any(dim=1).to(torch.float32)
    return torch.where(survives, 1.0 - max_occ, 0.0)


# --------------------------------------------------------------------------
# kernel wrappers

def _expand(x, n, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n).contiguous()


_REFUSAL = ("the fused route takes separate single-output vis/depth nets of one "
            "architecture, a 5-feature pair per proxy row or one 6-feature multi-geo "
            "pair, and a tile within shared memory (see fused_route_takes)")


def scene_args(scene, device, grouped=None):
    """The scene's arguments of K7's entry points: the cluster tables, K, C,
    then the group tables (gboxes, a 16-byte-aligned mboxes, Kg) where
    ops/resident.py::use_grouped(scene, grouped) takes the grouped trace, or
    (None, None, 0) for the flat one. Returns (arguments, the tables by name,
    to keep alive until the launch is enqueued)."""
    grouped = use_grouped(scene, grouped)
    tab, k, c = scene_tables(scene, device, grouped)
    groups = group_args(tab) if grouped else (None, None, 0)
    return [_ptr(tab["cl_boxes"]), _ptr(tab["cl_mt_table"]), _ptr(tab["cl_tri_map"]),
            _ptr(tab["cl_count"]), _ptr(tab["scene_aabb"]), k, c, *groups], tab


def _route_args(scene, proxies, models, origin, direction, t_min, t_max, active,
                my_id, max_hits, eps, sort_rays, grouped):
    """Validate what K7 reads. Returns (C arguments up to the outputs, N, the
    sort permutation or None, the tensors to keep alive until the launch is
    enqueued)."""
    if not fused_route_takes(models, proxies, max_hits):
        raise ValueError(_REFUSAL)
    if scene.instanced:
        raise ValueError("the fused route does not take instanced local geometry")
    dev = origin.device
    n = origin.shape[0]
    t_min = _expand(t_min, n, dev)
    t_max = _expand(t_max, n, dev)
    rays, _, n, _, _ = _kernel_inputs(scene, origin, direction, t_min, t_max, active)
    scene_ptrs, tab = scene_args(scene, dev, grouped)
    table = ProxyTableArgs.of(proxies, dev)
    packed = packed_pair(models)
    if packed[0].device != dev:
        raise ValueError(f"nets on {packed[0].device}, rays on {dev}")
    perm = schedule_order(scene, *rays) if sort_rays else None
    if perm is not None:
        rays = [x[perm] for x in rays]
    cfg = models.vis_cfg
    args = [
        *map(_ptr, rays), n, *scene_ptrs, *table.pointers, table.p, int(my_id), int(max_hits), float(eps),
        net_pairs(models), *map(_ptr, packed), cfg.width, cfg.depth, cfg.in_features,
        cfg.head_hidden, int(models.multi_geo), ACTIVATIONS[models.vis_cfg.final_activation],
        ACTIVATIONS[models.depth_cfg.final_activation]]
    return args, n, perm, (rays, tab, table, packed)


def _in_order(out: dict, perm) -> dict:
    return out if perm is None else {k: unsorted(v, perm) for k, v in out.items()}


def route_fused(scene, proxies, models, origin, direction, t_min, t_max, active,
                my_id: int, max_hits: int, eps: float, sort_rays: bool = True,
                grouped=None) -> dict:
    """One-kernel secondary routing. Returns the per-ray decisions:
    settled_node (my_id for a local settle, -1 for none), new_t, has_node,
    env_miss, no_route, local_hit. K7 for CUDA tensors (in schedule order
    with sort_rays; its trace takes the warp walks where
    ops/resident.py::use_grouped(scene, grouped) says so, with the same
    decisions either way), the plain version for CPU tensors."""
    if origin.device.type == "cpu":
        return route_fused_plain(scene, proxies, models, origin, direction, t_min,
                                 t_max, active, my_id, max_hits, eps)
    args, n, perm, keep = _route_args(scene, proxies, models, origin, direction, t_min,
                                      t_max, active, my_id, max_hits, eps, sort_rays,
                                      grouped)
    dev = origin.device
    node = torch.empty((n,), dtype=torch.int32, device=dev)
    new_t = torch.empty((n,), dtype=torch.float32, device=dev)
    flags = [torch.empty((n,), dtype=torch.bool, device=dev) for _ in range(4)]
    rc = _lib().route_secondary(*args, _ptr(node), _ptr(new_t), *map(_ptr, flags),
                                _stream(origin))
    _check(rc, "route_secondary")
    if n:
        LAUNCHES["route_secondary"] += 1
        LAUNCHES["route_multigeo"] += int(models.multi_geo)
    return _in_order(dict(settled_node=node, new_t=new_t, has_node=flags[0],
                          env_miss=flags[1], no_route=flags[2], local_hit=flags[3]), perm)


def shadow_route_fused(scene, proxies, models, origin, direction, t_min, t_max,
                       active, my_id: int, max_hits: int, eps: float,
                       sort_rays: bool = False, grouped=None) -> dict:
    """One-kernel neural shadow visibility. Returns weight = survives * (1 -
    max occlusion), occluded_local and survives per ray; pass t_max already
    scaled by the caller's occlusion margin. K7 for CUDA tensors (in schedule
    order with sort_rays; the trace by use_grouped(scene, grouped), as in
    route_fused), the plain version for CPU tensors."""
    if origin.device.type == "cpu":
        return shadow_route_fused_plain(scene, proxies, models, origin, direction,
                                        t_min, t_max, active, my_id, max_hits, eps)
    args, n, perm, keep = _route_args(scene, proxies, models, origin, direction, t_min,
                                      t_max, active, my_id, max_hits, eps, sort_rays,
                                      grouped)
    dev = origin.device
    weight = torch.empty((n,), dtype=torch.float32, device=dev)
    occluded = torch.empty((n,), dtype=torch.bool, device=dev)
    survives = torch.empty((n,), dtype=torch.bool, device=dev)
    rc = _lib().route_shadow(*args, _ptr(weight), _ptr(occluded), _ptr(survives),
                             _stream(origin))
    _check(rc, "route_shadow")
    if n:
        LAUNCHES["route_shadow"] += 1
        LAUNCHES["route_multigeo"] += int(models.multi_geo)
    return _in_order(dict(weight=weight, occluded_local=occluded, survives=survives), perm)


def _lib():
    lib = _build.load("route")
    if not getattr(lib, "_pg_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        common = ([p] * 5 + [i] + [p] * 5 + [i, i]      # rays, cluster tables
                  + [p, p, i]                           # group tables
                  + [p] * 8 + [i, i, i, f]              # proxy table, march
                  + [i] + [p] * 4 + [i] * 7)            # nets
        lib.route_secondary.argtypes = common + [p] * 6 + [p]
        lib.route_secondary.restype = i
        lib.route_shadow.argtypes = common + [p] * 3 + [p]
        lib.route_shadow.restype = i
        lib._pg_typed = True
    return lib


# --------------------------------------------------------------------------
# plain PyTorch versions

def _plain_nets(models, q):
    if models.multi_geo:
        args = (q.features, q.aabb_id, q.is_valid)
        return (apply_multigeo(models.vis_params, models.vis_cfg, *args),
                apply_multigeo(models.depth_params, models.depth_cfg, *args))
    return grouped_mlp_dense_plain(models, q.features, q.aabb_id, q.is_valid)


def route_fused_plain(scene, proxies, models, origin, direction, t_min, t_max,
                      active, my_id: int, max_hits: int, eps: float) -> dict:
    """Plain version of K7, secondary: the plain closest hit, march and nets,
    then the consumption block."""
    if not fused_route_takes(models, proxies, max_hits):
        raise ValueError(_REFUSAL)
    n = origin.shape[0]
    t_min = _expand(t_min, n, origin.device)
    t_max = _expand(t_max, n, origin.device)
    hits = resident_closest_plain(scene, origin, direction, t_min, t_max, active)
    local_hit = active & hits.is_hit
    local_t = torch.where(local_hit, hits.t, t_max)
    q = march_proxies_plain(proxies, origin, direction, local_t, active, my_id,
                            max_hits, eps)
    vis, depth = _plain_nets(models, q)
    return consume_secondary(q, vis, depth, active, local_hit, local_t, my_id, max_hits)


def shadow_route_fused_plain(scene, proxies, models, origin, direction, t_min,
                             t_max, active, my_id: int, max_hits: int,
                             eps: float) -> dict:
    """Plain version of K7, shadow: the plain any-hit, march and nets, then
    the occlusion blend."""
    if not fused_route_takes(models, proxies, max_hits):
        raise ValueError(_REFUSAL)
    n = origin.shape[0]
    t_min = _expand(t_min, n, origin.device)
    t_max = _expand(t_max, n, origin.device)
    occluded = active & resident_anyhit_plain(scene, origin, direction, t_min, t_max, active)
    survives = active & (~occluded)
    q = march_proxies_plain(proxies, origin, direction, t_max, survives, my_id,
                            max_hits, eps)
    vis, depth = _plain_nets(models, q)
    return dict(weight=consume_shadow(q, vis, depth, survives, max_hits),
                occluded_local=occluded, survives=survives)
