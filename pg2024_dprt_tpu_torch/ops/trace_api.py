"""Tracer selection: one closest-hit/occlusion API over three back ends
(counterpart of pg2024_dprt_tpu/ops/trace_api.py).

  * "resident"  - ops/resident.py: the hand-written CUDA kernels (K1/K2,
    K9/K10 on large scenes) for CUDA tensors, their plain PyTorch versions
    for CPU tensors;
  * "stackless" - ops/traversal.py: the lockstep threaded-BVH walk, plain
    PyTorch;
  * "cluster"   - ops/cluster_tracer.py: bulk cull, dispatch and block
    intersection, plain PyTorch;
  * "auto"      - resident on every device. (The JAX package's "auto" is
    stackless on its CPU backend and resident on an accelerator; the port
    decided in its first slice that "auto" means the kernels' contract on
    every device, so CPU runs exercise what the card runs.)

The streaming pair tracer (ops/tracer.py) is retired from this API, as in
JAX: its tile-interval cull misses corner-edge rays that its dropped-pair
count cannot see. "pallas" is rejected with that reason; the tracer stays
reachable through `_pairs_escalating`, its escalating entry. On instanced
scenes only the resident family traces (the other back ends would trace
the base geometry), so "stackless" and "cluster" raise ValueError there.

A scene's curves (scene.curves, round B-spline hair: scene/curves.py,
ops/curve_intersect.py) are merged into every back end's closest hit and
ORed into its occlusion, as in JAX (`_merge_curve_hits`).

Every entry point returns a `diag` count of rays whose result may still be
affected by tracer residue. The plain entry points return 0, as in JAX:
the resident and stackless back ends have no budget, and the cluster back
end's block budget is JAX's (`traverse_clusters(return_dropped=True)`
counts what it drops); the cutout entry points count the rays still on a
transparent hit after `max_hops` re-traces (a 0-dim tensor, so that counting
does not wait for the device).
"""
from __future__ import annotations

import torch

from ..scene.textures import sample_textures
from .cluster_tracer import occlusion_clusters, traverse_clusters
from .curve_intersect import intersect_curves, occlude_curves
from .resident import F32_MAX, trace_resident
from .tracer import REGION, trace_pairs
from .traversal import traverse_bvh

_TRACERS = ("stackless", "cluster", "resident")


def resolve_tracer(name: str, scene=None) -> str:
    if (name in ("stackless", "cluster") and scene is not None
            and getattr(scene, "cl_xf", None) is not None):
        # only the resident family has the per-cluster object-space transform
        raise ValueError(f"tracer {name!r} does not support instanced scenes; "
                         "use 'resident'")
    if name == "auto":
        return "resident"
    if name not in _TRACERS:
        raise ValueError(
            f"unknown tracer {name!r}; valid: {('auto',) + _TRACERS}. (The "
            "streaming pair tracer 'pallas' was retired: its tile-interval cull "
            "misses corner-edge rays - see ops/tracer.py.)")
    return name


def _pairs_escalating(scene, origin, direction, t_min, t_max, active,
                      any_hit: bool = False, region: int = REGION,
                      sort_rays: bool = True):
    """Pair trace that never silently force-misses: if the pair budget
    dropped any (tile, cluster) pair, re-trace the whole wavefront at 4x,
    then at 16x the budget. Returns (result, pairs still dropped); a residue
    after 16x is returned, never hidden."""
    for r in (region, region * 4, region * 16):
        res = trace_pairs(scene, origin, direction, t_min, t_max, active, region=r,
                          any_hit=any_hit, sort_rays=sort_rays)
        if res[1] == 0:
            break
    return res


def _merge_curve_hits(scene, origin, direction, t_min, t_max, active, res):
    """The triangle closest hit merged with the scene's curve primitives
    (scene.curves, round B-spline hair): a curve hit strictly nearer than
    the triangle hit wins, with tri_index = -2 - piece and u = v = 0;
    shading decodes it (render/shade.py surface_attributes)."""
    if scene.curves is None:
        return res
    hits, diag = res
    ch = intersect_curves(scene.curves, origin, direction, t_min, t_max, active,
                          with_normal=False)
    closer = ch.is_hit & ((~hits.is_hit) | (ch.t < hits.t))
    return hits._replace(
        t=torch.where(closer, ch.t, hits.t),
        tri_index=torch.where(closer, -2 - ch.piece, hits.tri_index),
        u=torch.where(closer, 0.0, hits.u),
        v=torch.where(closer, 0.0, hits.v),
        is_hit=hits.is_hit | closer), diag


def trace_closest_checked(scene, origin, direction, t_min, t_max, active,
                          tracer: str = "auto", sort_rays: bool = False):
    """Closest hit of the triangles and the scene's curves. Returns
    (HitRecord, diag). sort_rays applies to the resident kernels."""
    tracer = resolve_tracer(tracer, scene)
    if tracer == "stackless":
        res = traverse_bvh(scene, origin, direction, t_min, t_max, active), 0
    elif tracer == "cluster":
        res = traverse_clusters(scene, origin, direction, t_min, t_max, active), 0
    else:
        res = trace_resident(scene, origin, direction, t_min, t_max, active,
                             sort_rays=sort_rays)
    return _merge_curve_hits(scene, origin, direction, t_min, t_max, active, res)


def trace_occlusion_checked(scene, origin, direction, t_min, t_max, active,
                            tracer: str = "auto", sort_rays: bool = False):
    """Any-hit test of the triangles and the scene's curves. Returns ((N,)
    bool occluded, diag); the stackless back end answers it with its
    closest hit, as in JAX."""
    tracer = resolve_tracer(tracer, scene)
    if tracer == "stackless":
        occ, diag = traverse_bvh(scene, origin, direction, t_min, t_max, active).is_hit, 0
    elif tracer == "cluster":
        occ, diag = occlusion_clusters(scene, origin, direction, t_min, t_max, active), 0
    else:
        occ, diag = trace_resident(scene, origin, direction, t_min, t_max, active,
                                   any_hit=True, sort_rays=sort_rays)
    if scene.curves is not None:
        occ = occ | occlude_curves(scene.curves, origin, direction, t_min, t_max, active)
    return occ, diag


def trace_closest(scene, origin, direction, t_min, t_max, active, tracer: str = "auto"):
    """Closest hit of the triangles and the scene's curves; returns the
    HitRecord of trace_closest_checked."""
    return trace_closest_checked(scene, origin, direction, t_min, t_max, active, tracer)[0]


def trace_occlusion(scene, origin, direction, t_min, t_max, active, tracer: str = "auto"):
    """Any-hit test; returns the (N,) bool occluded flags of
    trace_occlusion_checked."""
    return trace_occlusion_checked(scene, origin, direction, t_min, t_max, active, tracer)[0]


def _hit_alpha(scene, hits):
    """Opacity at a hit (texture alpha channel); 1.0 where untextured. Only
    cutout scenes reach it, and instanced scenes have no textures, so the
    ids here are never virtual."""
    row = scene.tri_shade[hits.tri_index.clamp(min=0).long()]
    u = hits.u[:, None]
    v = hits.v[:, None]
    w = 1.0 - u - v
    tex = row[:, 19].to(torch.int32)
    uv = w * row[:, 9:11] + u * row[:, 11:13] + v * row[:, 13:15]
    rgba = sample_textures(scene.albedo_textures, tex, uv[:, 0], uv[:, 1])
    return torch.where(tex >= 0, rgba[:, 3], 1.0)


def trace_closest_cutout(scene, origin, direction, t_min, t_max, active,
                         tracer: str = "auto", max_hops: int = 4,
                         alpha_threshold: float = 0.05, sort_rays: bool = False):
    """Closest hit honoring cutout opacity (a hit with texture alpha below
    `alpha_threshold` is ignored), by re-tracing past transparent hits up to
    `max_hops` times. Scenes without a cutout texture take the closest-hit
    kernel directly.

    Returns (HitRecord, diag). Rays still on a transparent hit after
    `max_hops` re-traces report a miss and are counted in diag."""
    if not scene.has_cutout:
        return trace_closest_checked(scene, origin, direction, t_min, t_max,
                                     active, tracer, sort_rays)
    n = origin.shape[0]
    t_lo = torch.as_tensor(t_min, dtype=torch.float32, device=origin.device).expand(n)
    pending = active
    final = None
    diag = 0
    for _ in range(max_hops):
        hits, d = trace_closest_checked(scene, origin, direction, t_lo, t_max,
                                        pending, tracer, sort_rays)
        diag = diag + d
        # curve winners (tri_index <= -2) are opaque: the alpha gathered for
        # them is triangle 0's
        transparent = (hits.is_hit & (hits.tri_index >= 0)
                       & (_hit_alpha(scene, hits) < alpha_threshold))
        settled = pending & (~transparent)
        final = hits if final is None else type(hits)(*(
            torch.where(settled, h, f) for h, f in zip(hits, final)))
        t_lo = torch.where(transparent, hits.t + 1e-4, t_lo)
        pending = pending & transparent
    # residue: still transparent after max_hops -> miss, surfaced in diag
    final = final._replace(
        is_hit=final.is_hit & (~pending),
        tri_index=torch.where(pending, -1, final.tri_index),
        t=torch.where(pending, F32_MAX, final.t))
    return final, diag + pending.sum()


def trace_occlusion_cutout(scene, origin, direction, t_min, t_max, active,
                           tracer: str = "auto", max_hops: int = 4,
                           alpha_threshold: float = 0.05, sort_rays: bool = False):
    """Occlusion honoring cutout opacity: blocked only by opaque hits.
    Returns (occluded, diag). Scenes without a cutout texture take the
    any-hit kernel directly; a transparent occluder must be skipped, which
    needs to know where the hit was, so cutout scenes go through the
    closest-hit re-trace."""
    if not scene.has_cutout:
        return trace_occlusion_checked(scene, origin, direction, t_min, t_max,
                                       active, tracer, sort_rays)
    hits, diag = trace_closest_cutout(scene, origin, direction, t_min, t_max,
                                      active, tracer, max_hops, alpha_threshold,
                                      sort_rays)
    return hits.is_hit, diag
