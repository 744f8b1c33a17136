"""Tracer selection: one closest-hit/occlusion API (counterpart of
pg2024_dprt_tpu/ops/trace_api.py).

The port has one backend, "resident" (ops/resident.py): the hand-written
CUDA kernels for CUDA tensors, their plain PyTorch versions for CPU
tensors. "auto" means it on every device. The JAX package's "stackless" and
"cluster" backends are not ported yet and raise.

Every entry point returns a `diag` count of rays whose result may still be
affected by tracer residue. The resident tracer has no budget, so the plain
entry points return 0; the cutout entry points count the rays still on a
transparent hit after `max_hops` re-traces (a 0-dim tensor, so that counting
does not wait for the device).
"""
from __future__ import annotations

import torch

from ..scene.textures import sample_textures
from .resident import F32_MAX, trace_resident

_NOT_PORTED = ("stackless", "cluster")


def resolve_tracer(name: str, scene=None) -> str:
    if name in ("auto", "resident"):
        return "resident"
    if name in _NOT_PORTED:
        raise NotImplementedError(f"tracer {name!r} is not ported yet; use 'resident'")
    raise ValueError(f"unknown tracer {name!r}; valid: ('auto', 'resident')")


def trace_closest_checked(scene, origin, direction, t_min, t_max, active,
                          tracer: str = "auto", sort_rays: bool = False):
    """Closest hit. Returns (HitRecord, diag)."""
    resolve_tracer(tracer, scene)
    return trace_resident(scene, origin, direction, t_min, t_max, active,
                          sort_rays=sort_rays)


def trace_occlusion_checked(scene, origin, direction, t_min, t_max, active,
                            tracer: str = "auto", sort_rays: bool = False):
    """Any-hit test. Returns ((N,) bool occluded, diag)."""
    resolve_tracer(tracer, scene)
    return trace_resident(scene, origin, direction, t_min, t_max, active,
                          any_hit=True, sort_rays=sort_rays)


def _hit_alpha(scene, hits):
    """Opacity at a hit (texture alpha channel); 1.0 where untextured."""
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
        transparent = hits.is_hit & (_hit_alpha(scene, hits) < alpha_threshold)
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
