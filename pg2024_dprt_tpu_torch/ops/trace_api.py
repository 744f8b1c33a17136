"""Tracer selection: one closest-hit/occlusion API (counterpart of
pg2024_dprt_tpu/ops/trace_api.py).

The port has one backend, "resident" (ops/resident.py): the hand-written
CUDA kernels for CUDA tensors, their plain PyTorch versions for CPU
tensors. "auto" means it on every device. The JAX package's "stackless" and
"cluster" backends are not ported yet and raise.

Every entry point returns a `diag` count of rays whose result may still be
affected by tracer residue; the resident tracer has no budget and no
cutout re-trace, so it is always 0.
"""
from __future__ import annotations

from .resident import trace_resident

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


def trace_closest_cutout(scene, origin, direction, t_min, t_max, active,
                         tracer: str = "auto", sort_rays: bool = False):
    """Closest hit honoring cutout opacity. The port's scenes carry no
    textures (device_scene_from_meshes refuses them), so no hit can be
    transparent and this is the plain closest hit."""
    return trace_closest_checked(scene, origin, direction, t_min, t_max,
                                 active, tracer, sort_rays)


def trace_occlusion_cutout(scene, origin, direction, t_min, t_max, active,
                           tracer: str = "auto", sort_rays: bool = False):
    """Occlusion honoring cutout opacity; untextured scenes take the
    any-hit kernel directly (see trace_closest_cutout)."""
    return trace_occlusion_checked(scene, origin, direction, t_min, t_max,
                                   active, tracer, sort_rays)
