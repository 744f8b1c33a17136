"""Single-device render loop (counterpart of
pg2024_dprt_tpu/render/engine.py): frame -> spp -> bounces.

Two paths render a frame, chosen by `cfg.fused_frame` (`_fused_active`):

  * the fused frame (ops/frame.py): all spp of the frame in ONE launch of
    the frame kernel; the default on CUDA tensors for every scene its gate
    accepts;
  * the composed path, a plain Python loop. Per bounce:
      1. closest hit of every live path by the configured tracer
         (ops/trace_api.py: K1, or K9 on large scenes, for "auto"; the
         stackless or cluster back end when named), with the cutout
         re-trace for scenes with cutout textures;
      2. shade: env on miss, BSDF sample, next paths + NEE shadow paths;
      3. any-hit of the shadow paths (K2 / K10 for "auto"); unoccluded ones add their
         contribution / shadow_path_count to the direct image.

Each composed stage runs under a `torch.profiler.record_function` range
("camera_paths", "closest_trace", "shade", "shadow_trace", "accumulate"),
and the fused frame under "fused_frame", so one profiled frame attributes
device time to the stages (utils/profile.py); without a profiler the ranges
do nothing.

The composed path accumulates with `index_add_`, which on CUDA adds with
atomics: the order of the adds, and so the last bits of a pixel that several
paths reach in one bounce, changes from run to run. The fused frame has one
owner per pixel and is deterministic.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..core.camera import Camera
from ..core.device import resolve_device
from ..ops.trace_api import trace_closest_cutout as trace_closest
from ..ops.trace_api import trace_occlusion_cutout as trace_occlusion
from .config import RenderConfig
from .pathgen import generate_camera_paths
from .shade import shade


def _fused_active(scene, lights, env, cfg: RenderConfig) -> bool:
    """Whether the frame goes through the fused frame (ops/frame.py), as the
    JAX engine decides it: "on" always (the plain version for CPU tensors,
    as interpret mode there); "auto" when the tensors are on CUDA, the
    tracer selection is the resident family and the gate accepts the scene;
    "off" never."""
    from ..ops.frame import fused_frame_supported

    if cfg.fused_frame not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_frame {cfg.fused_frame!r}")
    return cfg.fused_frame == "on" or (
        cfg.fused_frame == "auto"
        and scene.cl_mt_table.is_cuda
        and cfg.tracer in ("auto", "resident")
        and fused_frame_supported(scene, lights, env, cfg))


def render_sample(scene, lights, env, camera: Camera, sample_count: int,
                  cfg: RenderConfig):
    """One spp: returns (direct_image, env_image, diag) — the images are
    (npix, 3) accumulators; diag counts rays whose result may be affected by
    tracer residue (the cutout re-trace's; 0 otherwise)."""
    if _fused_active(scene, lights, env, cfg):
        from ..ops.frame import render_sample_fused

        with record_function("fused_frame"):
            return render_sample_fused(scene, lights, env, camera, sample_count, cfg)
    npix = cfg.frame_buffer_size
    dev = camera.origin.device
    with record_function("camera_paths"):
        paths = generate_camera_paths(camera, sample_count)
    direct = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    env_img = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    diag = 0
    # path-traced wavefronts keep pixel order at every bounce: neighbouring
    # paths stay spatially coherent, so no sort (sort_rays=False)
    for bounce in range(cfg.bounces):
        rr = bool(cfg.russian_roulette) and \
            cfg.russian_roulette <= bounce + 1 < cfg.bounces
        with record_function("closest_trace"):
            hits, d1 = trace_closest(scene, paths.origin, paths.direction,
                                     cfg.t_epsilon, paths.tmax, paths.is_valid,
                                     tracer=cfg.tracer)
        with record_function("shade"):
            next_paths, shadow, env_add = shade(
                scene, lights, env, paths, hits, sample_count, bounce,
                cfg.shadow_path_count, npix, nee_mode=cfg.nee_mode, rr=rr)
            env_img += env_add
        # tmax is shaved so the light sample point never blocks itself
        with record_function("shadow_trace"):
            occluded, d2 = trace_occlusion(scene, shadow.origin, shadow.direction,
                                           cfg.t_epsilon, shadow.tmax * (1.0 - 1e-3),
                                           shadow.is_valid, tracer=cfg.tracer)
        with record_function("accumulate"):
            unoccluded = shadow.is_valid & (~occluded)
            contrib = torch.where(unoccluded[:, None],
                                  shadow.throughput / cfg.shadow_path_count, 0.0)
            direct.index_add_(0, shadow.pixel_index, contrib)
        diag += d1 + d2
        paths = next_paths
    return direct, env_img, diag


def _on(device, record):
    """Move a record's tensors to `device` (no copy when already there),
    nested records (the scene's textures) included."""
    move = lambda x: (x.to(device) if torch.is_tensor(x)
                      else _on(device, x) if isinstance(x, tuple) else x)
    if dataclasses.is_dataclass(record):
        return dataclasses.replace(record, **{
            f.name: move(getattr(record, f.name)) for f in dataclasses.fields(record)})
    return type(record)(*map(move, record))


def render_image(scene, lights, env, camera, cfg: RenderConfig, base_sample: int = 0,
                 return_stats: bool = False, device=None):
    """Full frame: the average over spp. Returns (height, width, 3) float32,
    or (image, {"tracer_diag": int}) with return_stats. Runs on `device`
    (CUDA unless the caller passes another); the inputs are moved there.

    On the fused path all spp run in ONE kernel launch."""
    dev = resolve_device(device)
    scene, lights, env, camera = (_on(dev, r) for r in (scene, lights, env, camera))
    npix = cfg.frame_buffer_size
    if _fused_active(scene, lights, env, cfg):
        from ..ops.frame import render_frame_fused

        with record_function("fused_frame"):
            direct, env_img, diag = render_frame_fused(
                scene, lights, env, camera, base_sample, cfg, spp=cfg.spp)
    else:
        direct = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        env_img = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        diag = 0
        for s in range(cfg.spp):
            d, e, dg = render_sample(scene, lights, env, camera, base_sample + s, cfg)
            direct += d
            env_img += e
            diag += dg
    img = ((direct + env_img) / cfg.spp).reshape(cfg.height, cfg.width, 3)
    if return_stats:
        return img, {"tracer_diag": int(diag)}
    return img


class Renderer:
    """Scene + lights + env + camera + config on one device."""

    def __init__(self, scene, lights, env, camera: Camera, cfg: RenderConfig,
                 device=None):
        self.device = resolve_device(device)
        self.scene, self.lights, self.env, self.camera = (
            _on(self.device, r) for r in (scene, lights, env, camera))
        self.cfg = cfg

    def render(self, base_sample: int = 0):
        return render_image(self.scene, self.lights, self.env, self.camera,
                            self.cfg, base_sample, device=self.device)
