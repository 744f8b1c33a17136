"""The frame-sequence loop (counterpart of pg2024_dprt_tpu/render/frames.py):
the reference renderer's launch loop of per-frame animation, spp
accumulation, timing sections and EXR output."""
from __future__ import annotations

import os
from typing import Optional

from ..utils.exr import write_exr
from ..utils.timing import TimedSection, Timing
from .animation import animate_lights, dolly_camera
from .config import RenderConfig
from .engine import render_image


def render_frames(scene, lights, env, camera, cfg: RenderConfig, num_frames: int = 1,
                  out_dir: Optional[str] = None, light_velocity=None, camera_velocity=None,
                  timing: Optional[Timing] = None, distributed=None, device=None):
    """Render `num_frames` frames; returns a list of (H, W, 3) numpy images,
    and writes `frame{i}.exr` into out_dir when given. `distributed` =
    (partitioned scene, models, mesh) renders through the partitions
    (parallel/distributed.py) on the mesh's device; else render_image on
    `device` (CUDA unless given)."""
    timing = timing or Timing()
    images = []
    for frame in range(num_frames):
        f_lights = animate_lights(lights, frame, light_velocity) if light_velocity else lights
        f_camera = dolly_camera(camera, frame, camera_velocity) if camera_velocity else camera
        with timing.section(TimedSection.Sample):
            if distributed is not None:
                from ..parallel.distributed import render_image_distributed

                partitioned, models, mesh = distributed
                img = render_image_distributed(partitioned, models, f_lights, env, f_camera,
                                               cfg, mesh, base_sample=frame * cfg.spp)
            else:
                img = render_image(scene, f_lights, env, f_camera, cfg,
                                   base_sample=frame * cfg.spp, device=device)
            img_np = img.cpu().numpy()
        images.append(img_np)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            write_exr(os.path.join(out_dir, f"frame{frame}.exr"), img_np)
    return images
