"""Camera path generation (counterpart of pg2024_dprt_tpu/render/pathgen.py):
one path per pixel with TEA-seeded sub-pixel jitter, throughput 1, tmax =
F32_MAX, in the tiled pixel order."""
from __future__ import annotations

import torch

from ..core.camera import Camera
from ..core.rng import rnd2, tea
from ..core.types import PathState

F32_MAX = 3.402823466e38


def tiled_pixel_order(width: int, height: int, block: int = 16, device=None) -> torch.Tensor:
    """Pixel ids in block-major (block x block) order (int64). Paths in this
    order give the tracer spatially coherent neighbours; accumulation is
    unaffected because paths carry their pixel_index, but the RNG seeds and
    the order of accumulation follow it, so it must match the JAX order."""
    ids = torch.arange(width * height, dtype=torch.int64, device=device)
    if width % block or height % block:
        return ids
    by, bx = ids // (width * block), ids % (width * block)
    blk, inner = bx // (block * block), bx % (block * block)
    rows = by * block + inner // block
    cols = blk * block + inner % block
    return rows * width + cols


def generate_camera_paths(camera: Camera, sample_count: int, tile_block: int = 16) -> PathState:
    """width*height camera paths for one sample (spp iteration)."""
    w, h = camera.width, camera.height
    n = w * h
    dev = camera.origin.device
    pixel_index = tiled_pixel_order(w, h, tile_block, device=dev)
    rows = pixel_index // w
    cols = pixel_index % w

    _, xi1, xi2 = rnd2(tea(pixel_index, int(sample_count)))
    origin, direction = camera.generate_rays(rows, cols, xi1, xi2)
    return PathState(
        origin=origin.contiguous(),
        direction=direction,
        tmax=torch.full((n,), F32_MAX, dtype=torch.float32, device=dev),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        pixel_index=pixel_index,
        shadow_path_id=torch.full((n,), -1, dtype=torch.int64, device=dev),
        is_shadow=torch.zeros((n,), dtype=torch.bool, device=dev),
        is_delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        is_valid=torch.ones((n,), dtype=torch.bool, device=dev),
    )
