"""Albedo textures (counterpart of pg2024_dprt_tpu/scene/textures.py).

Textures live in ONE flat packed texel buffer at their native resolutions,
with per-texture offset/height/width tables, and are sampled with a
bilinear gather (wrap addressing, the v flip of the reference's image
loader). Textures larger than `max_res` are box-filtered down to it. The
alpha channel drives the cutout test (opacity < 0.05 -> the hit is ignored,
ops/trace_api.py).

Not carried over from the JAX package: the scanline `pool` / `pool_meta`
and their size limits. They exist so that a Pallas kernel can fetch a texel
with a one-hot matmul; a CUDA thread gathers from `texels` directly
(csrc/frame.cu texture_sample).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device

MAX_TEXTURE_RES = 2048


class PackedTextures(NamedTuple):
    """Flat texel pool + per-texture geometry tables."""

    texels: torch.Tensor       # (T, 4) f32 RGBA, row-major per texture
    offset: torch.Tensor       # (NT,) i32 start row in texels
    height: torch.Tensor       # (NT,) i32
    width: torch.Tensor        # (NT,) i32
    cutout_rows: torch.Tensor  # (NC,) i32 textures with any alpha < 0.05

    @property
    def count(self) -> int:
        return self.offset.shape[0]

    @property
    def has_cutout(self) -> bool:
        return self.cutout_rows.shape[0] > 0


def _box_down(img: np.ndarray, max_res: int) -> np.ndarray:
    """Integer box-filter an (H, W, C) image down until both dims <= max_res."""
    while img.shape[0] > max_res or img.shape[1] > max_res:
        h, w = img.shape[:2]
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        pad_h, pad_w = h2 * 2 - h, w2 * 2 - w
        if pad_h or pad_w:
            img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
        img = (
            img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2]
        ) * 0.25
    return img


def build_textures(images, max_res: int = MAX_TEXTURE_RES, device=None) -> PackedTextures:
    """Pack (H, W, 3|4) float arrays into a PackedTextures pool at native
    resolution (box-downsampled only past `max_res`; alpha defaults to 1) on
    `device` (CUDA unless the caller passes another)."""
    dev = resolve_device(device)
    rows, offs, hs, ws, cut = [], [], [], [], []
    pos = 0
    for i, img in enumerate(images or ()):
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[:, :, None].repeat(3, axis=2)
        img = _box_down(img, max_res)
        h, w = img.shape[:2]
        rgba = np.ones((h, w, 4), np.float32)
        rgba[:, :, : min(img.shape[2], 4)] = img[:, :, :4]
        if rgba[:, :, 3].min() < 0.05:
            cut.append(i)
        rows.append(rgba.reshape(h * w, 4))
        offs.append(pos)
        hs.append(h)
        ws.append(w)
        pos += h * w
    texels = np.concatenate(rows, axis=0) if rows else np.zeros((0, 4), np.float32)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    return PackedTextures(torch.as_tensor(texels, device=dev),
                          i32(offs), i32(hs), i32(ws), i32(cut))


def sample_textures(tex: PackedTextures, tex_index: torch.Tensor,
                    u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear wrap sample at native per-texture resolution. tex_index (N,)
    (entries < 0 are clamped to 0 — callers mask the result), u/v (N,) in
    texture space. Returns (N, 4) RGBA. Wrapping is an integer modulo."""
    ti = tex_index.clamp(min=0).long()
    h = tex.height[ti].long()
    w = tex.width[ti].long()
    off = tex.offset[ti].long()
    hf = h.to(torch.float32)
    wf = w.to(torch.float32)

    x = u * wf - 0.5
    y = (1.0 - v) * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    y1i = torch.remainder(y0i + 1, h)

    at = lambda yi, xi: tex.texels[off + yi * w + xi]
    return (
        at(y0i, x0i) * (1 - fx) * (1 - fy)
        + at(y0i, x1i) * fx * (1 - fy)
        + at(y1i, x0i) * (1 - fx) * fy
        + at(y1i, x1i) * fx * fy
    )


def checkerboard(res: int = 64, color_a=(0.9, 0.9, 0.9), color_b=(0.2, 0.2, 0.2),
                 tiles: int = 8) -> np.ndarray:
    """Procedural test texture, (res, res, 3) f32."""
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    mask = ((yy * tiles // res) + (xx * tiles // res)) % 2 == 0
    return np.where(mask[:, :, None], np.asarray(color_a, np.float32),
                    np.asarray(color_b, np.float32))
