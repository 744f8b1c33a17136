"""Training data of the proxy nets, by ray casting the real geometry
(counterpart of pg2024_dprt_tpu/train/datagen.py).

Rays are cast at one object: each sample is the nets' five input features
(the entry point normalized to the box, the direction's phi / 2pi and
theta / pi) and the label, the depth from the box entry to the real hit
normalized by the box diagonal (1.0 on a miss).

The rays are drawn from an explicit torch.Generator on the host and then
moved to the scene's device, so a seed gives the same rays on every device
(the JAX package draws them from jax.random: a different stream). The
labeller is the trace the renderer runs: on CUDA tensors the closest-hit
kernels of ops/resident.py (K1, or K9 from CLOSEST_GROUPED_MIN_CLUSTERS
clusters on, by `trace_grouped`); on CPU tensors the stackless walk ops/traversal.py
traverse_bvh, which the JAX module runs everywhere. Only t and the hit flag
enter a label, so two triangles tied at the same t give the same label.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import math as cmath
from ..ops.resident import trace_resident
from ..ops.traversal import traverse_bvh

# rays labelled per trace
BATCH = 65536
# the trace's t_max for a label ray
T_FAR = 3.4e38


def _sample_entry_rays(gen: torch.Generator, aabb_min, aabb_max, n: int):
    """n random rays that enter the box [aabb_min, aabb_max]: the origin on a
    random face, the direction toward a random interior point. Drawn on the
    host from `gen` (a CPU torch.Generator); returns (origin, direction),
    (n, 3) float32 CPU tensors."""
    lo = torch.as_tensor(np.asarray(aabb_min, np.float32))
    hi = torch.as_tensor(np.asarray(aabb_max, np.float32))
    span = hi - lo
    face = torch.randint(0, 6, (n,), generator=gen)
    uv = torch.rand((n, 3), generator=gen)
    p = lo + uv * span
    axis = face // 2
    side = (face % 2).to(torch.float32)
    face_coord = lo[None, :] + side[:, None] * span[None, :]
    p = torch.where(torch.arange(3)[None, :] == axis[:, None], face_coord, p)
    interior = lo + torch.rand((n, 3), generator=gen) * span
    return p, cmath.normalize(interior - p)


def trace_labels(scene, origin, direction, eps: float):
    """(t, is_hit) of the closest hits of (N,) rays from t = eps: the trace
    kernels on CUDA tensors, traverse_bvh on CPU tensors."""
    n = origin.shape[0]
    dev = origin.device
    t_max = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        hits = traverse_bvh(scene, origin, direction, eps, t_max, active)
    else:
        hits, _ = trace_resident(scene, origin, direction, eps, t_max, active)
    return hits.t, hits.is_hit


def label_rays(scene, origin, direction, aabb_min, aabb_max, eps: float = 1e-4):
    """Features (N, 5) and depth labels (N,) of rays that enter the box,
    traced on the scene's device: depth = t / |aabb_max - aabb_min| of the
    closest hit, capped at 1, and 1.0 on a miss."""
    dev = origin.device
    lo = torch.as_tensor(np.asarray(aabb_min, np.float32), device=dev)
    hi = torch.as_tensor(np.asarray(aabb_max, np.float32), device=dev)
    span = torch.clamp(hi - lo, min=1e-12)
    max_length = torch.linalg.vector_norm(hi - lo)
    t, is_hit = trace_labels(scene, origin, direction, eps)
    depth = torch.clamp(torch.where(is_hit, t / max_length, 1.0), max=1.0)
    local = (origin - lo) / span
    phi, theta = cmath.spherical_for_train(direction)
    feats = torch.cat([local, (phi / (2 * math.pi))[:, None], (theta / math.pi)[:, None]],
                      dim=-1)
    return feats, depth


def generate_proxy_dataset(scene, aabb_min, aabb_max, num_samples: int, seed: int = 0,
                           eps: float = 1e-4, batch: int = BATCH):
    """Cast num_samples rays at one partition's geometry, in batches of
    `batch`, on the scene's device. Returns numpy (features (N, 5) f32,
    depth labels (N,) f32 in [0, 1], 1.0 = miss)."""
    dev = scene.cl_boxes.device
    gen = torch.Generator().manual_seed(int(seed))
    feats_out, labels_out = [], []
    done = 0
    while done < num_samples:
        n = min(batch, num_samples - done)
        origin, direction = _sample_entry_rays(gen, aabb_min, aabb_max, n)
        feats, depth = label_rays(scene, origin.to(dev), direction.to(dev), aabb_min,
                                  aabb_max, eps)
        feats_out.append(feats)
        labels_out.append(depth)
        done += n
    return (torch.cat(feats_out).cpu().numpy(), torch.cat(labels_out).cpu().numpy())


def generate_multigeo_dataset(scenes, aabb_mins, aabb_maxs, num_samples: int,
                              seed: int = 0, eps: float = 1e-4):
    """The multi-geo (instance id) dataset: one generate_proxy_dataset per
    object (seed + 7919 i), combined into the six-feature layout of
    datasets.multi_geo_features. Returns (features (N, 6), depth labels (N,))."""
    from .datasets import multi_geo_features

    feats, labels = [], []
    for i, (sc, lo, hi) in enumerate(zip(scenes, aabb_mins, aabb_maxs)):
        f, lab = generate_proxy_dataset(sc, lo, hi, num_samples, seed=seed + 7919 * i, eps=eps)
        feats.append(f)
        labels.append(lab)
    return multi_geo_features(feats, labels)
