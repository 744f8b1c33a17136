"""Grouped neural-proxy inference (counterpart of
pg2024_dprt_tpu/models/proxy.py).

Every object's params are stacked into one dict with leading dim O. The
functions here are the plain PyTorch engine, as in the JAX package, where
they run outside any kernel: `apply_grouped_reference` (O masked full-batch
passes, the oracle), `apply_grouped` / `apply_grouped_all` (one stable sort
groups the queries by object into block-aligned segments, then every layer is
one batched matmul with per-block weights) and `apply_multigeo` (one shared
net, the instance id as sixth input). The hand-written kernels for the
vis/depth pair are in ops/mlp.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mlp import (COMBINED_VISDEPTH, MLPConfig, PROD_DEPTH, PROD_VIS, apply_mlp,
                  bias_name, init_mlp, net_forward, rounded, stack_params)

# the instance id enters the multi-geo net as id / INSTANCE_DIVISOR (the
# training data's scaling)
INSTANCE_DIVISOR = 4.0


@dataclasses.dataclass(frozen=True)
class ProxyModels:
    """Stacked vis + depth nets for all O partition proxies (the same on
    every device).

    multi_geo: ONE net pair serves every object, with the instance id as the
    sixth input column; vis_params / depth_params are then single-net dicts
    (no leading O dim). combined: ONE double-output net per object
    (vis_cfg.out_features == 2, channel 0 = vis, 1 = depth); vis_params holds
    its stacked weights and depth_params is empty.

    `cache` holds what the kernel wrappers derive from the params (the
    packed bf16 copy of ops/mlp.py::packed_pair, stamped with the param
    tensors and their versions, so a replaced or in-place updated param
    repacks). It is not an argument: every new record, also one made by
    `dataclasses.replace` or `.to`, starts with an empty one."""

    vis_params: dict    # leaves (O, ...)
    depth_params: dict  # leaves (O, ...)
    num_objects: int = 0
    vis_cfg: MLPConfig = PROD_VIS
    depth_cfg: MLPConfig = PROD_DEPTH
    multi_geo: bool = False
    combined: bool = False
    cache: dict = dataclasses.field(default_factory=dict, init=False, compare=False,
                                    repr=False)

    def to(self, device) -> "ProxyModels":
        move = lambda d: {k: v.to(device) for k, v in d.items()}
        return dataclasses.replace(self, vis_params=move(self.vis_params),
                                   depth_params=move(self.depth_params))

    @property
    def device(self) -> torch.device:
        return next(iter(self.vis_params.values())).device


def _rng(seed_or_rng):
    return (np.random.RandomState(seed_or_rng) if isinstance(seed_or_rng, int)
            else seed_or_rng)


def random_proxy_models(rng, num_objects: int, vis_cfg: MLPConfig = PROD_VIS,
                        depth_cfg: MLPConfig = PROD_DEPTH, device=None) -> ProxyModels:
    """Random nets, a different draw per object and net, on `device` (CUDA
    unless given); `rng` is a seed, a numpy RandomState or a CPU
    torch.Generator."""
    rng = _rng(rng)
    vis = stack_params([init_mlp(rng, vis_cfg, device) for _ in range(num_objects)])
    depth = stack_params([init_mlp(rng, depth_cfg, device) for _ in range(num_objects)])
    return ProxyModels(vis, depth, num_objects, vis_cfg, depth_cfg)


def multigeo_proxy_models(vis_params: dict, depth_params: dict, num_objects: int,
                          vis_cfg: MLPConfig, depth_cfg: MLPConfig) -> ProxyModels:
    """Wrap one 6-feature net pair as the proxy model table for N objects."""
    for cfg in (vis_cfg, depth_cfg):
        if not cfg.multi_geo or cfg.in_features != 6:
            raise ValueError(f"multi-geo models need 6-feature multi-geo nets, got {cfg}")
    return ProxyModels(vis_params, depth_params, num_objects, vis_cfg, depth_cfg,
                       multi_geo=True)


def combined_proxy_models(stacked_params: dict, num_objects: int,
                          cfg: MLPConfig) -> ProxyModels:
    """Wrap stacked double-output nets as a combined model table."""
    if cfg.out_features != 2:
        raise ValueError("combined mode needs a 2-channel head")
    return ProxyModels(stacked_params, {}, num_objects, cfg, cfg, combined=True)


def random_combined_proxy_models(rng, num_objects: int, cfg: MLPConfig = None,
                                 device=None) -> ProxyModels:
    cfg = cfg or COMBINED_VISDEPTH
    rng = _rng(rng)
    nets = stack_params([init_mlp(rng, cfg, device) for _ in range(num_objects)])
    return combined_proxy_models(nets, num_objects, cfg)


def apply_multigeo(params: dict, cfg: MLPConfig, features, obj_id, valid,
                   compute_dtype=torch.bfloat16):
    """Multi-geo inference: append instance id / INSTANCE_DIVISOR as the 6th
    column and run the ONE shared net over the whole batch."""
    iid = (obj_id.clamp(min=0).to(torch.float32) / INSTANCE_DIVISOR)[:, None]
    x = torch.cat([features, iid], dim=-1)
    out = apply_mlp(params, x, cfg, compute_dtype=compute_dtype)
    return torch.where(valid, out, 0.0)


def apply_grouped_reference(stacked_params: dict, cfg: MLPConfig, features,
                            obj_id, valid, num_objects: int,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Oracle implementation: O masked full-batch passes (O x FLOPs)."""
    out = torch.zeros(features.shape[:-1], dtype=torch.float32, device=features.device)
    for o in range(num_objects):
        params_o = {k: v[o] for k, v in stacked_params.items()}
        pred = apply_mlp(params_o, features, cfg, compute_dtype=compute_dtype)
        out = torch.where((obj_id == o) & valid, pred, out)
    return out


def _dispatch(features, obj_id, valid, num_objects: int, block: int = 1024):
    """Grouped dispatch: one stable sort groups queries by object into
    block-aligned segments (budget Q + O * block always suffices, nothing is
    dropped). Returns (x (budget, F) scattered features, block_obj (NB,)
    per-block object id, slot (Q,) sorted query -> x row (budget for
    invalid), perm (Q,) sort permutation, budget, NB, BQ)."""
    q = features.shape[0]
    dev = features.device
    o_count = num_objects
    bq = min(block, max(q, 8))

    key = torch.where(valid, obj_id.to(torch.int64), o_count)
    sorted_key, perm = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=o_count + 1)[:o_count]
    region = bq * -(-counts // bq)                       # per-object, aligned
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    offsets = torch.cat([zero, torch.cumsum(region, 0)[:-1]])
    budget = q + o_count * bq - (q % bq if q % bq else 0)
    budget = bq * -(-budget // bq)
    nb = budget // bq

    # slot of each sorted query: object segment start + rank within object
    seg_start = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])
    srt_obj = sorted_key.clamp(max=o_count - 1)
    rank = torch.arange(q, dtype=torch.int64, device=dev) - seg_start[srt_obj]
    slot = torch.where(sorted_key < o_count, offsets[srt_obj] + rank, budget)

    x = torch.zeros((budget + 1, features.shape[1]), dtype=features.dtype, device=dev)
    x[slot] = features[perm]
    x = x[:budget]

    ends = offsets + region
    starts = torch.arange(nb, dtype=torch.int64, device=dev) * bq
    block_obj = (ends[None, :] <= starts[:, None]).sum(dim=-1).clamp(max=o_count - 1)
    return x, block_obj, slot, perm, budget, nb, bq


def apply_grouped_all(stacked_params: dict, cfg: MLPConfig, features, obj_id,
                      valid, num_objects: int, compute_dtype=torch.bfloat16,
                      block: int = 1024) -> torch.Tensor:
    """Grouped inference keeping every head channel: (Q, out_features), zero
    where `valid` is false. After the dispatch every layer is ONE batched
    matmul over (num_blocks, block, width) with each block's own weights."""
    q = features.shape[0]
    x, block_obj, slot, perm, budget, nb, bq = _dispatch(
        features, obj_id, valid, num_objects, block)
    x = x.reshape(nb, bq, features.shape[1])

    def dot(h, wname, out_w):
        w = rounded(stacked_params[wname][block_obj], compute_dtype)   # (NB, in, out)
        b = stacked_params[bias_name(wname)][block_obj].to(torch.float32)
        return torch.bmm(rounded(h, compute_dtype), w) + b[:, None, :]

    pred = net_forward(x, dot, cfg, cfg.final_activation)   # (NB, BQ, C)
    c = pred.shape[-1]
    # unscatter: sorted query i lives at slot[i] (invalid -> the zero row)
    pred_flat = torch.cat([pred.reshape(-1, c),
                           torch.zeros((1, c), dtype=pred.dtype, device=pred.device)])
    out = torch.zeros((q, c), dtype=torch.float32, device=features.device)
    out[perm] = pred_flat[slot]
    return torch.where(valid[:, None], out, 0.0)


def apply_grouped(stacked_params: dict, cfg: MLPConfig, features, obj_id, valid,
                  num_objects: int, compute_dtype=torch.bfloat16,
                  block: int = 1024) -> torch.Tensor:
    """Grouped inference, channel 0: (Q,), zero where `valid` is false."""
    return apply_grouped_all(stacked_params, cfg, features, obj_id, valid,
                             num_objects, compute_dtype, block)[:, 0]
