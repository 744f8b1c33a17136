"""The proxy nets' training loop (counterpart of pg2024_dprt_tpu/train/loop.py).

The recipe is the JAX module's: Adam (b1 0.9, b2 0.999, eps 1e-8), lr 5e-4,
MSE for vis, L1 for depth, the hit-masked sum of both for the combined
double-output net, a warmup + cosine schedule or the reduce-on-plateau rule,
an 80/20 split, batches of min(batch, n) rows with the ragged tail dropped,
a reshuffle after every epoch, npz checkpoints under the JAX names (weights
stored (in, out)), so either package reads the other's files.

Training runs the plain forward of models/mlp.py under autograd, in FP32
(TF32 off on CUDA, as core/device.py sets it); the nets' kernels K5-K7 have
no backward, as in JAX. Adam is torch's fused one, which computes optax's
update; the rates are written out from optax's definitions, because torch's
schedulers and ReduceLROnPlateau are other state machines:
`warmup_cosine_schedule` is optax.warmup_cosine_decay_schedule
(the count starts at 0, so the first update uses lr 0; the decay steps
include the warmup; past them the rate stays at the end value), and
`ReduceOnPlateau` is optax.contrib.reduce_on_plateau at its defaults (rtol
1e-4, atol 0, cooldown 0, accumulation 1), evaluated on every step's train
loss and scaling Adam's update (here its learning rate).

`fit` is one loop on every device, in the order of JAX's host-driven loop
(loop.py `fit(device_loop=False)`): the dataset goes to the device once, a
step's loss and the plateau state stay there, and the losses are read at
each epoch's end. JAX's `_fit_device`, a workaround for a remote TPU's round
trips, has no counterpart: `device_loop` is accepted and both values run
this loop.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.mlp import (COMBINED_VISDEPTH, MLPConfig, PROD_DEPTH, PROD_VIS, apply_mlp,
                          apply_mlp_all, init_mlp)
from .datagen import generate_proxy_dataset
from .datasets import balance_vis, combined_labels, depth_only, split_train_test

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    nn_type: str = "vis"          # "vis" (MSE) | "depth" (L1) | "combined"
    batch: int = 12800
    learn_rate: float = 5e-4
    epochs: int = 50
    # "plateau": Adam scaled by the reduce-on-plateau rule; "cosine": warmup +
    # cosine decay (the default)
    schedule: str = "cosine"
    total_steps_hint: int = 0     # cosine horizon; 0 = epochs * steps/epoch
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    seed: int = 19990201
    checkpoint_every: int = 20
    checkpoint_dir: Optional[str] = None
    # epochs per program of JAX's device-resident loop; the port's one loop
    # does not read it
    epochs_per_call: int = 25


def _loss_fn(params, x, y, cfg: MLPConfig, nn_type: str):
    if nn_type == "combined":
        # MSE on the vis channel + L1 on the depth channel masked to hits
        # (y = [vis, depth])
        pred = apply_mlp_all(params, x, cfg)
        vis_loss = torch.mean((pred[:, 0] - y[:, 0]) ** 2)
        hit = (y[:, 0] > 0.5).to(torch.float32)
        depth_err = torch.abs(pred[:, 1] - y[:, 1]) * hit
        depth_loss = torch.sum(depth_err) / torch.clamp(torch.sum(hit), min=1.0)
        return vis_loss + depth_loss
    pred = apply_mlp(params, x, cfg)
    if nn_type == "vis":
        return torch.mean((pred - y) ** 2)
    return torch.mean(torch.abs(pred - y))


def eval_loss(params, x, y, mlp_cfg: MLPConfig, nn_type: str) -> torch.Tensor:
    with torch.no_grad():
        return _loss_fn(params, x, y, mlp_cfg, nn_type)


def warmup_cosine_schedule(init_value: float, peak_value: float, warmup_steps: int,
                           decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule written out: count -> rate. A
    linear ramp from init_value to peak_value over warmup_steps, then
    cosine decay to end_value over decay_steps - warmup_steps (decay_steps
    includes the warmup), then end_value."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class ReduceOnPlateau:
    """optax.contrib.reduce_on_plateau written out, on the device: after
    each value the scale drops by `factor` once `patience` values in a row
    failed to improve on the best by the relative tolerance. The state stays
    in 0-dim tensors, so updating it never waits for the device."""

    def __init__(self, factor: float = 0.1, patience: int = 10, rtol: float = 1e-4,
                 atol: float = 0.0, device=None):
        self.factor, self.patience, self.rtol, self.atol = factor, patience, rtol, atol
        self.scale = torch.ones((), dtype=torch.float32, device=device)
        self.best = torch.full((), float("inf"), dtype=torch.float32, device=device)
        self.plateau_count = torch.zeros((), dtype=torch.int32, device=device)

    def update(self, value: torch.Tensor) -> torch.Tensor:
        """Take one value (accumulation 1: the average is the value itself);
        returns the new scale."""
        value = value.detach().to(torch.float32)
        improved = value < (1.0 - self.rtol) * self.best - self.atol
        self.best = torch.where(improved, value, self.best)
        count = torch.where(improved, 0, self.plateau_count + 1).to(torch.int32)
        hit = count == self.patience
        self.plateau_count = torch.where(hit, 0, count).to(torch.int32)
        self.scale = torch.clamp(torch.where(hit, self.scale * self.factor, self.scale),
                                 min=0.0)
        return self.scale


class Optimizer:
    """optax.adam chained with the cosine schedule or the plateau scale, as
    `make_optimizer` builds it: torch's fused Adam (optax's update up to
    rounding: m/bc1 / (sqrt(v/bc2) + eps)) whose learning rate, a 0-dim
    tensor on the device, is set before each step to the schedule's rate at
    the step count, times the plateau scale where there is one (optax scales
    the update by it, which is the same product)."""

    def __init__(self, params, learn_rate, plateau: Optional[ReduceOnPlateau] = None,
                 device=None):
        self.adam = torch.optim.Adam(
            params, lr=torch.zeros((), dtype=torch.float32, device=device),
            betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS, fused=True)
        self.lr = self.adam.param_groups[0]["lr"]
        self.learn_rate = learn_rate if callable(learn_rate) else (lambda _c: learn_rate)
        self.plateau = plateau
        self.count = 0

    def step(self, loss: torch.Tensor):
        """One update of the params from their gradients and the step's
        loss; clears the gradients."""
        rate = self.learn_rate(self.count)
        if self.plateau is None:
            self.lr.fill_(rate)
        else:
            torch.mul(self.plateau.update(loss), rate, out=self.lr)
        self.adam.step()
        self.adam.zero_grad()
        self.count += 1


def make_optimizer(cfg: TrainConfig, total_steps: int = 10_000, params=None,
                   device=None) -> Optimizer:
    """The optimizer of `cfg` over `params` (a list of tensors): Adam with
    the warmup + cosine schedule (peak cfg.learn_rate, warmup
    min(200, total_steps // 10 + 1), horizon max(total_steps, 2), end
    learn_rate * 1e-3), or Adam at cfg.learn_rate scaled by the plateau
    rule."""
    params = list(params or [])
    if device is None:
        device = params[0].device if params else None
    if cfg.schedule == "cosine":
        sched = warmup_cosine_schedule(0.0, cfg.learn_rate, min(200, total_steps // 10 + 1),
                                       max(total_steps, 2), cfg.learn_rate * 1e-3)
        return Optimizer(params, sched, device=device)
    return Optimizer(params, cfg.learn_rate,
                     ReduceOnPlateau(cfg.plateau_factor, cfg.plateau_patience, device=device),
                     device=device)


def fit(features, labels, mlp_cfg: MLPConfig, cfg: TrainConfig, params=None,
        verbose: bool = False, device_loop: Optional[bool] = None, device=None):
    """Train one proxy net on (features, labels) (numpy). Returns (params
    dict of tensors on the device, history {"train_loss", "test_loss"}:
    the last batch's train loss and the loss on the first 4 x batch test rows,
    per epoch).

    Runs on `device` (CUDA unless the caller passes another). `params`
    (tensors or arrays under the JAX names) start the run; without them the
    nets start from init_mlp drawn from numpy's RandomState(cfg.seed) (JAX
    draws them from its PRNGKey(cfg.seed): another stream). `device_loop` is
    accepted for JAX's signature; both values run the one loop."""
    del device_loop
    dev = resolve_device(device)
    if params is None:
        params = init_mlp(np.random.RandomState(cfg.seed % 2**32), mlp_cfg, dev)
    params = {k: (v.detach().to(dev, torch.float32).clone() if torch.is_tensor(v)
                  else torch.as_tensor(np.array(v, np.float32), device=dev))
              for k, v in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    plist = list(params.values())

    train_x, train_y, test_x, test_y = split_train_test(features, labels,
                                                        seed=cfg.seed & 0xFFFF)
    n = train_x.shape[0]
    b = min(cfg.batch, n)
    steps_per_epoch = max(1, n // min(cfg.batch, max(n, 1)))
    total_steps = cfg.total_steps_hint or cfg.epochs * steps_per_epoch
    opt = make_optimizer(cfg, total_steps, plist, dev)

    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    x, y = f32(train_x), f32(train_y)
    ex, ey = f32(test_x[:4 * b]), f32(test_y[:4 * b])

    history = {"train_loss": [], "test_loss": []}
    for epoch in range(cfg.epochs):
        # the ragged tail is dropped, as in JAX's loop
        for i in range(0, n - b + 1, b):
            loss = _loss_fn(params, x[i:i + b], y[i:i + b], mlp_cfg, cfg.nn_type)
            loss.backward()
            opt.step(loss)
        loss = loss.detach()
        test_t = eval_loss(params, ex, ey, mlp_cfg, cfg.nn_type) if test_x.shape[0] else loss
        train, test = (float(v) for v in torch.stack([loss, test_t]).cpu())
        history["train_loss"].append(train)
        history["test_loss"].append(test)
        if verbose:
            print(f"epoch {epoch + 1}: train {train:.6f} test {test:.6f}", flush=True)
        if cfg.checkpoint_dir and epoch % cfg.checkpoint_every == 0:
            save_checkpoint(os.path.join(
                cfg.checkpoint_dir, f"{cfg.nn_type}-loss={test:.6f}-epochs={epoch}"), params)
        # datasets.shuffle's permutation, applied on the device
        perm = torch.as_tensor(np.random.RandomState(epoch).permutation(n), device=dev)
        x, y = x[perm], y[perm]
    return {k: v.detach() for k, v in params.items()}, history


def train_proxy_for_partition(scene, aabb_min, aabb_max, nn_type: str,
                              mlp_cfg: MLPConfig = None, train_cfg: TrainConfig = None,
                              num_samples: int = 200_000, seed: int = 0):
    """Ray-cast one partition's geometry, build its dataset and train its
    net, on the scene's device. Returns (params, history)."""
    if mlp_cfg is None:
        if nn_type == "combined":
            mlp_cfg = COMBINED_VISDEPTH
        else:
            mlp_cfg = PROD_VIS if nn_type == "vis" else PROD_DEPTH
    train_cfg = train_cfg or TrainConfig(nn_type=nn_type)
    feats, depth = generate_proxy_dataset(scene, aabb_min, aabb_max, num_samples, seed=seed)
    if nn_type == "vis":
        x, y = balance_vis(feats, depth)
    elif nn_type == "combined":
        x, y = combined_labels(feats, depth)
    else:
        x, y = depth_only(feats, depth)
    return fit(x, y, mlp_cfg, train_cfg, device=scene.cl_boxes.device)


def save_checkpoint(path: str, params):
    """`path`.npz: one array per param under the JAX names, weights (in, out)
    (JAX's load_checkpoint and scene/convert.py load_mlp_checkpoint read it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in params.items()}
    np.savez(path + ".npz", **flat)


def load_checkpoint(path: str, device=None):
    """The param dict of a flat .npz checkpoint, as tensors on `device`
    (CUDA unless given)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    dev = resolve_device(device)
    with np.load(path) as data:
        return {k: torch.as_tensor(data[k], device=dev) for k in data.files}
