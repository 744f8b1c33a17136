"""Evaluation of trained proxy nets (counterpart of
pg2024_dprt_tpu/train/eval.py): the nets' predictions over a fixed test grid
as an EXR image, the visibility accuracy at a threshold and the depth L1
over true hits. The nets run where their params lie; results are numpy."""
from __future__ import annotations

import numpy as np
import torch

from ..models.mlp import MLPConfig, apply_mlp, apply_mlp_all
from ..utils.exr import write_exr


def _predict(fn, params, feats):
    dev = next(iter(params.values())).device
    with torch.no_grad():
        return fn(torch.as_tensor(np.asarray(feats, np.float32), device=dev)).cpu().numpy()


def prediction_grid(params, cfg: MLPConfig, width: int = 960, height: int = 540,
                    phi: float = 0.25, theta: float = 0.5):
    """The net over a (height x width) grid of entry points on the box's
    z = 0 face with one fixed direction. Returns (height, width) predictions."""
    ys, xs = np.meshgrid(
        np.linspace(0, 1, height, dtype=np.float32),
        np.linspace(0, 1, width, dtype=np.float32),
        indexing="ij",
    )
    feats = np.stack(
        [xs, ys, np.zeros_like(xs), np.full_like(xs, phi), np.full_like(xs, theta)],
        axis=-1,
    ).reshape(-1, 5)
    pred = _predict(lambda x: apply_mlp(params, x, cfg), params, feats)
    return pred.reshape(height, width)


def save_prediction_exr(path: str, params, cfg: MLPConfig, **kw):
    img = prediction_grid(params, cfg, **kw)
    write_exr(path, np.repeat(img[:, :, None], 3, axis=2))
    return img


def _accuracy(vis_pred, depth_pred, depth_labels, threshold):
    is_hit = depth_labels != 1.0
    vis_label = is_hit.astype(np.float32)
    vis_acc = ((vis_pred > threshold) == (vis_label > threshold)).mean()
    depth_l1 = (float(np.abs(depth_pred[is_hit] - depth_labels[is_hit]).mean())
                if is_hit.any() else 0.0)
    return {"vis_accuracy": float(vis_acc), "depth_l1": depth_l1,
            "hit_fraction": float(is_hit.mean())}


def depth_accuracy(vis_params, vis_cfg: MLPConfig, depth_params, depth_cfg: MLPConfig,
                   features: np.ndarray, depth_labels: np.ndarray, threshold: float = 0.5):
    """Visibility accuracy at `threshold` and the depth L1 over true hits of a
    separate vis / depth pair. Returns a dict of metrics."""
    vis_pred = _predict(lambda x: apply_mlp(vis_params, x, vis_cfg), vis_params, features)
    depth_pred = _predict(lambda x: apply_mlp(depth_params, x, depth_cfg), depth_params,
                          features)
    return _accuracy(vis_pred, depth_pred, depth_labels, threshold)


def combined_accuracy(params, cfg: MLPConfig, features: np.ndarray,
                      depth_labels: np.ndarray, threshold: float = 0.5):
    """depth_accuracy for a combined double-output net: one forward gives
    both channels (0 = vis, 1 = depth)."""
    pred = _predict(lambda x: apply_mlp_all(params, x, cfg), params, features)
    return _accuracy(pred[:, 0], pred[:, 1], depth_labels, threshold)
