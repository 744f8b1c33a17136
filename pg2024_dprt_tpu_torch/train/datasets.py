"""Dataset preparation for the proxy nets (counterpart of
pg2024_dprt_tpu/train/datasets.py; host numpy, so the same inputs and seeds
give the same arrays as the JAX module).

Datasets come from train.datagen (in-process ray casting) or from EXR pairs
as `export_exr_pair` writes them (the origin EXR carries the three position
features, the direction EXR [phi, theta, label]).
"""
from __future__ import annotations

import numpy as np

from ..utils.exr import read_exr, write_exr


def _balance_idx(depth_labels: np.ndarray, ratio: float, seed: int):
    """Shared row selection for the vis-balanced datasets: subsampled miss
    rows first, then all hit rows. Returns (idx, n_miss) so every consumer
    gathers features AND labels with the same index by construction."""
    miss = depth_labels == 1.0
    hit_idx = np.where(~miss)[0]
    miss_idx = np.where(miss)[0]
    rng = np.random.RandomState(seed)
    keep = rng.permutation(miss_idx.shape[0])[: int(hit_idx.shape[0] * ratio)]
    miss_idx = miss_idx[keep]
    return np.concatenate([miss_idx, hit_idx]), miss_idx.shape[0]


def balance_vis(features: np.ndarray, depth_labels: np.ndarray, ratio: float = 1.5, seed: int = 0):
    """Visibility dataset: binary hit labels, misses subsampled to
    ~ratio x hit count (the reference loader's balancing).
    Returns (features, vis_labels in {0,1})."""
    idx, n_miss = _balance_idx(depth_labels, ratio, seed)
    f = features[idx]
    vis = np.ones(idx.shape[0], np.float32)
    vis[:n_miss] = 0.0  # miss -> 0, hit -> 1 
    return f, vis


def depth_only(features: np.ndarray, depth_labels: np.ndarray):
    """Depth dataset: drop all misses."""
    hit = depth_labels != 1.0
    return features[hit], depth_labels[hit].astype(np.float32)


def combined_labels(features: np.ndarray, depth_labels: np.ndarray,
                    ratio: float = 1.5, seed: int = 0):
    """SEPARATEDNN=0 dataset: vis-balanced rows with 2-channel labels
    [binary hit, normalized depth] for the double-output net (the reference
    ships no combined training recipe — this composes its vis balancing with
    the depth target; the loss masks depth to hits, train/loop.py)."""
    idx, n_miss = _balance_idx(depth_labels, ratio, seed)
    f = features[idx]
    vis = np.ones(idx.shape[0], np.float32)
    vis[:n_miss] = 0.0
    y = np.stack([vis, depth_labels[idx].astype(np.float32)], axis=-1)
    return f, y


def split_train_test(features, labels, train_ratio: float = 0.8, seed: int = 0):
    """Shuffled 80/20 split."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(features.shape[0])
    features, labels = features[perm], labels[perm]
    k = int(features.shape[0] * train_ratio)
    return features[:k], labels[:k], features[k:], labels[k:]


def shuffle(features, labels, seed: int = 0):
    """Per-epoch reshuffle."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(features.shape[0])
    return features[perm], labels[perm]


def export_exr_pair(origin_path: str, direction_path: str, features: np.ndarray,
                    depth_labels: np.ndarray, width: int = 1024):
    """Write the reference's EXR dataset layout: origin EXR carries features
    0..2, direction EXR carries [feature3, feature4, label]."""
    n = features.shape[0]
    h = -(-n // width)
    pad = h * width - n

    def img(cols):
        a = np.concatenate([cols, np.ones((pad, 3), np.float32)], axis=0)
        return a.reshape(h, width, 3)

    write_exr(origin_path, img(features[:, 0:3]))
    dir_cols = np.stack(
        [features[:, 3], features[:, 4], depth_labels.astype(np.float32)], axis=-1
    )
    write_exr(direction_path, img(dir_cols))


def load_exr_pair(origin_path: str, direction_path: str):
    """Read an origin/direction EXR pair back into (features, depth_labels)."""
    o, names_o = read_exr(origin_path)
    d, names_d = read_exr(direction_path)

    def rgb(img, names):
        order = [names.index(c) for c in ("R", "G", "B")]
        return img[:, :, order].reshape(-1, 3)

    o = rgb(o, names_o)
    d = rgb(d, names_d)
    features = np.concatenate([o, d[:, 0:2]], axis=-1).astype(np.float32)
    return features, d[:, 2].astype(np.float32)


# the instance-id channel is the instance index over 4.0
INSTANCE_DIVISOR = 4.0


def multi_geo_features(features_list, labels_list,
                       divisor: float = INSTANCE_DIVISOR):
    """Combine per-object (N_i, 5) feature sets into one multi-geo
    (sum N_i, 6) set with instanceID/divisor appended as the 6th feature."""
    feats, labels = [], []
    for i, (f, l) in enumerate(zip(features_list, labels_list)):
        f = np.asarray(f, np.float32)
        iid = np.full((f.shape[0], 1), np.float32(i / divisor))
        feats.append(np.concatenate([f, iid], axis=1))
        labels.append(np.asarray(l, np.float32))
    return np.concatenate(feats, axis=0), np.concatenate(labels, axis=0)


def load_multi_datasets(origin_prefix: str, direction_prefix: str, size: int,
                        divisor: float = INSTANCE_DIVISOR):
    """The multi-geo dataset from files: per-instance origin/direction EXR
    pairs `<prefix><i>.exr` (export_exr_pair's layout, features already
    normalized to the box), instanceID/divisor as the 6th feature."""
    feats, labels = [], []
    for i in range(size):
        f, l = load_exr_pair(f"{origin_prefix}{i}.exr",
                             f"{direction_prefix}{i}.exr")
        feats.append(f)
        labels.append(l)
    return multi_geo_features(feats, labels, divisor=divisor)
