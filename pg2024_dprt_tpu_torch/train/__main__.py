"""Training command line (counterpart of pg2024_dprt_tpu/train/__main__.py).

Examples:
  # a vis net on ray-cast data from an OBJ object, on the GPU
  python -m pg2024_dprt_tpu_torch.train --obj scene.obj --nn-type vis --epochs 100

  # a depth net from an origin/direction EXR pair, on the CPU
  python -m pg2024_dprt_tpu_torch.train --origin-exr o.exr --direction-exr d.exr \\
      --nn-type depth --width 256 --depth 4 --out ckpt/depth --device cpu

Writes `<out>-<nn-type>-loss=<test loss>-epochs=<epochs>.npz` under the JAX
package's names, which either package's loader reads.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core.device import resolve_device
from ..models.mlp import MLPConfig
from .datagen import generate_proxy_dataset
from .datasets import balance_vis, combined_labels, depth_only, load_exr_pair
from .loop import TrainConfig, fit, save_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pg2024_dprt_tpu_torch.train",
                                 description="Train a neural visibility/depth proxy")
    ap.add_argument("--obj", help="OBJ file: ray-cast its geometry for data")
    ap.add_argument("--origin-exr", help="origin EXR of a dataset pair")
    ap.add_argument("--direction-exr", help="direction EXR of a dataset pair")
    ap.add_argument("--nn-type", choices=["vis", "depth", "combined"], default="vis",
                    help="combined = one double-output net")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=12800)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--schedule", choices=["cosine", "plateau"], default="cosine")
    ap.add_argument("--samples", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=19990201)
    ap.add_argument("--out", default="checkpoints/proxy")
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.obj:
        from ..scene.geometry import device_scene_from_meshes
        from ..scene.obj import load_obj

        meshes, _ = load_obj(args.obj)
        scene = device_scene_from_meshes(meshes, device=dev)
        lo = np.min([m.aabb()[0] for m in meshes], axis=0)
        hi = np.max([m.aabb()[1] for m in meshes], axis=0)
        feats, depth_labels = generate_proxy_dataset(scene, lo, hi, args.samples,
                                                     seed=args.seed & 0xFFFF)
    elif args.origin_exr and args.direction_exr:
        feats, depth_labels = load_exr_pair(args.origin_exr, args.direction_exr)
    else:
        ap.error("provide --obj or --origin-exr/--direction-exr")

    if args.nn_type == "vis":
        x, y = balance_vis(feats, depth_labels)
    elif args.nn_type == "combined":
        x, y = combined_labels(feats, depth_labels)
    else:
        x, y = depth_only(feats, depth_labels)
    print(f"dataset: {x.shape[0]} samples ({args.nn_type})")

    mlp_cfg = MLPConfig(
        width=args.width, depth=args.depth,
        out_features=2 if args.nn_type == "combined" else 1,
        final_activation="sigmoid" if args.nn_type == "combined" else "leaky_relu")
    cfg = TrainConfig(nn_type=args.nn_type, epochs=args.epochs, batch=args.batch,
                      learn_rate=args.lr, schedule=args.schedule, seed=args.seed)
    params, hist = fit(x, y, mlp_cfg, cfg, verbose=True, device=dev)
    loss = hist["test_loss"][-1]
    path = f"{args.out}-{args.nn_type}-loss={loss:.6f}-epochs={args.epochs}"
    save_checkpoint(path, params)
    print(f"saved {path}.npz (final test loss {loss:.6f})")
    return path + ".npz", hist


if __name__ == "__main__":
    main(sys.argv[1:])
