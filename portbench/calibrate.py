"""Readings that set a configuration's sizes, kept so that they can be
taken again; the benchmark's runs do not use this module.

    python3 -m portbench.calibrate nets --workload rooms_p8.neural --seeds 1 2
    python3 -m portbench.calibrate build --workload soup_2m.frame --sizes 1048576 2097152

`nets`: renders one checked frame's pool of pixels with the reference at
the cell's sizes and reports, for the proxy queries of the secondary and
the shadow rays, the share whose ray really hits the queried partition's
triangles (what trained vis nets predict: the configuration's
`vis_hit_share` is set from it), the share the benchmark's nets predict as
hits, and the share of the pool's pixels whose path a net's predicted hit
decided.

`build`: at each size (the value of the scene kind's `SIZE` key: the
soup's `triangles`, the rooms' `tris_per_room`), the seconds of the scene's
inputs, of the port's scene build
(host BVH, clusters, partitions: set-up that every run pays), and of the
reference's trace of the check's pixels. One JSON line a reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import manifest, scenes
from .check import Reference, plan
from .run import ROOT, merged


def nets_reading(name: str, seed: int, device: str, root: str = ROOT,
                 override: dict = None) -> dict:
    c = manifest.cell(manifest.load_benchmark(root), root, name)
    config = merged(c["config"], override or {})
    inputs = scenes.scene_inputs(config["scene"], root)
    nets = scenes.proxy_nets(config["nets"], config["scene"]["partitions"], device)
    req, check = config["request"], c["traffic"]["check"]
    early, orders = plan(check, seed, req["width"] * req["height"])
    sample = int(seed) % (2 ** c["traffic"]["first_sample_bits"]) + 1 + early
    ref = Reference(config, True, inputs, nets, device, root=root)
    info = {}
    t0 = time.perf_counter()
    ref.pixels(sample, orders[0], info=info)
    out = {"workload": name, "seed": seed, "pool": len(orders[0]),
           "reference_s": time.perf_counter() - t0,
           "decided_share": float(info["decided"].float().mean())}
    for kind in ("secondary", "shadow"):
        logged = info.get(kind, [])
        vis = torch.cat([v for v, _ in logged]) if logged else torch.zeros(0)
        truth = torch.cat([t for _, t in logged]) if logged else torch.zeros(0, dtype=torch.bool)
        out[kind] = {"queries": int(vis.numel()),
                     "true_hit_share": float(truth.float().mean()) if vis.numel() else None,
                     "predicted_hit_share": float((vis > 0.5).float().mean()) if vis.numel()
                     else None}
    return out


def build_reading(name: str, size: int, device: str, root: str = ROOT) -> dict:
    from .program import Program

    c = manifest.cell(manifest.load_benchmark(root), root, name)
    key = manifest.kind(c["config"]["scene"]["kind"], root).SIZE
    config = merged(c["config"], {"scene": {key: int(size)}})
    neural = bool(c["traffic"]["neural"])
    t0 = time.perf_counter()
    inputs = scenes.scene_inputs(config["scene"], root)
    nets = (scenes.proxy_nets(config["nets"], config["scene"]["partitions"], device)
            if "nets" in config else None)
    t1 = time.perf_counter()
    program = Program(config, neural, inputs, nets, device, root=root)
    t2 = time.perf_counter()
    program.frame(0)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del program
    torch.cuda.empty_cache()
    req, check = config["request"], c["traffic"]["check"]
    _, orders = plan(check, 1, req["width"] * req["height"])
    ref = Reference(config, neural, inputs, nets, device, root=root)
    t4 = time.perf_counter()
    for order in orders:
        ref.pixels(1, order)
    torch.cuda.synchronize()
    return {"workload": name, key: int(size), "inputs_s": t1 - t0, "scene_build_s": t2 - t1,
            "first_frame_s": t3 - t2, "reference_s": time.perf_counter() - t4,
            "reference_pixels": sum(len(o) for o in orders),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("nets", "build"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[1])
    p.add_argument("--sizes", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.what == "nets":
        for seed in args.seeds:
            print(json.dumps(nets_reading(args.workload, seed, args.device)),
                  flush=True)
    else:
        for size in args.sizes:
            print(json.dumps(build_reading(args.workload, size, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
