"""The controls of a cell's check: the plain reference put in the program's
place, with one guarantee broken, read by the same numbers against the
float32 reference. A limit is sound only where a control fails it.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 \
        [--control bf16|fp8_nets|nets_off] [--device cuda]

  * `bf16`: the whole reference in bfloat16, the nearest precision below the
    configurations' float32;
  * `fp8_nets` (neural cells): the nets' operands in float8 e4m3, the
    nearest precision below the bfloat16 the configuration states for them,
    everything else in float32;
  * `nets_off` (neural cells): vis nets that predict no hit.

For each seed the frames and pixels are those a run of the cell with that
seed checks (its first frame and the one after, at the pixels drawn from the
seed), at the cell's own sizes. One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import manifest, scenes
from .check import Reference, judge, plan
from .reference.neural import fp8
from .run import ROOT, merged

CONTROLS = ("bf16", "fp8_nets", "nets_off")


def control_numbers(name: str, seed: int, device: str, control: str = "bf16", root: str = ROOT,
                    override: dict = None) -> dict:
    """The numbers of cell `name`'s check with `control` in the program's
    place."""
    c = manifest.cell(manifest.load_benchmark(root), root, name)
    config = merged(c["config"], override or {})
    neural = bool(c["traffic"]["neural"])
    inputs = scenes.scene_inputs(config["scene"], root)
    nets = (scenes.proxy_nets(config["nets"], config["scene"]["partitions"], device)
            if "nets" in config else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    req, check = config["request"], c["traffic"]["check"]
    early, orders = plan(check, seed, req["width"] * req["height"])
    first = int(seed) % (2 ** c["traffic"]["first_sample_bits"]) + 1
    t0 = time.perf_counter()
    full = Reference(config, neural, inputs, nets, device, root=root)
    if control == "bf16":
        low = Reference(config, neural, inputs, nets, device, dtype=torch.bfloat16, root=root)
    elif control == "fp8_nets":
        low = Reference(config, neural, inputs, nets, device, operand=fp8, root=root)
    elif control == "nets_off":
        vis = dict(nets["vis"], head_b1=nets["vis"]["head_b1"] - 1e3)
        low = Reference(config, neural, inputs, dict(nets, vis=vis), device, root=root)
    else:
        raise ValueError(f"unknown control {control!r}")
    frames = [(first + early, orders[0]), (first + early + 1, orders[1])]
    numbers, failed, found = judge(full, frames, check, c["limits"],
                                   lambda k, ids: low.pixels(frames[k][0], ids).cpu())
    return {"workload": name, "seed": seed, "control": control, "numbers": numbers,
            "frames_failed": failed, "net_decided_in_pool": found,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=CONTROLS, default="bf16")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_numbers(args.workload, seed, args.device, args.control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
