#!/usr/bin/env python3
"""The port's spans on the benchmark's rooms_p8 configuration, on one GPU.

    python scripts/span_report.py [--exact] [--reps 5]

Builds what `portbench/program.py` builds for it (its meshes and nets from
portbench/scenes.py) under a `Timing` recorder, so the
set-up splits into the scene-build spans (scene.partition, scene.bvh,
scene.clusters, scene.proxies) and the kernels' build or load
(kernels.load, in the warm frame). Then `utils/profile.py
render_device_profile` over its frames: for every span the host self ms a
frame (unprofiled frames under a recorder), the device ms and device
operations it launched innermost and the idle ms charged to it (one
profiled frame); the frame's wall ms without and with a recorder, and the
stage device ms. Prints one JSON line. Neural mode (the cell rooms_p8.neural)
unless --exact (rooms_p8.exact). The process runs one host thread on one
core, as a benchmark run does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--exact", action="store_true")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    # one host thread on one core, as a benchmark run (portbench/run.py)
    from portbench.run import current_core

    os.environ["OMP_NUM_THREADS"] = "1"
    os.sched_setaffinity(0, {current_core()})

    import torch

    torch.set_num_threads(1)

    from pg2024_dprt_tpu_torch.utils.profile import render_device_profile
    from pg2024_dprt_tpu_torch.utils.timing import Timing
    from portbench import manifest, scenes
    from portbench.program import Program

    if not torch.cuda.is_available():
        print("span_report: needs CUDA", file=sys.stderr)
        return 2
    config = manifest.cell(manifest.load_benchmark(ROOT), ROOT, "rooms_p8.neural")["config"]
    neural = not args.exact
    dev = torch.device("cuda")
    imports_s = time.perf_counter() - t_start
    setup = Timing()
    with setup.recording():
        t0 = time.perf_counter()
        meshes = scenes.scene_meshes(config["scene"])
        nets = scenes.proxy_nets(config["nets"], config["scene"]["partitions"], dev)
        inputs_s = time.perf_counter() - t0
        with setup.section("program"):
            program = Program(config, neural, meshes, nets, dev)
        with setup.section("warm frame"):
            program.frame(0)
            torch.cuda.synchronize()
    profile = render_device_profile(lambda b: program.frame(b)[0], top=12, reps=args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    out = {"config": config["name"], "neural": neural, "card": card,
           "setup": {"imports_s": imports_s, "inputs_s": inputs_s,
                     "total_s": {k: v for k, v in setup.totals.items()},
                     "self_s": setup.self_seconds()},
           **profile}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
