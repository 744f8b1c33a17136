"""Run one cell of the port's benchmark once, and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`pg2024_dprt_tpu_torch`)
on a machine with an NVIDIA GPU. The run:

  1. set-up (`setup_s`, from the start of this module): imports, the
     configuration's scene inputs (its kind's) and nets made from its own
     seeds (scenes.py), the port's own build of its scene (host BVH,
     cluster tables, partitions),
     and one warm frame, which builds and loads the CUDA kernels;
  2. the window: frames back to back (a closed loop, spp 1 a frame), each
     at the next `base_sample` from a seed-derived start, each ending in a
     device synchronize, until `--seconds` have passed; with `--trace 1`
     under torch.profiler;
  3. after the window: no JAX module may be loaded; the peak device memory
     is read, the port's state freed, and the checked frames compared with
     the plain reference at pixels drawn from the seed, and in the neural
     cells also at pixels whose paths the nets decide (check.py);
  4. one JSON line on standard output, after the numbers compared and their
     limits on standard error. `--trace 0` reports the cell's end-to-end
     metrics, `--trace 1` its per-layer metrics, each by its reader in
     metrics/.

The configuration's scene is of a kind (`kinds/<kind>.py`, manifest.py),
which makes the scene's inputs, the port's build of them and the
reference's scene; an unknown kind fails the run before its set-up.

A cell whose configuration says `"ranks": N` runs as a world of N
processes instead, one partition and one card a rank (ranks.py).

The port's kernel builds stay in its checkout (`pg2024_dprt_tpu_torch/build/`);
any Triton or extension cache goes to `.portbench_cache/` there.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pg2024_dprt_tpu")
# the program's stage ranges (parallel/distributed.py, render/engine.py)
STAGES = ("neural_route", "migration", "settle_shade", "shadows", "fused_frame")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def current_core() -> int:
    """The core this process runs on (field 39 of /proc/self/stat), or the
    lowest of its affinity set where that cannot be read."""
    allowed = os.sched_getaffinity(0)
    try:
        with open("/proc/self/stat") as f:
            core = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, ValueError, IndexError):
        core = -1
    return core if core in allowed else min(allowed)


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"power_limit": "not read"}
    return {"power_limit": out.split(",")[-1].strip()}


def merged(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: str = ROOT, override: dict = None, start: float = None):
    """One run of cell `name`. Returns (result dict, lines of the numbers
    compared). `override` replaces entries of the configuration (the tests'
    small sizes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import manifest, scenes
    from .check import Reference, judge, plan
    from .program import Program
    from .trace import FRAME_RANGE, read_trace

    start = START if start is None else start
    bench = manifest.load_benchmark(root)
    c = manifest.cell(bench, root, name)
    config = merged(c["config"], override or {})
    traffic, limits = c["traffic"], c["limits"]
    neural = bool(traffic["neural"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    marks = [("imports", time.perf_counter())]
    inputs = scenes.scene_inputs(config["scene"], root)
    nets = (scenes.proxy_nets(config["nets"], config["scene"]["partitions"], dev)
            if "nets" in config else None)
    marks.append(("inputs", time.perf_counter()))
    program = Program(config, neural, inputs, nets, dev, root=root)
    marks.append(("scene build", time.perf_counter()))
    req = config["request"]
    npix = req["width"] * req["height"]
    first = int(seed) % (2 ** traffic["first_sample_bits"]) + 1
    program.frame(first - 1)
    sync()
    marks.append(("warm frame", time.perf_counter()))
    setup_s = marks[-1][1] - start
    parts = ", ".join(f"{n} {t - t_prev:.3f}" for (n, t), (_, t_prev)
                      in zip(marks, [("start", start)] + marks))
    print(f"portbench: set-up {setup_s:.3f} s ({parts})", file=sys.stderr)

    early, orders = plan(traffic["check"], seed, npix)
    frame_ms, stats, kept = [], [], {}
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if trace
            else contextlib.nullcontext())
    k = 0
    with prof:
        # the profiler's first kernel pays its start-up; not in the window
        torch.zeros(1, device=dev).add_(1.0)
        sync()
        t0 = time.perf_counter()
        while True:
            f0 = time.perf_counter()
            with record_function(FRAME_RANGE):
                img, st = program.frame(first + k)
            sync()
            f1 = time.perf_counter()
            frame_ms.append((f1 - f0) * 1e3)
            stats.append(st)
            if k == early:
                kept["early"] = (first + k, img)
            kept["last"] = (first + k, img)
            k += 1
            if f1 - t0 >= seconds:
                break
    window_s = f1 - t0
    bad_modules = forbidden_modules()
    if bad_modules:
        raise SystemExit(f"portbench: {', '.join(bad_modules)} loaded in the run")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = None
    if trace:
        r0 = time.perf_counter()
        tr = read_trace(prof, STAGES, window_s, k)
        print(f"portbench: trace of {len(tr.ops)} device operations read in "
              f"{time.perf_counter() - r0:.3f} s", file=sys.stderr)
    checked = [(sample, img.reshape(-1, 3).float().cpu())
               for sample, img in (kept.get("early", kept["last"]), kept["last"])]
    del program, kept, img
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the program's state is freed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ms = sorted(frame_ms)
    print(f"portbench: {k} frames in {window_s:.3f} s (ms min {ms[0]:.3f} median "
          f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}), peak {peak} B", file=sys.stderr)
    r0 = time.perf_counter()
    ref = Reference(config, neural, inputs, nets, dev, root=root)
    trace_log = [] if trace else None
    numbers, failed, found = judge(
        ref, [(sample, order) for (sample, _), order in zip(checked, orders)], traffic["check"],
        limits, lambda k, ids: checked[k][1][torch.as_tensor(ids, dtype=torch.int64)],
        trace_log)
    print(f"portbench: reference {time.perf_counter() - r0:.3f} s"
          + (f", net-decided pixels in the pool {found}" if found else ""), file=sys.stderr)

    ctx = SimpleNamespace(
        config=config, traffic=traffic, setup_s=setup_s, window_s=window_s, frames=k,
        frame_ms=frame_ms, samples_per_frame=npix * req["spp"], stats=stats, trace=tr,
        reference=ref, trace_log=trace_log, card=card() if cuda else {})
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    return finish(c, ctx, root, numbers, failed, device_info)


def finish(c: dict, ctx, root: str, numbers: dict, failed: int, device_info: dict,
           busy_s: float = None):
    """(result dict, lines of the numbers compared) of a run of cell `c`:
    its end-to-end metrics, or with a trace (`ctx.trace`) its per-layer
    metrics, each read from `ctx` by its reader; `correct` from the numbers
    against their limits; `device_info` with the card's power limit and,
    traced, `busy_s` (the trace's own by default) and the traced window."""
    from . import manifest

    tr = ctx.trace
    metrics = {}
    for m in (c["per_layer"] if tr is not None else c["end_to_end"]):
        value = manifest.metric(m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info["power_limit"] = ctx.card.get("power_limit", "not read")
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    result = {"correct": bool(correct), "attempted": ctx.frames, "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s if busy_s is None else busy_s,
                           window_s=tr.window_s)
        result["breakdown"] = tr.breakdown
    result["check"] = numbers
    lines = [f"check {key} {v['value']} limit {v['limit']}" for key, v in numbers.items()]
    return result, lines


def set_env() -> None:
    """One OpenMP thread a process, and any Triton or extension cache in
    `.portbench_cache/` of the checkout."""
    os.environ["OMP_NUM_THREADS"] = "1"
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))


def emit(result: dict, lines: list) -> int:
    """The end of a run: 4, and no result, where a JAX module is loaded;
    else the card, the numbers compared beside their limits on standard
    error, and the result line on standard output."""
    bad_modules = forbidden_modules()
    if bad_modules:
        print(f"portbench: {', '.join(bad_modules)} loaded in the run", file=sys.stderr)
        return 4
    dev = result["device"]
    print(f"portbench: card {dev['kind']}" + (f" x{dev['count']}" if dev["count"] > 1 else "")
          + f", power limit {dev['power_limit']}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from . import manifest

    c = manifest.cell(manifest.load_benchmark(ROOT), ROOT, args.workload)
    # an unknown scene kind fails here, before any set-up; its module, which
    # imports torch, loads after the pinning
    manifest.kind_file(c["config"]["scene"]["kind"], ROOT)
    set_env()
    if "ranks" in c["config"]:
        # a world of processes, one partition and one card a rank
        from . import ranks

        return ranks.main(args, c, time.monotonic() - (time.perf_counter() - START))
    # one process with one host thread on one core: the frames of the
    # partitioned cells are paced by the host, and a thread that moves
    # between the host's cores makes their times spread. The core is the
    # one the scheduler started the process on, from its own affinity set.
    os.sched_setaffinity(0, {current_core()})

    import torch

    torch.set_num_threads(1)
    try:
        import pg2024_dprt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is not in this checkout ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        print(f"portbench: {args.workload} needs {c['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    return emit(*run_cell(args.workload, args.seed, args.seconds, bool(args.trace)))


if __name__ == "__main__":
    sys.exit(main())
