"""Run a cell whose configuration says `"ranks": N` as a world of N
processes: one partition a rank and one card a rank, the paper's deployment
(one MPI rank a GPU). Paths move between the cards through the port's
`RankMesh` over NCCL, and the image is summed with its `all_reduce`.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`run.py` hands such a cell here. The parent process:

  1. checks for N cores in its affinity set and spawns the ranks (a fresh
     interpreter each, the spawn method; each checks for its card), which
     meet through a rendezvous file in a temporary directory, not a port;
  2. waits for every rank's result until `DEADLINE_S` after its own start:
     a rank that raises, dies or is still running then fails the run, and
     every rank still alive is killed;
  3. once every rank has ended, compares every rank's checked frames with
     rank 0's bit for bit (`ranks.unequal_pixels`), and rank 0's with the
     plain reference on card 0 (check.py, as run.py does);
  4. prints the result line in run.py's shape (run.finish, run.emit):
     `count` N, the peak of the fullest card, the readers of metrics/ on
     rank 0's numbers.

The spawn loop (`run_world`) follows the port's `parallel/spawn.py`
`run_ranks`, but the harness keeps its own: importing that module loads
torch and the port in the parent before any rank starts, seconds that
would add to `setup_s` one after the other; the run's deadline counts
from the run's start, not from the spawn; each rank pins itself to its
core and runs the tests' `prepare` before it joins the world; and the
group's timeout outlasts rank 0's kernel build, which the other ranks
wait for at a barrier (the port's is 60 s).

Each rank:

  * pins itself to a core of its own (rank r to the r-th core of the
    parent's affinity set, counted from the parent's own core), and takes
    one torch thread and `cuda:<rank>`;
  * joins the world over NCCL (`make_rank_mesh`), with a gloo group beside
    it for the harness's own messages, so that none of them is a device
    operation in the trace;
  * makes the configuration's scene inputs (scenes.py, by its kind) and
    builds the scene as the port builds it for a rank (program.py): every
    partition on the host, then its own on its card;
  * rank 0 builds any stale kernel library first, and the others load
    them after a barrier, so that no two processes build into the port's
    build directory at once;
  * runs one warm frame: set-up (`setup_s`) ends when every rank's has,
    counted from the parent's start;
  * the window: frames back to back (spp 1, the next `base_sample`), each
    ending in a device synchronize; after each, rank 0 says over gloo
    whether `--seconds` have passed on its clock, so every rank runs the
    same frames. With `--trace 1` every rank profiles the window's first
    `TRACED_FRAMES` frames (the traced window), so that reading the traces
    stays well inside the run's time; the per-layer readers read rank 0's
    trace, and `busy_s` is the ranks' mean;
  * after the window: no JAX module may be loaded; the peak device memory
    is read; the checked frames go to the parent.
"""
from __future__ import annotations

import datetime
import gc
import multiprocessing
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

# seconds after the run's start by which every rank has reported; the
# parent then still runs the reference within the run's 360 s
DEADLINE_S = 330.0
# seconds a rank waits for the others at the rendezvous and at each
# collective before it fails
GROUP_TIMEOUT_S = 300
# seconds the other ranks get to report once one has failed
FAILURE_GRACE_S = 5.0
# frames a rank profiles with --trace 1: on an H100 host a profiled rank frame
# takes about 0.2 s, and stopping the profiler and reading its trace about
# 0.4 s more a frame
TRACED_FRAMES = 60
# the number compared between ranks, exactly (limit 0): checked pixels in
# which a rank's frame differs from rank 0's in any bit
UNEQUAL = "ranks.unequal_pixels"


def rank_cores(world: int) -> list:
    """One core a rank: the parent's affinity set in order, from the core
    the parent runs on."""
    from .run import current_core

    allowed = sorted(os.sched_getaffinity(0))
    at = allowed.index(current_core())
    cores = allowed[at:] + allowed[:at]
    if len(cores) < world:
        raise RuntimeError(f"{world} ranks need a core each; the affinity set holds "
                           f"{len(cores)}: {cores}")
    return cores[:world]


def _rank_main(rank: int, world: int, init: str, backend: str, core: int, job: dict, out):
    try:
        result = pickle.dumps(_rank(rank, world, init, backend, core, job))
    except Exception:
        # the parent reports it, and fails the run
        out.put((rank, traceback.format_exc(), None))
    else:
        out.put((rank, None, result))


def _rank(rank: int, world: int, init: str, backend: str, core: int, job: dict) -> dict:
    os.sched_setaffinity(0, {core})
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if job["prepare"] is not None:
        job["prepare"](rank)
    if job["device"] == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need a CUDA device each; "
                           f"{torch.cuda.device_count()} found")
    dev = torch.device("cuda", rank) if job["device"] == "cuda" else torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        ctl = dist.new_group(backend="gloo") if backend != "gloo" else None
        return _window(rank, world, dev, backend, ctl, job)
    finally:
        dist.destroy_process_group()


def _window(rank: int, world: int, dev, backend: str, ctl, job: dict) -> dict:
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    from pg2024_dprt_tpu_torch.parallel import make_rank_mesh

    from . import scenes
    from .check import plan
    from .program import Program
    from .run import STAGES, forbidden_modules
    from .trace import FRAME_RANGE, read_trace

    config, traffic = job["config"], job["traffic"]
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    # the rank's process started, imported torch and the port, and joined
    # the world
    marks = [("ranks up", time.monotonic())]
    mesh = make_rank_mesh(world, dev, backend=backend)
    inputs = scenes.scene_inputs(config["scene"])
    marks.append(("inputs", time.monotonic()))
    program = Program(config, False, inputs, None, dev, mesh=mesh)
    del inputs
    marks.append(("scene build", time.monotonic()))
    if cuda and rank == 0:
        from pg2024_dprt_tpu_torch.ops import _build

        _build.build()
    dist.barrier(group=ctl)
    marks.append(("kernels", time.monotonic()))
    req = config["request"]
    first = int(job["seed"]) % (2 ** traffic["first_sample_bits"]) + 1
    program.frame(first - 1)
    sync()
    dist.barrier(group=ctl)
    marks.append(("warm frame", time.monotonic()))

    early, _ = plan(traffic["check"], job["seed"], req["width"] * req["height"])
    frame_ms, stats, kept = [], [], {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts) if job["trace"] else None
    stop = torch.zeros(1, dtype=torch.int64)
    k, traced = 0, None
    if prof is not None:
        prof.start()
        # the profiler's first kernel pays its start-up; not in the window
        torch.zeros(1, device=dev).add_(1.0)
        sync()
    dist.barrier(group=ctl)
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
        # rank 0's clock decides, and every rank runs the same frames
        stop[0] = int(f1 - t0 >= job["seconds"])
        dist.broadcast(stop, src=0, group=ctl)
        if prof is not None and traced is None and (k == TRACED_FRAMES or stop.item()):
            # (frames, seconds) of the traced window
            traced = (k, f1 - t0)
            s0 = time.monotonic()
            prof.stop()
            stop_s = time.monotonic() - s0
        if stop.item():
            break
    window_s = f1 - t0
    bad_modules = forbidden_modules()
    if bad_modules:
        raise RuntimeError(f"{', '.join(bad_modules)} loaded in rank {rank}")
    out = {"peak": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0, "frames": k,
           "core": os.sched_getaffinity(0)}
    tr = None
    if prof is not None:
        r0 = time.monotonic()
        tr = read_trace(prof, STAGES, traced[1], traced[0])
        out["trace_s"] = (stop_s, time.monotonic() - r0)
    out["checked"] = [(sample, img.reshape(-1, 3).float().cpu())
                      for sample, img in (kept.get("early", kept["last"]), kept["last"])]
    out["busy_s"] = tr.busy_s if tr is not None else None
    if rank == 0:
        out.update(marks=marks, window_s=window_s, frame_ms=frame_ms, stats=stats, trace=tr,
                   kind=torch.cuda.get_device_name(dev) if cuda else dev.type)
    del program, kept, img
    gc.collect()
    out["done"] = time.monotonic()
    return out


def run_world(job: dict, world: int, backend: str, cores: list, deadline: float) -> list:
    """Every rank's result, in rank order, or RuntimeError naming the ranks
    that raised, died, or had not reported by `deadline` (time.monotonic)."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    results, failed = {}, {}
    with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, backend, cores[r], job, out))
                 for r in range(world)]
        end, grace = deadline, False
        try:
            for p in procs:
                p.start()
            # the parent's own import, for the check after the window,
            # overlaps the ranks' start-up
            import torch  # noqa: F401
            while len(results) + len(failed) < world:
                try:
                    rank, err, blob = out.get(timeout=max(0.0, min(1.0, end - time.monotonic())))
                    if err is None:
                        results[rank] = pickle.loads(blob)
                    else:
                        failed[rank] = err
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if p.exitcode not in (None, 0) and r not in results and r not in failed:
                            failed[r] = f"exited with code {p.exitcode} before it reported"
                if failed and not grace:
                    # the others get a moment to report: the failure that set
                    # off theirs names the cause
                    grace = True
                    end = min(end, time.monotonic() + FAILURE_GRACE_S)
                if time.monotonic() >= end:
                    for r in range(world):
                        if r not in results and r not in failed:
                            failed[r] = ("still running when another rank failed" if grace
                                         else "still running at the run's deadline")
            for r, p in enumerate(procs):
                if failed:
                    break
                p.join(timeout=max(0.0, end - time.monotonic()))
                if p.is_alive():
                    failed[r] = "did not exit by the run's deadline"
        finally:
            for p in procs:
                if p.pid is None:
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
            out.close()
            out.join_thread()
    if failed:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"rank {r}: {msg}" for r, msg in sorted(failed.items())))
    return [results[r] for r in range(world)]


def unequal_pixels(results: list) -> tuple:
    """(checked pixels, over every rank but 0 and every checked frame, that
    differ from rank 0's in any bit; the checked frames in which any did)."""
    import torch

    total, frames = 0, set()
    for res in results[1:]:
        for k, ((s0, a), (s, b)) in enumerate(zip(results[0]["checked"], res["checked"])):
            n = (a.shape[0] if s != s0 or a.shape != b.shape else
                 int((a.view(torch.int32) != b.view(torch.int32)).any(dim=1).sum()))
            total += n
            if n:
                frames.add(k)
    return total, frames


def run_ranks_cell(c: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
                   start: float = None, prepare=None, deadline_s: float = DEADLINE_S):
    """One run of the rank cell `c` (as manifest.cell gives it). Returns
    (result dict, lines of the numbers compared), as run.run_cell does.
    `start`: the run's start on time.monotonic (now, by default);
    `prepare(rank)`, a function importable by its module path, runs first
    in every rank (the tests break the timed path with it)."""
    from .run import ROOT, card, finish

    start = time.monotonic() if start is None else start
    config, traffic, limits = c["config"], c["traffic"], c["limits"]
    world = int(config["ranks"])
    if world != config["scene"]["partitions"]:
        raise ValueError(f"{world} ranks for {config['scene']['partitions']} partitions: "
                         f"one partition a rank")
    if world != c["chips"]:
        raise ValueError(f"{world} ranks on {c['chips']} chips: one card a rank")
    if traffic["neural"]:
        raise ValueError("the rank harness runs exact traffic only")
    cuda = device == "cuda"
    job = dict(config=config, traffic=traffic, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=device, prepare=prepare)
    # the parent imports nothing heavy before the ranks start
    results = run_world(job, world, "nccl" if cuda else "gloo", rank_cores(world),
                        start + deadline_s)
    import torch

    from . import scenes
    from .check import Reference, judge, plan

    r0 = results[0]
    marks = r0["marks"]
    setup_s = marks[-1][1] - start
    parts = ", ".join(f"{n} {t - t_prev:.3f}" for (n, t), (_, t_prev)
                      in zip(marks, [("start", start)] + marks))
    print(f"portbench: set-up {setup_s:.3f} s on rank 0 ({parts}); ranks on cores "
          f"{[sorted(r['core']) for r in results]}", file=sys.stderr)
    ms = sorted(r0["frame_ms"])
    print(f"portbench: {r0['frames']} frames in {r0['window_s']:.3f} s (ms min {ms[0]:.3f} "
          f"median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}), peaks "
          f"{[r['peak'] for r in results]} B; ranks done "
          f"{max(r['done'] for r in results) - start:.3f} s after the start", file=sys.stderr)
    if r0["trace"] is not None:
        print(f"portbench: traced window {r0['trace'].frames} frames in "
              f"{r0['trace'].window_s:.3f} s; each rank's profiler stop and trace read (s) "
              f"{[tuple(round(t, 3) for t in r['trace_s']) for r in results]}; rank 0's "
              f"trace holds {len(r0['trace'].ops)} device operations", file=sys.stderr)

    # every rank returns the whole image: each rank's checked frames are
    # rank 0's, bit for bit
    unequal, unequal_frames = unequal_pixels(results)
    # the reference, once the ranks have ended and freed their cards
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if cuda else torch.device(device)
    req = config["request"]
    npix = req["width"] * req["height"]
    _, orders = plan(traffic["check"], seed, npix)
    checked = r0["checked"]
    t_ref = time.perf_counter()
    ref = Reference(config, False, scenes.scene_inputs(config["scene"]), None, dev)
    numbers, failed, _ = judge(
        ref, [(sample, order) for (sample, _), order in zip(checked, orders)], traffic["check"],
        limits, lambda k, ids: checked[k][1][torch.as_tensor(ids, dtype=torch.int64)])
    print(f"portbench: reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    # an exact comparison: its limit is 0
    numbers[UNEQUAL] = {"value": unequal, "limit": 0}
    if unequal:
        # frames failed: at least those in which the ranks differ
        failed = max(failed, len(unequal_frames))

    ctx = SimpleNamespace(
        config=config, traffic=traffic, setup_s=setup_s, window_s=r0["window_s"],
        frames=r0["frames"], frame_ms=r0["frame_ms"], samples_per_frame=npix * req["spp"],
        stats=r0["stats"], trace=r0["trace"], reference=ref, trace_log=None,
        card=card() if cuda else {})
    device_info = {"platform": "gpu" if cuda else dev.type, "kind": r0["kind"], "count": world,
                   "memory_peak_bytes": max(r["peak"] for r in results)}
    busy_s = (sum(r["busy_s"] for r in results) / world if r0["trace"] is not None
              else None)
    return finish(c, ctx, ROOT, numbers, failed, device_info, busy_s)


def main(args, c: dict, start: float) -> int:
    """The command line's run of the rank cell `c` (`args` parsed by
    run.main; `start` the run's start on time.monotonic)."""
    from .run import emit

    # the ranks share one host: NCCL's bootstrap stays on its loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # each rank checks for its card and imports the port; a rank that finds
    # neither fails the run
    try:
        result, lines = run_ranks_cell(c, args.seed, args.seconds, bool(args.trace),
                                       start=start)
    except RuntimeError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 5
    return emit(result, lines)
