"""Run a function on a world of ranks spawned on this host, one process a
rank, with a deadline: the way the tests (gloo on the CPU) and chip_smoke.py
(gloo ranks on one GPU, a one-rank NCCL world) drive RankMesh frames from
one parent process. On a cluster torchrun starts the ranks instead
(render/__main__.py).

    results = run_ranks(fn, world_size, args, workdir, backend="gloo")

Each rank starts from a fresh interpreter (the spawn method), sets one torch
thread (the ranks share the host's cores), joins the process group through
a rendezvous file in `workdir` (which must not exist yet; no port is taken),
calls `fn(*args)` and sends its return value to the parent by value (plain
pickle: CPU tensors and numpy arrays travel whole). `fn` must be importable
by its module path, and makes its own mesh (parallel/mesh.py
make_rank_mesh). A rank that raises, dies or is still running at the
deadline fails the whole world: every rank still alive is killed and
RuntimeError names the ranks and their tracebacks.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import time
import traceback

import torch.multiprocessing as mp

# seconds a rank waits for the others in init_process_group and in each
# collective before it fails
GROUP_TIMEOUT_S = 60
# seconds the other ranks get to report once one has failed
FAILURE_GRACE_S = 2.0


def _rank_main(rank: int, world_size: int, init_method: str, backend: str, fn, args, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            result = fn(*args)
        finally:
            # fn may end the group itself (the CLI under torchrun does)
            if dist.is_initialized():
                dist.destroy_process_group()
        out.put((rank, None, pickle.dumps(result)))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
        raise


def run_ranks(fn, world_size: int, args=(), workdir: str = ".", backend: str = "gloo",
              deadline_s: float = 300.0) -> list:
    """fn(*args) on `world_size` spawned ranks; returns their results in rank
    order, or raises RuntimeError when a rank fails or the deadline passes."""
    os.makedirs(workdir, exist_ok=True)
    rendezvous = os.path.join(os.path.abspath(workdir), "rendezvous")
    if os.path.exists(rendezvous):
        raise ValueError(f"{rendezvous} exists: a rendezvous file serves one world")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, f"file://{rendezvous}", backend, fn, args, out))
             for r in range(world_size)]
    end = time.monotonic() + deadline_s
    results, failed, grace = {}, {}, False
    try:
        for p in procs:
            p.start()
        while len(results) + len(failed) < world_size:
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
                # the other ranks get a moment to report (the failure that
                # set off theirs names the cause)
                grace = True
                end = min(end, time.monotonic() + FAILURE_GRACE_S)
            if time.monotonic() >= end:
                for r in range(world_size):
                    if r not in results and r not in failed:
                        failed[r] = ("still running when another rank failed" if grace
                                     else f"still running at the deadline of {deadline_s:g} s")
        for r, p in enumerate(procs):
            if failed:
                break
            p.join(timeout=max(0.0, end - time.monotonic()))
            if p.is_alive():
                failed[r] = f"did not exit by the deadline of {deadline_s:g} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    if failed:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"rank {r}: {msg}" for r, msg in sorted(failed.items())))
    return [results[r] for r in range(world_size)]
