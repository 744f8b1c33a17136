"""The rank harness (ranks.py) at a tiny size on the CPU: a gloo world of
four spawned ranks runs a rank cell as the cards' NCCL world does, one
partition a rank. BENCHMARK.json holds no rank cell yet, so the tests make
one: `DEPLOYMENT`, four rooms of `rooms_p8`, under the exact mix and the
limits, metrics and readers of `rooms_p8.exact`. Its run agrees with the
plain reference, every rank's frames equal rank 0's, and the frames equal
the in-process frame; a run with the timed path broken in the ranks is not
correct, once for each fault the cell can have; a rank that raises or
hangs fails the run by its deadline; the command line refuses the cell on
a host without its four cards. On a host with four cards the last tests run
the deployment at its full size over NCCL
(`python -m pytest portbench/tests/test_portbench_ranks.py -k four_cards`).

The faults reach the ranks through `prepare`: a function of this module,
which each spawned rank imports by name and calls with its rank before it
builds anything.
"""
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import manifest, scenes
from portbench.program import Program
from portbench.ranks import UNEQUAL, rank_cores, run_ranks_cell, run_world, unequal_pixels
from portbench.run import ROOT, current_core, merged

CELL = "rooms_p4.ranks"
# the one-process cell whose mix, limits and metrics the rank cell takes
EXACT = "rooms_p8.exact"
# four rooms of rooms_p8's, one partition a rank and a card: its request,
# light and sky, and its camera moved along x to the four rooms' centre
DEPLOYMENT = {"ranks": 4, "scene": {"rooms": 4, "partitions": 4},
              "camera": {"eye": [4.25, 1.4, 6.0], "target": [4.25, 0.8, 0.5]}}
SEED = 3_000_000_019
TINY = {"request": {"width": 24, "height": 16}, "scene": {"tris_per_room": 3000}}
# the check's pixels at the tiny size: a uniform 96 of each frame
TINY_CHECK = {"pixels": 96}


def rank_cell(override=None, check=None) -> dict:
    """The rank cell, as manifest.cell gives a cell: `DEPLOYMENT` over
    `override`, the check's parameters over `check`."""
    c = manifest.cell(manifest.load_benchmark(ROOT), ROOT, EXACT)
    base = {k: c["config"][k] for k in ("scene", "lights", "sky", "camera", "request")}
    traffic = dict(c["traffic"], check=dict(c["traffic"]["check"], **(check or {})))
    return dict(c, entry=dict(c["entry"], name=CELL, chips=4), name=CELL, chips=4,
                config=merged(merged(base, DEPLOYMENT), override or {}), traffic=traffic)


def run(prepare=None, trace=False, deadline_s=120.0):
    torch.set_num_threads(1)
    return run_ranks_cell(rank_cell(TINY, TINY_CHECK), SEED, 0.05, trace, device="cpu",
                          prepare=prepare, deadline_s=deadline_s)


def test_the_rank_world_agrees_with_the_reference_and_its_ranks_agree():
    result, lines = run()
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert result["check"]["outlier_share"]["value"] == 0.0
    assert result["check"][UNEQUAL] == {"value": 0, "limit": 0}
    assert lines[-1] == f"check {UNEQUAL} 0 limit 0"
    assert result["device"]["count"] == 4 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"msamples_per_s.partitioned", "setup_s"}


def test_a_traced_rank_run_reads_rank_0s_counters():
    result, _ = run(trace=True)
    assert result["correct"], result["check"]
    metrics = result["metrics"]
    for name in ("exchange.rounds", "exchange.paths_moved", "exchange.bytes_shipped",
                 "exchange.useful_share", "dist.host_syncs"):
        assert metrics[name]["value"] > 0, name
    # no device on the CPU: the readers of device time find nothing
    assert "trace.k9k10_ms" not in metrics and "dist.migration_ms" not in metrics
    assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result


def test_the_rank_frames_equal_the_in_process_frame():
    torch.set_num_threads(1)
    c = rank_cell(TINY)
    job = dict(config=c["config"], traffic=c["traffic"], seed=SEED, seconds=0.05, trace=False,
               device="cpu", prepare=None)
    results = run_world(job, 4, "gloo", rank_cores(4), time.monotonic() + 120.0)
    assert unequal_pixels(results) == (0, set())
    from pg2024_dprt_tpu_torch.parallel import make_mesh

    program = Program(c["config"], False, scenes.scene_inputs(c["config"]["scene"]), None,
                      "cpu", mesh=make_mesh(4, "cpu"))
    for sample, img in results[0]["checked"]:
        want = program.frame(sample)[0].reshape(-1, 3)
        assert torch.equal(img, want), float((img - want).abs().max())


def _memo_first(fn):
    first = []

    def wrapped(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]
    return wrapped


def _on_image(fn, change):
    def wrapped(*a, **k):
        img, stats = fn(*a, **k)
        return change(img), stats
    return wrapped


def _half_batch(img):
    """Half of the pixels left out, the mean taken over the rest."""
    flat = img.reshape(-1, 3).clone()
    flat[1::2] = 0.0
    flat[0::2] *= 2.0
    return flat.reshape(img.shape)


def unchanged(rank):
    """A step that returns its state unchanged: every frame returns the
    first one's image."""
    import pg2024_dprt_tpu_torch.parallel as port_parallel

    port_parallel.render_image_distributed = _memo_first(port_parallel.render_image_distributed)


def half_batch(rank):
    import pg2024_dprt_tpu_torch.parallel as port_parallel

    port_parallel.render_image_distributed = _on_image(port_parallel.render_image_distributed,
                                                       _half_batch)


def altered(rank):
    import pg2024_dprt_tpu_torch.parallel as port_parallel

    port_parallel.render_image_distributed = _on_image(port_parallel.render_image_distributed,
                                                       lambda x: x * 1.01)


def one_rank_altered(rank):
    """Rank 2's image altered where it is produced; rank 0's is sound."""
    if rank == 2:
        altered(rank)


def no_exchange(rank):
    """The exchange between the cards left out: every path stays where it is."""
    import pg2024_dprt_tpu_torch.parallel.distributed as port_distributed

    port_distributed.exchange_paths = lambda mesh, bufs, bucket_size=0: (
        bufs, *(torch.zeros(len(bufs), dtype=torch.int64),) * 3)


def raises(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")


def hangs(rank):
    if rank == 1:
        time.sleep(3600)


@pytest.mark.parametrize("prepare", [unchanged, half_batch, altered, one_rank_altered,
                                     no_exchange], ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(prepare):
    result, _ = run(prepare)
    assert not result["correct"] and result["failed"] >= 1, result["check"]
    if prepare is one_rank_altered:
        assert result["check"]["outlier_share"]["value"] == 0.0
        assert result["check"][UNEQUAL]["value"] > 0


def test_a_rank_that_raises_fails_the_run_before_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run(raises, deadline_s=300.0)
    assert time.monotonic() - t0 < 60.0
    assert not multiprocessing.active_children()


def test_a_rank_that_hangs_fails_the_run_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1: still running"):
        run(hangs, deadline_s=20.0)
    assert time.monotonic() - t0 < 40.0
    assert not multiprocessing.active_children()


def test_each_rank_gets_a_core_of_its_own_from_the_parents():
    allowed = os.sched_getaffinity(0)
    cores = rank_cores(len(allowed))
    assert cores[0] == current_core() and set(cores) == allowed
    with pytest.raises(RuntimeError, match="need a core each"):
        rank_cores(len(allowed) + 1)


def checkout_with_the_cell(tmp_path):
    """A checkout whose BENCHMARK.json holds the rank cell: the benchmark's
    files, the cell's configuration and limits, and the rest of the
    repository beside them (the port and the sources it builds)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, manifest.DIR), root / manifest.DIR,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in os.listdir(ROOT):
        if name not in (manifest.DIR, "BENCHMARK.json", ".git", ".portbench_cache"):
            os.symlink(os.path.join(ROOT, name), root / name)
    c = rank_cell()
    bench = manifest.load_benchmark(ROOT)
    conf = dict(manifest.by_name(bench["configs"], c["entry"]["config"]), name="rooms_p4",
                file=f"{manifest.DIR}/configs/rooms_p4.json")
    bench["configs"].append(conf)
    bench["workloads"].append(dict(c["entry"], config="rooms_p4"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if EXACT in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / conf["file"]).write_text(json.dumps(c["config"]))
    (root / manifest.DIR / "workloads" / f"{CELL}.json").write_text(
        json.dumps({"limits": c["limits"]}))
    return root


def test_the_run_refuses_on_a_host_without_the_cells_cards(tmp_path):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this host has the four cards the cell asks for")
    root = checkout_with_the_cell(tmp_path)
    assert manifest.cell(manifest.load_benchmark(root), root, CELL)["config"]["ranks"] == 4
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "need a CUDA device each" in out.stderr, out.stderr[-2000:]


def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: NCCL runs one rank a card")


def test_the_rank_frames_equal_the_in_process_frame_on_four_cards():
    """On four cards, at the deployment's full size: the NCCL world's
    checked frames against the in-process mesh's frames of the same scene
    on card 0, equal within rounding."""
    four_cards()
    from pg2024_dprt_tpu_torch.parallel import make_mesh

    c = rank_cell()
    job = dict(config=c["config"], traffic=c["traffic"], seed=SEED, seconds=2.0, trace=False,
               device="cuda", prepare=None)
    results = run_world(job, 4, "nccl", rank_cores(4), time.monotonic() + 300.0)
    assert unequal_pixels(results) == (0, set())
    dev = torch.device("cuda", 0)
    program = Program(c["config"], False, scenes.scene_inputs(c["config"]["scene"]), None, dev,
                      mesh=make_mesh(4, dev))
    for sample, img in results[0]["checked"]:
        want = program.frame(sample)[0].reshape(-1, 3).cpu()
        diff = (img - want).abs()
        print(f"sample {sample}: {int((diff > 0).any(dim=1).sum())} pixels of {img.shape[0]} "
              f"differ, max abs {float(diff.max())}, max rel "
              f"{float((diff / want.abs().clamp(min=1e-2)).max())}", flush=True)
        # the card adds some terms in another order on the two meshes (the
        # all_reduce against the in-process loop, K14's atomic adds)
        assert torch.allclose(img, want, rtol=1e-5, atol=1e-6)


def test_a_traced_rank_run_on_four_cards_is_correct(tmp_path):
    """The command line's run of the rank cell on four cards, traced, at
    the deployment's full size: correct, every rank equal, and rank 0's
    device readers find the exchange's kernels."""
    four_cards()
    root = checkout_with_the_cell(tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                          "--seed", "3000000021", "--seconds", "5", "--trace", "1"],
                         cwd=root, capture_output=True, text=True, timeout=600)
    print(out.stderr[-6000:], flush=True)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(result), flush=True)
    assert result["correct"] and result["check"][UNEQUAL]["value"] == 0, result["check"]
    assert result["device"]["count"] == 4 and result["device"]["busy_s"] > 0
    for name in ("dist.migration_ms", "trace.k9k10_ms", "exchange.bytes_shipped"):
        assert result["metrics"][name]["value"] > 0, name
