"""Scene kinds (`kinds/<kind>.py`, manifest.py): the kinds `soup` and
`rooms` make the inputs, nets and reference pixels they made before they
were kinds, bit for bit (`digests.json`, taken from the harness before
the move at the tests' small size); a kind added as files and entries
alone runs through `run_cell` and is judged correct, and judged not
correct with its build or its reference broken; an unknown kind fails at
once and names the file it lacks."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import manifest, scenes
from portbench.check import Reference, plan
from portbench.program import partitioned_scene
from portbench.run import ROOT, merged, run_cell

BENCH = manifest.load_benchmark(ROOT)
DIGESTS = json.load(open(os.path.join(ROOT, manifest.DIR, "tests", "digests.json")))
SEEDS = (3_000_000_017, 4_000_000_037)
KINDS = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, manifest.DIR, "kinds"))
               if f.endswith(".py"))


def config_of(name):
    with open(os.path.join(ROOT, manifest.by_name(BENCH["configs"], name)["file"])) as f:
        return json.load(f)


def tiny(config):
    """The configuration at the tests' small size: 24x16 pixels, its kind's
    size key at 3,000."""
    size = manifest.kind(config["scene"]["kind"], ROOT).SIZE
    return merged(config, {"request": {"width": 24, "height": 16}, "scene": {size: 3000}})


def mesh_digest(meshes):
    h = hashlib.sha256()
    for m in meshes:
        h.update(m["name"].encode())
        h.update(np.asarray(m["base_color"], np.float32).tobytes())
        for k in ("v0", "v1", "v2"):
            h.update(np.ascontiguousarray(m[k], np.float32).tobytes())
    return h.hexdigest()


def net_digest(nets):
    h = hashlib.sha256()
    for kind in ("vis", "depth"):
        for key in sorted(nets[kind]):
            h.update(key.encode())
            h.update(nets[kind][key].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_a_configurations_inputs_and_nets_are_the_parents_bit_for_bit(name):
    torch.set_num_threads(2)
    config = config_of(name)
    assert mesh_digest(scenes.scene_inputs(config["scene"])) == DIGESTS["meshes"][name]
    assert mesh_digest(scenes.scene_inputs(tiny(config)["scene"])) == DIGESTS["meshes_tiny"][name]
    if "nets" in config:
        nets = scenes.proxy_nets(config["nets"], config["scene"]["partitions"], "cpu")
        assert net_digest(nets) == DIGESTS["nets"][name]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_references_checked_pixels_are_the_parents_bit_for_bit(name):
    """Two frames at each of two seeds, at the pixels a tiny check draws
    (in the neural cell a pool of the whole image, and which pixels a net
    decided)."""
    torch.set_num_threads(2)
    c = manifest.cell(BENCH, ROOT, name)
    config = tiny(c["config"])
    neural = bool(c["traffic"]["neural"])
    nets = (scenes.proxy_nets(config["nets"], config["scene"]["partitions"], "cpu")
            if "nets" in config else None)
    ref = Reference(config, neural, scenes.scene_inputs(config["scene"]), nets, "cpu")
    check = {"early_frames": 8, "pixels": 96, **({"pool": 384} if neural else {})}
    for seed in SEEDS:
        early, orders = plan(check, seed, 24 * 16)
        first = seed % (2 ** c["traffic"]["first_sample_bits"]) + 1
        h = hashlib.sha256()
        for k, order in enumerate(orders):
            info = {} if neural else None
            h.update(ref.pixels(first + early + k, order, info=info).numpy().tobytes())
            if neural:
                h.update(info["decided"].numpy().tobytes())
        assert h.hexdigest() == DIGESTS["pixels"][name][str(seed)], (name, seed)


@pytest.mark.parametrize("name", KINDS)
def test_a_kind_supplies_its_parts_and_its_reference_lives_under_reference(name):
    kind = manifest.kind(name, ROOT)
    for part in ("inputs", "device_scene", "reference"):
        assert callable(getattr(kind, part)), part
    assert isinstance(kind.SIZE, str)
    # the reference/ folder imports nothing of the port
    # (test_portbench_manifest.py)
    assert kind.reference.__module__.startswith(f"{manifest.DIR}.reference.")


# a scene kind of its own: a soup drawn by numpy's Generator over a floor
# of two large triangles
FLOORED = '''"""The scene kind `floored`: a soup of random small triangles drawn by
numpy's Generator, over a floor of two large triangles."""
from __future__ import annotations

import numpy as np

from portbench.meshes import device_scene, partitioned_scene  # noqa: F401
from portbench.reference.triangles import reference_scene as reference  # noqa: F401

SIZE = "triangles"


def inputs(scene):
    rng = np.random.default_rng(scene["seed"])
    n, ext, jit = scene["triangles"], scene["extent"], scene["jitter"]
    base = rng.random((n, 3), dtype=np.float32) * ext
    e1 = (rng.random((n, 3), dtype=np.float32) - 0.5) * jit * ext
    e2 = (rng.random((n, 3), dtype=np.float32) - 0.5) * jit * ext
    y, c, h = scene["floor_y"], 0.5 * ext, scene["floor_half"]
    q = np.array([[c - h, y, c - h], [c + h, y, c - h], [c + h, y, c + h], [c - h, y, c + h]],
                 np.float32)
    return [dict(v0=base, v1=base + e1, v2=base + e2, base_color=(0.8, 0.7, 0.6), name="soup"),
            dict(v0=q[[0, 0]], v1=q[[2, 3]], v2=q[[1, 2]], base_color=(0.6, 0.6, 0.6),
                 name="floor")]
'''
# the kind with its build, or its reference, broken
BROKEN = {
    "build_drops_a_mesh": '''
import portbench.meshes as _meshes


def device_scene(inputs, scene, device):
    return _meshes.device_scene(inputs[:-1], scene, device)
''',
    "reference_one_triangle_less": '''
from portbench.reference.triangles import reference_scene as _reference


def reference(inputs, scene, neural, device, dtype):
    floor = dict(inputs[-1], **{k: inputs[-1][k][1:] for k in ("v0", "v1", "v2")})
    return _reference(inputs[:-1] + [floor], scene, neural, device, dtype)
''',
}
CELL = "floored.frame"


def checkout_with_the_kind(tmp_path, kind_source=FLOORED, kind="floored"):
    """A copy of the harness with a configuration of scene kind `kind`
    added as files and entries alone: its kind file, configuration and
    cell limits, and its entries in BENCHMARK.json (the soup cell's
    traffic and metrics). Returns (root, the bytes of every file the copy
    had before)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, manifest.DIR), root / manifest.DIR,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / manifest.DIR).rglob("*") if p.is_file()}
    pb = root / manifest.DIR
    (pb / "kinds" / "floored.py").write_text(kind_source)
    conf = config_of("soup_2m")
    conf.update(name="floored", reduced={})
    conf["scene"] = {"kind": kind, "triangles": 65536, "extent": 1.0, "jitter": 0.08,
                     "floor_y": -0.05, "floor_half": 4.0, "tris_per_cluster": 512, "seed": 5}
    (pb / "configs" / "floored.json").write_text(json.dumps(conf))
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps({"limits": {"outlier_share": 0.002}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "floored", "source": "a seeded soup over a floor",
                             "file": f"{manifest.DIR}/configs/floored.json", "reduced": [],
                             "why": "a scene kind added as files"})
    bench["workloads"].append({"name": CELL, "config": "floored", "traffic": "frame", "chips": 1,
                               "why": "the single-device frame over a soup on a floor"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "soup_2m.frame" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


def run_floored(root):
    torch.set_num_threads(2)
    return run_cell(CELL, 3_000_000_023, 0.05, False, device="cpu", root=str(root),
                    override={"request": {"width": 24, "height": 16},
                              "scene": {"triangles": 3000}})[0]


def test_a_kind_added_as_files_runs_and_is_correct(tmp_path):
    root, before = checkout_with_the_kind(tmp_path)
    result = run_floored(root)
    assert result["correct"], result["check"]
    assert result["check"]["outlier_share"]["value"] == 0.0
    # the soup cell's end-to-end metrics (a p95 needs more than the one frame)
    assert {"msamples_per_s", "setup_s"} <= set(result["metrics"])
    for p, data in before.items():
        assert p.read_bytes() == data, p


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_a_kind_with_its_build_or_its_reference_broken_is_not_correct(tmp_path, fault):
    root, _ = checkout_with_the_kind(tmp_path, FLOORED + BROKEN[fault])
    result = run_floored(root)
    assert not result["correct"], result["check"]
    assert result["failed"] >= 1


def test_a_kind_without_a_partitioned_build_says_so(tmp_path):
    source = FLOORED.replace("device_scene, partitioned_scene", "device_scene")
    root, _ = checkout_with_the_kind(tmp_path, source)
    kind = manifest.kind("floored", str(root))
    with pytest.raises(ValueError, match="'floored' builds no partitioned scene"):
        partitioned_scene(kind, [], {"kind": "floored", "partitions": 2}, "cpu")


def test_an_unknown_kind_fails_at_once_and_names_its_file(tmp_path):
    missing = os.path.join(ROOT, manifest.DIR, "kinds", "no_such_kind.py")
    with pytest.raises(FileNotFoundError, match=missing):
        manifest.kind("no_such_kind", ROOT)
    with pytest.raises(FileNotFoundError, match="unknown scene kind"):
        manifest.kind("../kinds/soup", ROOT)
    with pytest.raises(FileNotFoundError, match=missing):
        run_cell("soup_2m.frame", 1, 0.05, False, device="cpu",
                 override={"scene": {"kind": "no_such_kind"}})
    # the command line, in a checkout of the harness alone: the kind's error
    # comes before the look for a card or the port
    root, _ = checkout_with_the_kind(tmp_path, kind="no_such_kind")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert os.path.join(manifest.DIR, "kinds", "no_such_kind.py") in out.stderr, out.stderr[-2000:]
