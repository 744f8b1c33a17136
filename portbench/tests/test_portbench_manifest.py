"""The benchmark's manifest: every name in BENCHMARK.json finds its files,
names and units keep to their characters, and a cell added as new files is
found without an edit to any file that is there."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import manifest
from portbench.run import ROOT, current_core, forbidden_modules

BENCH = manifest.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units_keep_to_their_characters(entry):
    assert manifest.NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert manifest.NAME.fullmatch(entry[key])
    for key in entry.get("reduced", []):
        assert manifest.NAME.fullmatch(key)
    if "unit" in entry:
        assert manifest.UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    c = manifest.cell(BENCH, ROOT, name)
    assert c["config"]["name"] == c["entry"]["config"]
    assert os.path.isfile(manifest.kind_file(c["config"]["scene"]["kind"], ROOT))
    assert set(c["config"]["reduced"]) == set(
        manifest.by_name(BENCH["configs"], c["entry"]["config"])["reduced"])
    assert "outlier_share" in c["limits"]
    reported = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in reported


@pytest.mark.parametrize("entry", METRICS, ids=lambda e: e["name"])
def test_every_metric_has_a_reader_and_its_metadata_only_in_benchmark_json(entry):
    mod = manifest.metric(entry["name"], ROOT)
    assert callable(mod.read)
    for key in ("LAYER", "UNIT", "BETTER", "SOURCE", "MOVES", "CELLS"):
        assert not hasattr(mod, key)
    for cell in entry.get("workloads", []):
        assert cell in CELLS
    if "layer" in entry:
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_every_reader_file_is_a_metric_of_benchmark_json():
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench", "metrics"))
             if f.endswith(".py")}
    assert files == {m["name"] for m in METRICS}


def test_a_cell_added_as_files_is_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    conf = json.load(open(os.path.join(ROOT, "portbench", "configs", "soup_2m.json")))
    conf["name"] = "soup_256k"
    conf["scene"]["triangles"] = 262144
    (root / "portbench" / "configs" / "soup_256k.json").write_text(json.dumps(conf))
    (root / "portbench" / "traffic" / "frame_small.json").write_text(json.dumps(
        dict(json.load(open(os.path.join(ROOT, "portbench", "traffic", "frame.json"))),
             check={"early_frames": 2, "pixels": 64})))
    (root / "portbench" / "workloads" / "soup_256k.frame_small.json").write_text(
        json.dumps({"limits": {"outlier_share": 0.5}}))
    (root / "portbench" / "metrics" / "frames.count.py").write_text(
        "def read(ctx):\n    return ctx.frames\n")
    bench["configs"].append(dict(manifest.by_name(bench["configs"], "soup_2m"), name="soup_256k",
                                 file="portbench/configs/soup_256k.json"))
    bench["workloads"].append({"name": "soup_256k.frame_small", "config": "soup_256k",
                               "traffic": "frame_small", "chips": 1, "why": "a smaller soup"})
    bench["per_layer"].append({"name": "frames.count", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "msamples_per_s", "workloads": ["soup_256k.frame_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = manifest.cell(manifest.load_benchmark(str(root)), str(root), "soup_256k.frame_small")
    assert c["config"]["scene"]["triangles"] == 262144
    assert c["traffic"]["check"]["pixels"] == 64
    assert c["limits"]["outlier_share"] == 0.5
    assert [m["name"] for m in c["per_layer"]][-1] == "frames.count"
    assert manifest.metric("frames.count", str(root)).read(type("C", (), {"frames": 7})) == 7
    for p, data in before.items():
        assert p.read_bytes() == data


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "flax", "pg2024_dprt_tpu"}


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=lambda p: os.path.basename(p))
def test_the_reference_imports_nothing_of_the_program(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert roots <= {"__future__", "math", "dataclasses", "numpy", "torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pg2024_dprt_tpu_torch", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pg2024_dprt_tpu.core", sys)
    assert "pg2024_dprt_tpu" in forbidden_modules()


def test_run_refuses_without_a_gpu():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_checkout_without_the_port(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_run_pins_itself_to_a_core_of_its_own_affinity_set():
    assert current_core() in os.sched_getaffinity(0)
