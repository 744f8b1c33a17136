"""What decides `correct`, at a tiny size on the CPU: the port's entry of
every cell agrees with the plain reference; the controls (the reference in
bfloat16; in the neural cell also the nets in float8, and the nets off) fail
the cell's limits; and a run with the timed path broken underneath comes
out not correct, once for each fault the cell can have."""
import pytest
import torch

import pg2024_dprt_tpu_torch.parallel as port_parallel
import pg2024_dprt_tpu_torch.parallel.distributed as port_distributed
import pg2024_dprt_tpu_torch.render as port_render
import pg2024_dprt_tpu_torch.render.proxy_stages as port_stages
from portbench import manifest, scenes
from portbench.check import Reference
from portbench.control import control_numbers
from portbench.reference.neural import net
from portbench.run import ROOT, run_cell

BENCH = manifest.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
# the cells run in one process (run_cell); a rank cell's runs are
# test_portbench_ranks.py's
ONE_PROCESS = [name for name in CELLS
               if "ranks" not in manifest.cell(BENCH, ROOT, name)["config"]]
SEED = 3_000_000_017
# the check's pixels at the tiny size: a uniform 96 of each frame, and in
# the neural cells up to 48 of the pixels the nets decide among the rest
TINY_CHECK = {"pixels": 96, "pool": 384, "net_pixels": 48}


def tiny(name):
    """The cell's configuration cut to a CPU test: 24x16 pixels, and its
    scene kind's size key (`SIZE`: a soup's triangles, a room's) at a few
    thousand, the rooms as far apart as the cell's."""
    size = manifest.kind(manifest.cell(BENCH, ROOT, name)["config"]["scene"]["kind"], ROOT).SIZE
    return {"request": {"width": 24, "height": 16}, "scene": {size: 3000}}


@pytest.fixture(autouse=True)
def tiny_check(monkeypatch):
    """Every cell's traffic mix with the check cut to the tiny image."""
    cell = manifest.cell

    def small(*a, **k):
        c = cell(*a, **k)
        check = {key: TINY_CHECK[key] for key in c["traffic"]["check"] if key in TINY_CHECK}
        return dict(c, traffic=dict(c["traffic"], check=dict(c["traffic"]["check"], **check)))
    monkeypatch.setattr(manifest, "cell", small)


def run(name, seed=SEED):
    torch.set_num_threads(2)
    return run_cell(name, seed, 0.05, False, device="cpu", override=tiny(name))[0]


@pytest.mark.parametrize("name", ONE_PROCESS)
def test_the_port_agrees_with_the_reference(name):
    result = run(name)
    assert result["correct"], result["check"]
    for number in result["check"].values():
        assert number["value"] == 0.0
    if name.endswith("neural"):
        assert "outlier_share.nets" in result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_renders_lit_geometry(name):
    c = manifest.cell(manifest.load_benchmark(ROOT), ROOT, name)
    config = dict(c["config"], **{k: dict(c["config"][k], **v) for k, v in tiny(name).items()})
    inputs = scenes.scene_inputs(config["scene"])
    nets = (scenes.proxy_nets(config["nets"], config["scene"]["partitions"], "cpu")
            if "nets" in config else None)
    ref = Reference(config, bool(c["traffic"]["neural"]), inputs, nets, "cpu")
    log = []
    pix = ref.pixels(5, torch.arange(16 * 12), None if ref.neural else log)
    assert bool(torch.isfinite(pix).all()) and float(pix.std()) > 0.0
    if log:
        assert any(bool(w["hit"].any()) for w in log)
        assert any(bool((~w["occluded"] & w["shadow"][4]).any()) for w in log)


def test_the_nets_are_the_configurations_and_predict_its_hit_share():
    spec = manifest.cell(manifest.load_benchmark(ROOT), ROOT, "rooms_p8.neural")["config"]["nets"]
    a, b = (scenes.proxy_nets(spec, 8, "cpu") for _ in range(2))
    for kind in ("vis", "depth"):
        for key in a[kind]:
            assert torch.equal(a[kind][key], b[kind][key])
    gen = torch.Generator().manual_seed(spec["seed"])
    torch.rand((2, 8, sum(fi * fo + fo for _, fi, fo in scenes.net_shapes(
        spec["width"], spec["depth"], spec["head_hidden"]))), generator=gen)
    feats = torch.rand((scenes.BIAS_SAMPLES, 5), generator=gen)
    for p in range(8):
        vis = net({k: v[p] for k, v in a["vis"].items()}, feats, spec["depth"])
        assert abs(float((vis > 0.5).float().mean()) - spec["vis_hit_share"]) < 2e-3


CONTROL_CASES = [(name, control) for name in CELLS
                 for control in (("bf16", "fp8_nets", "nets_off") if name.endswith("neural")
                                 else ("bf16",))]


@pytest.mark.parametrize("name,control", CONTROL_CASES,
                         ids=[f"{n}-{c}" for n, c in CONTROL_CASES])
def test_the_control_fails_the_limit(name, control):
    torch.set_num_threads(2)
    got = control_numbers(name, SEED, "cpu", control, override=tiny(name))
    assert any(v["value"] > v["limit"] for v in got["numbers"].values()), got
    if control == "nets_off":
        assert got["numbers"]["outlier_share.nets"]["value"] > 0.5


def _unchanged(fn):
    """A step that returns its state unchanged: every frame returns the
    first one's result."""
    first = []

    def wrapped(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]
    return wrapped


def _on_image(fn, change):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if isinstance(out, tuple):
            return (change(out[0]),) + out[1:]
        return change(out)
    return wrapped


def _half_batch(img):
    """Half of the pixels left out, the mean taken over the rest."""
    flat = img.reshape(-1, 3).clone()
    flat[1::2] = 0.0
    flat[0::2] *= 2.0
    return flat.reshape(img.shape)


FAULTS = {
    "unchanged": lambda mp, entry: mp.setattr(*entry, _unchanged(getattr(*entry))),
    "half_batch": lambda mp, entry: mp.setattr(*entry, _on_image(getattr(*entry), _half_batch)),
    "altered": lambda mp, entry: mp.setattr(*entry, _on_image(getattr(*entry), lambda x: x * 1.01)),
    "no_exchange": lambda mp, entry: mp.setattr(
        port_distributed, "exchange_paths",
        lambda mesh, bufs, bucket_size=0: (bufs, *(torch.zeros(len(bufs), dtype=torch.int64),) * 3)),
    "no_nets": lambda mp, entry: mp.setattr(
        port_stages, "_nn_pair",
        lambda models, feats, obj, valid: (torch.zeros(feats.shape[0]),) * 2),
}
CASES = [(name, fault) for name in ONE_PROCESS for fault in FAULTS
         if not (fault == "no_exchange" and name.startswith("soup"))
         and not (fault == "no_nets" and not name.endswith("neural"))]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f}" for n, f in CASES])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    entry = ((port_parallel, "render_image_distributed") if name.startswith("rooms")
             else (port_render, "render_image"))
    FAULTS[fault](monkeypatch, entry)
    result = run(name)
    assert not result["correct"], result["check"]
