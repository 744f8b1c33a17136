"""The port's command-line renderer and its host I/O
(pg2024_dprt_tpu_torch/render/__main__.py, render/frames.py,
render/animation.py, scene/obj.py, utils/png.py) against the JAX package,
on the CPU (--device cpu), at small sizes.

Tolerances: OBJ arrays, PNG bytes and decoded texels equal; light and
camera motion equal within 1e-6; the cornell CLI frame within the golden bar
of tests/test_render_single.py (rtol 1e-3 / atol 1e-4) of the JAX CLI's.
The other cases port the oracles of tests/test_cli.py and
tests/test_native_and_io.py.
"""
import os

import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.render import animation as j_anim
from pg2024_dprt_tpu.render.__main__ import main as j_main
from pg2024_dprt_tpu.scene import procedural as j_procedural
from pg2024_dprt_tpu.scene.lights import LightTable as JLights
from pg2024_dprt_tpu.scene.obj import load_obj as j_load_obj
from pg2024_dprt_tpu.utils import png as j_png
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera
from pg2024_dprt_tpu_torch.render import animation
from pg2024_dprt_tpu_torch.render.__main__ import auto_camera, load_scene, main, scene_bounds
from pg2024_dprt_tpu_torch.scene.obj import load_obj, scene_from_obj
from pg2024_dprt_tpu_torch.utils import png



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the tier-1 run puts several
    test files side by side on the CPU's cores, and torch's own thread pool
    in each would oversubscribe them (its matmuls then slow down many-fold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def test_cli_builtin_cornell_matches_jax(tmp_path):
    """cornell through both CLIs on the CPU: the same image (the port
    composes on CPU tensors; JAX traces stackless), PNG and EXR written."""
    args = ["cornell", "--size", "24", "--spp", "2", "--bounces", "2", "--format", "both"]
    out = str(tmp_path / "r")
    images = main(args + ["--out", out, "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "frame0.png"))
    assert os.path.exists(os.path.join(out, "frame0.exr"))
    img = images[0]
    assert img.shape == (24, 24, 3) and np.all(np.isfinite(img))
    assert 0.01 < float(np.mean(img)) < 20.0
    want = j_main(args + ["--out", str(tmp_path / "j")])[0]
    np.testing.assert_allclose(img, want, rtol=1e-3, atol=1e-4)


def test_cli_obj_scene_auto_framing(tmp_path):
    """An emitter-free .obj: auto camera and auto area light, a lit image."""
    (tmp_path / "box.obj").write_text(
        "v 0 0 0\nv 2 0 0\nv 2 0 2\nv 0 0 2\n"
        "v 0.7 0 0.7\nv 1.3 0 0.7\nv 1.0 0.8 1.0\n"
        "f 1 4 3 2\n"
        "f 5 6 7\n")
    out = str(tmp_path / "r")
    images = main([str(tmp_path / "box.obj"), "--size", "20", "--spp", "2", "--bounces", "2",
                   "--out", out, "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "frame0.png"))
    assert float(np.mean(images[0])) > 1e-3


def _cli_matches_jax(tmp_path, args):
    """The port's CLI on the CPU and the JAX CLI on the same argv: the same
    image within the golden bar. Returns the port's image."""
    img = main(args + ["--out", str(tmp_path / "r"), "--device", "cpu"])[0]
    assert np.all(np.isfinite(img))
    want = j_main(args + ["--out", str(tmp_path / "j")])[0]
    assert img.shape == want.shape
    np.testing.assert_allclose(img, want, rtol=1e-3, atol=1e-4)
    return img


def test_cli_distributed_partitions(tmp_path):
    """rooms:2 on the in-process mesh of 2 partitions, exact mode (no nets
    passed): JAX's image."""
    img = _cli_matches_jax(tmp_path, ["rooms:2", "--size", "16", "--spp", "1", "--bounces", "2",
                                      "--partitions", "2"])
    assert img.shape == (16, 16, 3) and float(np.mean(img)) > 1e-4


def _torchrun(args, out):
    """The port's CLI under torch.distributed.run, 2 processes; returns the
    finished run (stdout, stderr) and rank 0's frame from its EXR."""
    import subprocess
    import sys

    from pg2024_dprt_tpu_torch.utils import read_exr

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = root
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "pg2024_dprt_tpu_torch.render", *args, "--format", "exr", "--out", out],
        cwd=root, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    got, names = read_exr(os.path.join(out, "frame0.exr"))
    return run, got[:, :, [names.index(c) for c in "RGB"]]


def test_cli_torchrun_ranks_match_in_process(tmp_path):
    """rooms:2 under torchrun, one partition a gloo rank on the CPU: rank 0's
    frame equals the in-process CLI's (held against JAX above) within rtol
    1e-3 / atol 1e-4, and only rank 0 writes and reports."""
    args = ["rooms:2", "--size", "16", "--spp", "1", "--bounces", "2", "--partitions", "2",
            "--device", "cpu"]
    run, got = _torchrun(args, str(tmp_path / "ranks"))
    assert run.stdout.count("wrote 1 frame(s)") == 1
    want = main(args + ["--out", str(tmp_path / "one")])[0]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert float(np.mean(got)) > 1e-4


NEURAL = ["rooms:2", "--size", "16", "--spp", "1", "--bounces", "2", "--partitions", "2",
          "--neural", "--proxy-samples", "2000", "--proxy-epochs", "2", "--device", "cpu"]


def _loss_lines(out: str):
    return [line for line in out.splitlines() if " loss " in line]


@pytest.fixture(scope="module")
def neural_in_process(_one_torch_thread, tmp_path_factory):
    """The in-process CLI's rooms:2 --neural run on the CPU, one torch
    thread (as each torchrun rank): (images, stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        images = main(NEURAL + ["--out", str(tmp_path_factory.mktemp("neural"))])
    return images, buf.getvalue()


def test_cli_torchrun_neural_ranks_match_in_process(tmp_path, neural_in_process):
    """rooms:2 --neural under torchrun, one partition a gloo rank on the CPU:
    each rank trains its own partition's nets and receives the other's.
    Rank 0's frame equals the in-process CLI's within rtol 1e-3 / atol 1e-4;
    each partition's losses are printed once, equal to the in-process run's
    (the nets are the same), and one frame is written."""
    images, out = neural_in_process
    run, got = _torchrun(NEURAL, str(tmp_path / "ranks"))
    for p in range(2):
        for kind in ("vis", "depth"):
            assert run.stdout.count(f"partition {p}: {kind} loss") == 1, run.stdout
    assert _loss_lines(run.stdout) == _loss_lines(out)
    assert run.stdout.count("wrote 1 frame(s)") == 1 and run.stdout.count("Train:") == 1
    np.testing.assert_allclose(got, images[0], rtol=1e-3, atol=1e-4)
    assert float(np.mean(got)) > 1e-4


def test_cli_under_torchrun_refuses_other_partition_counts(monkeypatch, tmp_path):
    """Under torchrun's environment --partitions must equal the world size,
    with or without --neural; it raises before any process group."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    base = ["rooms:2", "--size", "8", "--device", "cpu", "--out", str(tmp_path / "r")]
    for extra in ([], ["--neural"]):
        with pytest.raises(ValueError, match="must equal the world size"):
            main(base + ["--partitions", "3"] + extra)


def test_cli_neural_partitions_train_their_nets(neural_in_process):
    """--neural trains a vis and a depth net per partition (train/), then
    routes through them."""
    images, out = neural_in_process
    assert images[0].shape == (16, 16, 3) and np.all(np.isfinite(images[0]))
    assert out.count("vis loss") == 2 and out.count("depth loss") == 2 and "Train:" in out


def test_cli_scene_specs_and_bounds():
    meshes, lights, _ = load_scene("soup:256", device="cpu")
    assert lights is None
    lo, hi = scene_bounds(meshes)
    assert np.all(hi > lo)
    cam = auto_camera(lo, hi, 45.0, 32, 32, device="cpu")
    assert cam.width == 32
    meshes, lights, _ = load_scene("cornell", device="cpu")
    assert lights is not None and lights.count == 2
    meshes, _, _ = load_scene("cornell-water", device="cpu")
    assert any(m.bsdf_type != meshes[0].bsdf_type for m in meshes)
    (city,), lights, _ = load_scene("city:3000", device="cpu")
    want = j_procedural.city_scene(3000)
    for f in ("v0", "v1", "v2"):
        np.testing.assert_array_equal(getattr(city, f), getattr(want, f))
    (base,), tf = load_scene("instanced:5,64", device="cpu")[0]
    assert base.num_triangles == 64 and tf.shape == (5, 3, 4)
    with pytest.raises(SystemExit):
        load_scene("no-such-scene.obj", device="cpu")


INSTANCED = ["instanced:4,512", "--size", "20", "--spp", "1", "--bounces", "2"]


def test_cli_instanced_builtin(tmp_path):
    """instanced:4,512 on one device (bounds from the transformed base
    corners, auto camera and light on them): JAX's image."""
    img = _cli_matches_jax(tmp_path, INSTANCED)
    assert img.shape == (20, 20, 3) and float(np.mean(img)) > 1e-4


def test_cli_instanced_distributed(tmp_path):
    """instanced:4,512 on 2 partitions (build_partitioned_scene_instanced,
    exact mode): JAX's image."""
    img = _cli_matches_jax(tmp_path, INSTANCED + ["--partitions", "2"])
    assert img.shape == (20, 20, 3) and float(np.mean(img)) > 1e-4


def test_cli_needs_cuda_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["cornell", "--size", "8", "--out", str(tmp_path / "r")])
    (tmp_path / "t.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scene_from_obj(str(tmp_path / "t.obj"))
    assert scene_from_obj(str(tmp_path / "t.obj"), device="cpu").num_triangles == 1


def test_frames_animate_lights_and_camera(tmp_path):
    """--frames with --light-velocity and --dolly: each frame its own
    image, EXRs written by render_frames."""
    out = str(tmp_path / "r")
    images = main(["cornell", "--size", "12", "--spp", "1", "--bounces", "1", "--frames", "2",
                   "--light-velocity", "0.1,0,0", "--dolly", "0,0,0.2", "--format", "exr",
                   "--out", out, "--device", "cpu"])
    assert len(images) == 2 and not np.array_equal(images[0], images[1])
    assert sorted(os.listdir(out)) == ["frame0.exr", "frame1.exr"]


def test_animation_matches_jax():
    quad = np.asarray([[[0, 1, 0], [1, 1, 0], [1, 1, 1]]], np.float32)
    rad = np.asarray([[5.0, 5.0, 5.0]], np.float32)
    tl = tscene.LightTable.from_arrays(quad, rad, device="cpu")
    jl = JLights.from_arrays(quad, rad)
    got, want = animation.animate_lights(tl, 3, (0.1, -0.2, 0.3)), j_anim.animate_lights(
        jl, 3, (0.1, -0.2, 0.3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    args = ([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, 16, 12)
    tc, jc = Camera.look_at(*args, device="cpu"), JCamera.look_at(*args)
    pairs = ((animation.dolly_camera(tc, 2, (0.0, 0.1, -0.3)),
              j_anim.dolly_camera(jc, 2, (0.0, 0.1, -0.3))),
             (animation.orbit_camera(tc, 5, [0.5, 0.5, 0.5], 2.0, 0.7, 12.0, 45.0),
              j_anim.orbit_camera(jc, 5, [0.5, 0.5, 0.5], 2.0, 0.7, 12.0, 45.0)))
    for got_c, want_c in pairs:
        assert (got_c.width, got_c.height) == (want_c.width, want_c.height)
        for f in ("origin", "forward", "right", "up", "tan_half_fov"):
            np.testing.assert_allclose(getattr(got_c, f).numpy(), np.asarray(getattr(want_c, f)),
                                       rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# OBJ and PNG

OBJ_TEXT = ("mtllib scene.mtl\n"
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
            "vn 0 0 1\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
            "o quad\nusemtl red\n"
            "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
            "o tri\nusemtl tex\n"
            "f -4//-1 -3//-1 -2//-1\n"
            "g nomat\nusemtl missing\nf 1 2 3\n")


def test_obj_loader_matches_jax(tmp_path):
    """load_obj on the .obj files of the JAX tests (materials, negative
    indices, polygons, groups): every array and field equal; and the JAX
    oracle's facts."""
    (tmp_path / "scene.mtl").write_text(
        "newmtl red\nKd 1.0 0.1 0.1\nnewmtl tex\nKd 0.5 0.5 0.5\nmap_Kd wood.png\n")
    (tmp_path / "scene.obj").write_text(OBJ_TEXT)
    (tmp_path / "box.obj").write_text(
        "v 0 0 0\nv 2 0 0\nv 2 0 2\nv 0 0 2\nv 0.7 0 0.7\nv 1.3 0 0.7\nv 1.0 0.8 1.0\n"
        "f 1 4 3 2\nf 5 6 7\n")
    for name in ("scene.obj", "box.obj"):
        meshes, textures = load_obj(str(tmp_path / name))
        jmeshes, jtextures = j_load_obj(str(tmp_path / name))
        assert textures == jtextures and len(meshes) == len(jmeshes)
        for m, jm in zip(meshes, jmeshes):
            assert (m.name, m.base_color, m.texture_index, m.bsdf_type) == (
                jm.name, jm.base_color, jm.texture_index, jm.bsdf_type)
            for f in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2"):
                np.testing.assert_array_equal(getattr(m, f), getattr(jm, f), err_msg=f)
    meshes, textures = load_obj(str(tmp_path / "scene.obj"))
    quad = next(m for m in meshes if m.name.startswith("quad"))
    tri = next(m for m in meshes if m.name.startswith("tri"))
    assert quad.num_triangles == 2 and tri.num_triangles == 1
    assert quad.base_color == (1.0, 0.1, 0.1) and quad.texture_index == -1
    assert tri.texture_index == 0 and textures == ["wood.png"]
    np.testing.assert_allclose(quad.n0[0], [0, 0, 1])
    np.testing.assert_allclose(quad.uv1[0], [1, 0])


def test_write_png_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    for img in (rng.rand(9, 13, 3).astype(np.float32) * 3.0,
                (rng.rand(7, 5, 3) * 255).astype(np.uint8),
                rng.rand(6, 4).astype(np.float32)):
        png.write_png(str(tmp_path / "a.png"), img)
        j_png.write_png(str(tmp_path / "b.png"), img)
        assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(png.tonemap(img, 1.5, 2.0), j_png.tonemap(img, 1.5, 2.0))


def _chunk(tag, data):
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _encode_png_with_filters(img: np.ndarray, ftype: int) -> bytes:
    """An 8-bit RGB PNG with one filter type on every row."""
    import struct
    import zlib

    h, w, _ = img.shape
    bpp = 3
    raw = b""
    prev = np.zeros((w * bpp,), np.int32)
    for y in range(h):
        row = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        if ftype == 0:
            filt = row
        elif ftype == 1:
            filt = (row - left) & 0xFF
        elif ftype == 2:
            filt = (row - prev) & 0xFF
        elif ftype == 3:
            filt = (row - ((left + prev) >> 1)) & 0xFF
        else:
            filt = np.zeros_like(row)
            for x in range(row.shape[0]):
                a = int(row[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                filt[x] = (row[x] - pred) & 0xFF
        raw += bytes([ftype]) + bytes(filt.astype(np.uint8))
        prev = row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", range(5))
def test_read_png_filters_match_jax(tmp_path, ftype):
    """Every PNG filter type decodes to the source texels, as JAX's reader."""
    img = (np.random.RandomState(5).rand(13, 17, 3) * 255).astype(np.uint8)
    p = tmp_path / f"f{ftype}.png"
    p.write_bytes(_encode_png_with_filters(img, ftype))
    back = png.read_png(str(p))
    np.testing.assert_allclose(back, img.astype(np.float32) / 255.0, atol=1e-6)
    np.testing.assert_array_equal(back, j_png.read_png(str(p)))


def test_read_png_color_types_match_jax(tmp_path):
    """Gray, gray + alpha, RGBA, 16-bit and palette (with tRNS) images."""
    import struct
    import zlib

    rng = np.random.RandomState(6)
    cases = []
    for ctype, ch in ((0, 1), (4, 2), (6, 4)):
        img = (rng.rand(9, 11, ch) * 255).astype(np.uint8)
        raw = b"".join(b"\x00" + img[y].tobytes() for y in range(9))
        cases.append((struct.pack(">IIBBBBB", 11, 9, 8, ctype, 0, 0, 0), raw, b""))
    img16 = (rng.rand(5, 6, 3) * 65535).astype(">u2")
    raw16 = b"".join(b"\x00" + img16[y].tobytes() for y in range(5))
    cases.append((struct.pack(">IIBBBBB", 6, 5, 16, 2, 0, 0, 0), raw16, b""))
    idx = rng.randint(0, 4, (4, 7)).astype(np.uint8)
    pal = _chunk(b"PLTE", bytes(range(12))) + _chunk(b"tRNS", bytes([255, 128]))
    cases.append((struct.pack(">IIBBBBB", 7, 4, 8, 3, 0, 0, 0),
                  b"".join(b"\x00" + idx[y].tobytes() for y in range(4)), pal))
    for i, (ihdr, raw, extra) in enumerate(cases):
        p = tmp_path / f"c{i}.png"
        p.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
                      + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
        got = png.read_png(str(p))
        np.testing.assert_array_equal(got, j_png.read_png(str(p)))
    assert got.shape == (4, 7, 4)


def test_textured_obj_scene_from_disk(tmp_path):
    """.obj + .mtl + .png on disk -> scene_from_obj -> render_image shows
    the texture's colour split (the JAX oracle)."""
    from pg2024_dprt_tpu_torch.render import RenderConfig, render_image

    tex = np.zeros((16, 16, 3), np.uint8)
    tex[:, :8, 0] = 255
    tex[:, 8:, 2] = 255
    png.write_png(str(tmp_path / "split.png"), tex)
    (tmp_path / "scene.mtl").write_text("newmtl floor\nKd 1 1 1\nmap_Kd split.png\n")
    (tmp_path / "scene.obj").write_text(
        "mtllib scene.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 0 1\n"
        "vn 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "o floor\nusemtl floor\n"
        "f 1/1/1 4/4/1 3/3/1 2/2/1\n")
    scene = scene_from_obj(str(tmp_path / "scene.obj"), device="cpu")
    assert scene.albedo_textures is not None and scene.albedo_textures.offset.shape[0] == 1
    env = tscene.EnvironmentMap.constant((0.0, 0.0, 0.0), device="cpu")
    lights = tscene.LightTable.from_arrays(
        np.asarray([[[0.2, 2.0, 0.2], [0.8, 2.0, 0.2], [0.5, 2.0, 0.8]]]),
        np.asarray([[8.0, 8.0, 8.0]]), device="cpu")
    cam = Camera.look_at([0.5, 1.6, 0.5], [0.5, 0.0, 0.5], [0, 0, -1], 45.0, 24, 24,
                         device="cpu")
    img = render_image(scene, lights, env, cam, RenderConfig(width=24, height=24, spp=2,
                                                             bounces=1), device="cpu").numpy()
    cols = img.mean(axis=0)
    left, right = cols[:10].mean(axis=0), cols[-10:].mean(axis=0)
    ratios = sorted([left[0] / max(left[2], 1e-6), right[0] / max(right[2], 1e-6)])
    assert ratios[1] > 3.0 and ratios[0] < 1 / 3.0, (left, right)
    # a missing texture becomes one white texel, with a warning
    (tmp_path / "scene.mtl").write_text("newmtl floor\nKd 1 1 1\nmap_Kd gone.png\n")
    with pytest.warns(UserWarning, match="not decodable"):
        scene = scene_from_obj(str(tmp_path / "scene.obj"), device="cpu")
    assert scene.albedo_textures.texels.shape[0] == 1
