"""Port core layer vs the JAX package: RNG and pixel order bit-exact, math
and camera within float32 rounding; the port's import and device rules."""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu import core as jcore
from pg2024_dprt_tpu.render.pathgen import tiled_pixel_order as j_tiled
from pg2024_dprt_tpu_torch import core as tcore
from pg2024_dprt_tpu_torch.core import math as tmath
from pg2024_dprt_tpu_torch.render.pathgen import tiled_pixel_order as t_tiled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# seeds around the int32 and uint32 wrap points (the uint32 emulation's hazards)
_EDGE = [0, 1, 2**31 - 2, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]


def _u32(a):
    return np.asarray(a, np.uint64).astype(np.uint32)


@pytest.mark.parametrize("v1", [0, 7, 2**31 - 1, 2**31, 2**32 - 1])
def test_tea_bit_exact_at_wrap_points(v1):
    """tea: exact (0 tolerance) against JAX uint32, seeds near 2^31, 2^32."""
    v0 = np.asarray(_EDGE + list(np.random.RandomState(v1 % 97).randint(0, 2**32, 64, np.uint64)),
                    np.uint64)
    want = np.asarray(jcore.tea(jnp.asarray(_u32(v0)), jnp.uint32(v1)))
    got = tcore.tea(torch.as_tensor(v0.astype(np.int64)), v1).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2**32
    # the host-side scalar form gives the same bits
    assert [tcore.tea_int(int(a), v1) for a in v0] == got.tolist()


def test_rnd_sequences_bit_exact():
    """rnd/rnd2/rnd3: seeds exact, floats exact (0 tolerance)."""
    seeds = np.asarray(_EDGE + [12345, 987654321], np.uint64)
    js = jnp.asarray(_u32(seeds))
    ts = torch.as_tensor(seeds.astype(np.int64))
    for _ in range(3):
        js, a1, a2, a3 = jcore.rnd3(js)
        ts, b1, b2, b3 = tcore.rnd3(ts)
        for a, b in ((a1, b1), (a2, b2), (a3, b3)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    js, a1, a2 = jcore.rnd2(js)
    ts, b1, b2 = tcore.rnd2(ts)
    np.testing.assert_array_equal(b1.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(a2))


@pytest.mark.parametrize("wh", [(32, 32), (48, 16), (40, 24), (256, 256)])
def test_tiled_pixel_order_bit_exact(wh):
    w, h = wh
    np.testing.assert_array_equal(t_tiled(w, h).numpy(), np.asarray(j_tiled(w, h)))


def test_math_matches_jax():
    """Frames, sampling and Fresnel within 2e-6 (float32 rounding of
    transcendental functions and operation order)."""
    rng = np.random.RandomState(3)
    n = rng.randn(256, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = rng.randn(256, 3).astype(np.float32)
    xi = rng.rand(2, 256).astype(np.float32)
    tn, tw = torch.as_tensor(n), torch.as_tensor(w)
    jn, jw = jnp.asarray(n), jnp.asarray(w)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=2e-6, atol=2e-6)
    close(tmath.normalize(tw), jcore.normalize(jw))
    for a, b in zip(tmath.make_frame(tn), jcore.make_frame(jn)):
        close(a, b)
    close(tmath.to_world(tn, tw), jcore.to_world(jn, jw))
    close(tmath.to_local(tn, tw), jcore.to_local(jn, jw))
    close(tmath.uniform_hemisphere(*map(torch.as_tensor, xi)),
          jcore.uniform_hemisphere(*map(jnp.asarray, xi)))
    p = rng.rand(3, 256, 3).astype(np.float32)
    for a, b in zip(tmath.uniform_sample_triangle(*map(torch.as_tensor, p), *map(torch.as_tensor, xi)),
                    jcore.uniform_sample_triangle(*map(jnp.asarray, p), *map(jnp.asarray, xi))):
        close(a, b)
    for a, b in zip(tmath.cartesian_to_spherical(tn), jcore.cartesian_to_spherical(jn)):
        close(a, b)
    eta_i = np.where(rng.rand(256) > 0.5, 1.33, 1.0).astype(np.float32)
    eta_t = np.where(eta_i > 1.0, 1.0, 1.33).astype(np.float32)
    wi_t, tir_t = tmath.refract_z(tn, torch.as_tensor(eta_i), torch.as_tensor(eta_t))
    wi_j, tir_j = jcore.refract_z(jn, jnp.asarray(eta_i), jnp.asarray(eta_t))
    close(wi_t, wi_j)
    np.testing.assert_array_equal(tir_t.numpy(), np.asarray(tir_j))
    close(tmath.dielectric_reflectance(tn[:, 2].abs(), torch.as_tensor(eta_i), torch.as_tensor(eta_t)),
          jcore.dielectric_reflectance(jnp.abs(jn[:, 2]), jnp.asarray(eta_i), jnp.asarray(eta_t)))


def test_camera_rays_match_jax():
    """Camera basis and jittered rays within 1e-6."""
    args = ([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0, 48, 32)
    jc = jcore.Camera.look_at(*args)
    tc = tcore.Camera.look_at(*args, device="cpu")
    for f in ("origin", "forward", "right", "up", "tan_half_fov"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   rtol=1e-6, atol=1e-6)
    rng = np.random.RandomState(5)
    pix = np.arange(48 * 32)
    xi = rng.rand(2, pix.size).astype(np.float32)
    jo, jd = jc.generate_rays(jnp.asarray(pix // 48), jnp.asarray(pix % 48), *map(jnp.asarray, xi))
    to, td = tc.generate_rays(torch.as_tensor(pix // 48), torch.as_tensor(pix % 48),
                              *map(torch.as_tensor, xi))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def _port_sources():
    pkg = os.path.join(ROOT, "pg2024_dprt_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every .py of the port, and chip_smoke.py, imports torch-side code
    only: no `jax`, no `pg2024_dprt_tpu` (the port keeps its own copies)."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "pg2024_dprt_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {name}")
    assert not bad, bad


def test_kernel_sources_include_only_cuda_and_their_own_headers():
    """Every source in csrc/ includes CUDA toolkit and C headers and the
    port's own headers only: no Python, PyTorch or JAX header, so the kernels
    build with nvcc alone. Every library of ops/_build.py has its source, and
    the fused-frame and texture modules are in the import scan above."""
    from pg2024_dprt_tpu_torch.ops import _build

    csrc = os.path.join(ROOT, "pg2024_dprt_tpu_torch", "csrc")
    own = set(os.listdir(csrc))
    assert {"resident_trace.cu", "resident_trace.cuh", "frame.cu"} <= own
    assert set(_build.SOURCES.values()) <= own
    allowed = {"cuda_runtime.h", "math_constants.h", "stdint.h"}
    bad = []
    for f in sorted(own):
        for n, line in enumerate(open(os.path.join(csrc, f)), 1):
            if line.lstrip().startswith("#include"):
                name = line.split()[1].strip('<>"')
                if name not in allowed | own:
                    bad.append(f"{f}:{n} {name}")
    assert not bad, bad
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {"pg2024_dprt_tpu_torch/ops/frame.py",
            "pg2024_dprt_tpu_torch/scene/textures.py"} <= scanned


def test_entry_points_need_cuda_unless_told(monkeypatch):
    """Without CUDA and without device=, entry points raise instead of
    quietly running on the CPU."""
    from pg2024_dprt_tpu_torch.render import RenderConfig, render_image
    from pg2024_dprt_tpu_torch.scene import (
        EnvironmentMap, cornell_box, device_scene_from_meshes)

    meshes, lights = cornell_box(device="cpu")
    scene = device_scene_from_meshes(meshes, device="cpu")
    env = EnvironmentMap.constant((0.1, 0.1, 0.1), device="cpu")
    cam = tcore.Camera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, 16, 16,
                               device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_image(scene, lights, env, cam, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_scene_from_meshes(meshes)
    img = render_image(scene, lights, env, cam, cfg, device="cpu")
    assert img.shape == (16, 16, 3) and img.device.type == "cpu"
