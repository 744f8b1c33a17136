"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX, where the repository's conftest.py cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Tests marked `cuda` skip without a GPU; the CUDA kernels have no CPU mode.
Tolerance for the trace kernels K1/K2: exact. They are built without FMA
contraction and pick the same lexicographic (t, slot) winner as the plain
versions. Tolerance for the frame kernel K3: a last-bit difference of
sinf/cosf/acosf/atan2f against PyTorch's kernels can flip a hit at an edge,
an RIS pick or a roulette survival, and that pixel then differs by far more
than rounding; so at most 0.1 % of the pixels may lie outside
|a - b| / max(|a|, 1e-2) < 1e-3, and the frame means agree within 1e-3.
"""
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu_torch import ops as tops
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera
from pg2024_dprt_tpu_torch.render import RenderConfig
from pg2024_dprt_tpu_torch.scene import device_scene_from_meshes, random_tri_soup

T_MIN = 1e-3
# canonical ids past 2^24 are not exact in float32: the kernels must carry
# them through cl_tri_map (int32), never through cl_mt_table's row 12
ID_OFFSET = 2**24 + 3


def _case(device, n=8192):
    scene = device_scene_from_meshes([random_tri_soup(5000, seed=60)],
                                     tris_per_cluster=128, device=device)
    rng = np.random.RandomState(61)
    o = (rng.rand(n, 3) * 1.4 - 0.2).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = (rng.rand(n) * 2.0).astype(np.float32)
    act = rng.rand(n) > 0.1
    on = lambda a: torch.as_tensor(a, device=device)
    rays = (on(o), on(d), torch.full((n,), T_MIN, device=device), on(tmax), on(act))
    return scene, rays


def _offset_ids(scene):
    tm = scene.cl_tri_map
    return scene._replace(cl_tri_map=torch.where(tm >= 0, tm + ID_OFFSET, tm))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernels have no CPU mode)")


def test_ids_past_2p24_are_exact_on_cpu():
    """The plain closest hit returns canonical ids from cl_tri_map exactly,
    also past 2^24 where float32 cannot hold them."""
    scene, rays = _case("cpu", n=2048)
    base = tops.resident_closest(scene, *rays)
    big = tops.resident_closest(_offset_ids(scene), *rays)
    assert big.tri_index.dtype == torch.int32
    hit = base.is_hit
    assert hit.sum() > 100
    assert torch.equal(big.is_hit, hit)
    assert torch.equal(big.tri_index[hit], base.tri_index[hit] + ID_OFFSET)
    assert (big.tri_index[~hit] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("offset_ids", [False, True])
def test_kernels_match_plain_on_gpu(offset_ids):
    """K1 and K2 on the card equal their plain versions on the card, field by
    field (so moving their device functions into the shared header changed
    no result), and each wrapper counts exactly its own launch."""
    _need_cuda()
    scene, rays = _case("cuda")
    if offset_ids:
        scene = _offset_ids(scene)
    before = dict(tops.LAUNCHES)
    got = tops.resident_closest(scene, *rays)
    want = tops.resident_closest_plain(scene, *rays)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.is_hit.sum() > 100
    if offset_ids:
        assert (got.tri_index[got.is_hit] >= ID_OFFSET).all()
    occ = tops.resident_anyhit(scene, *rays)
    assert torch.equal(occ, tops.resident_anyhit_plain(scene, *rays))
    assert tops.LAUNCHES["resident_closest"] == before["resident_closest"] + 1
    assert tops.LAUNCHES["resident_anyhit"] == before["resident_anyhit"] + 1


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    """A CUDA wrapper launches its kernel or raises: wrong dtypes or rays on
    another device than the scene raise before any launch."""
    _need_cuda()
    scene, (o, d, tmin, tmax, act) = _case("cuda", n=256)
    before = dict(tops.LAUNCHES)
    with pytest.raises(ValueError):
        tops.resident_closest(scene, o.double(), d, tmin, tmax, act)
    with pytest.raises(ValueError):
        tops.resident_anyhit(scene, o, d, tmin, tmax, act.to(torch.int32))
    cpu_scene = scene._replace(cl_mt_table=scene.cl_mt_table.cpu())
    with pytest.raises(ValueError):
        tops.resident_closest(cpu_scene, o, d, tmin, tmax, act)
    assert tops.LAUNCHES == before


def _frame_case(kind, device):
    """(scene, lights, env, camera, cfg) of a small frame: a 5000-triangle
    soup under an area light with a lat-long sky, or the checkerboard-floor
    cornell with the water box."""
    if kind == "soup":
        scene = device_scene_from_meshes([random_tri_soup(5000, seed=60)],
                                         tris_per_cluster=128, device=device)
        lt = np.asarray([[[0.3, 2.0, 0.3], [0.7, 2.0, 0.3], [0.7, 2.0, 0.7]],
                         [[0.1, 2.0, 0.1], [0.3, 2.0, 0.1], [0.3, 2.0, 0.3]]], np.float32)
        lights = tscene.LightTable.from_arrays(
            lt, np.asarray([[60, 60, 60], [20, 50, 20]], np.float32), device=device)
        sky = np.random.default_rng(0).uniform(0.0, 1.0, (16, 32, 3)).astype(np.float32)
        env = tscene.EnvironmentMap.from_image(sky, rotation_offset=2.007, device=device)
        cam = Camera.look_at([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0, 64, 64,
                             device=device)
        return scene, lights, env, cam, dict(width=64, height=64, bounces=3)
    meshes, lights = tscene.textured_cornell_box(with_water_sphere=True, device=device)
    scene = device_scene_from_meshes(
        meshes, textures=[tscene.checkerboard(tiles=4)], device=device)
    env = tscene.EnvironmentMap.constant((0.2, 0.3, 0.4), device=device)
    cam = Camera.look_at([0.5, 0.9, 2.2], [0.5, 0.2, 0.0], [0, 1, 0], 45.0, 32, 32,
                         device=device)
    return scene, lights, env, cam, dict(width=32, height=32, bounces=3)


def _frames_agree(got, want):
    for a, b in zip(got[:2], want[:2]):
        rel = (a - b).abs() / a.abs().clamp(min=1e-2)
        outliers = int((rel >= 1e-3).any(dim=1).sum())
        assert outliers <= 1e-3 * a.shape[0], outliers
        assert abs(float(a.mean()) - float(b.mean())) <= 1e-3 * abs(float(b.mean())) + 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["soup", "textured_cornell"])
@pytest.mark.parametrize("nee_mode,rr", [("ris", 0), ("sum", 2)])
def test_frame_kernel_matches_plain_on_gpu(kind, nee_mode, rr):
    """K3 on the card against its plain version on the card, 3 spp in one
    launch; the wrapper counts exactly one launch and none of K1/K2."""
    _need_cuda()
    scene, lights, env, cam, kw = _frame_case(kind, "cuda")
    cfg = RenderConfig(spp=3, nee_mode=nee_mode, russian_roulette=rr, **kw)
    before = dict(tops.LAUNCHES)
    got = tops.render_frame_fused(scene, lights, env, cam, 5, cfg, spp=3)
    after = dict(tops.LAUNCHES)
    want = tops.render_frame_fused_plain(scene, lights, env, cam, 5, cfg, spp=3)
    torch.cuda.synchronize()
    assert after == {**before, "frame_sample": before["frame_sample"] + 1}
    assert float(got[0].max()) > 0.0 and float(got[1].max()) > 0.0
    _frames_agree(got, want)


@pytest.mark.cuda
def test_frame_kernel_is_deterministic():
    """Two K3 launches with the same arguments give bit-identical images."""
    _need_cuda()
    scene, lights, env, cam, kw = _frame_case("soup", "cuda")
    cfg = RenderConfig(spp=2, **kw)
    a = tops.render_frame_fused(scene, lights, env, cam, 1, cfg, spp=2)
    b = tops.render_frame_fused(scene, lights, env, cam, 1, cfg, spp=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_frame_wrapper_refuses_what_the_kernel_does_not_take():
    """A table on another device than the camera, or a camera and a config
    of different sizes, raise before any launch."""
    _need_cuda()
    scene, lights, env, cam, kw = _frame_case("soup", "cuda")
    cfg = RenderConfig(**kw)
    before = dict(tops.LAUNCHES)
    with pytest.raises(ValueError):
        tops.render_frame_fused(scene._replace(tri_shade=scene.tri_shade.cpu()),
                                lights, env, cam, 0, cfg)
    with pytest.raises(ValueError):
        tops.render_frame_fused(scene, lights, env, cam, 0, RenderConfig(width=16, height=16))
    assert tops.LAUNCHES == before
