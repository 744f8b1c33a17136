"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX, where the repository's conftest.py cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Tests marked `cuda` skip without a GPU; the CUDA kernels have no CPU mode.
Tolerance: exact. The kernels are built without FMA contraction and pick
the same lexicographic (t, slot) winner as the plain versions.
"""
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu_torch import ops as tops
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
    field, and each wrapper counts exactly its own launch."""
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
