"""The port's proxy nets (models/mlp.py, models/proxy.py, ops/mlp.py) against
the JAX package, on the same weights and queries (made with numpy from a
seed and handed to both).

Tolerances: in f32 the two packages run the same sums in another order:
rtol / atol 2e-5. With bf16 operands every product rounds its activation to
bf16, the sums run in another order, and one flipped bf16 rounding of an
activation moves an output by about 2^-8 relative: rtol / atol 2e-2, the JAX
package's own limit between its Pallas kernels and its grouped engine.
The Pallas kernels run in interpret mode.
"""
import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.models import mlp as jmlp
from pg2024_dprt_tpu.models import proxy as jproxy
from pg2024_dprt_tpu.ops import pallas_mlp as jpallas
from pg2024_dprt_tpu.train.datasets import INSTANCE_DIVISOR as J_INSTANCE_DIVISOR
from pg2024_dprt_tpu.train.loop import load_checkpoint as j_load_checkpoint
from pg2024_dprt_tpu_torch import models as tmodels
from pg2024_dprt_tpu_torch.models import mlp as tmlp
from pg2024_dprt_tpu_torch.ops import mlp as tops_mlp
from pg2024_dprt_tpu_torch.scene import (
    load_mlp_checkpoint, mlp_params_from_arrays, proxy_models_from_arrays,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = tmlp.MLPConfig(width=64, depth=2)
CONFIGS = ["PROD_VIS", "PROD_DEPTH", "MULTIGEO_VIS", "MULTIGEO_DEPTH", "COMBINED_VISDEPTH"]


def _jcfg(cfg):
    return jmlp.MLPConfig(**{f: getattr(cfg, f) for f in (
        "width", "depth", "in_features", "head_hidden", "final_activation",
        "out_features", "multi_geo")})


def _to_jax(params):
    return {k: jnp.asarray(v.numpy()) for k, v in params.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", CONFIGS)
def test_named_configs_and_param_layout_match_jax(name):
    tc, jc = getattr(tmlp, name), getattr(jmlp, name)
    assert _jcfg(tc) == jc
    assert tmlp.param_shapes(tc) == jmlp.param_shapes(jc)
    assert tmlp.param_names(tc) == jmlp.param_names(jc)
    params = tmlp.init_mlp(np.random.RandomState(0), tc, device="cpu")
    assert list(params) == tmlp.param_names(tc)
    for wn, fi, fo in tmlp.param_shapes(tc):
        w, b = params[wn], params[tmlp.bias_name(wn)]
        assert tuple(w.shape) == (fi, fo) and tuple(b.shape) == (fo,)
        assert float(w.abs().max()) <= 1.0 / np.sqrt(fi) and float(b.abs().max()) <= 1.0 / np.sqrt(fi)


def test_macs_per_row_of_the_production_net():
    assert tmlp.macs_per_row(tmlp.PROD_VIS) == 286_944


def test_init_takes_a_torch_generator():
    a = tmlp.init_mlp(torch.Generator().manual_seed(3), tmlp.PROD_VIS, device="cpu")
    b = tmlp.init_mlp(torch.Generator().manual_seed(3), tmlp.PROD_VIS, device="cpu")
    c = tmlp.init_mlp(torch.Generator().manual_seed(4), tmlp.PROD_VIS, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["res_w0"], c["res_w0"])


def test_initialisers_need_cuda_unless_told(monkeypatch):
    """Like every entry point of the port, the seeded initialisers put their
    tensors on CUDA and raise when there is none, unless told device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmlp.init_mlp(np.random.RandomState(0), SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.random_proxy_models(0, 2, SMALL, SMALL)
    assert tmodels.random_proxy_models(0, 2, SMALL, SMALL, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("mode,tol", [("f32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("name", ["PROD_VIS", "MULTIGEO_VIS", "COMBINED_VISDEPTH"])
def test_apply_mlp_matches_jax_at_published_widths(name, mode, tol):
    tc = getattr(tmlp, name)
    params = tmlp.init_mlp(np.random.RandomState(11), tc, device="cpu")
    x = np.random.RandomState(12).rand(64, tc.in_features).astype(np.float32)
    tdt, jdt = (torch.float32, jnp.float32) if mode == "f32" else (torch.bfloat16, jnp.bfloat16)
    got = tmlp.apply_mlp(params, torch.as_tensor(x), tc, compute_dtype=tdt)
    want = jmlp.apply_mlp(_to_jax(params), jnp.asarray(x), _jcfg(tc), compute_dtype=jdt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (64,)
    _close(got, want, tol)
    got_all = tmlp.apply_mlp_all(params, torch.as_tensor(x), tc, compute_dtype=tdt)
    want_all = jmlp.apply_mlp_all(_to_jax(params), jnp.asarray(x), _jcfg(tc), compute_dtype=jdt)
    assert tuple(got_all.shape) == (64, tc.out_features)
    _close(got_all, want_all, tol)


def test_half_vs_full_error_and_to_bf16():
    params = tmlp.init_mlp(np.random.RandomState(13), tmlp.PROD_VIS, device="cpu")
    x = np.random.RandomState(14).rand(64, 5).astype(np.float32)
    half = tmlp.to_bf16(params)
    assert all(v.dtype == torch.bfloat16 for v in half.values())
    got = tmlp.half_vs_full_error(params, torch.as_tensor(x))
    want = jmlp.half_vs_full_error(_to_jax(params), jnp.asarray(x))
    assert 0.0 < got < 1e-3 and abs(got - want) <= 0.5 * want + 1e-7


def _grouped_case(q, o_count, cfg, seed, vis_cfg=None):
    m = tmodels.random_proxy_models(np.random.RandomState(seed), o_count, vis_cfg or cfg, cfg,
                                    device="cpu")
    rng = np.random.RandomState(seed + 1)
    feats = rng.rand(q, cfg.in_features).astype(np.float32)
    obj = rng.randint(0, o_count, q).astype(np.int32)
    valid = rng.rand(q) > 0.35
    return m, feats, obj, valid


GROUPED_CASES = [(1500, 4, 0), (130, 1, 4), (777, 8, 6), (333, 3, 8)]


@pytest.mark.parametrize("q,o_count,seed", GROUPED_CASES)
def test_grouped_engine_matches_jax(q, o_count, seed):
    """apply_grouped / apply_grouped_reference against the JAX functions of
    the same name, and against each other (the dispatch drops nothing)."""
    m, feats, obj, valid = _grouped_case(q, o_count, SMALL, seed)
    ta = (torch.as_tensor(feats), torch.as_tensor(obj), torch.as_tensor(valid), o_count)
    ja = (jnp.asarray(feats), jnp.asarray(obj), jnp.asarray(valid), o_count)
    got = tmodels.apply_grouped(m.vis_params, SMALL, *ta, block=256)
    _close(got, jproxy.apply_grouped(_to_jax(m.vis_params), _jcfg(SMALL), *ja, block=256), 2e-2)
    ref = tmodels.apply_grouped_reference(m.vis_params, SMALL, *ta)
    _close(ref, jproxy.apply_grouped_reference(_to_jax(m.vis_params), _jcfg(SMALL), *ja), 2e-2)
    _close(got, ref, 2e-2)
    assert (got[~torch.as_tensor(valid)] == 0).all()
    f32 = tmodels.apply_grouped(m.vis_params, SMALL, *ta, compute_dtype=torch.float32)
    _close(f32, jproxy.apply_grouped(_to_jax(m.vis_params), _jcfg(SMALL), *ja,
                                     compute_dtype=jnp.float32), 2e-5)


def test_apply_grouped_all_matches_jax_on_combined_nets():
    cfg = tmlp.MLPConfig(width=64, depth=2, out_features=2, final_activation="sigmoid")
    m = tmodels.random_combined_proxy_models(np.random.RandomState(20), 5, cfg, device="cpu")
    assert m.combined and m.depth_params == {}
    rng = np.random.RandomState(21)
    feats = rng.rand(600, 5).astype(np.float32)
    obj = rng.randint(0, 5, 600).astype(np.int32)
    valid = rng.rand(600) > 0.2
    got = tmodels.apply_grouped_all(m.vis_params, cfg, torch.as_tensor(feats),
                                    torch.as_tensor(obj), torch.as_tensor(valid), 5, block=128)
    want = jproxy.apply_grouped_all(_to_jax(m.vis_params), _jcfg(cfg), jnp.asarray(feats),
                                    jnp.asarray(obj), jnp.asarray(valid), 5, block=128)
    assert tuple(got.shape) == (600, 2)
    _close(got, want, 2e-2)


def test_apply_multigeo_matches_jax():
    assert tmodels.INSTANCE_DIVISOR == J_INSTANCE_DIVISOR
    cfg = tmlp.MLPConfig(width=64, depth=2, in_features=6, final_activation="sigmoid",
                         multi_geo=True)
    params = tmlp.init_mlp(np.random.RandomState(30), cfg, device="cpu")
    m = tmodels.multigeo_proxy_models(params, params, 6, cfg, cfg)
    assert m.multi_geo
    rng = np.random.RandomState(31)
    feats = rng.rand(400, 5).astype(np.float32)
    obj = rng.randint(-1, 6, 400).astype(np.int32)
    valid = obj >= 0
    got = tmodels.apply_multigeo(params, cfg, torch.as_tensor(feats), torch.as_tensor(obj),
                                 torch.as_tensor(valid))
    want = jproxy.apply_multigeo(_to_jax(params), _jcfg(cfg), jnp.asarray(feats),
                                 jnp.asarray(obj), jnp.asarray(valid))
    _close(got, want, 2e-2)
    assert (got[~torch.as_tensor(valid)] == 0).all()


@pytest.mark.parametrize("kernel", ["pair", "dense"])
@pytest.mark.parametrize("q,o_count,seed", GROUPED_CASES)
def test_pair_and_dense_plain_versions_match_the_pallas_kernels(kernel, q, o_count, seed):
    """grouped_mlp_pair / grouped_mlp_dense on CPU tensors (their plain
    versions) against the JAX functions of the same name in interpret mode;
    the vis net ends in a sigmoid, the depth net in a LeakyReLU, so a swap
    of the two nets' weights or activations would show."""
    vis_cfg = tmlp.MLPConfig(width=64, depth=2, final_activation="sigmoid")
    m, feats, obj, valid = _grouped_case(q, o_count, SMALL, seed, vis_cfg=vis_cfg)
    ta = (torch.as_tensor(feats), torch.as_tensor(obj), torch.as_tensor(valid))
    ja = (jnp.asarray(feats), jnp.asarray(obj), jnp.asarray(valid), o_count)
    t_fn = {"pair": tops_mlp.grouped_mlp_pair, "dense": tops_mlp.grouped_mlp_dense}[kernel]
    t_plain = {"pair": tops_mlp.grouped_mlp_pair_plain,
               "dense": tops_mlp.grouped_mlp_dense_plain}[kernel]
    j_fn = {"pair": jpallas.grouped_mlp_pair, "dense": jpallas.grouped_mlp_dense}[kernel]
    assert m.vis_cfg == vis_cfg and m.depth_cfg == SMALL and m.num_objects == o_count
    vis, depth = t_fn(m, *ta)
    j_vis, j_depth = j_fn(_to_jax(m.vis_params), _to_jax(m.depth_params), _jcfg(vis_cfg),
                          _jcfg(SMALL), *ja, block=256, interpret=True)
    _close(vis, j_vis, 2e-2)
    _close(depth, j_depth, 2e-2)
    p_vis, p_depth = t_plain(m, *ta)
    assert torch.equal(vis, p_vis) and torch.equal(depth, p_depth)
    inv = ~torch.as_tensor(valid)
    assert (vis[inv] == 0).all() and (depth[inv] == 0).all()
    assert float(vis.max()) <= 1.0 and float(depth.min()) < 0.0


def test_pair_kernels_refuse_other_architectures():
    m, feats, obj, valid = _grouped_case(64, 2, SMALL, 40)
    ta = (torch.as_tensor(feats), torch.as_tensor(obj), torch.as_tensor(valid))
    wide = tmlp.MLPConfig(width=128, depth=2)
    two = tmlp.MLPConfig(width=64, depth=2, out_features=2)
    for vis_cfg, depth_cfg in ((wide, SMALL), (two, two)):
        other = dataclasses.replace(m, vis_cfg=vis_cfg, depth_cfg=depth_cfg)
        assert tops_mlp.pair_refusal(vis_cfg, depth_cfg)
        with pytest.raises(ValueError):
            tops_mlp.grouped_mlp_pair(other, *ta)
    assert tops_mlp.pair_refusal(SMALL, SMALL) is None


def _r16(v):
    return (v + 15) // 16 * 16


def _fragment_index(fan_in, fan_out):
    """(round16(in), round16(out)) positions of a Linear's weights in its
    block of pack_nets' fragment order (csrc/proxy_mlp.cuh): W[16 s + 8 half
    + 2 t + e][16 p + 8 h + g] at lane 4 g + t, element 4 h + 2 half + e of
    the 16-byte slot (pair p, k-step s). Written from that rule, not from
    the packer's permutation."""
    kk = torch.arange(_r16(fan_in))[:, None]
    nn = torch.arange(_r16(fan_out))[None, :]
    lane = 4 * (nn % 8) + (kk % 8) // 2
    elem = 4 * ((nn % 16) // 8) + 2 * ((kk % 16) // 8) + kk % 2
    return (((nn // 16) * (_r16(fan_in) // 16) + kk // 16) * 32 + lane) * 8 + elem


def test_dense_rule_and_packed_layout():
    """The dispatch rule counts bf16 bytes as the JAX package does: 8
    production pairs take the dense kernel, 12 the pair kernel. The packed
    buffers hold each object's Linears in param_shapes order."""
    assert tops_mlp.DENSE_WEIGHT_LIMIT == jpallas.DENSE_WEIGHT_LIMIT
    shape_of = lambda o: {
        **{wn: torch.empty((o, fi, fo), device="meta") for wn, fi, fo in tmlp.param_shapes(tmlp.PROD_VIS)},
        **{tmlp.bias_name(wn): torch.empty((o, fo), device="meta")
           for wn, fi, fo in tmlp.param_shapes(tmlp.PROD_VIS)}}
    for o, dense in ((8, True), (12, False)):
        p = shape_of(o)
        assert tops_mlp.param_bytes(p) == jpallas._param_bytes(p)
        assert tops_mlp.use_dense(p, p) is dense
    m, _, _, _ = _grouped_case(8, 3, SMALL, 50)
    w, b = tops_mlp.pack_nets(m.vis_params, SMALL, 3)
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert tuple(w.shape) == (3, sum(_r16(fi) * _r16(fo) for _, fi, fo in
                                     tmlp.param_shapes(SMALL)))
    off = 16 * 16 + 16 * 32 + 16 * 16 + 16 * 32    # the four encoder Linears, padded
    res_w0 = lambda w: w[:, off + _fragment_index(64, 64)]
    assert torch.equal(res_w0(w)[1], m.vis_params["res_w0"][1].to(torch.bfloat16))
    assert torch.equal(b[2, 8 + 32 + 8 + 32:8 + 32 + 8 + 32 + 64], m.vis_params["res_b0"][2])
    first = tops_mlp.packed_pair(m)
    assert tops_mlp.packed_pair(m) is first
    # a record with other params never sees this record's packed copy
    other = dataclasses.replace(m, vis_params={k: v + 1.0 for k, v in m.vis_params.items()})
    assert other.cache == {} and m.cache
    assert not torch.equal(tops_mlp.packed_pair(other)[0], first[0])
    # a param written in place, or replaced in the dict, repacks
    m.vis_params["res_w0"].mul_(2.0)
    second = tops_mlp.packed_pair(m)
    assert second is not first and tops_mlp.packed_pair(m) is second
    assert torch.equal(res_w0(second[0])[1], m.vis_params["res_w0"][1].to(torch.bfloat16))
    m.depth_params["head_b1"] = m.depth_params["head_b1"] + 1.0
    third = tops_mlp.packed_pair(m)
    assert third is not second and torch.equal(third[3][:, -1:], m.depth_params["head_b1"])


FRAGMENT_CASES = [(w, h, i, False) for w in (16, 24, 64, 256) for h in (1, 20, 64)
                  for i in (3, 8) if h <= w] + [(512, 64, 6, True)]


@pytest.mark.parametrize("width,head,in_features,multi_geo", FRAGMENT_CASES)
def test_fragment_pack_unpacks_to_every_param(width, head, in_features, multi_geo):
    """pack_nets (csrc/proxy_mlp.cuh's fragment order) holds every weight of
    every object exactly, rounded to bf16, at the place the kernels read it
    (_fragment_index); the padding to 16 x 16 blocks is zero; the biases are
    every Linear's, in param_shapes order."""
    cfg = (tmlp.MULTIGEO_VIS if multi_geo else
           tmlp.MLPConfig(width=width, depth=2, head_hidden=head, in_features=in_features))
    o_count = 1 if multi_geo else 3
    params = tmlp.stack_params([tmlp.init_mlp(np.random.RandomState(80 + i), cfg, device="cpu")
                                for i in range(o_count)])
    wf, bf = tops_mlp.pack_nets(params, cfg, o_count)
    assert wf.dtype == torch.bfloat16 and bf.dtype == torch.float32
    assert torch.equal(bf, torch.cat([params[tmlp.bias_name(wn)]
                                      for wn, _, _ in tmlp.param_shapes(cfg)], dim=1))
    off = 0
    for wn, fi, fo in tmlp.param_shapes(cfg):
        index = off + _fragment_index(fi, fo)
        assert len(set(index.flatten().tolist())) == index.numel()
        got = wf[:, index]                                    # (O, K, N)
        assert torch.equal(got[:, :fi, :fo], params[wn].to(torch.bfloat16)), wn
        pad = torch.ones_like(got, dtype=torch.bool)
        pad[:, :fi, :fo] = False
        assert bool((got[pad] == 0).all()), wn
        off += _r16(fi) * _r16(fo)
    assert off == wf.shape[1]


def test_trained_checkpoints_predict_alike_in_both_packages():
    """artifacts/proxies/{vis,depth,combined}_prod-*.npz loaded by both
    packages give the same predictions on 256 seeded queries (bf16, 2e-2)."""
    x = np.random.RandomState(60).rand(256, 5).astype(np.float32)
    for prefix, cfg in (("vis_prod", tmlp.PROD_VIS), ("depth_prod", tmlp.PROD_DEPTH),
                        ("combined_prod", tmlp.COMBINED_VISDEPTH)):
        (path,) = glob.glob(os.path.join(ROOT, "artifacts", "proxies", prefix + "-*.npz"))
        t_params = load_mlp_checkpoint(path, cfg, device="cpu")
        j_params = j_load_checkpoint(path)
        assert set(t_params) == set(j_params)
        got = tmlp.apply_mlp_all(t_params, torch.as_tensor(x), cfg, compute_dtype=torch.bfloat16)
        want = jmlp.apply_mlp_all(j_params, jnp.asarray(x), _jcfg(cfg), compute_dtype=jnp.bfloat16)
        _close(got, want, 2e-2)
        assert float(got.std()) > 1e-3


def test_converters_round_trip():
    """proxy_models_from_arrays carries a JAX ProxyModels' fields across
    unchanged, checks names and shapes, and .to() keeps every field."""
    m = tmodels.random_proxy_models(np.random.RandomState(70), 3, SMALL, SMALL, device="cpu")
    arrays = lambda d: {k: v.numpy() for k, v in d.items()}
    back = proxy_models_from_arrays(arrays(m.vis_params), arrays(m.depth_params), 3,
                                    SMALL, SMALL, device="cpu")
    assert back.num_objects == 3 and back.vis_cfg == SMALL and not back.combined
    for k in m.vis_params:
        assert torch.equal(back.vis_params[k], m.vis_params[k])
        assert torch.equal(back.depth_params[k], m.depth_params[k])
    moved = back.to("cpu")
    assert moved.vis_cfg == back.vis_cfg and moved.cache == {}
    bad = arrays(m.vis_params)
    bad["res_w0"] = bad["res_w0"][:, :, :32]
    with pytest.raises(ValueError, match="res_w0"):
        mlp_params_from_arrays(bad, SMALL, device="cpu")
    comb_cfg = tmlp.MLPConfig(width=64, depth=2, out_features=2)
    comb = tmodels.random_combined_proxy_models(np.random.RandomState(71), 2, comb_cfg,
                                                device="cpu")
    back = proxy_models_from_arrays(arrays(comb.vis_params), {}, 2, comb_cfg, comb_cfg,
                                    combined=True, device="cpu")
    assert back.combined and back.depth_params == {}


def test_ab_scaled_loader_matches_jax_load_models():
    """scene/convert.py::load_ab_scaled_models reads the three trained
    families of artifacts/ab_scaled/weights.npz as the JAX script's
    load_models does: the same architectures, and the same outputs on the
    same features (bf16 operands: rtol / atol 2e-2)."""
    import sys

    from pg2024_dprt_tpu_torch.scene import load_ab_scaled_models

    path = os.path.join(ROOT, "artifacts", "ab_scaled", "weights.npz")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import ab_neural_scaled
    finally:
        sys.path.pop(0)
    j_families = ab_neural_scaled.load_models(path)
    t_families = load_ab_scaled_models(path, device="cpu")
    rng = np.random.RandomState(21)
    q = 512
    feats = rng.rand(q, 5).astype(np.float32)
    obj = rng.randint(-1, 8, q).astype(np.int32)
    valid = (obj >= 0) & (rng.rand(q) > 0.1)
    jargs = (jnp.asarray(feats), jnp.asarray(obj), jnp.asarray(valid))
    targs = (torch.as_tensor(feats), torch.as_tensor(obj), torch.as_tensor(valid))
    for jm, tm, name in zip(j_families, t_families, ("separate", "combined", "multigeo")):
        assert (tm.num_objects, tm.multi_geo, tm.combined) == \
            (jm.num_objects, jm.multi_geo, jm.combined), name
        for jc, tc in ((jm.vis_cfg, tm.vis_cfg), (jm.depth_cfg, tm.depth_cfg)):
            assert dataclasses.asdict(_jcfg(tc)) == dataclasses.asdict(jc), name
        if name == "separate":
            pairs = [(jproxy.apply_grouped(jm.vis_params, jm.vis_cfg, *jargs, 8),
                      tmodels.apply_grouped(tm.vis_params, tm.vis_cfg, *targs, 8)),
                     (jproxy.apply_grouped(jm.depth_params, jm.depth_cfg, *jargs, 8),
                      tmodels.apply_grouped(tm.depth_params, tm.depth_cfg, *targs, 8))]
        elif name == "combined":
            pairs = [(jproxy.apply_grouped_all(jm.vis_params, jm.vis_cfg, *jargs, 8),
                      tmodels.apply_grouped_all(tm.vis_params, tm.vis_cfg, *targs, 8))]
        else:
            pairs = [(jproxy.apply_multigeo(jm.vis_params, jm.vis_cfg, *jargs),
                      tmodels.apply_multigeo(tm.vis_params, tm.vis_cfg, *targs)),
                     (jproxy.apply_multigeo(jm.depth_params, jm.depth_cfg, *jargs),
                      tmodels.apply_multigeo(tm.depth_params, tm.depth_cfg, *targs))]
        for want, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2,
                                       err_msg=name)
            assert float(np.abs(np.asarray(want)).max()) > 0.0
