"""Carry state across from the JAX package, as numpy arrays.

These functions build the port's records from the JAX records' fields given
as numpy arrays (e.g. `{k: np.asarray(v) for k, v in
jax_scene._asdict().items()}`), so both packages can trace and shade
identical tables whatever each package's scene build would produce, and run identical
nets: the scene (its curves too), lights, environment and camera; the proxy-box table; the
vis/depth nets' weights (param dicts under the JAX names, weights (in, out),
also as the flat .npz checkpoints the JAX trainer writes, one net a file or
the three trained families of artifacts/ab_scaled/ in one file). Nothing
here imports the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..models.mlp import MLPConfig, PROD_DEPTH, PROD_VIS, param_shapes, bias_name
from ..models.proxy import ProxyModels
from .curves import CurveSet
from .geometry import DeviceScene, ProxyTable
from .lights import EnvironmentMap, LightTable
from .textures import PackedTextures

# DeviceScene fields a JAX scene may leave unset (None)
_OPTIONAL = ("cl_gboxes", "cl_mboxes", "cl_xf", "cl_tri_table", "cl_woop_table",
             "node_min", "node_max", "node_first", "node_count", "node_skip",
             "v0", "v1", "v2", "tri_valid")


def device_scene_from_arrays(arrays: dict, device=None) -> DeviceScene:
    """Port DeviceScene from the JAX DeviceScene's fields. Fields the port
    does not keep (TPU-only tables, per-triangle shading arrays that
    tri_shade packs) are ignored. Instanced scenes carry `cl_xf` and their
    instance-level cluster and group tables across. `albedo_textures`, when
    present, is the dict of the JAX PackedTextures' fields
    (packed_textures_from_arrays), and `curves` the dict of the JAX
    CurveSet's fields (curve_set_from_arrays)."""
    dev = resolve_device(device)
    tex = arrays.get("albedo_textures")
    curves = arrays.get("curves")
    fields = {}
    for name in DeviceScene._fields:
        a = arrays.get(name)
        if name in ("albedo_textures", "curves") or (a is None and name in _OPTIONAL):
            continue
        fields[name] = torch.as_tensor(np.array(arrays[name]), device=dev)
    return DeviceScene(
        **fields,
        albedo_textures=None if tex is None else packed_textures_from_arrays(tex, dev),
        curves=None if curves is None else curve_set_from_arrays(curves, dev))


def curve_set_from_arrays(arrays: dict, device=None) -> CurveSet:
    """Port CurveSet from the JAX CurveSet's fields (p0, p1, r0, r1,
    seg_id, color), piece for piece."""
    dev = resolve_device(device)
    dtypes = {"seg_id": np.int32}
    return CurveSet(**{
        name: torch.as_tensor(np.array(arrays[name], dtypes.get(name, np.float32)),
                              device=dev)
        for name in CurveSet._fields})


def packed_textures_from_arrays(arrays: dict, device=None):
    """Port PackedTextures from the JAX PackedTextures' fields; the scanline
    pool (a TPU-kernel layout) is dropped. None for an empty pool."""
    if np.asarray(arrays["offset"]).shape[0] == 0:
        return None
    dev = resolve_device(device)
    i32 = lambda name: torch.as_tensor(np.array(arrays[name], np.int32), device=dev)
    return PackedTextures(
        torch.as_tensor(np.array(arrays["texels"], np.float32), device=dev),
        i32("offset"), i32("height"), i32("width"), i32("cutout_rows"))


def light_table_from_arrays(arrays: dict, device=None) -> LightTable:
    dev = resolve_device(device)
    return LightTable(**{
        name: torch.as_tensor(np.array(arrays[name], np.float32), device=dev)
        for name in LightTable._fields})


def environment_from_arrays(arrays: dict, device=None) -> EnvironmentMap:
    return EnvironmentMap.from_image(arrays["image"],
                                     float(arrays["rotation_offset"]), device)


def camera_from_arrays(arrays: dict, width: int, height: int,
                       device=None) -> Camera:
    dev = resolve_device(device)
    f32 = lambda name: torch.as_tensor(np.array(arrays[name], np.float32), device=dev)
    return Camera(f32("origin"), f32("forward"), f32("right"), f32("up"),
                  f32("tan_half_fov"), width, height)


def proxy_table_from_arrays(arrays: dict, device=None) -> ProxyTable:
    """Port ProxyTable from the JAX ProxyTable's fields (unset instancing
    fields and an unset `vis_grid` stay None)."""
    dev = resolve_device(device)
    dtypes = {"obj_id": np.int32, "node_id": np.int32, "vis_grid": bool}
    fields = {}
    for name in ProxyTable._fields:
        a = arrays.get(name)
        if a is not None:
            fields[name] = torch.as_tensor(
                np.array(a, dtypes.get(name, np.float32)), device=dev)
    return ProxyTable(**fields)


def mlp_params_from_arrays(arrays: dict, cfg: MLPConfig = None, device=None) -> dict:
    """Param dict of tensors from a dict of numpy arrays under the JAX names
    (one net, or nets stacked along a leading object axis). With `cfg`, the
    names and trailing shapes are checked against the architecture."""
    dev = resolve_device(device)
    params = {k: torch.as_tensor(np.array(v, np.float32), device=dev)
              for k, v in arrays.items()}
    if cfg is not None:
        for wn, fi, fo in param_shapes(cfg):
            for name, shape in ((wn, (fi, fo)), (bias_name(wn), (fo,))):
                if name not in params or tuple(params[name].shape[-len(shape):]) != shape:
                    got = tuple(params[name].shape) if name in params else None
                    raise ValueError(f"{name}: want trailing shape {shape}, got {got}")
        if len(params) != 2 * len(param_shapes(cfg)):
            raise ValueError("arrays hold names the architecture does not have")
    return params


def proxy_models_from_arrays(vis: dict, depth: dict, num_objects: int,
                             vis_cfg: MLPConfig = PROD_VIS,
                             depth_cfg: MLPConfig = PROD_DEPTH,
                             multi_geo: bool = False, combined: bool = False,
                             device=None) -> ProxyModels:
    """Port ProxyModels from the JAX ProxyModels' param dicts (`depth` is
    empty for combined nets) and its static fields."""
    return ProxyModels(
        mlp_params_from_arrays(vis, vis_cfg, device),
        mlp_params_from_arrays(depth, None if combined else depth_cfg, device),
        num_objects, vis_cfg, depth_cfg, multi_geo=multi_geo, combined=combined)


def load_mlp_checkpoint(path: str, cfg: MLPConfig = None, device=None) -> dict:
    """One net's params from a flat .npz checkpoint under the JAX names, as
    the JAX trainer's save_checkpoint writes it
    (artifacts/proxies/vis_prod-*.npz, depth_prod-*.npz, combined_prod-*.npz)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return mlp_params_from_arrays({k: data[k] for k in data.files}, cfg, device)


def load_ab_scaled_models(path: str, device=None):
    """The three trained model families of one flat prefixed .npz, as
    artifacts/ab_scaled/weights.npz holds them (one net per key prefix:
    vis{p}/, depth{p}/ and comb{p}/ for each partition p, mgvis/ and
    mgdepth/ for the shared multi-geo pair; names and (in, out) weights as
    the JAX trainer writes them). The architecture is read from the arrays:
    width from the first encoder, depth from the residual weights; head
    widths and activations are the trainer's (separate nets leaky_relu,
    combined nets a sigmoid double output, multi-geo nets leaky_relu with 6
    inputs). Returns (separate, combined, multi-geo) ProxyModels on
    `device` (CUDA unless given)."""
    from ..models.mlp import MLPConfig
    from ..models.proxy import combined_proxy_models, multigeo_proxy_models

    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}

    def net(prefix):
        pre = prefix + "/"
        return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}

    parts = sum(1 for k in arrays if k.startswith("vis") and k.endswith("/enc_o_w0"))
    first = net("vis0")
    width = 8 * first["enc_o_w0"].shape[1]
    depth = sum(1 for k in first if k.startswith("res_w"))
    sep_cfg = MLPConfig(width=width, depth=depth, head_hidden=first["head_w0"].shape[1])
    comb_cfg = dataclasses.replace(sep_cfg, out_features=2, final_activation="sigmoid")
    mg = net("mgvis")
    mg_cfg = MLPConfig(width=width, depth=depth, in_features=6, multi_geo=True,
                       head_hidden=mg["head_w1"].shape[1])
    stacked = lambda name: {k: np.stack([net(f"{name}{p}")[k] for p in range(parts)])
                            for k in net(f"{name}0")}
    separate = proxy_models_from_arrays(stacked("vis"), stacked("depth"), parts,
                                        sep_cfg, sep_cfg, device=device)
    combined = combined_proxy_models(
        mlp_params_from_arrays(stacked("comb"), comb_cfg, device), parts, comb_cfg)
    multigeo = multigeo_proxy_models(
        mlp_params_from_arrays(mg, mg_cfg, device),
        mlp_params_from_arrays(net("mgdepth"), mg_cfg, device), parts, mg_cfg, mg_cfg)
    return separate, combined, multigeo
