"""The benchmark's inputs, each from the configuration's own seeds: the
scene's, made by its kind (`kinds/<kind>.py` `inputs`; for the kinds of
triangle meshes, frozen copies of the generators the configurations name),
and the proxy nets' weights, drawn on the device in one call. Every run of
a configuration renders the same scene with the same nets, so a run's seed
changes which samples it renders, not how much work a frame is.

Seeded nets are nearly constant over their inputs, and their means differ
from net to net far more than each varies, so one added bias would make some
nets predict a hit on every query and others on none. Trained vis nets
predict hits on about the share of queries that really hit, and their
output crosses 0.5 within each net's inputs. So each vis net's output bias
is set so that it predicts a hit on `vis_hit_share` of a fixed sample of
feature vectors.
"""
from __future__ import annotations

import math

import torch

from . import manifest
from .reference.neural import LEAKY_SLOPE, net
from .run import ROOT

# feature vectors each vis net's bias is set on
BIAS_SAMPLES = 8192


def scene_inputs(scene: dict, root: str = ROOT):
    """The inputs of a configuration's `scene` entry, made by its kind."""
    return manifest.kind(scene["kind"], root).inputs(scene)


# the name scripts/span_report.py calls it by
scene_meshes = scene_inputs


def net_shapes(width: int, depth: int, head_hidden: int) -> list:
    """(name, fan_in, fan_out) of every Linear of one PROD net (5 inputs:
    an origin encoder 3 -> w/8 -> w/2, a direction encoder 2 -> w/8 -> w/2,
    `depth` residual w x w blocks, a head w -> head_hidden -> 1)."""
    e, o = width // 8, width // 2
    return ([("enc_o_w0", 3, e), ("enc_o_w1", e, o), ("enc_d_w0", 2, e), ("enc_d_w1", e, o)]
            + [(f"res_w{i}", width, width) for i in range(depth)]
            + [("head_w0", width, head_hidden), ("head_w1", head_hidden, 1)])


def proxy_nets(nets: dict, count: int, device) -> dict:
    """{"vis": params, "depth": params}, each leaf with a leading axis of
    `count` nets: weights and biases uniform in +-1 / sqrt(fan_in) (a Linear
    layer's default), drawn on `device` by one generator seeded from
    `nets["seed"]`, in one call; then each vis net's output bias moved so
    that it predicts a hit (output over 0.5) on `nets["vis_hit_share"]` of
    `BIAS_SAMPLES` feature vectors drawn from the same generator."""
    shapes = net_shapes(nets["width"], nets["depth"], nets["head_hidden"])
    sizes = [(fi * fo, fo) for _, fi, fo in shapes]
    per_net = sum(a + b for a, b in sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(nets["seed"]))
    u = torch.rand((2, count, per_net), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for k, kind in enumerate(("vis", "depth")):
        params, at = {}, 0
        for (name, fi, fo), (nw, nb) in zip(shapes, sizes):
            bound = 1.0 / math.sqrt(fi)
            params[name] = (u[k, :, at:at + nw] * bound).reshape(count, fi, fo).contiguous()
            params[name.replace("_w", "_b")] = (u[k, :, at + nw:at + nw + nb] * bound).contiguous()
            at += nw + nb
        out[kind] = params
    feats = torch.rand((BIAS_SAMPLES, 5), generator=gen, device=device)
    vis, shift = out["vis"], []
    for p in range(count):
        y = net({k: v[p] for k, v in vis.items()}, feats, nets["depth"])
        pre = torch.where(y >= 0, y, y / LEAKY_SLOPE)
        shift.append(0.5 - torch.quantile(pre, 1.0 - float(nets["vis_hit_share"])))
    vis["head_b1"] = vis["head_b1"] + torch.stack(shift)[:, None]
    return out
