"""The neural-proxy MLP family (counterpart of pg2024_dprt_tpu/models/mlp.py).

Production architecture: two encoders, origin (3) -> w/8 -> w/2 and
direction (2) -> w/8 -> w/2 (LeakyReLU), concatenated to width w = out1;
`depth` residual blocks h = leaky(h + Linear(w, w) h) = out2; head over
out1 + out2 (the global skip): w -> head_hidden -> out_features, then the
final activation.

Multi-geo architecture: an instance-id encoder 1 -> w/8 -> w/2 beside the
feature encoder 5 -> w/8 -> w/2, concatenated = out1; pre_block Linear(w, w)
+ LeakyReLU; a Linear(w, w) + LeakyReLU, `depth` residual blocks and a
trailing Linear(w, w) without activation = out2; head over out1 + out2:
w -> w/2 -> head_hidden -> out_features.

The structure is written down once, in `net_forward`, which every plain
PyTorch site calls with its own `dot` closure (one net, block-grouped nets);
the CUDA kernels' forward (csrc/proxy_mlp.cuh) is written from it.

Params are plain dicts of tensors under the JAX package's names
(`enc_o_w0` ... `head_b1`), weights stored (in, out), so a checkpoint of
either package loads into the other. Inference runs with bf16 operands and
f32 accumulation: `compute_dtype=torch.bfloat16` rounds the activation and
the weight of every product to bf16 and keeps the product, the sum and the
bias add in f32 (a bf16 x bf16 torch.matmul would round the result to bf16,
which the JAX package does not).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from ..core.device import resolve_device

LEAKY_SLOPE = 0.01  # torch F.leaky_relu default


@dataclass(frozen=True)
class MLPConfig:
    width: int = 256
    depth: int = 4              # number of residual blocks
    in_features: int = 5        # 6 for the multi-geo (instance-id) variant
    head_hidden: int = 64
    final_activation: str = "leaky_relu"  # "leaky_relu" | "sigmoid" | "none"
    # head output channels: 1 = separate vis and depth nets; 2 = the
    # combined double-output net (channel 0 = vis, channel 1 = depth)
    out_features: int = 1
    multi_geo: bool = False

    @property
    def enc_hidden(self) -> int:
        return self.width // 8

    @property
    def enc_out(self) -> int:
        return self.width // 2


# the production configs used by the renderer
PROD_VIS = MLPConfig(width=256, depth=4, final_activation="leaky_relu")
PROD_DEPTH = MLPConfig(width=256, depth=4, final_activation="leaky_relu")
MULTIGEO_VIS = MLPConfig(width=512, depth=3, in_features=6,
                         final_activation="sigmoid", multi_geo=True)
MULTIGEO_DEPTH = MLPConfig(width=512, depth=3, in_features=6,
                           final_activation="leaky_relu", multi_geo=True)
COMBINED_VISDEPTH = MLPConfig(width=256, depth=4, out_features=2,
                              final_activation="sigmoid")


def same_architecture(a: MLPConfig, b: MLPConfig) -> bool:
    """True when two nets differ at most in their final activation (what the
    pair, dense and route kernels need of a vis/depth pair)."""
    key = lambda c: (c.width, c.depth, c.in_features, c.head_hidden)
    return key(a) == key(b)


def param_shapes(cfg: MLPConfig):
    """Ordered (name, fan_in, fan_out) for every Linear in the net."""
    shapes = []
    if cfg.multi_geo:
        feat_in = cfg.in_features - 1
        shapes += [("enc_f_w0", feat_in, cfg.enc_hidden),
                   ("enc_f_w1", cfg.enc_hidden, cfg.enc_out),
                   ("enc_i_w0", 1, cfg.enc_hidden),
                   ("enc_i_w1", cfg.enc_hidden, cfg.enc_out),
                   ("pre_w", cfg.width, cfg.width),
                   ("rbin_w", cfg.width, cfg.width)]
        shapes += [(f"res_w{i}", cfg.width, cfg.width)
                   for i in range(cfg.depth)]
        shapes += [("rbout_w", cfg.width, cfg.width),
                   ("head_w0", cfg.width, cfg.width // 2),
                   ("head_w1", cfg.width // 2, cfg.head_hidden),
                   ("head_w2", cfg.head_hidden, cfg.out_features)]
    else:
        origin_in = cfg.in_features - 2
        shapes += [("enc_o_w0", origin_in, cfg.enc_hidden),
                   ("enc_o_w1", cfg.enc_hidden, cfg.enc_out),
                   ("enc_d_w0", 2, cfg.enc_hidden),
                   ("enc_d_w1", cfg.enc_hidden, cfg.enc_out)]
        shapes += [(f"res_w{i}", cfg.width, cfg.width)
                   for i in range(cfg.depth)]
        shapes += [("head_w0", cfg.width, cfg.head_hidden),
                   ("head_w1", cfg.head_hidden, cfg.out_features)]
    return shapes


def bias_name(wn: str) -> str:
    return wn.replace("_w", "_b") if "_w" in wn else wn + "_b"


def param_names(cfg: MLPConfig):
    """Flat ordered weight/bias name list (the kernel wrappers' layout)."""
    names = []
    for wn, _, _ in param_shapes(cfg):
        names += [wn, bias_name(wn)]
    return names


def param_layout(cfg: MLPConfig) -> Dict[str, tuple]:
    """Every param's shape by name, in sorted name order: weights (in, out),
    biases (out,)."""
    shapes = {}
    for wn, fi, fo in param_shapes(cfg):
        shapes[wn], shapes[bias_name(wn)] = (fi, fo), (fo,)
    return dict(sorted(shapes.items()))


def flatten_params(params: Dict, cfg: MLPConfig) -> torch.Tensor:
    """One net's params as one f32 vector, in param_layout's order, so that
    unflatten_params reads it back from `cfg` alone."""
    layout = param_layout(cfg)
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != layout:
        raise ValueError(f"params {got} are not those of {cfg}: {layout}")
    return torch.cat([params[k].reshape(-1).to(torch.float32) for k in layout])


def unflatten_params(vec: torch.Tensor, cfg: MLPConfig) -> Dict[str, torch.Tensor]:
    """flatten_params' inverse: views of `vec` under the param names."""
    out, at = {}, 0
    for k, shape in param_layout(cfg).items():
        n = math.prod(shape)
        out[k] = vec[at:at + n].reshape(shape)
        at += n
    if at != vec.numel():
        raise ValueError(f"a vector of {vec.numel()} values holds {at} params of {cfg}")
    return out


def macs_per_row(cfg: MLPConfig) -> int:
    """Multiply-adds of one forward pass of one row."""
    return sum(fi * fo for _, fi, fo in param_shapes(cfg))


def init_mlp(rng, cfg: MLPConfig = PROD_VIS, device=None) -> Dict[str, torch.Tensor]:
    """Random params with nn.Linear's default bounds, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weight and bias, drawn on the host from `rng` (a
    numpy RandomState or a CPU torch.Generator) and put on `device` (CUDA
    unless given)."""
    device = resolve_device(device)
    params = {}
    for wn, fi, fo in param_shapes(cfg):
        bound = 1.0 / math.sqrt(fi)
        for name, shape in ((wn, (fi, fo)), (bias_name(wn), (fo,))):
            if isinstance(rng, torch.Generator):
                u = torch.rand(shape, generator=rng, dtype=torch.float32)
            else:
                u = torch.as_tensor(rng.random_sample(shape).astype(np.float32))
            params[name] = ((u * 2.0 - 1.0) * bound).to(device)
    return params


def _leaky(x):
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def net_forward(x, dot: Callable, cfg: MLPConfig, final_activation: str):
    """The one place the network structure is written down.

    `dot(h, w_name, out_width)` computes h @ W + b for the named Linear
    (bias name derived); each site supplies its own closure. Returns the
    (..., out_features) head output after `final_activation`."""
    if cfg.multi_geo:
        feat = x[..., : cfg.in_features - 1]
        iid = x[..., cfg.in_features - 1:]
        hf = _leaky(dot(feat, "enc_f_w0", cfg.enc_hidden))
        hf = _leaky(dot(hf, "enc_f_w1", cfg.enc_out))
        hi = _leaky(dot(iid, "enc_i_w0", cfg.enc_hidden))
        hi = _leaky(dot(hi, "enc_i_w1", cfg.enc_out))
        out1 = torch.cat([hf, hi], dim=-1)                   # (..., width)
        h = _leaky(dot(out1, "pre_w", cfg.width))            # pre_block
        h = _leaky(dot(h, "rbin_w", cfg.width))              # res_block lead
        for i in range(cfg.depth):
            h = _leaky(h + dot(h, f"res_w{i}", cfg.width))
        h = dot(h, "rbout_w", cfg.width)                     # trail, no act
        h = out1 + h                                         # global skip
        h = _leaky(dot(h, "head_w0", cfg.width // 2))
        h = _leaky(dot(h, "head_w1", cfg.head_hidden))
        out = dot(h, "head_w2", cfg.out_features)
    else:
        origin = x[..., : cfg.in_features - 2]
        direction = x[..., cfg.in_features - 2:]
        ho = _leaky(dot(origin, "enc_o_w0", cfg.enc_hidden))
        ho = _leaky(dot(ho, "enc_o_w1", cfg.enc_out))
        hd = _leaky(dot(direction, "enc_d_w0", cfg.enc_hidden))
        hd = _leaky(dot(hd, "enc_d_w1", cfg.enc_out))
        out1 = torch.cat([ho, hd], dim=-1)                   # (..., width)
        h = out1
        for i in range(cfg.depth):
            h = _leaky(h + dot(h, f"res_w{i}", cfg.width))
        h = out1 + h                                         # global skip
        h = _leaky(dot(h, "head_w0", cfg.head_hidden))
        out = dot(h, "head_w1", cfg.out_features)
    if final_activation == "leaky_relu":
        out = _leaky(out)
    elif final_activation == "sigmoid":
        out = torch.sigmoid(out)
    return out


def rounded(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x as f32 after a round trip through `compute_dtype` (the operand
    rounding of a reduced-precision product that accumulates in f32)."""
    if compute_dtype == torch.float32:
        return x.to(torch.float32)
    return x.to(compute_dtype).to(torch.float32)


def apply_mlp_all(params: Dict, x: torch.Tensor, cfg: MLPConfig,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Forward pass keeping every head channel: x (..., in_features) ->
    (..., out_features). The combined net's consumer reads channel 0 = vis,
    channel 1 = depth."""

    def dot(h, wn, out_w):
        return (torch.matmul(rounded(h, compute_dtype), rounded(params[wn], compute_dtype))
                + params[bias_name(wn)].to(torch.float32))

    return net_forward(rounded(x, compute_dtype), dot, cfg, cfg.final_activation)


def apply_mlp(params: Dict, x: torch.Tensor, cfg: MLPConfig = PROD_VIS,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Forward pass: x (..., in_features) -> (...,) prediction (channel 0)."""
    return apply_mlp_all(params, x, cfg, compute_dtype)[..., 0]


def stack_params(params_list) -> Dict[str, torch.Tensor]:
    """Stack per-object param dicts along a new leading axis (the grouped
    inference engine's weight layout)."""
    return {k: torch.stack([p[k] for p in params_list], dim=0) for k in params_list[0]}


def to_bf16(params: Dict) -> Dict:
    """Half-precision deployment weights."""
    return {k: v.to(torch.bfloat16) for k, v in params.items()}


def half_vs_full_error(params: Dict, x, cfg: MLPConfig = PROD_VIS) -> float:
    """f32-vs-bf16 prediction MSE."""
    full = apply_mlp(params, x, cfg, compute_dtype=torch.float32)
    half = apply_mlp(to_bf16(params), x, cfg, compute_dtype=torch.bfloat16)
    return float(torch.mean((full - half) ** 2))
