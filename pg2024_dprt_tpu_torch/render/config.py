"""Declarative render configuration (counterpart of
pg2024_dprt_tpu/render/config.py), with the same fields so one config
serializes for both packages.

What the port does with each field today:
  * `tracer`: "auto" and "resident" run the resident trace (CUDA kernels on
    CUDA tensors, plain versions on CPU tensors); "stackless" and "cluster"
    are not ported and raise.
  * `fused_frame`: "off" runs the composed path (closest trace, shade +
    NEE, any-hit shadow trace, accumulation per bounce). "on" runs the
    fused frame (ops/frame.py: all spp in one launch of the frame kernel
    for CUDA tensors, its plain version for CPU tensors) and raises for a
    scene its gate rejects. "auto" is fused when the tensors are on CUDA,
    `tracer` is "auto" or "resident" and the gate accepts the scene (no
    cutout textures, at least one light, bounces <= 8), else composed.
  * `use_neural_proxies`, `max_proxy_hits`, `max_migrations`,
    `bucket_fraction` and `use_visibility_grids` serve the distributed and
    neural paths, not ported yet; the single-device frame ignores them,
    as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 256
    spp: int = 1
    bounces: int = 4
    # NEE shadow rays per shading point (reference shadowPathCount=4).
    shadow_path_count: int = 4
    # Max proxy-AABB marching steps per ray (reference maxCount=3).
    max_proxy_hits: int = 3
    # Ray epsilon.
    t_epsilon: float = 1e-3
    # Neural-proxy routing for secondary/shadow rays (bounce >= 1).
    use_neural_proxies: bool = False
    # Wavefront migration iterations safety bound (distributed path).
    max_migrations: int = 32
    # Traversal backend: "auto" | "resident" (see module docstring).
    tracer: str = "auto"
    # Whole-sample fused frame: "auto" | "off" (composed path) | "on".
    fused_frame: str = "auto"
    # Per-destination bucket capacity as a fraction of path capacity.
    bucket_fraction: float = 1.0
    # NEE estimator: "ris" draws shadow_path_count light candidates and
    # traces ONE occlusion ray chosen by weighted reservoir sampling; "sum"
    # traces all shadow_path_count rays per shading point.
    nee_mode: str = "ris"
    # Russian roulette: paths entering bounce >= this index are survival-
    # tested with 1/p compensation (render/shade.py). 0 = off.
    russian_roulette: int = 0
    # Cross-partition culling via visibility grids (distributed path).
    use_visibility_grids: bool = False

    @property
    def frame_buffer_size(self) -> int:
        return self.width * self.height

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        return RenderConfig(**json.loads(s))
