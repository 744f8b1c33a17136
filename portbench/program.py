"""The system under test: the port's public entries, given the benchmark's
inputs and nets.

`Program` builds what a user of the port builds for a configuration and
renders one frame a call. The scene is its kind's build (`kinds/<kind>.py`:
`device_scene`, or `partitioned_scene` for a configuration with
partitions), through the port's public entries; the rest is shared: the
lights, sky, camera and render request, the mesh and the proxy models, and
the frame entry, `render_image` for a configuration without partitions and
`render_image_distributed` for one with them, on its own in-process mesh or
on a mesh the caller gives (`mesh`: a rank's, ranks.py). Everything the
port derives (cluster tables, partitions, proxy boxes, packed nets) stays
the port's; the reference works it out again.
"""
from __future__ import annotations

import torch

from . import manifest
from .run import ROOT


def partitioned_scene(kind, inputs, scene: dict, device):
    """The kind's partitioned scene, or ValueError where the kind has none."""
    if not hasattr(kind, "partitioned_scene"):
        raise ValueError(f"scene kind {scene['kind']!r} builds no partitioned scene: "
                         f"{kind.__file__} has no partitioned_scene")
    return kind.partitioned_scene(inputs, scene, device)


class Program:
    def __init__(self, config: dict, neural: bool, inputs, nets, device, mesh=None,
                 root: str = ROOT):
        from pg2024_dprt_tpu_torch.core.camera import Camera
        from pg2024_dprt_tpu_torch.models import MLPConfig, ProxyModels
        from pg2024_dprt_tpu_torch.parallel import make_mesh, render_image_distributed
        from pg2024_dprt_tpu_torch.render import RenderConfig, render_image
        from pg2024_dprt_tpu_torch.render.engine import _on
        from pg2024_dprt_tpu_torch.scene import EnvironmentMap, LightTable

        self.device = torch.device(device)
        req, cam, lights, sky = (config[k] for k in ("request", "camera", "lights", "sky"))
        self.cfg = RenderConfig(
            width=req["width"], height=req["height"], spp=req["spp"], bounces=req["bounces"],
            shadow_path_count=req["shadow_path_count"], max_proxy_hits=req["max_proxy_hits"],
            t_epsilon=req["t_epsilon"], nee_mode=req["nee_mode"], use_neural_proxies=neural)
        self.camera = Camera.look_at(cam["eye"], cam["target"], cam["up"], cam["fov_degrees"],
                                     req["width"], req["height"], device=self.device)
        self.lights = LightTable.from_arrays(lights["triangles"], lights["radiance"],
                                             device=self.device)
        self.env = EnvironmentMap.constant(sky["color"], sky["height"], sky["width"],
                                           device=self.device)
        scene = config["scene"]
        kind = manifest.kind(scene["kind"], root)
        self.partitions = scene.get("partitions", 0)
        if mesh is not None:
            # as the port's command line builds for a rank: every partition
            # on the host, then the mesh's own on its device (exact frames)
            part = partitioned_scene(kind, inputs, scene, "cpu")
            self.scene = part._replace(
                scenes=[_on(self.device, s) if i in mesh.local else None
                        for i, s in enumerate(part.scenes)],
                proxies=part.proxies.to(self.device))
            self.mesh = mesh
            self._render = lambda b: render_image_distributed(
                self.scene, None, self.lights, self.env, self.camera, self.cfg,
                mesh=self.mesh, base_sample=b, return_stats=True)
        elif self.partitions:
            self.scene = partitioned_scene(kind, inputs, scene, self.device)
            self.mesh = make_mesh(self.partitions, self.device)
            spec = config["nets"]
            ncfg = MLPConfig(width=spec["width"], depth=spec["depth"],
                             head_hidden=spec["head_hidden"], final_activation="leaky_relu")
            self.models = ProxyModels(nets["vis"], nets["depth"], self.partitions, ncfg, ncfg)
            self._render = lambda b: render_image_distributed(
                self.scene, self.models, self.lights, self.env, self.camera, self.cfg,
                mesh=self.mesh, base_sample=b, return_stats=True, device=self.device)
        else:
            self.scene = kind.device_scene(inputs, scene, self.device)
            self._render = lambda b: (render_image(self.scene, self.lights, self.env, self.camera,
                                                   self.cfg, base_sample=b,
                                                   device=self.device), None)

    def frame(self, base_sample: int):
        """(image (H, W, 3), stats or None) of the frame at `base_sample`:
        the distributed frame's stats (migration rounds per bounce, paths
        moved), None for the single-device frame."""
        return self._render(int(base_sample))
