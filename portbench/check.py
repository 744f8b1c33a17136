"""How `correct` is decided: the frames the window rendered, at pixels
drawn from the seed, against the plain reference.

One frame early in the window (its ordinal drawn from the seed among the
first `check.early_frames`) and the window's last frame are checked. Each
frame's pixels come from one ordering of the image drawn from the seed:

  * its first `check.pixels` pixels, a uniform sample of the image, give
    `outlier_share`;
  * where the mix sets `check.net_pixels` (the neural cells), the next
    pixels of the ordering, up to `check.pool` in all, are rendered by the
    reference too, and the first `net_pixels` of them whose path a net's
    predicted hit decided (a route to another partition, or a shadow ray
    blocked) give `outlier_share.nets`. Those are the pixels the nets and
    K7's route decisions set; a uniform sample holds few of them.

A pixel is an outlier when its value is not finite or any channel differs
from the reference's by `PIXEL_TOLERANCE` of the reference's value (or of
1e-2, where that is larger). A number is the share of outliers among its
pixels: paths whose rays graze an edge may take another branch on the card
than in the reference, and each such path is one outlier.
"""
from __future__ import annotations

import numpy as np
import torch

from . import manifest
from .reference.neural import bf16, render_pixels_neural
from .reference.pathtrace import make_view, render_pixels
from .run import ROOT

PIXEL_TOLERANCE = 1e-3


def plan(check: dict, seed: int, npix: int):
    """(early frame ordinal, per checked frame a (pool,) ordering of pixel
    ids drawn from the seed)."""
    rng = np.random.default_rng([int(seed) % (2 ** 32), int(seed) // (2 ** 32), 0x5EED])
    early = int(rng.integers(0, check["early_frames"]))
    size = min(max(check["pixels"], check.get("pool", 0)), npix)
    orders = [rng.choice(npix, size=size, replace=False) for _ in range(2)]
    return early, orders


class Reference:
    """The reference renderer of one configuration's scene and nets. The
    scene, its partitions and their boxes are its kind's `reference` of the
    benchmark's inputs (`kinds/<kind>.py`), and the frame traces through
    that scene's queries: which primitives a ray can hit, and how, is the
    kind's to know, as its build is on the program's side."""

    def __init__(self, config: dict, neural: bool, inputs, nets, device,
                 dtype=torch.float32, operand=bf16, root: str = ROOT):
        self.config, self.neural, self.operand = config, neural, operand
        self.view = make_view(config["camera"], config["lights"], config["sky"],
                              config["request"], device, dtype)
        kind = manifest.kind(config["scene"]["kind"], root)
        self.scene, self.boxes = kind.reference(inputs, config["scene"], neural, device, dtype)
        self.nets = nets
        self.device = device

    def pixels(self, sample: int, pix, trace_log=None, info=None) -> torch.Tensor:
        """(P, 3) float32 values of the pixels `pix` (ids) at `sample`."""
        pix = torch.as_tensor(pix, dtype=torch.int64, device=self.device)
        if self.neural:
            spec = self.config["nets"]
            return render_pixels_neural(self.view, self.scene, self.boxes, self.nets,
                                        spec["depth"], self.config["request"]["max_proxy_hits"],
                                        pix, sample, self.operand, info)
        return render_pixels(self.view, self.scene, pix, sample, trace_log)


def outliers(got: torch.Tensor, want: torch.Tensor) -> int:
    """Pixels whose value is not finite or off the reference's."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    rel = (got - want).abs() / want.abs().clamp(min=1e-2)
    bad = ~torch.isfinite(got).all(dim=1) | ~torch.isfinite(want).all(dim=1) | \
        (rel >= PIXEL_TOLERANCE).any(dim=1)
    return int(bad.sum())


def judge(ref: Reference, frames, check: dict, limits: dict, got, trace_log=None):
    """The numbers compared over the checked frames. `frames`: (sample,
    ordering) pairs; `got(k, ids)`: the (len(ids), 3) values under test of
    frame k at pixel ids. Returns ({number: {value, limit}}, frames failed,
    net-decided pixels found per frame)."""
    counts = {"outlier_share": [0, 0], "outlier_share.nets": [0, 0]}
    failed, found = 0, []
    for k, (sample, order) in enumerate(frames):
        rand = np.sort(order[:check["pixels"]])
        frame_bad = {}
        if check.get("net_pixels"):
            info = {}
            want = ref.pixels(sample, order, info=info).cpu()
            decided = info["decided"].cpu().numpy()
            at = np.nonzero(decided[len(rand):])[0][:check["net_pixels"]] + len(rand)
            found.append(int(decided[len(rand):].sum()))
            pos = np.argsort(order[:len(rand)])
            parts = {"outlier_share": (rand, want[:len(rand)][pos]),
                     "outlier_share.nets": (order[at], want[at])}
        else:
            parts = {"outlier_share": (rand, ref.pixels(sample, rand, trace_log).cpu())}
        for key, (ids, ref_vals) in parts.items():
            if len(ids) == 0:
                continue
            n_bad = outliers(got(k, ids), ref_vals)
            counts[key][0] += n_bad
            counts[key][1] += len(ids)
            frame_bad[key] = n_bad / len(ids)
        failed += any(v > limits[key] for key, v in frame_bad.items())
    numbers = {key: {"value": bad / total if total else 1.0, "limit": limits[key]}
               for key, (bad, total) in counts.items() if key in limits}
    return numbers, failed, found
