from .camera import Camera
from .device import resolve_device
from .rng import rnd, rnd2, rnd3, tea
from .types import BSDF_DIFFUSE, BSDF_WATER, HitRecord, PathState
