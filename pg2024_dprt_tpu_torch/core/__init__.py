from .camera import Camera
from .device import resolve_device
from .rng import rnd, rnd2, rnd3, tea, tea_int
from .types import BSDF_DIFFUSE, BSDF_WATER, HitRecord, PathState
