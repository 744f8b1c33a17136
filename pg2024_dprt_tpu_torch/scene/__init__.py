from .bvh import FlatBVH, build_bvh
from .convert import (
    camera_from_arrays,
    device_scene_from_arrays,
    environment_from_arrays,
    light_table_from_arrays,
    packed_textures_from_arrays,
)
from .geometry import DeviceScene, MeshGeometry, concat_geometry, device_scene_from_meshes
from .lights import EnvironmentMap, LightTable
from .procedural import cornell_box, random_tri_soup, soup_frame, textured_cornell_box
from .textures import PackedTextures, build_textures, checkerboard, sample_textures
