from .bvh import FlatBVH, build_bvh
from .convert import (
    camera_from_arrays,
    device_scene_from_arrays,
    environment_from_arrays,
    light_table_from_arrays,
    load_mlp_checkpoint,
    mlp_params_from_arrays,
    packed_textures_from_arrays,
    proxy_models_from_arrays,
    proxy_table_from_arrays,
)
from .geometry import (
    CL_GROUP,
    DeviceScene,
    MeshGeometry,
    ProxyTable,
    concat_geometry,
    device_scene_from_instances,
    device_scene_from_meshes,
)
from .lights import EnvironmentMap, LightTable
from .procedural import (
    auto_light,
    cornell_box,
    instanced_frame,
    random_tri_soup,
    soup_frame,
    textured_cornell_box,
)
from .textures import PackedTextures, build_textures, checkerboard, sample_textures
