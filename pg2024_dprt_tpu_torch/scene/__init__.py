from .bvh import FlatBVH, build_bvh
from .convert import (
    camera_from_arrays,
    curve_set_from_arrays,
    device_scene_from_arrays,
    environment_from_arrays,
    light_table_from_arrays,
    load_ab_scaled_models,
    load_mlp_checkpoint,
    mlp_params_from_arrays,
    packed_textures_from_arrays,
    proxy_models_from_arrays,
    proxy_table_from_arrays,
)
from .curves import CurveSet
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
    city_scene,
    cornell_box,
    instance_grid,
    instanced_frame,
    random_tri_soup,
    soup_frame,
    statue_mesh,
    textured_cornell_box,
    two_room_scene,
)
from .partition import (
    PartitionedScene,
    build_partitioned_scene,
    build_partitioned_scene_instanced,
    partition_instances,
    partition_meshes,
)
from .obj import load_obj, load_texture_images, scene_from_obj
from .visibility_grid import (
    VisibilityGrid,
    build_conservative_grid,
    build_visibility_grid,
    query_conservative_grids,
    query_visibility,
)
from .textures import PackedTextures, build_textures, checkerboard, sample_textures
