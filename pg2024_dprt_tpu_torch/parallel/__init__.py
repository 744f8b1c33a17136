from .mesh import NODES_AXIS, InProcessMesh, make_mesh
from .exchange import exchange_paths, ring_shadow_occlusion
from .distributed import render_image_distributed, render_sample_distributed
