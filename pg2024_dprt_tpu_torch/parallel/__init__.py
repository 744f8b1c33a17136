from .mesh import NODES_AXIS, InProcessMesh, RankMesh, make_mesh, make_rank_mesh
from .exchange import exchange_paths, ring_shadow_occlusion
from .distributed import render_image_distributed, render_sample_distributed
from .spawn import run_ranks
