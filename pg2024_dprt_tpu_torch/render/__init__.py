from .config import RenderConfig
from .engine import Renderer, render_image, render_sample
from .pathgen import generate_camera_paths, tiled_pixel_order
from .proxy_stages import march_proxies, secondary_route, shadow_direct_light_nn
from .shade import shade, surface_attributes
