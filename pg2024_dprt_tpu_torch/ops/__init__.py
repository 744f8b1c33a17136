from .frame import (
    fused_frame_supported,
    render_frame_fused,
    render_frame_fused_plain,
    render_sample_fused,
)
from .resident import (
    LAUNCHES,
    reset_launch_counts,
    resident_anyhit,
    resident_anyhit_plain,
    resident_closest,
    resident_closest_plain,
    trace_resident,
)
from .trace_api import (
    resolve_tracer,
    trace_closest_checked,
    trace_closest_cutout,
    trace_occlusion_checked,
    trace_occlusion_cutout,
)
