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
