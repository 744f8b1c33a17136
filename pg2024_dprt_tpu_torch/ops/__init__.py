from .frame import (
    fused_frame_supported,
    render_frame_fused,
    render_frame_fused_plain,
    render_sample_fused,
)
from .cluster_tracer import occlusion_clusters, traverse_clusters
from .curve_exact import (
    intersect_bspline_exact,
    pieces_for_tolerance,
    scan_count_for,
    tessellation_error_bound,
)
from .curve_intersect import PAIR_BUDGET, CurveHit, intersect_curves, occlude_curves
from .march import march_proxies_plain, proxy_march
from .mlp import (
    DENSE_WEIGHT_LIMIT,
    grouped_mlp_dense,
    grouped_mlp_dense_plain,
    grouped_mlp_pair,
    grouped_mlp_pair_plain,
    pack_nets,
    packed_pair,
)
from .resident import (
    LAUNCHES,
    grouped_anyhit,
    grouped_closest,
    reset_launch_counts,
    resident_anyhit,
    resident_anyhit_plain,
    resident_closest,
    resident_closest_plain,
    schedule_keys,
    schedule_keys_plain,
    schedule_order,
    trace_grouped,
    trace_resident,
    use_grouped,
)
from .shade import shade_paths
from .route import (
    consume_secondary,
    consume_shadow,
    fused_route_takes,
    route_fused,
    route_fused_plain,
    shadow_route_fused,
    shadow_route_fused_plain,
)
from .trace_api import (
    resolve_tracer,
    trace_closest,
    trace_closest_checked,
    trace_closest_cutout,
    trace_occlusion,
    trace_occlusion_checked,
    trace_occlusion_cutout,
)
from .tracer import (
    interval_cull,
    pair_anyhit,
    pair_closest,
    pair_trace_plain,
    pair_woop,
    prep_pairs,
    prepare_pairs,
    trace_pairs,
)
from .traversal import intersect_brute_force, moller_trumbore, traverse_bvh
