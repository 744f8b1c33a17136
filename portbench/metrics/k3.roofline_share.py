"""The fused frame K3's least time over its traced device ms a frame, in
per cent: the least time is the larger of the frame's float32 operations
over 67 TFLOP/s and its bytes over 3.35 TB/s, counted from the
reference's own sampled paths and clusters (roofline.py), so it reads the
same work whatever implements K3."""

from portbench.roofline import bound_ms, frame_work


def read(ctx):
    if ctx.trace is None or not ctx.trace_log:
        return None
    k3_ms = ctx.trace.op_ms("frame_sample_kernel") / ctx.trace.frames
    if k3_ms <= 0.0:
        return None
    req, view = ctx.config["request"], ctx.reference.view
    work = frame_work(ctx.reference.scene, ctx.trace_log, req["width"] * req["height"],
                      view.light_tris.shape[0], view.sky.numel())
    return 100.0 * bound_ms(work)[0] / k3_ms
