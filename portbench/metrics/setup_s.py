"""Seconds from the start of the run to the end of its warm frame:
imports, the meshes and nets, the port's scene build, the kernels' build
or load, one frame."""


def read(ctx):
    return ctx.setup_s
