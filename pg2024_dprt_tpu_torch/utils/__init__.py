from .exr import read_exr, write_exr
