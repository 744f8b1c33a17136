from .exr import read_exr, write_exr
from .png import read_png, write_png
from .timing import TimedSection, Timing
