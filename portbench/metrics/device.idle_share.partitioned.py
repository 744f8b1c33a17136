"""`device.idle_share` of the partitioned frames, read by the same reader:
a metric of its own because it moves `msamples_per_s.partitioned`."""

from portbench.manifest import sibling_reader

read = sibling_reader(__file__, "device.idle_share")
