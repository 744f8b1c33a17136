"""`msamples_per_s` of the partitioned frames, read by the same reader: a
metric of its own only so that it takes a bound of its own, since these
frames are paced by the host and spread more from run to run."""

from portbench.manifest import sibling_reader

read = sibling_reader(__file__, "msamples_per_s")
