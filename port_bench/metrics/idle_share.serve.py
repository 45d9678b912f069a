"""The device's idle share in the traced stretch of steps: the share of
its span in which no kernel, copy or fill ran (the union of the
profiler's device events)."""

from port_bench.benchlib import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    return readers.idle_share(ctx)
