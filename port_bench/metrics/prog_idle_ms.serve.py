"""The device's idle time a serving step inside the program's own calls:
the part of the ``align`` and ``chn`` spans' host intervals in which no
device event ran. The rest of ``idle_share.serve`` falls between the
calls, in the caller."""

from port_bench.benchlib import spans

LAYER = "device"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frames_per_s"
SPANS = ["align", "chn"]


def read(ctx):
    return spans.idle_ms(ctx, SPANS)
