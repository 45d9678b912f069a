"""The device's idle time a train step inside the forward: the part of the
``align``, ``chn`` and ``train.loss`` spans' host intervals in which no
device event ran."""

from port_bench.benchlib import spans

LAYER = "forward"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "samples_per_s"
SPANS = ["align", "chn", "train.loss"]


def read(ctx):
    return spans.idle_ms(ctx, SPANS)
