"""The device's idle time a train step inside the backward: the part of
the ``train.backward`` span's host interval (``total.backward()``, whose
nodes run on autograd's device thread meanwhile) in which no device event
ran."""

from port_bench.benchlib import spans

LAYER = "backward"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "samples_per_s"
SPANS = ["train.backward"]


def read(ctx):
    return spans.idle_ms(ctx, SPANS)
