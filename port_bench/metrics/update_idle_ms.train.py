"""The device's idle time a train step inside the update: the part of the
``train.update`` span's host interval (``TrainState.apply_gradients``:
all-reduce, clip, Adam, ``zero_grad``, repack) in which no device event
ran."""

from port_bench.benchlib import spans

LAYER = "optimizer"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "samples_per_s"
SPANS = ["train.update"]


def read(ctx):
    return spans.idle_ms(ctx, SPANS)
