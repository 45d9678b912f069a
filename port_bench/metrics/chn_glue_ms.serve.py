"""The CHN's device time a serving step outside its trunk and tail
kernels (K1 / K2, K4 / K5): the kernels launched under ``chn.input``
(normalise, concat, layout, cast), ``chn.head`` (the five head convs on
cuDNN and the channels-last copy), ``chn.trunk_conv`` (``trunk_conv``, the
residual add, the layout) and ``chn.output`` (de-normalise, clamp,
composite)."""

from port_bench.benchlib import spans

LAYER = "inpainter"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frames_per_s"
SPANS = ["chn.input", "chn.head", "chn.trunk_conv", "chn.output"]


def read(ctx):
    return spans.device_ms(ctx, SPANS)
