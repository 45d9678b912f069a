"""The CHN's device time a serving step, from inside the program: the
kernels launched under its ``chn`` span (``models/chn.py:chn_infer_apply``:
input, head, trunk, trunk_conv, tail, composite), in the profiled steps.
The counterpart of ``chn_ms.serve``, which times the call from outside
with CUDA events."""

from port_bench.benchlib import spans

LAYER = "inpainter"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frames_per_s"
SPANS = ["chn"]


def read(ctx):
    return spans.device_ms(ctx, SPANS)
