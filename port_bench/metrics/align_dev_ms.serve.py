"""The aligner's device time a serving step, from inside the program: the
kernels launched under its ``align`` span (``models/cpn.py:CPN.align``, or
``train/build.py:dfpn_align_fn``'s ``align_fn``: VGG pool-4, DFPN and the
warp), in the profiled steps. The counterpart of ``align_ms.serve``, which
times the call from outside with CUDA events."""

from port_bench.benchlib import spans

LAYER = "aligner"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frames_per_s"
SPANS = ["align"]


def read(ctx):
    return spans.device_ms(ctx, SPANS)
