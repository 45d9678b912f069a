"""The tail kernels' share of their roofline in serving (``ops/tail.py``
-> ``csrc/tail.cu``, K4 / K5): the tail's least time from its shapes (the
upsample-convs in their 4-phase form, hr_conv, conv_last) over the device
time of the kernels named ``tw::``."""

from port_bench.benchlib import flops, readers

LAYER = "tail kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNELS = r"\btw::"
SCOPE = None
COUNTERS = [("master_thesis_tpu_torch.ops.tail", "tail_cuda", 1),
            ("master_thesis_tpu_torch.ops.tail", "tail_banded_cuda", 1)]


def cost(ctx):
    t = ctx.traffic
    return flops.tail_cost(t["batch"] * t["refs"], t["height"] // 4, t["width"] // 4)


def read(ctx):
    return readers.roofline(ctx, KERNELS, SCOPE, cost(ctx))
