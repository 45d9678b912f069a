"""The backward kernels' share of their roofline in the CHN train step
(``ops/rrdb_bwd.py`` -> ``csrc/rrdb_bwd.cu``, K3; ``ops/tail_bwd.py`` ->
``csrc/tail_bwd.cu``, K6): each trunk and tail conv's input gradient and
weight gradient counted from shapes (the upsample-convs in their 4-phase
form; K6's recompute is its design's and is not counted), over the device
time of the kernels named ``kb::``, ``tb::`` or ``tw::`` that the
``TrunkFunctionBackward`` and ``TailFunctionBackward`` autograd nodes
launch."""

from port_bench.benchlib import flops, readers

LAYER = "backward kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "samples_per_s"
KERNELS = r"\b(kb|tb|tw)::"
SCOPE = r"^(TrunkFunctionBackward|TailFunctionBackward)$"
COUNTERS = [("master_thesis_tpu_torch.ops.rrdb_bwd", "rrdb_bwd_cuda", "RRDB_BWD_KERNELS"),
            ("master_thesis_tpu_torch.ops.tail_bwd", "tail_bwd_cuda", 1)]


def cost(ctx):
    t = ctx.traffic
    n = t["batch"] * (t["frames"] - 1)
    return flops.backward_cost(n, t["height"] // 4, t["width"] // 4, ctx.config["cli"]["chn_nb"])


def read(ctx):
    return readers.roofline(ctx, KERNELS, SCOPE, cost(ctx))
