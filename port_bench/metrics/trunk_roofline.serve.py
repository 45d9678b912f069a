"""The trunk kernels' share of their roofline in serving (``ops/rrdb.py``
-> ``csrc/rrdb.cu``, K1 / K2): the trunk's least time from its shapes
(20 RRDBs of five 3x3 convs over the trunk grid, a quarter of the frame's
sides) over the device time of the kernels named ``cw::``."""

from port_bench.benchlib import flops, readers

LAYER = "trunk kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNELS = r"\bcw::"
SCOPE = None
COUNTERS = [("master_thesis_tpu_torch.ops.rrdb", "rdb_cuda", "RDB_CONVS"),
            ("master_thesis_tpu_torch.ops.rrdb", "rdb_banded_cuda", "RDB_CONVS")]


def cost(ctx):
    t = ctx.traffic
    return flops.trunk_cost(t["batch"] * t["refs"], t["height"] // 4, t["width"] // 4,
                            ctx.config["cli"]["chn_nb"])


def read(ctx):
    return readers.roofline(ctx, KERNELS, SCOPE, cost(ctx))
