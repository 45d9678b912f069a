"""The conv-stack kernels' share of their roofline in CHN+DFPN serving
(``ops/conv_stack.py`` -> ``csrc/conv_stack.cu``, ``conv_stack_wgmma.cu``;
K7 / K8). On the default routes they run the correlation mixer alone:
its 14 convs over one cs x cs tile a (target, reference) pair, p-space as
channels. The least time from those shapes over the device time of the
kernels named ``stack_kernel``, ``ww::`` or ``fw::``."""

from port_bench.benchlib import flops, readers

LAYER = "conv-stack kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNELS = r"\bstack_kernel\b|\b(ww|fw)::"
SCOPE = None
COUNTERS = [("master_thesis_tpu_torch.ops.conv_stack", "conv_stack_tiles_cuda", 1),
            ("master_thesis_tpu_torch.ops.conv_stack", "conv_stack_banded_cuda", 1)]


def cost(ctx):
    t = ctx.traffic
    cs = ctx.config["cli"]["dfpn_base_size"] // 16
    return flops.stack_cost(flops.mixer_convs(cs), t["batch"] * t["refs"], cs, cs)


def read(ctx):
    return readers.roofline(ctx, KERNELS, SCOPE, cost(ctx))
