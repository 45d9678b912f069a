"""The conv-stack kernels' share of their roofline in CHN+DFPN serving
(``ops/conv_stack.py`` -> ``csrc/conv_stack.cu``, ``conv_stack_wgmma.cu``;
K7 / K8). The CLI's bf16 DFPN route runs on them sep4d's six convs and the
mixer's 14 (K7), both flow estimators' stride-1 convs and VGG's pool-4
tower (K8): :func:`..benchlib.flops.dfpn_stack_convs`, each conv bounded
as a launch of its own (:func:`..benchlib.flops.convs_cost`). Their least
time over the device time of the kernels named ``stack_kernel``, ``ww::``
or ``fw::``, whose count the profile checks against the K7 and K8 launch
counters."""

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
    return flops.convs_cost(flops.dfpn_stack_convs(t["batch"], t["refs"], ctx.config["cli"]["dfpn_base_size"]))


def read(ctx):
    return readers.roofline(ctx, KERNELS, SCOPE, cost(ctx))
