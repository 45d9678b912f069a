"""The host time a train step spends packing weights for the kernels: the
union of the ``chn.pack`` spans' host intervals (``TrunkFunction.forward``,
``TailFunction.forward``, and ``TrunkFunction.backward``'s pull matrices
on autograd's device thread)."""

from port_bench.benchlib import spans

LAYER = "autograd Functions"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "samples_per_s"
SPANS = ["chn.pack"]


def read(ctx):
    return spans.host_ms(ctx, SPANS)
