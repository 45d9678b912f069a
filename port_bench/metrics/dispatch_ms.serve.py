"""The program's host time a serving step: the union of its ``align`` and
``chn`` spans' host intervals, the time the host spends issuing (and,
where the program waits on the card, waiting for) the step's work."""

from port_bench.benchlib import spans

LAYER = "entry (host dispatch)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"
SPANS = ["align", "chn"]


def read(ctx):
    return spans.host_ms(ctx, SPANS)
