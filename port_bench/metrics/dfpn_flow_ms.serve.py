"""DFPN's flow estimators' device time a serving step: the kernels
launched under the two ``align.flow`` spans of
``models/dfpn.py:dfpn_infer_apply`` (``flow_64`` and ``flow_256``, each with
the resize of its input flow)."""

from port_bench.benchlib import spans

LAYER = "aligner"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frames_per_s"
SPANS = ["align.flow"]


def read(ctx):
    return spans.device_ms(ctx, SPANS)
