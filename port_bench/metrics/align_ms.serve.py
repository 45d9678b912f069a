"""The aligner's device time a serving step: CUDA events the benchmark
records around the aligner call (``CPN.align``, or DFPN's VGG pool-4,
``dfpn_infer_apply`` and the warp through ``train/build.py:
dfpn_align_fn``), the mean over the window's steps."""

LAYER = "aligner"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    return sum(a for a, _ in ctx.spans) / len(ctx.spans) if ctx.spans else None
