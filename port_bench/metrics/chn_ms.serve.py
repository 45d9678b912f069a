"""The inpainter's device time a serving step: CUDA events the benchmark
records around ``chn_infer_apply`` (``models/chn.py``: head, trunk,
trunk_conv, tail, composite), the mean over the window's steps."""

LAYER = "inpainter"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    return sum(c for _, c in ctx.spans) / len(ctx.spans) if ctx.spans else None
