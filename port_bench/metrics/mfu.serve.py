"""The whole serving step's share of the chip's peak: the step's model
FLOPs (the aligner's and CHN's conv and matmul products,
:func:`..benchlib.flops.serve_step_flops`) times the window's steps, over
the window's seconds at the configuration's peak."""

from port_bench.benchlib import flops, readers

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(ctx):
    t, cli = ctx.traffic, ctx.config["cli"]
    return readers.mfu(ctx, flops.serve_step_flops(ctx.config["aligner"], t["batch"], t["refs"], t["height"],
                                                   t["width"], cli["chn_nb"], cli["dfpn_base_size"]))
