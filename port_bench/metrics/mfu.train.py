"""The whole train step's share of the chip's peak: the step's model FLOPs
(each conv and matmul product once forward and once for each gradient the
step needs, recompute not counted;
:func:`..benchlib.flops.chn_train_step_flops`) times the window's steps,
over the window's seconds at the configuration's peak."""

from port_bench.benchlib import flops, readers

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "samples_per_s"


def read(ctx):
    t = ctx.traffic
    step = flops.chn_train_step_flops(t["batch"], t["frames"], t["height"], t["width"], ctx.config["cli"]["chn_nb"])
    return readers.mfu(ctx, step)
