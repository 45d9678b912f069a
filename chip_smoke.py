#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port's serving step, CHN training step, CHN+DFPN
inpaint step, full videos and DFPN training on one NVIDIA GPU.

Phases, each fatal on failure:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel of the path, from ``master_thesis_tpu_torch/
   csrc/`` with nvcc for ``sm_90a`` (registers, shared memory and spills
   from ``-Xptxas -v``);
3. kernels: each kernel wrapper on card tensors at the main path's shapes
   (and ragged shapes), held against its plain PyTorch version with TF32
   off: max|kernel - plain| <= 1e-2 * max|plain| (both round operands to
   bf16 at the same points and sum in different orders), and a relative
   L2 limit on the part the convs compute (an RRDB's output less its
   identity part ``1.2 x``); each check is also read on a fault planted in
   the kernel's weights (and, for K1 and K4, in its code: ``-DRDB_PLANT=1``
   on K1's ragged 2x60x120 check, ``-DTAIL_PLANT=1`` on K4's main and
   ragged checks) and must catch it; K1's x1..x4 against the plain
   version's and against the first K1 design (``rdb_forward_tiles`` /
   ``rdb_forward_hidden``, an independent implementation); K1 beside that
   first design and the cuDNN route (five ``F.conv2d`` a RDB) on the same
   inputs at 80x64x64 and 8x128x128, and K4 beside its first design
   (``tail_first_cuda``, held to the plain version too) at 80x64x64, each
   fatal unless the new design is faster; each of an RDB's five convs and
   each of the tail's four launches against its floor (each launch also
   held to its plain stage); the memory each tail design holds; CUDA-event
   times;
4. main path: ``CPN.align`` then ``chn_infer_apply`` at B=16, F=5, 256x256,
   nb=20, bf16 compute on seeded random weights (bench.py's step); the
   launch counts of one step; output checks; a small input through the
   kernels against the same network through their plain versions on the
   card (relative L2 limit, read also with a planted fault), with the
   drift from the f32 plain path on the CPU printed beside it; host-clock
   step time; one step under ``torch.profiler`` (device time by kernel,
   busy share, layout transposes and copies); the network's output must be
   channels-last (the caller's NHWC view of it copies nothing); beside it
   the same step with the layout of the first tail design (the trunk's sum
   copied to NCHW, the first design, its output copied to NHWC), timed and
   profiled the same way;
5. backward kernels: K3 (an RRDB's backward over the activations K1
   keeps, one call) and K6 (the tail's, one call) on card tensors at the
   train step's shapes (8 frames at 64x64; the 20-RRDB trunk; a ragged
   shape; for K6 also an odd one), held against their plain versions with
   TF32 off by the relative L2 of dx and of each weight / bias grad group,
   each check also read on faults planted in the kernels' code (compiled
   with ``-DBWD_PLANT``: lrelu slope 0.25 in the masks, the centre tap
   left out of the weight grads, the bias grads dropped; for K6 also
   upconv2's adjoint reading the wrong phase plane); each run twice must
   agree bit for bit; the first designs (``rrdb_bwd_first``,
   ``tail_bwd_first_cuda``) held to the plain versions too; device times
   (the kernels' sum under ``torch.profiler``, whose count of the port's
   own kernels, picked by name, must equal the launches or the reading is
   taken again; K6's launches each printed: a backward is a
   chain of short launches, and CUDA events around it also count the
   host's gaps, which are printed beside), each beside its first design's
   (fatal unless faster), K3 also beside the cuDNN route's (autograd
   through the five ``F.conv2d`` of each RDB);
6. training: the CHN train step (frozen CPN, CHN forward with autograd,
   the five-part loss with VGG-16, backward, Adam, repack) at B=8,
   frames_n=2, 256x256, nb=20, bf16 compute on seeded inputs; the launch
   counts of one step; finite loss and grads, moved parameters; on a
   1x2x64x64 batch the grads through the kernels against the grads through
   their plain versions on the card (read also with a planted fault);
   host-clock step time, samples/s, peak memory; one step under
   ``torch.profiler`` (host time in ``TrunkFunctionBackward``);
7. conv-stack kernels: K7 (the tile stack) at the mixer's shapes (20
   tiles) and at both sep4d stages (5 120 tiles), channels-last with each
   wide 3x3 conv on the wide-conv kernel ``conv3x3_wide_wgmma`` (stage 1
   also with the p <-> q swap in its epilogue), at ragged tile counts, and
   its first design (channel-major, fused groups alone) on the mixer;
   K8 (the banded stack: each 3x3 / 5x5 conv with Cin and Cout multiples
   of 64 on the frame kernel ``conv_frame_wgmma``, the thin ones on the
   fused kernel) at flow_256's c0-c1 (Cin 10) and c15-c17 segments at
   256x256, at VGG's block 1 (Cin 3) and at a ragged 60x120 frame, and its
   first design (fused groups alone) on c15-c17; each held against its
   plain version with TF32 off by relative L2, and read on the faults
   planted in the code of the kernels it runs (the fused kernel with
   ``-DSTACK_PLANT``: a corner tap left out, the ReLU off a conv, the
   biases dropped; the wide-conv kernel with ``-DWIDE_PLANT``: tap (0, 0)
   left out, the bias dropped, one tap read with a wrong swizzle phase;
   the frame kernel with ``-DFRAME_PLANT``: the corner tap left out, the
   bias dropped, each tile's top halo row read as zeros); CUDA-event
   times of the kernel, its plain version and the same stack as the
   module route (cuDNN convs in bf16); K7 on sep4d and K8 on each of its
   three callers (flow_256, flow_64, VGG pool-4) beside their first
   designs on the same values, each fatal unless faster; each wide and
   each frame conv against its floor (a frame conv also beside one cuDNN
   ``F.conv2d``); stage 1 with the swap in the epilogue and with one
   permute; the mixer's kernels, ``mixer_apply`` and the first design on
   the mixer; K8 on the default hybrid route (flow_256's c0 alone at
   256x256 and its mids c6-c7, c9-c10, c11-c12 at 64 / 32 / 64, flow_64's
   c0 at 64x64) against its plain version with the faults, beside the plain
   version, the module route and the bound, each c0 launch beside its floor
   and one cuDNN ``F.conv2d``; both flow estimators (20 frames) on the
   module route, every kernel route and the four hybrid ones, and VGG's
   pool-4 tower (24 frames) through its module, on K8 and as
   ``vgg_pool4_hybrid``, each hybrid output held against the module route's
   by relative L2, CUDA-event times in two rounds;
8. the CHN+DFPN path: VGG pool-4 features, ``dfpn_infer_apply`` at base
   256, ``dfpn_align`` and ``chn_infer_apply`` at B=4, F=5, 256x256,
   nb=20, bf16, once with the JAX package's default routes (K7 on the
   mixer), once with every kernel route (K7 on sep4d too, K8 on both
   flow estimators and on VGG's pool-4 tower) and once on each hybrid
   route (``HYBRID_ROUTES``: c0 and the 64x64 / 32x32 mid segments on K8,
   c0 alone on K8, c0 as one phase-packed conv or one im2col product, and
   the last with ``vgg_pool4_hybrid``): the launch counts of one step;
   output checks; on a small input (1x2x64x64, base 64) the DFPN outputs
   through the kernels against their plain versions on the card, read also
   with a planted fault, and the same on the default hybrid route at
   1x2x128x128, base 128 (the mixer and VGG through their modules; the
   outputs and each K8 call's output held); host-clock step time,
   inpainted frames/s, the DFPN align alone, peak memory; one step under
   ``torch.profiler`` (with its layout copies); then CPN's context modules
   (``CPNContext``: Encoder, ``cm_module``, Decoder), which no path calls,
   at 1 x (1 + 4) x 256x256 in f32 against the same modules on the CPU;
9. banded kernels: K2 (the trunk's RDBs in 32-row bands) on one RRDB and
   on the 20-RRDB trunk at 8 frames of 128x256, K5 (the tail in 32-row
   bands) at 8 frames of 128x128 and 128x256, each held against its plain
   band decomposition by relative L2 with TF32 off and read on a weight
   fault and on the band-edge fault compiled with ``-DBAND_PLANT=1`` (K5
   also on ``-DTAIL_PLANT=1``); each beside its full-frame twin (K1, K4) on
   the same input: the largest difference (K2 must equal K1 bit for bit,
   on one RRDB and on the trunk, and K5 K4), CUDA-event times, bounds, the
   memory a call holds; K2's RRDB also beside the first K1 design and the
   cuDNN route, K5 beside its first design (fatal unless faster);
10. full video: BASELINE.md config 5 through ``infer.Inpainter``, 12
   frames at 512x512 (one seeded frame over time, a hole strip moving 12
   rows a frame), nb=20 bf16 on the seeded serving weights, ff / ip / cp
   with the identity aligner and with a CPN-cost aligner of near-identity
   geometry, each once to warm up and once timed: seconds per video,
   frames/s, frames refined, K1 / K2 / K4 / K5 launches, host syncs, peak
   memory, PSNR / SSIM against the clean frames (floors, with random
   weights); output checks (finite, in [0, 1], the input where the mask is
   0, launches on the routes the shape takes); one ff video under
   ``torch.profiler``; ff at 512x1024 (the banded trunk's route); and on 4
   frames, every refine of each algorithm's video through the kernels
   against the same inputs through their plain versions over the hole
   pixels, read also with two planted faults, the end-to-end difference of
   the two videos printed beside it;
11. DFPN training: the DFPN train step (the frozen VGG pool-4 features of
   the masked and the clean frames on K8, the DFPN forward through its
   modules with autograd, the six-part loss in f32, backward, Adam with
   StepLR) at ``config.py``'s defaults, B=8, frames_n=2, 256x256, base 256,
   bf16 compute, f32 parameters, on a seeded synthetic batch (clean frames
   y, 10% hole masks m, x = y (1 - m), smooth flows, ``flows_use`` on half
   the batch): the launch counts of one step; finite items, every DFPN
   parameter with a finite nonzero grad and moved, no VGG parameter moved;
   host-clock step time, samples/s, peak memory; one step under
   ``torch.profiler`` (busy share, layout copies by caller); on 1x2x64x64,
   base 64, the loss items and the three pool-4 maps the step reads with
   K8's features against the module's, the maps read also with each
   planted fault of K8's two kernels; then
   ``train.loop.Trainer`` over 2 epochs of 3 steps with
   ``accumulate_grad_batches=2`` and a validation an epoch (seconds an
   epoch), and a fresh state restored from epoch 1's checkpoint, which
   lands mid-accumulation, running epoch 2: its parameters and Adam
   moments against the uninterrupted run's by relative L2, each group
   under its own limit, read also with the open window's grads dropped;
12. the CLI: ``master_thesis_tpu_torch.__main__.main(argv)`` on ``cuda`` over
   a GOT-10k / YouTube-VOS / DAVIS-2017 tree the phase writes at the
   datasets' resolutions (1280x720, DAVIS 854x480; smooth seeded content,
   written with OpenCV, or as PNGs by the zlib writer where OpenCV is
   missing): the train loader's samples/s with threads and with worker
   processes at 1 and 8 workers, their first batches bit-equal; DFPN train
   (B=8, frames_n 2, 256x256, base 256, 8 worker processes, an epoch of 10
   steps with its validation and checkpoint), its checkpoint reloaded and
   resumed for a second epoch (8 loader threads), DFPN test, CHN train
   (nb 20, the CPN aligner, 8 loader threads) and CHN test (ff / ip / cp over the DAVIS clip at the default
   test_size, the videos written); each mode's kernel launches against the
   expected ones (none in DFPN train, K7 / K8 in DFPN test, K1 / K3 / K4 / K6 in
   CHN train, K1 / K4 in CHN test), batches and parameters on the card,
   finite items, every parameter moved, CHN test's frames in [0, 1] and the
   input's where visible; each train mode's ms/step with the real loader
   and busy share beside the synthetic-batch step of phases 6 and 11;
   then at ``--compute_dtype float32`` DFPN test, CHN train (3 steps) and
   CHN test (at 480x720, past the f32 band thresholds), the CHN modes with
   ``--chn_aligner dfpn``: each takes the f32 routes it runs (K7 in DFPN
   test; K1 / K3 / K4 / K6 / K7 in CHN train; K2 / K5 / K7 in CHN test) and
   no bf16 kernel;
13. distribution (``master_thesis_tpu_torch.parallel``): (a) phase 6's
   train step (CHN, B=8, frames_n 2, 256x256, nb 20, bf16, the same seeds
   and batch) on a 1x1 NCCL mesh, its items and parameter updates by group
   against the one-process step's, beside two one-process runs' own
   spread; (b) two ranks on the one card over gloo (spawned with
   ``torch.multiprocessing``), the CHN step on a 2x1 mesh (4 rows a rank)
   and (c) the DFPN train step at B=8, frames_n 3, base 256, its frozen VGG
   features on K8, on a 1x2 mesh (one reference a rank), each 3 steps from
   the same seeds and batches as a one-process run of them: each rank's
   items (summed over the ranks) and its parameter updates by group against
   the one-process run's, the ranks' parameters bit-equal, each rank's
   K1 / K3 / K4 / K6 (b) and K8 (c) launches in its last step, each rank's
   ms/step, all-reduce ms an update (CUDA events) and peak memory; both read
   also with two planted faults, each denominator local to its rank and
   rank 1 keeping its own grads, which must be caught. Two ranks on one
   card check correctness, not scaling;
14. f32 (run after phase 11, before the CLI; ``csrc/conv_f32.cu``, and
   the 3xTF32 kernel ``csrc/conv_frame_tf32.cu`` for K7's and K8's
   64-multiple convs, K4's / K5's four tail stages and K1's / K2's five
   convs an RDB; TF32 off): first
   that kernel alone on every shape the f32 CHN+DFPN step gives it (sep4d's
   four wide convs at 5 120 tiles, stage 1's last with the swap in its
   epilogue; the mixer's 256 -> 256 5x5 and 3x3; flow_256's and flow_64's
   128-channel convs; VGG's 64 -> 64 .. 512 -> 512 at 4 and 20 frames)
   against its plain f32 version (limit 1e-5), a rerun bit-identical, each
   fault compiled in with ``-DTF32_PLANT`` that applies (the two correction
   products dropped, the corner tap left out, each tile's top halo row read
   as zeros where a frame has several row tiles; a row window's first input
   row read as zeros, K2's and K5's; a gc-mode conv's last 32-channel chunk
   read one chunk early, K1's and K2's) caught, its time beside its floor
   (3 x FLOPs at 495 TFLOP/s), the f32 bound, the SIMT kernel and one cuDNN
   ``F.conv2d``; then each site's f32 route at its main-path shapes (K1 / K4
   80x64x64, K3 / K6 8x64x64, K2 / K5 8x128x256 in bands, K7 sep4d's two
   stages and the mixer, K8 its three callers)
   against its plain f32 version by relative L2 (limit 1e-5; K1's and K2's
   over the RRDB's body, its output less 1.2 x; the backward
   checks' plain versions sum in f64 over the route's own activations),
   each check read on the faults that apply to its kernels: two compiled
   into conv_f32.cu with ``-DF32_PLANT`` (tap (0, 0) dropped; the channel
   slice read one group of 8 off) where a route launches it, the
   ``-DTF32_PLANT`` ones where it launches the 3xTF32 kernel (K4, K6, K7, K8
   1-3; K5 1-4; K1 1-3 and 5; K2 1-5), which must be caught;
   each route's device time with its launch count beside its
   bound (at 67 TFLOP/s; K1, K2, K4, K5, K7, K8 from their routed convs, the
   bound at 67 TFLOP/s beside it), the 3 x TF32 figure, the plain version,
   the cuDNN route and the library yardstick (one ``F.conv2d`` /
   ``conv2d_weight`` a launch; an upsample-conv at the upsampled size);
   K1's, K2's, K4's, K5's, K7's and K8's beside their f32 first design
   (every conv on the SIMT kernel), each fatal unless faster; K5 equal to
   K4 and K2 to K1 bit for bit on one input; K4's four stages alone at
   80x64x64 and one K5 band's four launches, then K1's five convs at
   80x64x64 and one K2 band's five, against their plain versions, rerun
   and faults, each beside its floor, the SIMT kernel and one cuDNN
   ``F.conv2d`` (K1's conv1-4 also beside the padded conv mode, Cout 32 ->
   64); the f32 CPN serving step (B=4, F=5,
   256x256, nb 20) against its plain routes, profiled; the f32 CHN train
   step (B=8, frames_n 2), its grads against the plain backward versions
   from the same forward (limit 1e-4), 3 steps after 1; a CHN+DFPN step on
   every kernel route in f32 (the 3xTF32 kernel's launches held to the
   routed convs' count, the trunk's 300 and the tail's four); each f32
   route's launches.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without a card or
outside the repository. Usage: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
B, F, H, W, NB = 16, 5, 256, 256, 20
TOL = 1e-2  # max|kernel - plain| / max|plain| for one call in bf16
# Relative L2 limits, each set between a reading of the correct kernel and
# one of a planted fault (PERF.md, Findings): one RRDB's body (output less
# 1.2 x), the trunk's body (less 1.2**NB x), the tail, and the whole step.
L2_RRDB, L2_TRUNK, L2_TAIL, L2_STEP = 2e-2, 1e-1, 5e-3, 2e-2
# Relative L2 limits of the backward kernels' dx and each grad group
# against the plain versions (both round every cotangent to bf16 before a
# product; sums in another order flip some roundings, and the flips spread
# through the dense convs): one RRDB, the 20-RRDB trunk, the tail, and the
# train step's grads by group (weights, biases of head, trunk, tail) from a
# shared forward.
L2_K3, L2_K3_TRUNK, L2_K6, L2_TRAIN = 5e-2, 2e-2, 1e-2, 5e-2
TRAIN_B, TRAIN_F = 8, 2
FAULTS = {1: "lrelu slope 0.25 in the masks", 2: "centre tap left out of dW",
          3: "bias grads dropped"}
# K6's also, compiled into csrc/tail_bwd_wgmma.cuh with -DBWD_PLANT=4.
K6_FAULTS = {**FAULTS, 4: "upconv2's adjoint reads phase plane (0, 1) where (1, 0) belongs"}
# The CHN+DFPN step: B targets, F references, DFPN's base size.
DFPN_B, DFPN_F, DFPN_BASE = 4, 5, 256
# The hybrid DFPN routes (``dfpn_align_fn``'s ``hybrid_*`` flags), the JAX
# A/B's candidates (scripts/measure/dfpn_serving_ab.py), with K8's launches
# (all, on the frame kernel) in one CHN+DFPN step: the default hybrid runs
# flow_256's c0 (256x256) and c6-c7, c9-c10, c11-c12 (64, 32, 64) and
# flow_64's c0 (64x64) on K8, its mids (16, 8, 16) through the modules
# (tests/test_torch_dfpn_hybrid.py holds the plans to these).
HYBRID_ROUTES = (
    ("hybrid, mids and c0 on K8", dict(hybrid_flow=True), (8, 6)),
    ("hybrid, c0 alone on K8", dict(hybrid_flow=True, hybrid_fuse_mids=False), (2, 0)),
    ("hybrid, c0 s2d", dict(hybrid_flow=True, hybrid_fuse_mids=False, hybrid_c0_mode="s2d"), (0, 0)),
    ("hybrid, c0 im2col", dict(hybrid_flow=True, hybrid_fuse_mids=False, hybrid_c0_mode="im2col"),
     (0, 0)),
    ("hybrid, c0 s2d + vgg_pool4_hybrid", dict(hybrid_flow=True, hybrid_fuse_mids=False,
                                                hybrid_c0_mode="s2d", hybrid_vgg=True), (0, 0)),
)
STACK_FAULTS = {1: "corner tap left out", 2: "ReLU off the last ReLU conv of each launch",
                3: "biases dropped"}
# Faults compiled into K7's wide-conv kernel (csrc/conv3x3_wide_wgmma.cuh)
# with -DWIDE_PLANT=n.
WIDE_FAULTS = {1: "wide conv: tap (0, 0) left out", 2: "wide conv: bias dropped",
               3: "wide conv: tap (1, 1) read with its swizzle phase in the base offset"}
# Faults compiled into K8's frame kernel (csrc/conv_frame_wgmma.cuh) with
# -DFRAME_PLANT=n.
FRAME_FAULTS = {1: "frame conv: corner tap (-r, -r) left out", 2: "frame conv: bias dropped",
                3: "frame conv: each tile's top halo row (the tile above's) read as zeros"}
# Relative L2 limits of the conv-stack kernels against their plain versions
# (both round every conv's output to bf16; sums in another order flip some
# roundings), and of the small CHN+DFPN input's DFPN outputs, whose
# cascade of ~50 convs carries those flips on.
L2_STACK, L2_DFPN = 1e-2, 5e-2
# The banded kernels (K2, K5): their checks' shapes, 8 frames of the trunk
# grids of 512x512 and 512x1024 inputs; the fault compiled into both with
# -DBAND_PLANT=1 drops the halo row above every band but the first.
BAND_N, BAND_H, BAND_WS = 8, 128, (128, 256)
BAND_FAULT = "halo row above each band dropped"
# Relative L2 limit of K2's 20-RRDB trunk against its plain version: the
# trunk's bf16 floor reads 0.017 at these shapes, and the band-edge fault,
# which touches the rows at 3 band edges of 128, 0.064 (PERF.md, Findings).
L2_TRUNK_BANDED = 4e-2
# The full-video phase: BASELINE.md config 5 (benchmarks.py:config_5), F
# frames at VIDEO_H x VIDEO_W, and ff at VIDEO_WIDE; the whole-video check
# of the kernels against their plain versions runs VIDEO_CHECK_F frames.
VIDEO_F, VIDEO_H, VIDEO_W, VIDEO_WIDE, VIDEO_CHECK_F = 12, 512, 512, 1024, 4
# Relative L2 limit of that check, pooled over a video's refines (each one
# CHN call on the same inputs through both paths, over the hole pixels):
# correct kernels read 0.011-0.017 there, the planted faults 0.059 and up
# (PERF.md, Findings).
L2_REFINE = 3e-2
# Relative L2 limit of K1's x1..x4 against the plain version's and the first
# design's (each one conv deep in bf16: correct kernels read ~3e-4), and
# the fault compiled into K1 / K2 with -DRDB_PLANT=1.
L2_HIDDEN = 5e-3
RDB_FAULT = "right halo column of every row run read as zeros"
# The tail's four launches (K4; per band for K5), and the fault compiled
# into them with -DTAIL_PLANT=1.
TAIL_STAGES = ("upconv1", "upconv2", "hr_conv", "conv_last")
TAIL_FAULT = "right halo column of every tile read as zeros"
# Device kernels the profile counts as layout transposes and copies (cuDNN's
# NCHW <-> NHWC transposes, ATen's copies and device-to-device memcpy).
LAYOUT_KEYS = ("nchwtonhwc", "nhwctonchw", "transpose", "copy")
# The DFPN train step: config.py's batch_size and frames_n. The loss items
# with K8's frozen features against the module's (bf16 both) may differ by
# REL_K8_ITEMS relative at most over the six items (they read 4.0e-4), the
# three pool-4 maps the step reads by L2_K8_MAPS relative L2 (they read
# 7.6e-3); K8's planted faults move the items by 2.9e-4 to 1.7e-2 and the
# maps by 0.069 to 0.63, so the maps are this phase's kernel check and the
# items a smoke test (PERF.md, Findings; K8 at
# the train step's 256x256 frames is held against its plain version in the
# VGG checks of phase 8). A resumed run's parameters may differ from the
# uninterrupted run's by L2_RESUME_PARAMS relative, its Adam moments by
# L2_RESUME_MOMENTS: the card's backward is not deterministic
# (F.interpolate's backward and cuDNN's weight grads sum with atomics), and
# Adam's first updates turn a grad's noise into a full step where the grad
# is near zero, so two runs of one epoch from one checkpoint read 1.04e-4 at
# most on the parameters and 2.45e-3 on the moments apart; a lost
# accumulation window reads 1.54e-3 on the parameters and 0.31 and up on
# the moments (PERF.md, Findings).
DFPN_TRAIN_B, DFPN_TRAIN_F = 8, 2
REL_K8_ITEMS, L2_K8_MAPS = 2e-3, 2e-2
L2_RESUME_PARAMS, L2_RESUME_MOMENTS = 5e-4, 2e-2
# The distribution phase: DIST_STEPS steps a run; the DFPN step's frames_n
# (two references, one a model rank); a rank's run must end within
# DIST_JOIN_S seconds. A distributed run's items may differ from the
# one-process run's by L2_DIST_ITEMS at most (the largest relative error
# over the items and steps: the one-process perceptual item is a bf16
# mean, the mesh's an f32 sum over a count), each group of its first
# step's grads (after the all-reduce) by L2_DIST_GRADS relative L2 (bf16
# sums over other batch splits), each group of its parameter updates over
# the steps by L2_DIST_UPDATES (Adam's first steps turn a grad's noise
# into a full step where the grad is near zero). Correct runs read at most
# 7.5e-3 / 4.0e-3 / 0.243; denominators local to a rank 1.0 / 1.0 / 0.19
# and up; rank 1 keeping its own grads, on rank 1, 0.022 / 0.61 / 0.84 and
# up, with the ranks' parameters unequal (PERF.md, Findings).
DIST_STEPS, DIST_DFPN_F, DIST_JOIN_S = 3, 3, 300
L2_DIST_ITEMS, L2_DIST_GRADS, L2_DIST_UPDATES = 2e-2, 5e-2, 6e-1
DIST_FAULTS = {"local": "each denominator local to its rank",
               "skip": "rank 1 keeps its own grads (it takes part in the all-reduce and drops the sum)"}
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SEED = 0


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn`` on the card over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The port's kernels as the profiler names them, by the library that
# launches them: device_ms counts these against a wrapper's launch count,
# and not PyTorch's own kernels, copies or memsets in the same window.
KERNELS_K4 = r"\btw::"
KERNELS_K3 = r"\bkb::"
KERNELS_K3_FIRST = r"\bcb::|\brdb_kernel<"
KERNELS_K6 = r"\b(tb|tw)::"
KERNELS_K6_FIRST = r"\bcb::|\bupconv_kernel\("


def device_ms(fn, iters=3, launches=None, kernels=None, per_kernel=None):
    """Device time of ``fn`` (the sum of its kernels' times under
    ``torch.profiler``) per call, and the number of the port's kernels
    counted: free of the host gaps between launches that CUDA events over a
    chain of short launches also count. The profiler can drop kernels from
    a window; with ``launches`` (the kernels one call launches) and
    ``kernels`` (a pattern of their names) a reading that did not count
    exactly ``launches * iters`` of them is a failed one: it is taken
    again, at most twice, and then the run fails. ``per_kernel``, a dict,
    gets each counted kernel's time a call, by name."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        total = sum(e.self_device_time_total for e in events)
        own = [e for e in events if kernels is None or re.search(kernels, e.key)]
        count = sum(e.count for e in own)
        if launches is None or count == launches * iters:
            if per_kernel is not None:
                per_kernel.update((e.key, e.self_device_time_total / 1e3 / iters) for e in own)
            return total / 1e3 / iters, count
        print(f"device_ms: the profile counted {count} of the port's kernels, {launches * iters} "
              f"launched (reading {attempt + 1}); reading again")
    raise RuntimeError(f"device_ms: the profile miscounted the kernels in 3 readings ({count} of "
                       f"{launches * iters})")


def launches_of(fn, counter):
    """The kernel launches one call of ``fn`` adds to ``counter.launches``."""
    before = counter.launches
    fn()
    return counter.launches - before


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check(name, got, want, base, l2_limit, max_abs=True, planted=False):
    """Holds a kernel's output against its plain version: max|got - want|
    <= ``TOL * max|plain|`` (with ``max_abs``) and ||got - want|| /
    ||want - base|| <= ``l2_limit``. ``base`` is the identity part of the
    output (``1.2 x`` for an RRDB; None for none), so the relative L2 reads
    the part the convs compute. With ``planted`` the output comes from a
    planted fault and must fail. Returns the max abs error."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: kernel output is not finite")
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    rel = ((got - want).norm() / (want if base is None else want - base).norm()).item()
    ok = (not max_abs or err <= TOL * scale) and rel <= l2_limit
    verdict = ("MISSED" if ok else "caught") if planted else ("ok" if ok else "FAIL")
    print(f"{'planted' if planted else 'check'} {name}: max_abs_err={err:.6g} "
          f"max|plain|={scale:.6g}{f' tol={TOL * scale:.6g}' if max_abs else ''} "
          f"rel_l2{'' if base is None else '(body)'}={rel:.6g} limit={l2_limit:g} {verdict}")
    if ok == planted:
        raise RuntimeError(f"{name}: " + ("the check does not see a planted fault" if planted
                                          else "kernel disagrees with its plain version"))
    return err


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build():
    from master_thesis_tpu_torch import _build

    t0 = time.perf_counter()
    report = _build.build(_build.SOURCES, [
        (name, (f"-DBWD_PLANT={f}",)) for name in ("rrdb_bwd", "tail_bwd") for f in FAULTS
    ] + [("tail_bwd", ("-DBWD_PLANT=4",))] + [("conv_stack", (f"-DSTACK_PLANT={f}",)) for f in STACK_FAULTS]
      + [("conv_stack_wgmma", (f"-DWIDE_PLANT={f}",)) for f in WIDE_FAULTS]
      + [("conv_stack_wgmma", (f"-DFRAME_PLANT={f}",)) for f in FRAME_FAULTS]
      + [(name, ("-DBAND_PLANT=1",)) for name in ("rrdb", "tail")]
      + [("rrdb", ("-DRDB_PLANT=1",)), ("tail", ("-DTAIL_PLANT=1",))]
      + [("conv_f32", (f"-DF32_PLANT={f}",)) for f in F32_FAULTS]
      + [("conv_frame_tf32", (f"-DTF32_PLANT={f}",)) for f in {**TF32_FAULTS, **TF32_BWD_FAULTS}])
    print(f"build: {len(report)} libraries in {time.perf_counter() - t0:.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)})")
    for name, (secs, log) in sorted(report.items()):
        print(f"build {name}: {secs:.1f} s")
        if "_PLANT" in name:
            continue
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem", "wgmma")):
                print(f"  ptxas {name}: {line.strip()}")


def plant_rdb(p, fault):
    """A copy of packed RDB ``p`` with a fault, for the kernel side only:
    ``"x4"`` drops x4 from conv5's input, ``"bias5"`` drops conv5's bias."""
    from master_thesis_tpu_torch.ops import rrdb

    ks = list(p.kernels)
    bs = list(p.b.split([k.shape[0] for k in ks]))
    if fault == "x4":
        ks[4] = ks[4].clone()
        ks[4][:, -ks[0].shape[0]:] = 0  # x4 is conv5's last gc input channels
    else:
        bs[4] = torch.zeros_like(bs[4])
    return rrdb.pack_rdb(list(zip(ks, bs)), p.w.dtype)


def planted_trunk(trunk_w, fault="x4"):
    """The trunk's weights with ``fault`` planted in every RDB, as a fault
    of the kernel would show in every launch."""
    return [[plant_rdb(p, fault) for p in rdbs] for rdbs in trunk_w]


def channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


@contextlib.contextmanager
def planted_rdb():
    """Within: the RDB wrappers (K1, K2) launch the library built with
    ``-DRDB_PLANT=1`` (csrc/conv3x3_wgmma.cuh): every row run's right halo
    column is read as zeros, which only a frame wider than one 64-pixel
    run shows."""
    from master_thesis_tpu_torch.ops import rrdb

    orig = rrdb._rdb_lib
    rrdb._rdb_lib = lambda _=(): orig(("-DRDB_PLANT=1",))
    try:
        yield
    finally:
        rrdb._rdb_lib = orig


@contextlib.contextmanager
def planted_tail():
    """Within: the tail wrappers (K4, K5) launch the library built with
    ``-DTAIL_PLANT=1`` (csrc/tail_wgmma.cuh): every tile's right halo
    column is read as zeros in all four launches."""
    from master_thesis_tpu_torch.ops import tail

    orig = tail._tail_lib
    tail._tail_lib = lambda _=(): orig(("-DTAIL_PLANT=1",))
    try:
        yield
    finally:
        tail._tail_lib = orig


def rrdb_tiles(x, rdbs):
    """One RRDB through the first K1 design (``csrc/rrdb.cu:
    rdb_forward_tiles``: fused RDBs over 8x16 tiles, NCHW, B in mma.sync
    fragment order), an independent implementation that only this script
    runs, on contiguous NCHW ``x``."""
    import ctypes

    from master_thesis_tpu_torch import _build

    lib = _build.load("rrdb")
    lib.rdb_forward_tiles.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rdb_forward_tiles.restype = ctypes.c_int
    n, _, h, w = x.shape
    y = x
    for j, p in enumerate(rdbs):
        out = torch.empty_like(x)
        rc = lib.rdb_forward_tiles(y.data_ptr(), x.data_ptr() if j == 2 else None, p.w.data_ptr(),
                                   p.b.data_ptr(), out.data_ptr(), n, h, w,
                                   torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, "rdb_forward_tiles")
        y = out
    return y


def rrdb_cudnn(x, rdbs, convs=None):
    """One RRDB as the cuDNN route: each RDB's five ``F.conv2d`` in bf16
    channels-last with the concatenations (TF32 off); ``convs``, if given,
    the RDBs' (kernels, biases) to use (autograd leaves for the backward's
    yardstick). K1's and K3's yardstick beside them; the port never calls
    it."""
    import torch.nn.functional as F

    y = x
    for j, p in enumerate(rdbs):
        ks, bs = convs[j] if convs is not None else cudnn_convs(p, x.dtype)
        feats = [y]
        for k in range(4):
            feats.append(F.leaky_relu(F.conv2d(torch.cat(feats, 1), ks[k], bs[k], padding=1), 0.2))
        out = 0.2 * F.conv2d(torch.cat(feats, 1), ks[4], bs[4], padding=1) + y
        y = 0.2 * out + x if j == 2 else out
    return y


def cudnn_convs(p, dtype):
    ks = [channels_last(k) for k in p.kernels]
    return ks, [b.to(dtype) for b in p.b.split([k.shape[0] for k in ks])]


def rrdb_cudnn_backward(x, rdbs):
    """The cuDNN route's backward of one RRDB (autograd through the five
    ``F.conv2d`` of each RDB, bf16 channels-last, TF32 off): a function of
    the output cotangent returning dx and every conv's weight and bias
    grads, over a forward graph made once. K3's yardstick; the port never
    calls it."""
    xs = x.detach().requires_grad_()
    convs = [tuple([t.detach().requires_grad_() for t in part] for part in cudnn_convs(p, x.dtype))
             for p in rdbs]
    with torch.enable_grad():
        y = rrdb_cudnn(xs, rdbs, convs)
    leaves = [xs] + [t for ks, bs in convs for t in ks + bs]
    return lambda g: torch.autograd.grad(y, leaves, g, retain_graph=True)


def phase_kernels(chn):
    """K1 (RRDB = 3 RDB calls of 5 conv launches) and K4 (tail = 4
    launches) against their plain versions, at the main path's shapes and
    ragged ones; each check also read on a planted fault; K1's x1..x4
    against the plain version's and the first design's; K1 beside the
    first design and the cuDNN route on the same inputs, K4 beside its
    first design; each conv of an RDB and each launch of the tail against
    its floor."""
    from master_thesis_tpu_torch.ops import rrdb, rrdb_bwd, tail

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trunk_w, tail_w = chn.nn.packed()
    nf = chn.nn.nf
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    n = B * F
    results = {}

    one = [trunk_w[0]]
    run_k = lambda x, w=one: rrdb.rrdb_trunk(x, w)
    run_p = lambda x: rrdb.rrdb_trunk(x, one, rdb_fn=rrdb.rdb_plain)
    x = channels_last(rnd(n, nf, H // 4, W // 4))
    want = run_p(x)
    err = check("K1 rrdb (80, 64, 64, 64)", run_k(x), want, 1.2 * x.float(), L2_RRDB)
    for fault in ("x4", "bias5"):
        bad = [[*one[0][:2], plant_rdb(one[0][2], fault)]]
        check(f"K1 rrdb, {fault} fault in rdb3", run_k(x, bad), want, 1.2 * x.float(), L2_RRDB,
              planted=True)
    for shape in ((2, 60, 120), (1, 13, 21)):
        xr = channels_last(rnd(shape[0], nf, *shape[1:]))
        want_r = run_p(xr)
        label = f"K1 rrdb ragged ({shape[0]}, 64, {shape[1]}, {shape[2]})"
        check(label, run_k(xr), want_r, 1.2 * xr.float(), L2_RRDB)
        if shape[2] > 64:
            with planted_rdb():
                check(f"{label}, {RDB_FAULT}", run_k(xr), want_r, 1.2 * xr.float(), L2_RRDB,
                      planted=True)
    want = rrdb.rrdb_trunk(x, trunk_w, rdb_fn=rrdb.rdb_plain)
    base = 1.2 ** NB * x.float()
    check(f"K1 {NB}-RRDB trunk", rrdb.rrdb_trunk(x, trunk_w), want, base, L2_TRUNK, max_abs=False)
    check(f"K1 {NB}-RRDB trunk, x4 fault in every rdb", rrdb.rrdb_trunk(x, planted_trunk(trunk_w)),
          want, base, L2_TRUNK, max_abs=False, planted=True)

    # x1..x4 and the output of one RDB against the plain version's and the
    # first design's (rdb_forward_hidden, the first K3 design's recompute):
    # an independent
    # implementation on the same input.
    p0 = one[0][0]
    out, hid = rrdb.rdb_cuda(x, p0, keep_hidden=True)
    _, want_h = rrdb.rdb_plain(x, p0, keep_hidden=True)
    x_nchw = x.contiguous()
    out_old, hid_old = rrdb_bwd._rdb_hidden(rrdb_bwd._lib(), SimpleNamespace(launches=0), x_nchw, p0)
    for k in range(4):
        got = hid[..., 32 * k: 32 * k + 32].permute(0, 3, 1, 2)
        check(f"K1 x{k + 1} vs the plain version", got, want_h[k], None, L2_HIDDEN)
        check(f"K1 x{k + 1} vs the first design", got, hid_old[:, 32 * k: 32 * k + 32], None, L2_HIDDEN)
    check("K1 rdb output vs the first design", out, out_old, x.float(), L2_RRDB)

    w_all = [t for p in one[0] for t in (p.wg, p.b)]
    b_ms, b_by = bound_ms(3 * rrdb.rdb_flops(n, H // 4, W // 4), nbytes(x, x, *w_all))
    results["K1"] = dict(
        name="rrdb (conv_kernel x5 per RDB, 3 RDBs per RRDB)", route="cuda",
        source="master_thesis_tpu_torch/csrc/rrdb.cu",
        replaces="master_thesis_tpu/ops/pallas_rrdb.py:181",
        max_abs_err=err, ms=cuda_ms(lambda: run_k(x)),
        plain_ms=cuda_ms(lambda: run_p(x)), bound_ms=b_ms, bound_by=b_by,
        library_ms=None, tiles_ms=cuda_ms(lambda: rrdb_tiles(x_nchw, one[0])),
        cudnn_ms=cuda_ms(lambda: rrdb_cudnn(x, one[0])),
    )
    print(f"K1 kernel launches per RDB call: {rrdb.RDB_CONVS} (one per conv); rdb_cuda.launches "
          f"counts RDB calls")
    x8 = channels_last(rnd(8, nf, 128, 128))
    x8_nchw = x8.contiguous()
    for label, xs, xs_nchw in (("80x64x64", x, x_nchw), ("8x128x128", x8, x8_nchw)):
        t_new, t_old = cuda_ms(lambda: run_k(xs)), cuda_ms(lambda: rrdb_tiles(xs_nchw, one[0]))
        t_cudnn = cuda_ms(lambda: rrdb_cudnn(xs, one[0]))
        print(f"K1 old vs new, one RRDB at {label}: new {t_new:.4f} ms, first design {t_old:.4f} ms "
              f"({t_old / t_new:.2f}x), cuDNN route {t_cudnn:.4f} ms")
        if not t_new < t_old:
            raise RuntimeError(f"K1 at {label} is not faster than the first design")
    for k in range(1, 6):  # out and hid from the x1..x4 check above
        t = cuda_ms(lambda: rrdb.rdb_conv_cuda(k, x, p0, out, hid))
        floor, _ = bound_ms(*rrdb.rdb_conv_cost(k, n, H // 4, W // 4))
        print(f"K1 conv{k} alone at {n}x64x64: {1e3 * t:.2f} us, floor {1e3 * floor:.1f} us "
              f"({floor / t:.1%} of it)")

    y = channels_last(rnd(n, nf, H // 4, W // 4))
    out = tail.tail_cuda(y, tail_w)
    if out.shape != (n, 3, H, W) or not out.is_contiguous(memory_format=torch.channels_last):
        raise RuntimeError(f"K4 output shape {tuple(out.shape)} or layout (not channels-last)")
    want = tail.tail_plain(y, tail_w)
    err = check("K4 tail (80, 64, 64, 64) -> (80, 3, 256, 256)", out, want, None, L2_TAIL)
    for key in ("up1_b", "last_b"):
        bad = dict(tail_w, **{key: torch.zeros_like(tail_w[key])})
        check(f"K4 tail, {key} dropped", tail.tail_cuda(y, bad), want, None, L2_TAIL, planted=True)
    with planted_tail():
        check(f"K4 tail, {TAIL_FAULT}", tail.tail_cuda(y, tail_w), want, None, L2_TAIL, planted=True)
    yr = channels_last(rnd(2, nf, 60, 120))
    want_r = tail.tail_plain(yr, tail_w)
    check("K4 tail ragged (2, 64, 60, 120)", tail.tail_cuda(yr, tail_w), want_r, None, L2_TAIL)
    with planted_tail():
        check(f"K4 tail ragged, {TAIL_FAULT}", tail.tail_cuda(yr, tail_w), want_r, None, L2_TAIL,
              planted=True)
    # The first design (NCHW, three launches) on the same input: held to the
    # plain version too, and timed beside the new one.
    y_nchw = y.contiguous()
    check("K4 first design (tail_first_cuda)", tail.tail_first_cuda(y_nchw, tail_w), want, None,
          L2_TAIL)
    t_new = cuda_ms(lambda: tail.tail_cuda(y, tail_w))
    t_old = cuda_ms(lambda: tail.tail_first_cuda(y_nchw, tail_w))
    peak_new = peak_mb(lambda: tail.tail_cuda(y, tail_w))
    peak_old = peak_mb(lambda: tail.tail_first_cuda(y_nchw, tail_w))
    d_new, d_kernels = device_ms(lambda: tail.tail_cuda(y, tail_w), launches=tail.TAIL_KERNELS,
                                 kernels=KERNELS_K4)
    print(f"K4 old vs new at 80x64x64: new {t_new:.4f} ms (device {d_new:.4f}, {d_kernels} kernels "
          f"in 3 calls), first design {t_old:.4f} ms ({t_old / t_new:.2f}x); holds {peak_new:.1f} MB "
          f"at its peak (first design {peak_old:.1f})")
    if not t_new < t_old:
        raise RuntimeError("K4 at 80x64x64 is not faster than the first design")
    # Each launch alone against its floor, on the plain version's input to
    # that stage (channels-last), and held to the plain stage.
    src = y
    for k, stage in enumerate(TAIL_STAGES):
        want_k = tail.tail_stage_plain(k, src, tail_w)
        src_nhwc = src.permute(0, 2, 3, 1).contiguous()
        dst = torch.empty(want_k.permute(0, 2, 3, 1).shape, dtype=src.dtype, device=src.device)
        tail.tail_stage_cuda(k, src_nhwc, tail_w, dst)
        check(f"K4 {stage} alone", dst.permute(0, 3, 1, 2), want_k, None, L2_TAIL)
        t = cuda_ms(lambda: tail.tail_stage_cuda(k, src_nhwc, tail_w, dst))
        floor, by = bound_ms(*tail.tail_stage_cost(k, n, H // 4, W // 4))
        print(f"K4 {stage} alone at {tuple(src.shape)}: {1e3 * t:.2f} us, floor {1e3 * floor:.1f} us "
              f"({by}; {floor / t:.1%} of it)")
        src = want_k
    b_ms, b_by = bound_ms(tail.tail_flops(n, H // 4, W // 4), nbytes(y, out))
    results["K4"] = dict(
        name="tail (tail_kernel x4: upconv1, upconv2, hr_conv, conv_last)", route="cuda",
        source="master_thesis_tpu_torch/csrc/tail_wgmma.cuh",
        replaces="master_thesis_tpu/ops/pallas_tail.py:263",
        max_abs_err=err, ms=t_new, plain_ms=cuda_ms(lambda: tail.tail_plain(y, tail_w)), bound_ms=b_ms,
        bound_by=b_by, library_ms=None, first_design_ms=t_old, peak_mb=peak_new, first_peak_mb=peak_old,
    )
    for key, r in results.items():
        beside = (f" first_design_ms={r['tiles_ms']:.4f} cudnn_route_ms={r['cudnn_ms']:.4f}"
                  if "tiles_ms" in r else
                  f" first_design_ms={r['first_design_ms']:.4f} peak_mb={r['peak_mb']:.1f} "
                  f"first_peak_mb={r['first_peak_mb']:.1f}")
        print(f"kernel {key} {r['name']}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) library_ms=null{beside}")
    return results


def rrdbnet_forward(net, trunk_w, rdb_fn, tail_fn, nchw_tail=False):
    """``RRDBNet.forward`` on the full-frame routes with the given trunk
    weights, RDB and tail; with ``nchw_tail`` the trunk's sum is copied to
    NCHW for the tail (the layout of the first tail design)."""
    from master_thesis_tpu_torch.ops import rrdb

    _, tail_w = net.packed()

    def forward(x, trunk_band_rows=None, tail_band_rows=None):
        y = channels_last(net.conv_first(x))
        t = rrdb.rrdb_trunk(y, trunk_w, rdb_fn=rdb_fn)
        s = y + net.trunk_conv(t)
        return tail_fn(s.contiguous() if nchw_tail else channels_last(s), tail_w)

    return forward


def make_inputs(b, f, h, w, seed):
    """bench.py's inputs: frames uniform in [0, 1), masks at 10% holes."""
    rng = np.random.RandomState(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    return (to(rng.rand(b, h, w, 3)), to(rng.rand(b, h, w, 1) > 0.9),
            to(rng.rand(b, f, h, w, 3)), to(rng.rand(b, f, h, w, 1) > 0.9))


def phase_main_path(cpn, chn, results, device_line):
    from master_thesis_tpu_torch.models.chn import CHN, chn_infer_apply
    from master_thesis_tpu_torch.ops import rrdb, tail

    def step(x_t, m_t, x_r, m_r):
        xa, va, vm = cpn.align(x_t, m_t, x_r, m_r)
        return chn_infer_apply(chn, x_t, 1 - m_t, xa, va, vm), (xa, va, vm)

    inputs = make_inputs(B, F, H, W, SEED)
    with torch.inference_mode():
        for _ in range(2):
            step(*inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rrdb.rdb_cuda.launches = 0
        tail.tail_cuda.launches = 0
        (y_hat, y_comp), _ = step(*inputs)
        torch.cuda.synchronize()
        counts = {"K1": rrdb.rdb_cuda.launches, "K4": tail.tail_cuda.launches}
    want = {"K1": NB * 3, "K4": tail.TAIL_KERNELS}
    print(f"main path launches in one step: {counts} (expected {want})")
    if counts != want:
        raise RuntimeError("the main path did not launch each kernel as expected")
    for key in counts:
        results[key]["launches"] = counts[key]

    x_t, m_t = inputs[0], inputs[1]
    if y_hat.shape != (B, F, H, W, 3) or y_comp.shape != (B, F, H, W, 3):
        raise RuntimeError(f"output shapes {tuple(y_hat.shape)}, {tuple(y_comp.shape)}")
    if not (torch.isfinite(y_hat).all() and y_hat.min() >= 0 and y_hat.max() <= 1):
        raise RuntimeError("y_hat is not finite in [0, 1]")
    visible = (1 - m_t)[:, None].expand(B, F, H, W, 3) == 1
    x_rep = x_t[:, None].expand(B, F, H, W, 3)
    if not torch.equal(y_comp[visible], x_rep[visible]):
        raise RuntimeError("y_hat_comp differs from x_t where the target is visible")
    if y_hat.std().item() <= 0:
        raise RuntimeError("y_hat is constant")
    print(f"main path output: y_hat in [{y_hat.min().item():.4f}, {y_hat.max().item():.4f}], "
          f"std {y_hat.std().item():.4f}; y_hat_comp == x_t on all visible pixels")

    # A small input through the kernels, against the same network through
    # the kernels' plain versions on the card (same bf16 rounding points),
    # and, for the size of bf16 drift alone, the f32 plain path on the CPU;
    # read also with a fault planted in every RDB of the kernel path.
    small = make_inputs(1, 2, 64, 64, SEED + 1)
    ref = CHN(nb=NB, device="cpu", dtype=torch.float32)
    ref.load_state_dict(chn.state_dict())
    cpu = lambda t: t.float().cpu()
    trunk_w, _ = chn.nn.packed()
    net = lambda *fns: SimpleNamespace(nn=rrdbnet_forward(chn.nn, *fns), dtype=chn.dtype)
    with torch.inference_mode():
        (y_small, _), aligned = step(*small)
        v_small = 1 - small[1]
        y_plain, _ = chn_infer_apply(
            net(trunk_w, rrdb.rdb_plain, tail.tail_plain), small[0], v_small, *aligned)
        y_bad, _ = chn_infer_apply(
            net(planted_trunk(trunk_w), rrdb.rdb, tail.tail), small[0], v_small, *aligned)
        y_f32, _ = chn_infer_apply(ref, cpu(small[0]), cpu(v_small), *map(cpu, aligned))
    rel = ((y_small - y_plain).norm() / y_plain.norm()).item()
    rel_bad = ((y_bad - y_plain).norm() / y_plain.norm()).item()
    drift = ((cpu(y_small) - y_f32).norm() / y_f32.norm()).item()
    print(f"check main path, 1x2x64x64, kernels vs plain versions on the card: relative L2 "
          f"{rel:.6g} (limit {L2_STEP:g}); with an x4 fault in every rdb {rel_bad:.6g}; "
          f"bf16 vs f32 plain path on the CPU: relative L2 {drift:.6g}")
    if rel > L2_STEP:
        raise RuntimeError("the kernel path disagrees with the plain path")
    if rel_bad <= L2_STEP:
        raise RuntimeError("the main-path check does not see a planted fault")

    iters = 20
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*inputs)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
    print(f"main path: B={B} F={F} {H}x{W} nb={NB} bf16: {1e3 * dt:.3f} ms/step, "
          f"{B / dt:.3f} frames/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {device_line}")
    _, layout_after = phase_profile(step, inputs, dt)

    # The tail's input and output stay channels-last on the path: its output
    # is the NHWC chn_infer_apply reads as a view. Beside it, the layout the
    # first tail design needed (the trunk's sum copied to NCHW, the first
    # design, its NCHW output copied to NHWC), timed and profiled the same
    # way on the same inputs.
    with torch.inference_mode():
        probe = chn.nn(torch.randn(2, 9, 64, 64, device="cuda").to(chn.dtype))
    if not probe.permute(0, 2, 3, 1).is_contiguous():
        raise RuntimeError("the network's output is not channels-last: the caller's NHWC view copies")
    before = SimpleNamespace(nn=rrdbnet_forward(chn.nn, trunk_w, rrdb.rdb, tail.tail_first_cuda,
                                                nchw_tail=True), dtype=chn.dtype)

    def step_before(x_t, m_t, x_r, m_r):
        xa, va, vm = cpn.align(x_t, m_t, x_r, m_r)
        return chn_infer_apply(before, x_t, 1 - m_t, xa, va, vm), (xa, va, vm)

    with torch.inference_mode():
        step_before(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step_before(*inputs)
        torch.cuda.synchronize()
        dt_before = (time.perf_counter() - t0) / iters
    print(f"main path with the first tail design and its NCHW copies: {1e3 * dt_before:.3f} ms/step "
          f"(this design {1e3 * dt:.3f})")
    _, layout_before = phase_profile(step_before, inputs, dt_before)
    print(f"layout transposes and copies in one step: {layout_after:.3f} ms (first tail design and "
          f"its copies: {layout_before:.3f} ms)")


def phase_profile(step, inputs, step_s, grad=False):
    """One step under ``torch.profiler``: device time by kernel, and the
    device's busy share of the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    mode = contextlib.nullcontext() if grad else torch.inference_mode()
    with mode, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=grad) as prof:
        step(*inputs)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    print(f"profile: device busy {busy:.3f} ms in one step; {100 * busy / (1e3 * step_s):.1f}% "
          f"of the unprofiled {1e3 * step_s:.3f} ms/step")
    for ms, count, key in rows[:12]:
        print(f"profile: {ms:10.3f} ms {count:5d}x {key[:100]}")
    layout = [r for r in rows if any(k in r[2].lower() for k in LAYOUT_KEYS)]
    layout_ms = sum(r[0] for r in layout)
    print(f"profile: layout transposes and copies {layout_ms:.3f} ms in "
          f"{sum(r[1] for r in layout)} launches")
    for ms, count, key in layout[:4]:
        print(f"profile:   {ms:10.3f} ms {count:5d}x {key[:100]}")
    if grad:  # which op launched each layout copy, the 24 costliest
        groups = sorted(layout_callers(prof).items(), key=lambda kv: -kv[1][0])
        for (caller, op), (ms, count) in groups[:24]:
            print(f"profile copies: {ms:8.3f} ms {count:4d}x {caller[:60]} > {op[:120]}")
        rest = groups[24:]
        if rest:
            print(f"profile copies: {sum(v[0] for _, v in rest):8.3f} ms "
                  f"{sum(v[1] for _, v in rest):4d}x in {len(rest)} more groups")
    if grad:  # where the host's time goes
        host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()),
                      reverse=True)
        for ms, count, key in host[:10]:
            print(f"profile host: {ms:10.3f} ms {count:6d}x {key[:90]}")
        for e in prof.key_averages():
            if e.key == "TrunkFunctionBackward":
                print(f"profile host: TrunkFunctionBackward {e.self_cpu_time_total / 1e3:.3f} ms "
                      f"self, {e.cpu_time_total / 1e3:.3f} ms with its callees, {e.count}x")
    return busy, layout_ms


def layout_callers(prof):
    """The layout copies of a profile (``LAYOUT_KEYS``) by the op that
    launched them: the nearest enclosing op that is not ATen's (an autograd
    Function, a backward node, the optimizer; "(top level)" if none) and
    the outermost ATen op below it with its input shapes (a profile taken
    with ``record_shapes``). Returns {(caller, op): (ms, launches)}."""
    groups = {}
    for e in prof.events():
        copies = [k for k in getattr(e, "kernels", ())
                  if any(t in k.name.lower() for t in LAYOUT_KEYS)]
        if not copies:
            continue
        node = e
        while node.cpu_parent is not None and node.cpu_parent.name.startswith("aten::"):
            node = node.cpu_parent
        caller = node.cpu_parent.name if node.cpu_parent is not None else "(top level)"
        key = (caller, f"{node.name} {[list(s) for s in node.input_shapes if s]}")
        ms, count = groups.get(key, (0.0, 0))
        groups[key] = (ms + sum(k.duration for k in copies) / 1e3, count + len(copies))
    return groups


@contextlib.contextmanager
def planted_bwd(fault):
    """Within: the backward wrappers (K3, K6) launch their kernels from the
    library built with ``-DBWD_PLANT=fault`` (csrc/conv_bwd_wgmma.cuh,
    csrc/tail_bwd_wgmma.cuh)."""
    from master_thesis_tpu_torch.ops import rrdb_bwd, tail_bwd

    orig = rrdb_bwd._lib, tail_bwd._lib
    defines = (f"-DBWD_PLANT={fault}",)
    rrdb_bwd._lib = lambda _=(): orig[0](defines)
    tail_bwd._lib = lambda _=(): orig[1](defines)
    try:
        yield
    finally:
        rrdb_bwd._lib, tail_bwd._lib = orig


@contextlib.contextmanager
def plain_backward():
    """Within: the trunk's and the tail's autograd Functions run the
    backward kernels' plain versions (their forward stays the kernels')."""
    from master_thesis_tpu_torch.ops import rrdb_bwd, tail_bwd

    orig = rrdb_bwd.rrdb_bwd, tail_bwd.tail_bwd

    def rrdb_plain(x, g, rdbs, pulls, kept, out, scratch=None):
        dx, grads = rrdb_bwd.rrdb_bwd_plain(x, g, rdbs, kept)
        return dx, rrdb_bwd.flat_grads(grads, out)

    rrdb_bwd.rrdb_bwd = rrdb_plain
    tail_bwd.tail_bwd = lambda x, g, p: tail_bwd.tail_bwd_plain(x, g, p)
    try:
        yield
    finally:
        rrdb_bwd.rrdb_bwd, tail_bwd.tail_bwd = orig


def rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp(min=1e-30)).item()


def check_groups(name, got, want, limit, planted=None):
    """Holds every group of a backward's outputs (dx, weight and bias grads)
    against the plain version's: each relative L2 <= ``limit``. With
    ``planted`` (a fault's label) the outputs come from a planted fault and
    some group must exceed it. Returns the worst group's reading."""
    for k, v in got.items():
        if not torch.isfinite(v).all():
            raise RuntimeError(f"{name}: {k} is not finite")
    rels = {k: rel_l2(got[k], want[k]) for k in want}
    worst = max(rels, key=rels.get)
    ok = rels[worst] <= limit
    verdict = ("MISSED" if ok else "caught") if planted else ("ok" if ok else "FAIL")
    label = f"planted {name}, {planted}" if planted else f"check {name}"
    dx = f"dx {rels['dx']:.6g}, " if "dx" in rels else ""
    print(f"{label}: worst rel_l2 {rels[worst]:.6g} ({worst}) over {len(rels)} groups, "
          f"{dx}limit {limit:g} {verdict}")
    if ok == bool(planted):
        raise RuntimeError(f"{name}: " + ("the check does not see a planted fault" if planted
                                          else "kernel disagrees with its plain version"))
    return rels[worst]


def rrdb_groups(dx, grads, prefix=""):
    """An RRDB backward's outputs as named groups: dx and each conv's dW and db."""
    out = {} if dx is None else {"dx": dx}
    for j, (dws, dbs) in enumerate(grads):
        for k in range(5):
            out[f"{prefix}rdb{j + 1}.conv{k + 1}.w"] = dws[k]
            out[f"{prefix}rdb{j + 1}.conv{k + 1}.b"] = dbs[k]
    return out


def phase_kernels_bwd(chn, results):
    """K3 (one RRDB's backward, one call of 20 launches, over the
    activations K1 keeps) and K6 (the tail's backward, one call of 11
    launches) against their plain versions at the train step's shapes, the
    20-RRDB trunk (K3), a ragged shape and an odd one (K6); each check read
    on the planted faults; each run twice, bit for bit. K3 beside the first
    K3 design and the cuDNN route, K6 beside the first K6 design, on the
    same input; each fatal unless faster than its first design."""
    from master_thesis_tpu_torch.ops import rrdb, rrdb_bwd, tail, tail_bwd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(bf)
    net = chn.nn
    trunk_w, tail_w = net.packed()
    pulls = [rrdb.pack_rdb_pulls(rrdb.rrdb_convs(blk), bf) for blk in net.rrdb_trunk]
    nf, n, h, w = net.nf, TRAIN_B * (TRAIN_F - 1), H // 4, W // 4

    def k3(x, g, kept, i=0):
        dx, flat = rrdb_bwd.rrdb_bwd_cuda(x, g, pulls[i], kept)
        return rrdb_groups(dx, rrdb_bwd.rdb_grads(flat))

    def p3(x, g, kept, i=0):
        dx, grads = rrdb_bwd.rrdb_bwd_plain(x, g, trunk_w[i], kept)
        return rrdb_groups(dx, grads)

    def inputs(*shape, i=0):
        x, g = channels_last(rnd(*shape)), channels_last(rnd(*shape))
        return x, g, rrdb_bwd.rrdb_forward_kept(x, trunk_w[i])[1]

    x, g, kept = inputs(n, nf, h, w)
    want = p3(x, g, kept)
    got = k3(x, g, kept)
    check_groups(f"K3 rrdb backward ({n}, {nf}, {h}, {w})", got, want, L2_K3)
    err = (got["dx"].float() - want["dx"].float()).abs().max().item()
    again = k3(x, g, kept)
    same = all(torch.equal(got[k], again[k]) for k in got)
    print(f"K3 rerun bit-identical (dx, {len(got) - 1} dW / db groups): {same}")
    if not same:
        raise RuntimeError("K3: two runs on the same input differ")
    for fault, label in FAULTS.items():
        with planted_bwd(fault):
            check_groups("K3 rrdb backward", k3(x, g, kept), want, L2_K3, planted=label)
    xr, gr, kr = inputs(2, nf, 60, 120)
    check_groups("K3 rrdb backward ragged (2, 64, 60, 120)", k3(xr, gr, kr), p3(xr, gr, kr), L2_K3)
    adjs = rrdb.pack_rdb_adjoints(rrdb.rrdb_convs(net.rrdb_trunk[0]), bf)
    x_nchw, g_nchw = x.contiguous(), g.contiguous()

    def first():
        dx, grads = rrdb_bwd.rrdb_bwd_first(x_nchw, g_nchw, trunk_w[0], adjs)
        return rrdb_groups(dx, grads)

    check_groups("K3 first design (recompute, 51 launches) vs the plain version", first(), want,
                 L2_K3)

    # The trunk: the RRDB inputs and kept activations from K1 into both
    # backward chains.
    inters, kepts = [x], []
    for rdbs in trunk_w:
        y, k = rrdb_bwd.rrdb_forward_kept(inters[-1], rdbs)
        inters.append(y)
        kepts.append(k)

    def chain(bwd):
        gg, out = g, {}
        for i in reversed(range(len(trunk_w))):
            groups = bwd(inters[i], gg, kepts[i], i)
            gg = groups.pop("dx")
            out[f"rrdb{i}.dW"] = torch.cat([v.reshape(-1) for k, v in groups.items() if k.endswith(".w")])
            out[f"rrdb{i}.db"] = torch.cat([v.reshape(-1) for k, v in groups.items() if k.endswith(".b")])
        out["dx"] = gg
        return out

    want_t = chain(p3)
    check_groups(f"K3 {NB}-RRDB trunk backward", chain(k3), want_t, L2_K3_TRUNK)
    for fault, label in FAULTS.items():
        with planted_bwd(fault):
            check_groups(f"K3 {NB}-RRDB trunk backward", chain(k3), want_t, L2_K3_TRUNK, planted=label)

    # Times at the train shape: K3 with its grad buffer and scratch made
    # once (as TrunkFunction does), the first design, the cuDNN route.
    out = torch.empty(3 * rrdb_bwd.RDB_GRAD_NUMEL, dtype=torch.float32, device="cuda")
    scratch = torch.empty(rrdb_bwd.scratch_bytes(n, h, w), dtype=torch.uint8, device="cuda")
    run = lambda: rrdb_bwd.rrdb_bwd_cuda(x, g, pulls[0], kept, out, scratch)
    cudnn_bwd = rrdb_cudnn_backward(x, trunk_w[0])
    kept_t = [t for part in kept for t in part]
    grads_bytes = 4 * sum(p.numel() for p in net.rrdb_trunk[0].parameters())
    io = nbytes(g, x, x, *kept_t[1:], pulls[0]) + grads_bytes  # g, x, the rest kept in, dx out
    b_ms, b_by = bound_ms(rrdb_bwd.rrdb_bwd_flops(n, h, w), io)
    old_b_ms, _ = bound_ms(rrdb_bwd.rrdb_bwd_first_flops(n, h, w), io)
    t0 = time.perf_counter()
    for _ in range(50):
        run()
    host_ms = 1e3 * (time.perf_counter() - t0) / 50
    torch.cuda.synchronize()
    results["K3"] = dict(
        name=f"rrdb backward (one call: prep, 3 x (5 pulls + wgrad), reduce = "
             f"{rrdb_bwd.RRDB_BWD_KERNELS} launches)",
        route="cuda", source="master_thesis_tpu_torch/csrc/rrdb_bwd.cu",
        replaces="master_thesis_tpu/ops/pallas_rrdb.py:625",
        max_abs_err=err, stream_ms=cuda_ms(run, iters=20),
        plain_ms=device_ms(lambda: p3(x, g, kept))[0], bound_ms=b_ms, bound_by=b_by,
        library_ms=None, first_stream_ms=cuda_ms(first, iters=10),
        cudnn_ms=cuda_ms(lambda: cudnn_bwd(g), iters=10), first_bound_ms=old_b_ms,
    )
    r = results["K3"]
    r["ms"], r["device_kernels"] = device_ms(run, launches=rrdb_bwd.RRDB_BWD_KERNELS,
                                             kernels=KERNELS_K3)
    r["first_ms"], first_kernels = device_ms(
        first, launches=launches_of(first, rrdb_bwd.rrdb_bwd_first), kernels=KERNELS_K3_FIRST)
    print(f"K3 one RRDB at ({n}, {nf}, {h}, {w}): kernel {r['ms']:.4f} ms (device, "
          f"{r['device_kernels']} kernels in 3 calls; CUDA events {r['stream_ms']:.4f}), host "
          f"enqueue {host_ms:.4f} ms a call; first design {r['first_ms']:.4f} (device, "
          f"{first_kernels} kernels; events {r['first_stream_ms']:.4f}); cuDNN route (autograd "
          f"through the five F.conv2d of each RDB) {r['cudnn_ms']:.4f}; bound {b_ms:.4f} ms "
          f"({b_by}; the first design's work: {old_b_ms:.4f})")
    if r["ms"] >= r["first_ms"]:
        raise RuntimeError("K3: the redesigned backward is not faster than the first design")

    tconvs = [(m.weight, m.bias) for m in (net.upconv1, net.upconv2, net.hr_conv, net.conv_last)]
    tadj, fadj = tail_bwd.pack_tail_bwd(tail_w), tail_bwd.pack_tail_adjoint(tconvs, bf)

    def k6(x, g):
        dx, grads = tail_bwd.tail_bwd_cuda(x, g, tail_w, tadj)
        return {"dx": dx, **grads}

    def p6(x, g):
        dx, grads = tail_bwd.tail_bwd_plain(x, g, tail_w)
        return {"dx": dx, **grads}

    def f6(x, g):
        dx, grads = tail_bwd.tail_bwd_first_cuda(x, g, tail_w, fadj)
        return {"dx": dx, **grads}

    # The new K6 at the train shape, a ragged and an odd one; its faults;
    # a rerun; the first design on the same values.
    xt, gt = channels_last(rnd(n, nf, h, w)), channels_last(rnd(n, 3, 4 * h, 4 * w))
    want = p6(xt, gt)
    got = k6(xt, gt)
    check_groups(f"K6 tail backward ({n}, {nf}, {h}, {w}) <- ({n}, 3, {4 * h}, {4 * w})", got, want,
                 L2_K6)
    err = (got["dx"].float() - want["dx"].float()).abs().max().item()
    again = k6(xt, gt)
    same = all(torch.equal(got[k], again[k]) for k in got)
    print(f"K6 rerun bit-identical (dx, {len(got) - 1} dW / db groups): {same}")
    if not same:
        raise RuntimeError("K6: two runs on the same input differ")
    for fault, label in K6_FAULTS.items():
        with planted_bwd(fault):
            check_groups("K6 tail backward", k6(xt, gt), want, L2_K6, planted=label)
    for shape in ((2, nf, 60, 120), (1, nf, 13, 7)):
        xr, gr = channels_last(rnd(*shape)), channels_last(rnd(shape[0], 3, 4 * shape[2], 4 * shape[3]))
        check_groups(f"K6 tail backward {'ragged' if shape[0] == 2 else 'odd'} {shape}", k6(xr, gr),
                     p6(xr, gr), L2_K6)
    xf, gf = xt.contiguous(), gt.contiguous()
    check_groups("K6 first design (17 launches, NCHW) vs the plain version", f6(xf, gf), want, L2_K6)
    tail_params = sum(m.weight.numel() + m.bias.numel() for m in (net.upconv1, net.upconv2, net.hr_conv, net.conv_last))
    b_ms, b_by = bound_ms(tail_bwd.tail_bwd_flops(n, h, w), nbytes(xt, gt, xt) + 4 * tail_params)
    stages = {}
    ms, kernels = device_ms(lambda: k6(xt, gt), launches=tail_bwd.TAIL_BWD_KERNELS,
                            kernels=KERNELS_K6, per_kernel=stages)
    first_ms, first_kernels = device_ms(
        lambda: f6(xf, gf), launches=launches_of(lambda: f6(xf, gf), tail_bwd.tail_bwd_first_cuda),
        kernels=KERNELS_K6_FIRST)
    results["K6"] = dict(
        name=f"tail backward (one call: recompute x3, conv_last, (adjoint, wgrad) x3, reduce = "
             f"{tail_bwd.TAIL_BWD_KERNELS} launches)",
        route="cuda", source="master_thesis_tpu_torch/csrc/tail_bwd_wgmma.cuh",
        replaces="master_thesis_tpu/ops/pallas_tail.py:732",
        max_abs_err=err, ms=ms, device_kernels=kernels, stream_ms=cuda_ms(lambda: k6(xt, gt), iters=10),
        plain_ms=device_ms(lambda: p6(xt, gt))[0], bound_ms=b_ms, bound_by=b_by, library_ms=None,
        first_design_ms=first_ms, first_stream_ms=cuda_ms(lambda: f6(xf, gf), iters=10),
    )
    r = results["K6"]
    print(f"K6 at ({n}, {nf}, {h}, {w}): kernel {ms:.4f} ms (device, {kernels} kernels in 3 calls; "
          f"CUDA events {r['stream_ms']:.4f}); first design {first_ms:.4f} (device, {first_kernels} "
          f"kernels; events {r['first_stream_ms']:.4f}); bound {b_ms:.4f} ms ({b_by})")
    for key, t in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"K6 launch {t:.4f} ms a call (device): {key[:110]}")
    if not ms < first_ms:
        raise RuntimeError("K6: the redesigned backward is not faster than the first design")
    for key in ("K3", "K6"):
        r = results[key]
        print(f"kernel {key} {r['name']}: kernel_ms={r['ms']:.4f} ({r['device_kernels']} device "
              f"kernels; CUDA events over the launch chain {r['stream_ms']:.4f}) "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms=null")


def make_train_batch(b, f, h, w, seed):
    """Frames uniform in [0, 1) as the ground truth y, masks at 10% holes,
    x = y with the holes zeroed."""
    rng = np.random.RandomState(seed)
    y = rng.rand(b, f, h, w, 3).astype(np.float32)
    m = (rng.rand(b, f, h, w, 1) > 0.9).astype(np.float32)
    to = lambda a: torch.from_numpy(a).cuda()
    return to((1 - m) * y), to(m), to(y)


def grad_groups(chn):
    """The CHN grads in six groups: the weights and the biases of the head
    (conv_first, trunk_conv), the trunk and the tail."""
    groups = {}
    for name, p in chn.named_parameters():
        part = "trunk" if ".rrdb_trunk." in name else (
            "head" if ".conv_first." in name or ".trunk_conv." in name else "tail")
        groups.setdefault(f"{part}.{name.rsplit('.', 1)[1]}", []).append(p.grad.float().reshape(-1))
    return {k: torch.cat(v) for k, v in groups.items()}


def phase_train(cpn, chn, results, device_line):
    """The train step at B=8, frames_n=2, 256x256, nb=20, bf16."""
    from master_thesis_tpu_torch.models.chn import chn_infer_apply
    from master_thesis_tpu_torch.models.vgg import VGGFeatures
    from master_thesis_tpu_torch.ops import rrdb, rrdb_bwd, tail, tail_bwd
    from master_thesis_tpu_torch.train import chn_task, state

    chn.train()
    vgg = VGGFeatures(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED + 2))
    vgg.requires_grad_(False)
    st = state.create_train_state(chn, state.OptimConfig(), steps_per_epoch=2000)
    step = chn_task.make_train_step(chn, cpn.align, vgg)
    batch = make_train_batch(TRAIN_B, TRAIN_F, H, W, SEED + 3)
    for _ in range(2):
        step(st, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: v.clone() for k, v in chn.state_dict().items()}
    grads = {}
    orig = st.apply_gradients

    def capture():
        grads.update({k: p.grad.clone() for k, p in chn.named_parameters()})
        orig()

    st.apply_gradients = capture
    counters = (rrdb.rdb_cuda, rrdb_bwd.rrdb_bwd_cuda, tail.tail_cuda, tail_bwd.tail_bwd_cuda)
    for c in counters:
        c.launches = 0
    items = step(st, *batch)
    torch.cuda.synchronize()
    counts = dict(zip(("K1", "K3", "K4", "K6"), (c.launches for c in counters)))
    st.apply_gradients = orig
    want = {"K1": NB * 3, "K3": NB, "K4": tail.TAIL_KERNELS, "K6": tail_bwd.TAIL_BWD_KERNELS}
    print(f"train step launches in one step: {counts} (expected {want}; K1 and K3 count calls: "
          f"{rrdb.RDB_CONVS} and {rrdb_bwd.RRDB_BWD_KERNELS} kernel launches a call)")
    if counts != want:
        raise RuntimeError("the train step did not launch each kernel as expected")
    for key in ("K3", "K6"):
        results[key]["launches"] = counts[key]
    loss = {k: v.item() for k, v in items.items()}
    if not all(np.isfinite(v) for v in loss.values()):
        raise RuntimeError(f"train step loss not finite: {loss}")
    bad = [k for k, g in grads.items() if not torch.isfinite(g).all()]
    if bad or len(grads) != len(before):
        raise RuntimeError(f"grads missing or not finite: {bad[:5]}")
    moved = sum(not torch.equal(before[k], v) for k, v in chn.state_dict().items())
    if moved != len(before):
        raise RuntimeError(f"only {moved} of {len(before)} parameters changed in a step")
    print("train step: " + ", ".join(f"{k} {v:.6g}" for k, v in loss.items())
          + f"; {len(grads)} grads finite; all {moved} parameters moved")

    # Grads through the backward kernels against grads through their plain
    # versions on the card, from the same forward (the kernels'), on a small
    # batch; read also with a planted fault. The forward is shared because
    # the loss is L1: a forward that differs by bf16 noise flips the sign of
    # the small residuals, and with them the cotangents.
    x, m, y = make_train_batch(2, TRAIN_F, 128, 128, SEED + 4)
    t, refs = chn_task.target_ref_indexes(TRAIN_F)
    with torch.no_grad():
        aligned = cpn.align(x[:, t], m[:, t], x[:, refs], m[:, refs])

    def small_grads():
        chn.zero_grad(set_to_none=True)
        y_hat, y_comp = chn_infer_apply(chn, x[:, t], 1 - m[:, t], *aligned)
        total, _ = chn_task.compute_loss(y[:, t], 1 - m[:, t], y_hat, y_comp, aligned[2], vgg)
        total.backward()
        out = {"loss": total.detach().reshape(1), **grad_groups(chn)}
        chn.zero_grad(set_to_none=True)
        return out

    with plain_backward():
        want_g = small_grads()
    check_groups("train step grads, 2x2x128x128, backward kernels vs plain versions",
                 small_grads(), want_g, L2_TRAIN)
    for fault, label in FAULTS.items():
        with planted_bwd(fault):
            check_groups("train step grads", small_grads(), want_g, L2_TRAIN, planted=label)

    iters = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(st, *batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    print(f"train step: B={TRAIN_B} frames_n={TRAIN_F} {H}x{W} nb={NB} bf16: {1e3 * dt:.3f} ms/step, "
          f"{TRAIN_B / dt:.3f} samples/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {device_line}")
    busy, _ = phase_profile(lambda *b: step(st, *b), batch, dt, grad=True)
    return dt, busy


def make_dfpn_batch(b, f, h, w, seed):
    """The DFPN train step's batch: clean frames y uniform in [0, 1), masks
    m at 10% holes, x = y (1 - m), absolute flows (the identity grid under
    a seeded affine movement a frame, as the movement simulator makes:
    scale 0.9-1.1, rotation up to 0.1 rad, shift up to 0.2, so they leave
    [-1, 1] near the borders), and ``flows_use`` on the first half of the
    batch, rounded up (``p_simulator_bgs`` 0.5)."""
    from master_thesis_tpu_torch.ops.flows import identity_grid

    rng = np.random.RandomState(seed)
    y = rng.rand(b, f, h, w, 3).astype(np.float32)
    m = (rng.rand(b, f, h, w, 1) > 0.9).astype(np.float32)
    scale, rot = rng.uniform(0.9, 1.1, (b, f)), rng.uniform(-0.1, 0.1, (b, f))
    lin = scale[..., None, None] * np.stack([np.stack([np.cos(rot), -np.sin(rot)], -1),
                                            np.stack([np.sin(rot), np.cos(rot)], -1)], -2)
    flow = (np.einsum("bfij,hwj->bfhwi", lin, identity_grid(h, w).numpy())
            + rng.uniform(-0.2, 0.2, (b, f, 1, 1, 2)))
    to = lambda a: torch.from_numpy(np.asarray(a)).cuda()
    return (to((1 - m) * y), to(m), to(y), to(flow.astype(np.float32)), to(np.arange(b) < (b + 1) // 2))


class MemoryLogger:
    """A logger for the Trainer and the CLI's test modes: keeps the scalars
    it is given, and the shapes of the images."""

    def __init__(self):
        self.scalars = []
        self.images = []

    def log_scalars(self, scalars, step, prefix=""):
        self.scalars.append((prefix, step, dict(scalars)))

    def log_images(self, tag, images, step):
        self.images.append((tag, step, np.shape(images)))

    def flush(self):
        pass


def rel_l2_groups(a, b):
    """Relative L2 of train states ``a`` against ``b``: over all parameters,
    all first and all second Adam moments."""
    out = {}
    for name, get in (("params", lambda st, p: p.detach()),
                      ("exp_avg", lambda st, p: st.optimizer.state[p]["exp_avg"]),
                      ("exp_avg_sq", lambda st, p: st.optimizer.state[p]["exp_avg_sq"])):
        ga = torch.cat([get(a, p).float().reshape(-1) for p in a.params()])
        gb = torch.cat([get(b, p).float().reshape(-1) for p in b.params()])
        out[name] = ((ga - gb).norm() / gb.norm()).item()
    return out


def phase_dfpn_train(results, device_line):
    """The DFPN train step at B=8, frames_n=2, 256x256, base 256, bf16, and
    the train loop over it with gradient accumulation, checkpoints and
    resume."""
    import importlib.util
    import tempfile

    from master_thesis_tpu_torch.models.vgg import VGGFeatures
    from master_thesis_tpu_torch.ops import conv_stack
    from master_thesis_tpu_torch.train import dfpn_task, state
    from master_thesis_tpu_torch.train.build import build_dfpn
    from master_thesis_tpu_torch.train.checkpoint import restore_train_state
    from master_thesis_tpu_torch.train.loop import LoopConfig, Trainer

    t_phase = time.perf_counter()
    gen = lambda k: torch.Generator().manual_seed(SEED + k)
    vgg = VGGFeatures(dtype=torch.bfloat16, generator=gen(20))
    vgg.requires_grad_(False)
    # Random weights can leave the mixer's 4-channel ReLU convs dead (seed
    # 21 does at this batch: its first ten convs get zero grads); with this
    # seed every grad is live, so the check below that each is nonzero has
    # something to read.
    dfpn = build_dfpn(base_size=DFPN_BASE, dtype=torch.bfloat16, generator=gen(24))
    st = state.create_train_state(dfpn, state.OptimConfig(), steps_per_epoch=2000)
    step = dfpn_task.make_train_step(dfpn, vgg, pallas_vgg=True)
    batch = make_dfpn_batch(DFPN_TRAIN_B, DFPN_TRAIN_F, H, W, SEED + 22)
    for _ in range(3):
        step(st, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: v.clone() for k, v in dfpn.state_dict().items()}
    vgg_before = {k: v.clone() for k, v in vgg.state_dict().items()}
    grads = {}
    orig = st.apply_gradients

    def capture():
        grads.update({k: p.grad.clone() for k, p in dfpn.named_parameters()})
        return orig()

    st.apply_gradients = capture
    counters = {"K7": conv_stack.conv_stack_tiles_cuda, "K8": conv_stack.conv_stack_banded_cuda,
                "K8 frame": conv_stack.conv_frame_cuda}
    for c in counters.values():
        c.launches = 0
    items = step(st, *batch)
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}
    st.apply_gradients = orig
    # VGG's pool-4 tower on K8 three times (the target, the references, the
    # clean frames), 10 launches each, 9 on the frame kernel; K7 and K8 on
    # DFPN's own convs are refused on a grad path.
    want = {"K7": 0, "K8": 30, "K8 frame": 27}
    print(f"DFPN train step launches in one step: {counts} (expected {want})")
    if counts != want:
        raise RuntimeError("the DFPN train step did not launch each kernel as expected")
    results["K8"]["launches_dfpn_train"] = counts["K8"]
    loss = {k: v.item() for k, v in items.items()}
    if set(loss) != set(dfpn_task.LOSSES_NAMES) | {"loss"} or not all(np.isfinite(v) for v in loss.values()):
        raise RuntimeError(f"DFPN train step items missing or not finite: {loss}")
    bad = [k for k, g in grads.items() if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    if bad or len(grads) != len(before):
        raise RuntimeError(f"DFPN grads missing, not finite or zero: {bad[:5]}")
    moved = sum(not torch.equal(before[k], v) for k, v in dfpn.state_dict().items())
    if moved != len(before):
        raise RuntimeError(f"only {moved} of {len(before)} DFPN parameters changed in a step")
    if any(not torch.equal(vgg_before[k], v) for k, v in vgg.state_dict().items()):
        raise RuntimeError("a frozen VGG parameter changed in a DFPN train step")
    print("DFPN train step: " + ", ".join(f"{k} {v:.6g}" for k, v in loss.items())
          + f"; {len(grads)} grads finite and nonzero; all {moved} DFPN parameters moved, "
          f"no VGG parameter moved")

    iters = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(st, *batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    print(f"DFPN train step: B={DFPN_TRAIN_B} frames_n={DFPN_TRAIN_F} {H}x{W} base {DFPN_BASE} bf16: "
          f"{1e3 * dt:.3f} ms/step, {DFPN_TRAIN_B / dt:.3f} samples/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {device_line}")
    synthetic = (dt, phase_profile(lambda *b: step(st, *b), batch, dt, grad=True)[0])

    # The loss items and the three frozen feature maps the step reads, with
    # the features on K8 against the same step's with the module's, on a
    # small input; the maps are read also with each of K8's planted faults
    # (the items barely move under them: they are a smoke test).
    small_dfpn = build_dfpn(base_size=64, dtype=torch.bfloat16, generator=gen(23))
    small = make_dfpn_batch(1, DFPN_TRAIN_F, 64, 64, SEED + 24)

    def small_step(pallas):
        """The loss items and the pool-4 maps (target, references, clean
        frames) of ``forward_and_loss`` on the small input."""
        seen = []

        def record(pool4):
            def run(*a):
                out = pool4(*a)
                seen.append(out.float())
                return out
            return run

        orig = dfpn_task.vgg_pool4_pallas
        dfpn_task.vgg_pool4_pallas, vgg.pool4 = record(orig), record(vgg.pool4)
        try:
            with torch.no_grad():
                items = dfpn_task.forward_and_loss(small_dfpn, vgg, *small, pallas_vgg=pallas)[1]
        finally:
            dfpn_task.vgg_pool4_pallas = orig
            del vgg.pool4
        return items, dict(zip(("feats_t", "feats_r", "feats_y"), seen))

    module, module_feats = small_step(False)
    items_rel = lambda k8: {k: abs(k8[k].item() - module[k].item()) / abs(module[k].item())
                            for k in module}
    k8, k8_feats = small_step(True)
    rel = items_rel(k8)
    print("check DFPN train items, 1x2x64x64 base 64, K8 features vs module features: relative "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()) + f" (limit {REL_K8_ITEMS:g})")
    if max(rel.values()) > REL_K8_ITEMS:
        raise RuntimeError("the loss with K8's features disagrees with the loss with the module's")
    name = "DFPN train features, 1x2x64x64 base 64, K8 vs module"
    check_groups(name, k8_feats, module_feats, L2_K8_MAPS)
    for ctx, fault, label in ([(planted_stack, f, lb) for f, lb in STACK_FAULTS.items()]
                              + [(planted_frame, f, lb) for f, lb in FRAME_FAULTS.items()]):
        with ctx(fault):
            k8, k8_feats = small_step(True)
        rel = items_rel(k8)
        worst = max(rel, key=rel.get)
        print(f"planted DFPN train items, {label}: worst relative {rel[worst]:.6g} ({worst})")
        check_groups(name, k8_feats, module_feats, L2_K8_MAPS, planted=label)

    # The loop: 2 epochs of 3 steps with k = 2 (epoch 1's checkpoint holds
    # an open window), a validation an epoch; then epoch 2 again from that
    # checkpoint into a fresh state.
    have_tbx = importlib.util.find_spec("tensorboardX") is not None
    if not have_tbx:
        print("tensorboardX is not installed here: the Trainer logs to chip_smoke's MemoryLogger")
    loader = [make_dfpn_batch(DFPN_TRAIN_B, DFPN_TRAIN_F, H, W, SEED + 30 + i) for i in range(3)]
    val_loader = [make_dfpn_batch(DFPN_TRAIN_B, DFPN_TRAIN_F, H, W, SEED + 33)]
    args = lambda b: b

    def fit(root, epochs, st, saves=None):
        model = st.model
        trainer = Trainer(LoopConfig(max_epochs=epochs, default_root_dir=root), "dfpn",
                          logger=None if have_tbx else MemoryLogger())
        if saves is not None:
            save = trainer.checkpointer.save

            def timed_save(step, payload):
                save(step, payload)
                torch.cuda.synchronize()
                saves.append(time.perf_counter())

            trainer.checkpointer.save = timed_save
        trainer.fit(st, dfpn_task.make_train_step(model, vgg, pallas_vgg=True), args, loader,
                    eval_step=dfpn_task.make_eval_step(model, vgg, pallas_vgg=True),
                    eval_args=args, val_loader=val_loader)
        return trainer

    def fresh_state():
        model = build_dfpn(base_size=DFPN_BASE, dtype=torch.bfloat16, generator=gen(25))
        return state.create_train_state(
            model, state.OptimConfig(accumulate_grad_batches=2), steps_per_epoch=len(loader))

    with tempfile.TemporaryDirectory() as root:
        full = fresh_state()
        saves = [time.perf_counter()]
        trainer = fit(f"{root}/full", 2, full, saves)
        epochs = [b - a for a, b in zip(saves, saves[1:])]
        ckpts = sorted(os.listdir(trainer.checkpointer.dir))
        print(f"DFPN loop: 2 epochs of 3 steps, accumulate_grad_batches=2, a validation and a "
              f"checkpoint an epoch: {', '.join(f'{e:.3f}' for e in epochs)} s an epoch; checkpoints "
              f"{ckpts}; counts step {full.step} updates {full.updates}")
        if ckpts != ["step_3.pt", "step_6.pt"] or (full.step, full.updates, full.micro) != (6, 3, 0):
            raise RuntimeError("the DFPN loop did not run 2 epochs of 3 steps with 2 checkpoints")
        runs = {}
        for label, drop in (("resumed", False), ("resumed again", False),
                            ("resumed, the open window's grads dropped", True)):
            st2 = restore_train_state(fresh_state(), f"{trainer.checkpointer.dir}/step_3.pt")
            if (st2.step, st2.updates, st2.micro) != (3, 1, 1):
                raise RuntimeError(f"restored counts {(st2.step, st2.updates, st2.micro)}, not (3, 1, 1)")
            if drop:
                for p in st2.params():
                    p.grad = None
            fit(f"{root}/{len(runs)}", 2, st2)
            runs[label] = st2
        reads = {label: rel_l2_groups(st2, full) for label, st2 in runs.items()}
        floor = rel_l2_groups(runs["resumed again"], runs["resumed"])
        limits = {"params": L2_RESUME_PARAMS, "exp_avg": L2_RESUME_MOMENTS,
                  "exp_avg_sq": L2_RESUME_MOMENTS}
        for label, read in [*reads.items(), ("resumed again, against the first resumed run", floor)]:
            against = "" if "against" in label else " against the uninterrupted run"
            print(f"check DFPN resume from epoch 1's checkpoint ({label}){against}: relative L2 "
                  + ", ".join(f"{k} {v:.3g} (limit {limits[k]:g})" for k, v in read.items()))
        if any(reads[r][k] > limits[k] for r in ("resumed", "resumed again") for k in limits):
            raise RuntimeError("the resumed DFPN run does not match the uninterrupted one")
        lost = reads["resumed, the open window's grads dropped"]
        if any(lost[k] <= limits[k] for k in limits):
            raise RuntimeError("the resume check does not see a lost accumulation window in "
                               "each of the parameters and the moments")
    print(f"phase DFPN training: {time.perf_counter() - t_phase:.1f} s")
    return synthetic


@contextlib.contextmanager
def planted_stack(fault):
    """Within: the conv-stack wrappers (K7, K8) launch the library built
    with ``-DSTACK_PLANT=fault`` (csrc/conv_stack.cu)."""
    from master_thesis_tpu_torch.ops import conv_stack

    orig = conv_stack._lib
    conv_stack._lib = lambda _=(): orig((f"-DSTACK_PLANT={fault}",))
    try:
        yield
    finally:
        conv_stack._lib = orig


@contextlib.contextmanager
def planted_wgmma(flag, fault):
    """Within: the one-conv ``wgmma`` kernels (csrc/conv_stack_wgmma.cu: K7's
    wide convs, K8's frame convs) launch the library built with
    ``-D<flag>=fault``: ``WIDE_PLANT`` plants in conv3x3_wide_wgmma.cuh,
    ``FRAME_PLANT`` in conv_frame_wgmma.cuh."""
    from master_thesis_tpu_torch.ops import conv_stack

    orig = conv_stack._wide_lib
    conv_stack._wide_lib = lambda _=(): orig((f"-D{flag}={fault}",))
    try:
        yield
    finally:
        conv_stack._wide_lib = orig


planted_wide = functools.partial(planted_wgmma, "WIDE_PLANT")
planted_frame = functools.partial(planted_wgmma, "FRAME_PLANT")


@contextlib.contextmanager
def plain_stacks():
    """Within: the conv-stack wrappers run their plain versions on card
    tensors."""
    from master_thesis_tpu_torch.ops import conv_stack

    names = ("conv_stack_tiles_cuda", "conv_stack_tiles_cl_cuda", "conv_stack_banded_cuda")
    orig = [getattr(conv_stack, n) for n in names]
    conv_stack.conv_stack_tiles_cuda = conv_stack.conv_stack_tiles_plain
    conv_stack.conv_stack_tiles_cl_cuda = conv_stack.conv_stack_tiles_cl_plain
    conv_stack.conv_stack_banded_cuda = conv_stack.conv_stack_banded_plain
    try:
        yield
    finally:
        for n, f in zip(names, orig):
            setattr(conv_stack, n, f)


@contextlib.contextmanager
def recorded_banded(outs):
    """Within: each call of ``conv_stack.conv_stack_banded`` (K8's entry, the
    kernel or, under :func:`plain_stacks`, its plain version) appends its
    output to ``outs``."""
    from master_thesis_tpu_torch.ops import conv_stack

    orig = conv_stack.conv_stack_banded

    def record(x, p):
        outs.append(orig(x, p))
        return outs[-1]

    conv_stack.conv_stack_banded = record
    try:
        yield
    finally:
        conv_stack.conv_stack_banded = orig


def module_stack(convs, relus, x):
    """The same stack as the module route: the convs' modules (cuDNN, the
    compute dtype) on NCHW ``x``."""
    for conv, relu in zip(convs, relus):
        x = conv(x)
        x = torch.relu(x) if relu else x
    return x


def stack_faults(p, side):
    """The planted faults K7's channels-last plan of stack ``p`` can show: the
    fused kernel's where it runs a group (the ReLU fault only where one of
    its groups has a ReLU conv), the wide kernel's where it runs a conv."""
    from master_thesis_tpu_torch.ops import conv_stack as cst

    groups = cst.plan_tiles(p, side, wide=True)
    fused = [g for g in groups if g.kernel == "fused"]
    relu = any(p.relus[i] for g in fused for i in range(g.lo, g.hi))
    faults = [(planted_stack, f, label) for f, label in STACK_FAULTS.items()
              if fused and (f != 2 or relu)]
    return faults + [(planted_wide, f, label) for f, label in WIDE_FAULTS.items()
                     if any(g.kernel == "wide" for g in groups)]


def check_stack(name, run, plain, x, p, faults=None):
    """Holds a conv-stack kernel against its plain version by relative L2
    and reads the check on each planted fault (``faults``: (context, n,
    label) triples; all of the fused kernel's by default). Returns (max abs
    error, the plain output)."""
    want = plain(x, p)
    got = run(x, p)
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: output shape {tuple(got.shape)}, plain {tuple(want.shape)}")
    err = check(name, got, want, None, L2_STACK, max_abs=False)
    if faults is None:
        faults = [(planted_stack, f, label) for f, label in STACK_FAULTS.items()]
    for ctx, fault, label in faults:
        with ctx(fault):
            check(f"{name}, {label}", run(x, p), want, None, L2_STACK, max_abs=False, planted=True)
    return err, want


def phase_kernels_stack(dfpn, results):
    """K7 against its plain version at the CHN+DFPN step's shapes (B=4, F=5:
    20 correlation tiles for the mixer, 5 120 per sep4d stage) and ragged
    ones; CUDA-event times of the kernel, the plain version and the module
    route."""
    from master_thesis_tpu_torch.models.dfpn import _convs
    from master_thesis_tpu_torch.ops import conv_stack as cst

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(bf)
    n, cs = DFPN_B * DFPN_F, DFPN_BASE // 16
    tiles_plain = lambda x, p: cst.conv_stack_tiles_plain(x, p, cs)

    # K7 as mixer_apply and sep4d_apply run it: channels-last, each wide 3x3
    # conv on the wide-conv kernel (the mixer's 3x3 256 -> 256, sep4d's
    # four); ragged tile counts; the first design (channel-major, fused
    # groups alone) on the mixer.
    cl = cst.conv_stack_tiles_cl_cuda
    cl_plain = cst.conv_stack_tiles_cl_plain
    mixer = dfpn.corr_mixer
    p_mix = mixer.packed()
    x_mix = rnd(n, cs * cs, cs * cs)
    x_mix_cl = x_mix.view(n, -1, cs, cs).contiguous(memory_format=torch.channels_last)
    # With these seeded weights the mixer's conv 10 is all zeros after its
    # ReLU, so nothing before it reaches the output: the stack's checks read
    # the fused kernel's faults (its last launch), and the wide conv (conv 1)
    # is held alone at the mixer's shape, read on the wide kernel's faults.
    f_mix = [f for f in stack_faults(p_mix, cs) if f[0] is planted_stack]
    check_stack(f"K7 mixer ({n}, {cs * cs}, {cs}, {cs}) channels-last", cl, cl_plain, x_mix_cl, p_mix,
                f_mix)
    check_stack("K7 mixer ragged (7 tiles)", cl, cl_plain,
                rnd(7, cs * cs, cs, cs).contiguous(memory_format=torch.channels_last), p_mix, f_mix)
    (wi,) = [g.lo for g in cst.plan_tiles(p_mix, cs, wide=True) if g.kernel == "wide"]
    p_mix_wide = cst.pack_stack([(p_mix.kernels[wi], p_mix.biases[wi])], [p_mix.relus[wi]], bf)
    check_stack(f"K7 mixer conv {wi} alone, wide conv ({n} tiles)", cl, cl_plain,
                rnd(n, cs * cs, cs, cs).contiguous(memory_format=torch.channels_last), p_mix_wide,
                stack_faults(p_mix_wide, cs))
    first = lambda x, p: cst.conv_stack_tiles_cuda(x, p, cs)
    check_stack(f"K7 first design, mixer ({n}, {cs * cs}, {cs * cs})", first, tiles_plain, x_mix, p_mix)
    sep = dfpn.corr.conv
    p1, p2 = sep.packed()
    nt = n * cs * cs
    x1 = rnd(nt, 1, cs, cs)  # one channel: channels-last and NCHW alike
    x2 = rnd(nt, 256, cs, cs).contiguous(memory_format=torch.channels_last)
    f1, f2 = stack_faults(p1, cs), stack_faults(p2, cs)
    check_stack(f"K7 sep4d stage 1 ({nt}, 1, {cs}, {cs})", cl, cl_plain, x1, p1, f1)
    swap_k = lambda x, p: cl(x, p, swap=True)
    check_stack(f"K7 sep4d stage 1, p <-> q swap in the epilogue ({nt} tiles)", swap_k,
                lambda x, p: cl_plain(x, p, swap=True), x1, p1, f1)
    err7, _ = check_stack(f"K7 sep4d stage 2 ({nt}, 256, {cs}, {cs}) channels-last", cl, cl_plain,
                          x2, p2, f2)
    check_stack("K7 sep4d stage 2 ragged (7 tiles)", cl, cl_plain,
                rnd(7, 256, cs, cs).contiguous(memory_format=torch.channels_last), p2, f2)
    # The first design on the same values: channel-major, fused groups alone.
    x1_cm, x2_cm = x1.reshape(nt, 1, cs * cs), x2.reshape(nt, 256, cs * cs).contiguous()

    def sep_k():
        cl(x1, p1)
        cl(x2, p2)

    def sep_first():
        cst.conv_stack_tiles_cuda(x1_cm, p1, cs)
        cst.conv_stack_tiles_cuda(x2_cm, p2, cs)

    def sep_plain():
        cl_plain(x1, p1)
        cl_plain(x2, p2)

    def sep_module():
        module_stack(*_convs(sep.conv_1), x1)
        module_stack(*_convs(sep.conv_2), x2_cm.view(nt, 256, cs, cs))

    flops7 = cst.stack_flops(p1, nt, cs, cs) + cst.stack_flops(p2, nt, cs, cs)
    b_ms, b_by = bound_ms(flops7, nbytes(x1, x2, x2, x1, p1.w, p1.b, p2.w, p2.b))
    k7_ms, first_ms = cuda_ms(sep_k, iters=10), cuda_ms(sep_first, iters=10)
    k7_ms2, first_ms2 = cuda_ms(sep_k, iters=10), cuda_ms(sep_first, iters=10)
    results["K7"] = dict(
        name="conv stack, whole 16x16 tiles (sep4d's two stages: the wide 3x3 convs on "
             "conv3x3_wide_wgmma, the thin ones on stack_kernel)", route="cuda",
        source="master_thesis_tpu_torch/csrc/conv_stack_wgmma.cu",
        replaces="master_thesis_tpu/ops/pallas_sep4d.py:192", max_abs_err=err7,
        ms=k7_ms, plain_ms=cuda_ms(sep_plain, iters=3, warmup=1), bound_ms=b_ms, bound_by=b_by,
        library_ms=None, module_ms=cuda_ms(sep_module, iters=10), first_ms=first_ms,
    )
    print(f"kernel K7 on sep4d's two stages: new design {k7_ms:.4f} / {k7_ms2:.4f} ms, first design "
          f"(fused groups, channel-major) {first_ms:.4f} / {first_ms2:.4f} ms on the same values")
    if k7_ms >= first_ms or k7_ms2 >= first_ms2:
        raise RuntimeError("K7's new design is not faster than its first design on sep4d")
    # Each wide conv alone against its floor, at its widths.
    for si, (stage, pk) in enumerate(((1, p1), (1, p1), (2, p2), (2, p2))):
        i = (1, 2, 0, 1)[si]
        _, ci, co = pk.specs[i]
        one = cst.pack_stack([(pk.kernels[i], pk.biases[i])], [pk.relus[i]], bf)
        xi = rnd(nt, ci, cs, cs).contiguous(memory_format=torch.channels_last)
        t = cuda_ms(lambda: cst.conv3x3_wide_cuda(xi, one, 0), iters=10)
        f_ms, f_by = bound_ms(cst.stack_flops(one, nt, cs, cs),
                              nbytes(xi, one.wide[0]) + xi.numel() // ci * co * 2)
        print(f"kernel K7 wide conv, sep4d stage {stage} conv {i} {ci}->{co} ({nt} tiles): "
              f"{t:.4f} ms, floor {f_ms:.4f} ms ({f_by}), {100 * f_ms / t:.1f}% of it")
    # Stage 1 as sep4d_apply runs it: the p <-> q swap in the epilogue, or one
    # permute after it.
    swap_ms = {True: [], False: []}
    for in_kernel in (True, False, True, False):
        run = (lambda: cl(x1, p1, swap=True)) if in_kernel else (lambda: cst.swap_tiles(cl(x1, p1)))
        swap_ms[in_kernel].append(cuda_ms(run, iters=10))
    print(f"sep4d stage 1 ({nt} tiles): p <-> q swap in the epilogue "
          f"{' / '.join(f'{t:.4f}' for t in swap_ms[True])} ms, one permute after it "
          f"{' / '.join(f'{t:.4f}' for t in swap_ms[False])} ms")
    # The mixer: the kernels alone on channels-last tiles, mixer_apply
    # (which also copies the volume into channels-last), and the first
    # design on channel-major tiles (the whole of the former mixer_apply).
    mix_b, _ = bound_ms(cst.stack_flops(p_mix, n, cs, cs), nbytes(x_mix, p_mix.w))
    corr_mix = x_mix.view(DFPN_B, DFPN_F, cs, cs, cs, cs)
    mix_ms = cuda_ms(lambda: cl(x_mix_cl, p_mix))
    mix_apply = cuda_ms(lambda: cst.mixer_apply(p_mix, corr_mix, cs, bf))
    mix_first = cuda_ms(lambda: first(x_mix, p_mix))
    results["K7"]["mixer_ms"] = mix_ms
    print(f"kernel K7 on the mixer ({n} tiles): kernel_ms={mix_ms:.4f} (mixer_apply "
          f"{mix_apply:.4f}; first design {mix_first:.4f}) "
          f"plain_ms={cuda_ms(lambda: tiles_plain(x_mix, p_mix)):.4f} "
          f"module_ms={cuda_ms(lambda: module_stack(*_convs(mixer.mixer), x_mix.view(n, -1, cs, cs))):.4f} "
          f"bound_ms={mix_b:.4f}")

    r = results["K7"]
    print(f"kernel K7 {r['name']}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"module_ms={r['module_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
          f"library_ms=null")


def band_faults(p, h, w):
    """The planted faults K8's plan of stack ``p`` over ``h x w`` frames can
    show: the fused kernel's where it runs a group (the ReLU fault only where
    one of its groups has a ReLU conv), the frame kernel's where it runs a
    conv (the halo-row fault only where a frame conv's tiles leave a tile
    boundary inside the frame)."""
    from master_thesis_tpu_torch.ops import conv_stack as cst

    groups = cst.plan_banded(p, h, w)
    fused = [g for g in groups if g.kernel == "fused"]
    frames = [g for g in groups if g.kernel == "frame"]
    relu = any(p.relus[i] for g in fused for i in range(g.lo, g.hi))
    faults = [(planted_stack, f, label) for f, label in STACK_FAULTS.items()
              if fused and (f != 2 or relu)]
    return faults + [(planted_frame, f, label) for f, label in FRAME_FAULTS.items()
                     if frames and (f != 3 or any(g.th < h for g in frames))]


def k8_callers(dfpn, vgg, rnd, dtype=torch.bfloat16):
    """K8's three callers in the CHN+DFPN step as ``{caller: [(name, packed
    stack, conv modules, relus, NHWC input), ...]}`` on seeded inputs:
    flow_256's and flow_64's 7 segments (20 frames at base 256: 256 .. 32 and
    64 .. 8), and VGG's pool-4 tower (its 4 blocks at 256 .. 32) over the 4
    target and 20 reference frames of its two calls."""
    from master_thesis_tpu_torch.models.dfpn import _FLOW_SEGMENTS
    from master_thesis_tpu_torch.models.vgg import _POOL4_BLOCKS

    bf, n = dtype, DFPN_B * DFPN_F
    callers = {}
    for label, est, base in (("flow_256", dfpn.flow_256, DFPN_BASE), ("flow_64", dfpn.flow_64, DFPN_BASE // 4)):
        items = []
        for (names, _), hw in zip(_FLOW_SEGMENTS, [base >> i for i in (0, 1, 2, 3, 2, 1, 0)]):
            convs = [est.layer(nm) for nm in names]
            relus = [nm != "c17" for nm in names]
            p = est.stacks.get(names, convs, relus, bf)
            items.append(("-".join(names), p, convs, relus, rnd(n, hw, hw, p.specs[0][1])))
        callers[label] = items
    items = []
    for frames in (DFPN_B, n):
        for i, block in enumerate(_POOL4_BLOCKS):
            convs = [vgg.features[j] for j in block]
            p = vgg.stacks.get(f"block{i + 1}", convs, [True] * len(convs), bf)
            hw = DFPN_BASE >> i
            items.append((f"block{i + 1} x{frames}", p, convs, [True] * len(convs),
                           rnd(frames, hw, hw, p.specs[0][1])))
    callers["VGG pool-4"] = items
    return callers


def phase_kernels_band(dfpn, vgg, results):
    """K8 against its plain version: flow_256's first and last segments, VGG's
    block 1, a ragged frame, each read on the faults of the kernels its plan
    runs; on its three callers (flow_256, flow_64, VGG pool-4) beside its
    first design (fused groups alone) on the same values, fatal unless
    faster, with the plain version, the module route and the bound; each
    frame conv alone at its main-path shape against its plain version, then
    timed against its floor and one cuDNN ``F.conv2d``."""
    import torch.nn.functional as F

    from master_thesis_tpu_torch.ops import conv_stack as cst

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(bf)
    band = cst.conv_stack_banded_cuda
    band_plain = cst.conv_stack_banded_plain
    first = cst.conv_stack_banded_first_cuda
    callers = k8_callers(dfpn, vgg, rnd)
    flow, vgg_items = callers["flow_256"], callers["VGG pool-4"]

    def check_band(name, x, p):
        return check_stack(f"K8 {name} {tuple(x.shape)}", band, band_plain, x, p,
                           band_faults(p, x.shape[1], x.shape[2]))

    check_band("flow_256 c0-c1", flow[0][4], flow[0][1])
    err8, _ = check_band("flow_256 c15-c17", flow[-1][4], flow[-1][1])
    check_band("flow c15-c17 ragged", rnd(2, 60, 120, 128), flow[-1][1])
    _, p_vgg, _, _, x_vgg = vgg_items[0]
    check_band("VGG block 1", x_vgg, p_vgg)
    check_stack(f"K8 first design, flow_256 c15-c17 {tuple(flow[-1][4].shape)}", first, band_plain,
                flow[-1][4], flow[-1][1])

    # Each caller: the new route and the first design in turns, the plain
    # version and the module route.
    for label, items in callers.items():
        run = lambda fn, items=items: [fn(x, p) for _, p, _, _, x in items]
        module = lambda items=items: [module_stack(c, r, x.permute(0, 3, 1, 2)) for _, _, c, r, x in items]
        flops = sum(cst.stack_flops(p, x.shape[0], x.shape[1], x.shape[2]) for _, p, _, _, x in items)
        moved = sum(nbytes(x, p.w, p.b) + x.numel() // x.shape[3] * p.specs[-1][2] * x.element_size()
                    for _, p, _, _, x in items)
        b_ms, b_by = bound_ms(flops, moved)
        k_ms, f_ms = [], []
        for _ in range(2):
            k_ms.append(cuda_ms(lambda: run(band), iters=10))
            f_ms.append(cuda_ms(lambda: run(first), iters=10))
        p_ms, m_ms = cuda_ms(lambda: run(band_plain), iters=3, warmup=1), cuda_ms(module, iters=10)
        launches = sum(len(cst.plan_banded(p, x.shape[1], x.shape[2])) for _, p, _, _, x in items)
        frames = sum(len([g for g in cst.plan_banded(p, x.shape[1], x.shape[2]) if g.kernel == "frame"])
                     for _, p, _, _, x in items)
        print(f"kernel K8 on {label}: new route {k_ms[0]:.4f} / {k_ms[1]:.4f} ms ({launches} launches, "
              f"{frames} on the frame kernel), first design (fused groups) {f_ms[0]:.4f} / "
              f"{f_ms[1]:.4f} ms on the same values; plain_ms={p_ms:.4f} module_ms={m_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})")
        if k_ms[0] >= f_ms[0] or k_ms[1] >= f_ms[1]:
            raise RuntimeError(f"K8's new route is not faster than its first design on {label}")
        if label == "flow_256":
            results["K8"] = dict(
                name="conv stack over whole NHWC frames (flow_256's 7 segments: the 3x3 / 5x5 "
                     "128-channel convs on conv_frame_wgmma, c0 and c17 on stack_kernel)",
                route="cuda", source="master_thesis_tpu_torch/csrc/conv_stack_wgmma.cu",
                sources=["master_thesis_tpu_torch/csrc/conv_stack_wgmma.cu",
                         "master_thesis_tpu_torch/csrc/conv_stack.cu"],
                replaces="master_thesis_tpu/ops/pallas_sep4d.py:316", max_abs_err=err8,
                ms=k_ms[0], plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                module_ms=m_ms, first_ms=f_ms[0],
            )
        else:
            results["K8"][f"{label}_ms"] = k_ms[0]

    # Each frame conv alone at its main-path shape: held against its plain
    # version, then timed against its floor beside one cuDNN conv (bf16,
    # channels-last) of the same conv, a yardstick the port never calls.
    for label, items in callers.items():
        for name, p, _, _, x in items:
            n, h, w, _ = x.shape
            for g in cst.plan_banded(p, h, w):
                if g.kernel != "frame":
                    continue
                k, ci, co = p.specs[g.lo]
                one = cst.pack_stack([(p.kernels[g.lo], p.biases[g.lo])], [p.relus[g.lo]], bf)
                xi = rnd(n, h, w, ci)
                check(f"K8 frame conv, {label} {name} conv {g.lo} {k}x{k} {ci}->{co} at {n}x{h}x{w}",
                      cst.conv_frame_cuda(xi, one, 0), cst.conv_stack_banded_plain(xi, one), None,
                      L2_STACK, max_abs=False)
                t = cuda_ms(lambda: cst.conv_frame_cuda(xi, one, 0))
                f_ms, f_by = bound_ms(cst.stack_flops(one, n, h, w),
                                      nbytes(xi, one.wide[0]) + xi.numel() // ci * co * 2)
                xc, wk, bb = xi.permute(0, 3, 1, 2), channels_last(one.kernels[0]), one.biases[0].to(bf)
                lib = cuda_ms(lambda: F.conv2d(xc, wk, bb, padding=k // 2))
                print(f"kernel K8 frame conv, {label} {name} conv {g.lo} {k}x{k} {ci}->{co} at "
                      f"{n}x{h}x{w}: {t:.4f} ms, floor {f_ms:.4f} ms ({f_by}), {100 * f_ms / t:.1f}% "
                      f"of it; cuDNN F.conv2d {lib:.4f} ms")
    r = results["K8"]
    print(f"kernel K8 {r['name']}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"module_ms={r['module_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
          f"first_design_ms={r['first_ms']:.4f} library_ms=null")


EVERY_KERNEL = dict(pallas_sep4d=True, pallas_mixer=True, pallas_flow=True)


def phase_hybrid_routes(dfpn, vgg, results):
    """K8 on the default hybrid route at the CHN+DFPN step's shapes (20
    frames): flow_256's c0 alone at 256x256 and its mid segments c6-c7,
    c9-c10, c11-c12 at 64 / 32 / 64, flow_64's c0 at 64x64; each held against
    its plain version and read on the faults of the kernels its plan runs;
    their CUDA-event time beside the plain version, the module route and the
    bound; each c0 launch beside its floor and one cuDNN ``F.conv2d``. Then
    both flow estimators on each route (modules, every kernel, the four
    hybrid ones) and VGG's pool-4 tower (module, K8, ``vgg_pool4_hybrid``),
    each hybrid output held against the module route's by relative L2, and
    CUDA-event times in two rounds."""
    import torch.nn.functional as F

    from master_thesis_tpu_torch.models.dfpn import (
        flow_estimator_apply_hybrid,
        flow_estimator_apply_pallas,
    )
    from master_thesis_tpu_torch.models.vgg import vgg_pool4_hybrid, vgg_pool4_pallas
    from master_thesis_tpu_torch.ops import conv_stack as cst

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf, n = torch.bfloat16, DFPN_B * DFPN_F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(bf)
    band, band_plain = cst.conv_stack_banded_cuda, cst.conv_stack_banded_plain

    items = []
    for label, est, base, segs in (
            ("flow_256", dfpn.flow_256, DFPN_BASE, ((("c0",), 0), (("c6", "c7"), 2), (("c9", "c10"), 3),
                                                    (("c11", "c12"), 2))),
            ("flow_64", dfpn.flow_64, DFPN_BASE // 4, ((("c0",), 0),))):
        for names, down in segs:
            convs = [est.layer(nm) for nm in names]
            p = est.stacks.get(names, convs, [True] * len(convs), bf)
            hw = base >> down
            items.append((f"{label} {'-'.join(names)}", p, convs, rnd(n, hw, hw, p.specs[0][1])))
    for name, p, _, x in items:
        check_stack(f"K8 hybrid {name} {tuple(x.shape)}", band, band_plain, x, p,
                    band_faults(p, x.shape[1], x.shape[2]))
    plans = [cst.plan_banded(p, x.shape[1], x.shape[2]) for _, p, _, x in items]
    launches, frames = sum(map(len, plans)), sum(g.kernel == "frame" for pl in plans for g in pl)
    run = lambda fn: [fn(x, p) for _, p, _, x in items]
    module = lambda: [module_stack(c, [True] * len(c), x.permute(0, 3, 1, 2)) for _, _, c, x in items]
    flops = sum(cst.stack_flops(p, *x.shape[:3]) for _, p, _, x in items)
    moved = sum(nbytes(x, p.w, p.b) + x.numel() // x.shape[3] * p.specs[-1][2] * x.element_size()
                for _, p, _, x in items)
    b_ms, b_by = bound_ms(flops, moved)
    k_ms = [cuda_ms(lambda: run(band), iters=10) for _ in range(2)]
    p_ms, m_ms = cuda_ms(lambda: run(band_plain), iters=3, warmup=1), cuda_ms(module, iters=10)
    results["K8"].update(hybrid_ms=k_ms[0], hybrid_plain_ms=p_ms, hybrid_module_ms=m_ms,
                         hybrid_bound_ms=b_ms)
    print(f"kernel K8 on the hybrid route (flow_256 c0, c6-c7, c9-c10, c11-c12; flow_64 c0; {n} "
          f"frames): kernel_ms={k_ms[0]:.4f} / {k_ms[1]:.4f} ({launches} launches, {frames} on the "
          f"frame kernel) plain_ms={p_ms:.4f} module_ms={m_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    for name, p, _, x in items:
        if len(p.specs) != 1:
            continue
        k, ci, co = p.specs[0]
        t = cuda_ms(lambda: band(x, p))
        f_ms, f_by = bound_ms(cst.stack_flops(p, *x.shape[:3]),
                              nbytes(x, p.w, p.b) + x.numel() // ci * co * x.element_size())
        xc, wk, bb = x.permute(0, 3, 1, 2), channels_last(p.kernels[0]), p.biases[0].to(bf)
        lib = cuda_ms(lambda: F.conv2d(xc, wk, bb, padding=k // 2))
        print(f"kernel K8 hybrid c0, {name} {k}x{k} {ci}->{co} at {tuple(x.shape[:3])}: {t:.4f} ms "
              f"(fused kernel), floor {f_ms:.4f} ms ({f_by}), {100 * f_ms / t:.1f}% of it; cuDNN "
              f"F.conv2d {lib:.4f} ms")

    # Whole estimators on every route, on seeded frames of the step's shapes.
    for label, est, size in (("flow_256", dfpn.flow_256, DFPN_BASE), ("flow_64", dfpn.flow_64, DFPN_BASE // 4)):
        x_t, m_t, x_r, m_r = make_inputs(DFPN_B, DFPN_F, size, size, SEED + 20)
        ins = (x_t, m_t, x_r, m_r, 0.1 * torch.randn(*x_r.shape[:4], 2, generator=gen, device="cuda"))
        routes = {"modules": lambda: est(*ins), "every kernel": lambda: flow_estimator_apply_pallas(est, *ins)}
        for route, flags, _ in HYBRID_ROUTES[:4]:
            kw = dict(fuse_mids=flags.get("hybrid_fuse_mids", True),
                      c0_mode=flags.get("hybrid_c0_mode", "pallas"))
            routes[route] = functools.partial(flow_estimator_apply_hybrid, est, *ins, **kw)
        want = routes["modules"]()
        times = {r: [] for r in routes}
        for _ in range(2):
            for r, fn in routes.items():
                times[r].append(cuda_ms(fn, iters=10))
        for r, fn in routes.items():
            got = fn()
            err = rel_l2(got, want)
            ok = bool(torch.isfinite(got).all()) and err <= L2_DFPN
            print(f"{label} estimator ({DFPN_B}x{DFPN_F}x{size}x{size}), {r}: "
                  f"{' / '.join(f'{t:.4f}' for t in times[r])} ms; rel_l2 to the module route "
                  f"{err:.6g} (limit {L2_DFPN:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"the {label} estimator on {r} disagrees with its module route")

    # VGG's pool-4 tower over the step's 4 + 20 frames on its three routes.
    x = make_inputs(1, DFPN_B + DFPN_F * DFPN_B, DFPN_BASE, DFPN_BASE, SEED + 21)[2][0]
    towers = {"module": lambda: vgg.pool4(x), "K8": lambda: vgg_pool4_pallas(vgg, x),
              "vgg_pool4_hybrid": lambda: vgg_pool4_hybrid(vgg, x)}
    want = towers["module"]()
    times = {r: [cuda_ms(fn, iters=10)] for r, fn in towers.items()}
    for r, fn in towers.items():
        times[r].append(cuda_ms(fn, iters=10))
        err = rel_l2(fn(), want)
        print(f"VGG pool-4 ({x.shape[0]}x{DFPN_BASE}x{DFPN_BASE}), {r}: "
              f"{' / '.join(f'{t:.4f}' for t in times[r])} ms; rel_l2 to the module {err:.6g} "
              f"(limit {L2_DFPN:g}) {'ok' if err <= L2_DFPN else 'FAIL'}")
        if err > L2_DFPN:
            raise RuntimeError(f"VGG pool-4 on {r} disagrees with its module")


def phase_cpn_context(device_line):
    """CPN's context modules (``CPNContext``: Encoder, ``cm_module``,
    Decoder), which no path calls, once at 1 x (1 + 4) x 256x256 in f32 on
    the card (cuDNN, TF32 off) against the same modules on the CPU."""
    from master_thesis_tpu_torch.models.cpn import CPNContext

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x_t, m_t, x_r, m_r = make_inputs(1, 4, 256, 256, SEED + 22)
    ins = (x_t, m_t, x_r, 1 - m_r)
    outs = {}
    for dev in ("cuda", "cpu"):
        ctx = CPNContext(device=dev, generator=torch.Generator().manual_seed(SEED + 23)).eval()
        with torch.inference_mode():
            outs[dev] = [o.cpu() for o in ctx(*(t.to(dev) for t in ins))]
    (frame, c_mask), (frame_c, c_mask_c) = outs["cuda"], outs["cpu"]
    # c_mask is 1 less a sum of softmax weights: ~0 (f32 rounding) wherever a
    # reference is visible, so it is held by its largest difference.
    err, mask_err = rel_l2(frame, frame_c), (c_mask - c_mask_c).abs().max().item()
    ok = (frame.shape == (1, 256, 256, 3) and c_mask.shape == (1, 64, 64, 1) and err <= 1e-4
          and mask_err <= 1e-5)
    print(f"check CPN context (Encoder, cm_module, Decoder) 1x(1+4)x256x256 f32, card vs CPU: "
          f"frame rel_l2 {err:.3g} (limit 1e-4), c_mask max|diff| {mask_err:.3g} (limit 1e-5, "
          f"max|c_mask| {c_mask_c.abs().max().item():.3g}) {'ok' if ok else 'FAIL'} on {device_line}")
    if not ok:
        raise RuntimeError("CPN's context modules on the card disagree with the CPU")


def dfpn_outputs(dfpn, vgg, x_t, m_t, x_r, m_r, pool4=None, routes=EVERY_KERNEL):
    """VGG pool-4 features (on K8 unless ``pool4`` is given) and
    ``dfpn_infer_apply`` on ``routes`` (every kernel route by default), as
    named groups (for the small-input checks)."""
    from master_thesis_tpu_torch.models.dfpn import dfpn_infer_apply, prepare_vgg_input
    from master_thesis_tpu_torch.models.vgg import vgg_pool4_pallas

    pool4 = pool4 or functools.partial(vgg_pool4_pallas, vgg)
    b, f, h, w, _ = x_r.shape
    base = dfpn.base_size
    feats_t = pool4(prepare_vgg_input(x_t, size=base))
    feats_r = pool4(prepare_vgg_input(x_r.reshape(b * f, h, w, 3), size=base))
    feats_r = feats_r.reshape(b, f, *feats_r.shape[1:])
    outs = dfpn_infer_apply(dfpn, x_t, m_t, x_r, m_r, feats_t, feats_r, **routes)
    return dict(zip(("feats_t", "feats_r", "corr", "flow_16", "flow_64", "flow_full"),
                    (feats_t, feats_r, *outs)))


def phase_dfpn_path(chn, dfpn, vgg, results, device_line):
    """The CHN+DFPN step at B=4, F=5, 256x256, nb=20, bf16, with the default
    routes, with every kernel route and on each hybrid route."""
    from master_thesis_tpu_torch.models.chn import chn_infer_apply
    from master_thesis_tpu_torch.models.vgg import VGGFeatures
    from master_thesis_tpu_torch.ops import conv_stack, rrdb, tail
    from master_thesis_tpu_torch.train.build import build_dfpn, dfpn_align_fn

    chn.eval()
    inputs = make_inputs(DFPN_B, DFPN_F, H, W, SEED + 12)
    x_t, m_t = inputs[0], inputs[1]
    counters = {"K1": rrdb.rdb_cuda, "K4": tail.tail_cuda, "K7": conv_stack.conv_stack_tiles_cuda,
                "K7 wide": conv_stack.conv3x3_wide_cuda, "K8": conv_stack.conv_stack_banded_cuda,
                "K8 frame": conv_stack.conv_frame_cuda}
    routes = {
        # K7: 5 launches on the mixer and 3 + 3 on sep4d's stages, of which
        # the mixer's 3x3 256 -> 256 and sep4d's four wide convs on the
        # wide-conv kernel; K8: 15 on flow_256, 15 on flow_64, 10 on each of
        # the two VGG pool-4 calls, of which 13 + 13 + 9 + 9 on the frame
        # kernel (all but c0, c17 and VGG's 3 -> 64;
        # tests/test_torch_conv_stack.py holds the plans to these).
        "default routes": (dict(), {"K1": NB * 3, "K4": tail.TAIL_KERNELS, "K7": 5, "K7 wide": 1,
                                    "K8": 0, "K8 frame": 0}),
        "every kernel route": (dict(pallas_sep4d=True, pallas_flow=True, pallas_vgg=True),
                               {"K1": NB * 3, "K4": tail.TAIL_KERNELS, "K7": 11, "K7 wide": 5,
                                "K8": 50, "K8 frame": 44}),
        # The hybrid routes: the mixer on K7 as by default, K8 as HYBRID_ROUTES says.
        **{label: (flags, {"K1": NB * 3, "K4": tail.TAIL_KERNELS, "K7": 5, "K7 wide": 1, "K8": k8,
                           "K8 frame": k8_frame})
           for label, flags, (k8, k8_frame) in HYBRID_ROUTES},
    }
    for label, (flags, want) in routes.items():
        align = dfpn_align_fn(dfpn, vgg, **flags)

        def step(x_t, m_t, x_r, m_r):
            xa, va, vm = align(x_t, m_t, x_r, m_r)
            return chn_infer_apply(chn, x_t, 1 - m_t, xa, va, vm), (xa, va, vm)

        with torch.inference_mode():
            for _ in range(2):
                step(*inputs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            (y_hat, y_comp), (xa, va, vm) = step(*inputs)
            torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated()
        print(f"CHN+DFPN step, {label}: launches in one step {counts} (expected {want})")
        if counts != want:
            raise RuntimeError(f"the CHN+DFPN step ({label}) did not launch each kernel as expected")
        if label == "every kernel route":
            results["K7"]["launches"], results["K8"]["launches"] = counts["K7"], counts["K8"]
        elif label == HYBRID_ROUTES[0][0]:
            results["K8"]["launches_hybrid"] = counts["K8"]
        shape = (DFPN_B, DFPN_F, H, W)
        if y_hat.shape != (*shape, 3) or y_comp.shape != (*shape, 3) or va.shape != (*shape, 1):
            raise RuntimeError(f"output shapes {tuple(y_hat.shape)}, {tuple(y_comp.shape)}, {tuple(va.shape)}")
        if not all(torch.isfinite(t).all() for t in (y_hat, y_comp, xa, va, vm)):
            raise RuntimeError("a CHN+DFPN output is not finite")
        if y_hat.min() < 0 or y_hat.max() > 1:
            raise RuntimeError("y_hat is not in [0, 1]")
        visible = (1 - m_t)[:, None].expand(*shape, 3) == 1
        if not torch.equal(y_comp[visible], x_t[:, None].expand(*shape, 3)[visible]):
            raise RuntimeError("y_hat_comp differs from x_t where the target is visible")
        if not all(bool(((t == 0) | (t == 1)).all()) for t in (va, vm)):
            raise RuntimeError("v_aligned or v_map is not binary")
        print(f"CHN+DFPN step, {label}: outputs finite, y_hat in [{y_hat.min().item():.4f}, "
              f"{y_hat.max().item():.4f}], y_hat_comp == x_t on visible pixels, v_aligned and v_map "
              f"in {{0, 1}} (visible share {va.mean().item():.4f})")

        iters = 20
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                step(*inputs)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            t0 = time.perf_counter()
            for _ in range(iters):
                align(*inputs)
            torch.cuda.synchronize()
            da = (time.perf_counter() - t0) / iters
        print(f"CHN+DFPN step, {label}: B={DFPN_B} F={DFPN_F} {H}x{W} nb={NB} bf16: "
              f"{1e3 * dt:.3f} ms/step, {DFPN_B / dt:.3f} inpainted frames/s; DFPN align alone "
              f"{1e3 * da:.3f} ms; max_memory_allocated {peak / 2**30:.3f} GiB on {device_line}")
        phase_profile(step, inputs, dt)

    # A small input through the kernels against the same DFPN through their
    # plain versions on the card, read also with a planted fault.
    small_dfpn = build_dfpn(base_size=64, dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(SEED + 13))
    small_vgg = VGGFeatures(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED + 14))
    small = make_inputs(1, 2, 64, 64, SEED + 15)
    run = lambda: dfpn_outputs(small_dfpn, small_vgg, *small)
    with torch.inference_mode():
        with plain_stacks():
            want = run()
        check_groups("CHN+DFPN DFPN outputs, 1x2x64x64 base 64, kernels vs plain versions", run(),
                     want, L2_DFPN)
        for ctx, fault, label in ([(planted_stack, f, lb) for f, lb in STACK_FAULTS.items()]
                                  + [(planted_frame, f, lb) for f, lb in FRAME_FAULTS.items()]):
            with ctx(fault):
                check_groups("CHN+DFPN DFPN outputs", run(), want, L2_DFPN, planted=label)
    # The same on the default hybrid route at 1x2x128x128, base 128, where it
    # calls K8 on flow_256's c0 (fused kernel) and c6-c7, c11-c12 at 32x32
    # (frame kernel) and on flow_64's c0 at 32x32; VGG and the mixer through
    # their modules, so each fault reaches the outputs through K8 alone. The
    # groups are the DFPN outputs and each K8 call's output: at random
    # weights the flows barely see c0 (a corner tap left out of it moves
    # flow_64 by 5e-5 relative), so the calls' outputs carry the check.
    hyb_dfpn = build_dfpn(base_size=128, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(SEED + 18))
    small_h = make_inputs(1, 2, 128, 128, SEED + 19)

    def run():
        outs = []
        with recorded_banded(outs):
            groups = dfpn_outputs(hyb_dfpn, small_vgg, *small_h, pool4=small_vgg.pool4,
                                  routes=dict(pallas_mixer=False, hybrid_flow=True))
        return {**groups, **{f"K8 call {i}": y for i, y in enumerate(outs)}}

    with torch.inference_mode():
        with plain_stacks():
            want = run()
        for c in counters.values():
            c.launches = 0
        got = run()
        torch.cuda.synchronize()
        counts = {k: counters[k].launches for k in ("K7", "K8", "K8 frame")}
        if counts != {"K7": 0, "K8": 6, "K8 frame": 4}:
            raise RuntimeError(f"the small hybrid check launched {counts}")
        check_groups("CHN+DFPN DFPN outputs and K8 calls, hybrid route, 1x2x128x128 base 128, "
                     "kernels vs plain versions", got, want, L2_DFPN)
        for ctx, fault, label in ([(planted_stack, f, lb) for f, lb in STACK_FAULTS.items()]
                                  + [(planted_frame, f, lb) for f, lb in FRAME_FAULTS.items()]):
            with ctx(fault):
                check_groups("CHN+DFPN DFPN outputs and K8 calls, hybrid route", run(), want, L2_DFPN,
                             planted=label)


@contextlib.contextmanager
def planted_band():
    """Within: the RDB and tail wrappers launch the libraries built with
    ``-DBAND_PLANT=1`` (csrc/conv3x3_wgmma.cuh, csrc/tail_wgmma.cuh): a
    band's first tile row loses the halo row above the band (for K5, above
    conv_last's rows). Full-frame launches (K1, K4) start at row 0 and are
    not touched."""
    from master_thesis_tpu_torch.ops import rrdb, tail

    orig = rrdb._rdb_lib, tail._tail_lib
    rrdb._rdb_lib = lambda _=(): orig[0](("-DBAND_PLANT=1",))
    tail._tail_lib = lambda _=(): orig[1](("-DBAND_PLANT=1",))
    try:
        yield
    finally:
        rrdb._rdb_lib, tail._tail_lib = orig


@contextlib.contextmanager
def plain_kernels():
    """Within: the trunk's and the tail's CUDA wrappers (K1, K2, K4, K5) run
    their plain versions on card tensors."""
    from master_thesis_tpu_torch.ops import rrdb, tail

    orig = rrdb.rdb_cuda, rrdb.rdb_banded_cuda, tail.tail_cuda, tail.tail_banded_cuda
    rrdb.rdb_cuda, rrdb.rdb_banded_cuda = rrdb.rdb_plain, rrdb.rdb_banded_plain
    tail.tail_cuda, tail.tail_banded_cuda = tail.tail_plain, tail.tail_banded_plain
    try:
        yield
    finally:
        rrdb.rdb_cuda, rrdb.rdb_banded_cuda, tail.tail_cuda, tail.tail_banded_cuda = orig


def peak_mb(fn):
    """Device memory a call holds at its peak beyond what was allocated
    before it (outputs and scratch), in MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def phase_kernels_banded(chn, results):
    """K2 (the trunk's RDBs in row bands) and K5 (the tail in row bands)
    against their plain band decompositions at the video path's shapes:
    one RRDB and the 20-RRDB trunk at 8 frames of 128x256, the tail at 8
    frames of 128x128 and of 128x256; each check read on planted faults (a
    weight fault, and the band-edge fault compiled into the kernels); each
    kernel beside its full-frame twin (K1, K4) on the same input, times,
    bounds and the memory a call holds; K2 also beside the first K1 design
    and the cuDNN route, K5 beside its first design."""
    from master_thesis_tpu_torch.ops import rrdb, tail

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trunk_w, tail_w = chn.nn.packed()
    nf = chn.nn.nf
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    n, h, w = BAND_N, BAND_H, BAND_WS[-1]
    br = rrdb.TRUNK_BAND_ROWS

    one = [trunk_w[0]]
    run_k = lambda x, wts=one: rrdb.rrdb_trunk_banded(x, wts, br)
    run_p = lambda x: rrdb.rrdb_trunk_banded_plain(x, one, br)
    x = channels_last(rnd(n, nf, h, w))
    want = run_p(x)
    got = run_k(x)
    err = check(f"K2 rrdb in {h // br} bands ({n}, 64, {h}, {w})", got, want, 1.2 * x.float(), L2_RRDB)
    for fault in ("x4", "bias5"):
        bad = [[*one[0][:2], plant_rdb(one[0][2], fault)]]
        check(f"K2 rrdb, {fault} fault in rdb3", run_k(x, bad), want, 1.2 * x.float(), L2_RRDB,
              planted=True)
    with planted_band():
        check(f"K2 rrdb, {BAND_FAULT}", run_k(x), want, 1.2 * x.float(), L2_RRDB, planted=True)
    full = rrdb.rrdb_trunk(x, one)
    diff = (got.float() - full.float()).abs().max().item()
    print(f"K2 beside K1 full-frame on the same input: max|K2 - K1| = {diff:.6g}")
    if not torch.equal(got, full):
        raise RuntimeError("K2 differs from K1 on the same input")
    want_t = rrdb.rrdb_trunk_banded_plain(x, trunk_w, br)
    base = 1.2 ** NB * x.float()
    got_t = rrdb.rrdb_trunk_banded(x, trunk_w, br)
    check(f"K2 {NB}-RRDB trunk in bands", got_t, want_t, base, L2_TRUNK_BANDED, max_abs=False)
    if not torch.equal(got_t, rrdb.rrdb_trunk(x, trunk_w)):
        raise RuntimeError(f"K2's {NB}-RRDB trunk differs from K1's on the same input")
    print(f"K2 {NB}-RRDB trunk equals K1's bit for bit")
    check(f"K2 {NB}-RRDB trunk, x4 fault in every rdb", rrdb.rrdb_trunk_banded(x, planted_trunk(trunk_w), br),
          want_t, base, L2_TRUNK_BANDED, max_abs=False, planted=True)
    with planted_band():
        check(f"K2 {NB}-RRDB trunk, {BAND_FAULT}", rrdb.rrdb_trunk_banded(x, trunk_w, br), want_t, base,
              L2_TRUNK_BANDED, max_abs=False, planted=True)
    w_all = [t for p in one[0] for t in (p.wg, p.b)]
    b_ms, b_by = bound_ms(3 * rrdb.rdb_flops(n, h, w), nbytes(x, x, *w_all))
    results["K2"] = dict(
        name=f"rrdb in row bands (conv_kernel x5 per {br}-row band, x3 per RRDB)", route="cuda",
        source="master_thesis_tpu_torch/csrc/rrdb.cu",
        replaces="master_thesis_tpu/ops/pallas_rrdb.py:541",
        max_abs_err=err, ms=cuda_ms(lambda: run_k(x)), full_ms=cuda_ms(lambda: rrdb.rrdb_trunk(x, one)),
        plain_ms=cuda_ms(lambda: run_p(x), iters=5), bound_ms=b_ms, bound_by=b_by, library_ms=None,
        peak_mb=peak_mb(lambda: run_k(x)), full_peak_mb=peak_mb(lambda: rrdb.rrdb_trunk(x, one)),
        shape=f"one RRDB, {n}x64x{h}x{w}", cudnn_ms=cuda_ms(lambda: rrdb_cudnn(x, one[0])),
        tiles_ms=cuda_ms(lambda x_nchw=x.contiguous(): rrdb_tiles(x_nchw, one[0])),
    )

    tbr = tail.TAIL_BAND_ROWS
    for tw in BAND_WS:
        y = channels_last(rnd(n, nf, h, tw))
        want = tail.tail_banded_plain(y, tail_w, tbr)
        got = tail.tail_banded_cuda(y, tail_w, tbr)
        label = f"K5 tail in {h // tbr} bands ({n}, 64, {h}, {tw}) -> ({n}, 3, {4 * h}, {4 * tw})"
        err = check(label, got, want, None, L2_TAIL)
        for key in ("up1_b", "last_b"):
            bad = dict(tail_w, **{key: torch.zeros_like(tail_w[key])})
            check(f"K5 tail ({tw} columns), {key} dropped", tail.tail_banded_cuda(y, bad, tbr), want, None,
                  L2_TAIL, planted=True)
        with planted_band():
            check(f"K5 tail ({tw} columns), {BAND_FAULT}", tail.tail_banded_cuda(y, tail_w, tbr), want,
                  None, L2_TAIL, planted=True)
        with planted_tail():
            check(f"K5 tail ({tw} columns), {TAIL_FAULT}", tail.tail_banded_cuda(y, tail_w, tbr), want,
                  None, L2_TAIL, planted=True)
        full = tail.tail_cuda(y, tail_w)
        print(f"K5 beside K4 full-frame on the same input ({tw} columns): max|K5 - K4| = "
              f"{(got.float() - full.float()).abs().max().item():.6g}")
        if not torch.equal(got, full):
            raise RuntimeError(f"K5 differs from K4 on the same input ({tw} columns)")
    y_nchw = y.contiguous()
    check("K5 first design (tail_banded_first_cuda)", tail.tail_banded_first_cuda(y_nchw, tail_w, tbr),
          want, None, L2_TAIL)
    out = torch.empty(n, 3, 4 * h, 4 * tw, dtype=y.dtype, device=y.device)
    b_ms, b_by = bound_ms(tail.tail_flops(n, h, tw), nbytes(y, out))
    results["K5"] = dict(
        name=f"tail in row bands (tail_kernel x4 per {tbr}-row band)", route="cuda",
        source="master_thesis_tpu_torch/csrc/tail_wgmma.cuh",
        replaces="master_thesis_tpu/ops/pallas_tail.py:292",
        max_abs_err=err, ms=cuda_ms(lambda: tail.tail_banded_cuda(y, tail_w, tbr)),
        full_ms=cuda_ms(lambda: tail.tail_cuda(y, tail_w)),
        first_design_ms=cuda_ms(lambda: tail.tail_banded_first_cuda(y_nchw, tail_w, tbr)),
        plain_ms=cuda_ms(lambda: tail.tail_banded_plain(y, tail_w, tbr), iters=5), bound_ms=b_ms,
        bound_by=b_by, library_ms=None, peak_mb=peak_mb(lambda: tail.tail_banded_cuda(y, tail_w, tbr)),
        full_peak_mb=peak_mb(lambda: tail.tail_cuda(y, tail_w)),
        first_peak_mb=peak_mb(lambda: tail.tail_banded_first_cuda(y_nchw, tail_w, tbr)),
        shape=f"{n}x64x{h}x{tw}",
    )
    r = results["K5"]
    if not r["ms"] < r["first_design_ms"]:
        raise RuntimeError(f"K5 at {r['shape']} is not faster than the first design")
    for key, full in (("K2", "K1"), ("K5", "K4")):
        r = results[key]
        print(f"kernel {key} {r['name']} at {r['shape']}: kernel_ms={r['ms']:.4f} ({full} full-frame "
              f"{r['full_ms']:.4f}) plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms=null; holds {r['peak_mb']:.1f} MB at its peak "
              f"({full} {r['full_peak_mb']:.1f} MB)"
              + (f"; first design {r['tiles_ms']:.4f}, cuDNN route {r['cudnn_ms']:.4f}" if key == "K2" else
                 f"; first design {r['first_design_ms']:.4f} ms holding {r['first_peak_mb']:.1f} MB"))


def identity_align(x_t, m_t, x_r, m_r):
    """benchmarks.py:config_5's identity aligner: the references are aligned
    already and visible where their mask is 0."""
    v_r = 1 - m_r
    return x_r, v_r, torch.clamp(v_r - (1 - m_t[:, None]), 0, 1)


def plausible_cpn_align(cpn, rng, f_max=32):
    """benchmarks.py:_plausible_cpn_align on the port: the real CPN cost
    (``AEncoder`` on target and references, ``ARegressor``, ``affine_grid``
    and the 4-channel ``grid_sample`` warp, as ``CPN.align``) with the
    regressed theta swapped for a fixed near-identity jitter drawn from
    ``rng`` (+-2% scale / shear, +-3% shift), the regressed one kept live at
    1e-6 through tanh. Random CPN weights would regress arbitrary affines."""
    from master_thesis_tpu_torch.ops.grid_sample import affine_grid, grid_sample

    ident = np.asarray([[1.0, 0, 0], [0, 1.0, 0]], np.float32)
    jit_tab = torch.from_numpy((ident + np.concatenate(
        [rng.uniform(-0.02, 0.02, (f_max, 2, 2)), rng.uniform(-0.03, 0.03, (f_max, 2, 1))],
        axis=2)).astype(np.float32)).cuda()

    def align_fn(x_t, m_t, x_r, m_r):
        b, f, h, w, c = x_r.shape
        x_rf, m_rf = x_r.reshape(b * f, h, w, c), m_r.reshape(b * f, h, w, 1)
        feat_t = cpn.A_Encoder(x_t, m_t)
        feat_r = cpn.A_Encoder(x_rf, m_rf)
        feat_t_rep = feat_t[:, None].expand(b, f, *feat_t.shape[1:]).reshape(feat_r.shape)
        theta = cpn.A_Regressor(feat_t_rep, feat_r)
        theta = jit_tab[:f].repeat(b, 1, 1) + 1e-6 * torch.tanh(theta.float())
        grid = affine_grid(theta, (h, w), align_corners=False)
        warped = grid_sample(torch.cat([x_rf, 1.0 - m_rf], dim=-1), grid, align_corners=False)
        x_al = warped[..., :c].reshape(b, f, h, w, c)
        v_al = (warped[..., c:] > 0.5).to(x_r.dtype).reshape(b, f, h, w, 1)
        return x_al, v_al, torch.clamp(v_al - (1.0 - m_t[:, None]), 0.0, 1.0)

    return align_fn


def video_inputs(f, h, w, rng):
    """config 5's sequence: one seeded random frame over time, a hole strip
    moving 12 rows a frame (rows 150+12t..270+12t, columns 200..330), the
    holes filled with 0.45. Returns (x, m, y) on the card."""
    y = np.broadcast_to(rng.rand(1, h, w, 3), (f, h, w, 3)).astype(np.float32)
    m = np.zeros((f, h, w, 1), np.float32)
    for t in range(f):
        m[t, 150 + 12 * t: 270 + 12 * t, 200:330] = 1
    x = (1 - m) * y + m * 0.45
    return tuple(torch.from_numpy(a).cuda() for a in (x, m, y))


VIDEO_COUNTERS = ("K1", "K2", "K4", "K5")


def video_counters():
    from master_thesis_tpu_torch.ops import rrdb, tail

    return dict(zip(VIDEO_COUNTERS, (rrdb.rdb_cuda, rrdb.rdb_banded_cuda, tail.tail_cuda,
                                     tail.tail_banded_cuda)))


def run_video(inp, algo, x, m):
    """One video through ``inp``'s algorithm with the launch counters set to
    0 just before and read just after. Returns (output, seconds, counts)."""
    counters = video_counters()
    inp.refined = inp.syncs = 0
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = getattr(inp, f"inpaint_{algo}")(x, m, as_numpy=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, {k: c.launches for k, c in counters.items()}


def check_video(label, out, x, m, counts, per_call):
    """The video's fatal checks: finite output in [0, 1], equal to the input
    where its mask is 0, and launches on exactly the expected routes:
    ``per_call`` maps each expected kernel to its launches in one CHN call,
    and each must account for the same number of calls, the other kernels
    for none."""
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise RuntimeError(f"{label}: output not finite in [0, 1]")
    visible = (m == 0).expand_as(x)
    if not torch.equal(out[visible], x[visible]):
        raise RuntimeError(f"{label}: output differs from the input where the mask is 0")
    calls = {counts[k] / n for k, n in per_call.items()}
    quiet = [k for k in VIDEO_COUNTERS if k not in per_call and counts[k]]
    if len(calls) != 1 or not min(calls) or min(calls) % 1 or quiet:
        raise RuntimeError(f"{label}: launches {counts} are not {per_call} a CHN call")


def phase_video(cpn, chn, results, device_line):
    """BASELINE.md config 5 (benchmarks.py:config_5) through the port's
    ``Inpainter``: F=12 at 512x512, nb=20 bf16, the identity and the
    plausible-CPN aligners, ff / ip / cp each once to warm up and once
    timed; ff at 512x1024 (the banded trunk's shape); and every refine of
    a whole video through the kernels against its inputs through their
    plain versions."""
    from master_thesis_tpu_torch.infer import Inpainter
    from master_thesis_tpu_torch.ops import measures
    from master_thesis_tpu_torch.train.build import chn_infer_fn

    from master_thesis_tpu_torch.ops import rrdb, tail

    chn.eval()
    rng = np.random.RandomState(SEED)
    x, m, y = video_inputs(VIDEO_F, VIDEO_H, VIDEO_W, rng)
    # Launches a CHN call makes: an RRDB is 3 RDB launches (in every band
    # for K2), a tail TAIL_KERNELS launches (in every band for K5).
    trunk_bands = len(rrdb.bands(VIDEO_H // 4, rrdb.TRUNK_BAND_ROWS))
    tail_bands = len(rrdb.bands(VIDEO_H // 4, tail.TAIL_BAND_ROWS))
    square = {"K1": 3 * NB, "K5": tail.TAIL_KERNELS * tail_bands}
    wide = {"K2": 3 * NB * trunk_bands, "K5": tail.TAIL_KERNELS * tail_bands}
    aligners = (("identity", identity_align), ("plausible CPN", plausible_cpn_align(cpn, rng)))
    launches = {}
    for aname, align in aligners:
        inp = Inpainter(chn_infer_fn(chn), align)
        for algo in ("ff", "ip", "cp"):
            run_video(inp, algo, x, m)
            torch.cuda.reset_peak_memory_stats()
            out, dt, counts = run_video(inp, algo, x, m)
            label = f"video {algo}, {aname} aligner, F={VIDEO_F} {VIDEO_H}x{VIDEO_W}"
            check_video(label, out, x, m, counts, square)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            psnr, ssim = measures.psnr(out, y).item(), measures.ssim(out, y).item()
            print(f"{label}: {dt:.4f} s/video, {VIDEO_F / dt:.3f} frames/s; {inp.refined} frames "
                  f"refined, launches {counts}, {inp.syncs} host syncs, max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; PSNR {psnr:.4f} SSIM "
                  f"{ssim:.4f} (random weights: floors) on {device_line}")
            if (aname, algo) == ("identity", "ff"):
                phase_profile(lambda *a: inp.inpaint_ff(*a, as_numpy=False), (x, m), dt)

    xw, mw, _ = video_inputs(VIDEO_F, VIDEO_H, VIDEO_WIDE, np.random.RandomState(SEED + 1))
    inp = Inpainter(chn_infer_fn(chn), identity_align)
    run_video(inp, "ff", xw, mw)
    torch.cuda.reset_peak_memory_stats()
    out, dt, counts = run_video(inp, "ff", xw, mw)
    label = f"video ff, identity aligner, F={VIDEO_F} {VIDEO_H}x{VIDEO_WIDE}"
    check_video(label, out, xw, mw, counts, wide)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    print(f"{label}: {dt:.4f} s/video, {VIDEO_F / dt:.3f} frames/s; {inp.refined} frames refined, "
          f"launches {counts}, {inp.syncs} host syncs, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {device_line}")
    for k in ("K2", "K5"):
        results[k]["launches"] = launches[k]
    print(f"video path launches, all timed videos: {launches}")

    # The kernels against their plain versions over whole videos (identity
    # aligner: the schedule follows the masks alone, so every run takes the
    # same rounds), over the hole pixels (the visible ones are the input's by
    # construction). Gated per refine: each CHN call of the kernel path
    # against the plain path on the same inputs, pooled over the video.
    # Printed beside it, end to end: ip and cp feed refined frames back as
    # references, and the random network amplifies differences along them.
    xs, ms = x[:VIDEO_CHECK_F], m[:VIDEO_CHECK_F]
    hole = (ms == 1).expand_as(xs)
    x4 = planted_chn(chn)
    for algo in ("ff", "ip", "cp"):
        label = f"video {algo}, F={VIDEO_CHECK_F} {VIDEO_H}x{VIDEO_W}"
        with plain_kernels():
            want = getattr(Inpainter(chn_infer_fn(chn), identity_align), f"inpaint_{algo}")(
                xs, ms, as_numpy=False)
        reads = {}
        for fault, ctx in (("kernels", contextlib.nullcontext), ("x4 fault in every rdb", x4),
                           (f"{BAND_FAULT} in K5", planted_band)):
            refine = CheckedCHN(chn, ctx)
            got = getattr(Inpainter(refine, identity_align), f"inpaint_{algo}")(xs, ms, as_numpy=False)
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{label}, {fault}: output not finite")
            end = ((got - want)[hole].norm() / want[hole].norm()).item()
            reads[fault] = (refine.rel_l2(label), end)
        print(f"check {label}, kernels vs plain versions over the hole pixels, per refine (limit "
              f"{L2_REFINE:g}) / end to end: " + "; ".join(f"{k} {a:.6g} / {b:.6g}" for k, (a, b) in reads.items()))
        ok, *faults = (a for a, _ in reads.values())
        if not ok <= L2_REFINE:
            raise RuntimeError(f"{label}: the kernel path disagrees with the plain path")
        if not min(faults) > L2_REFINE:
            raise RuntimeError(f"{label}: the whole-video check does not see a planted fault")


class CheckedCHN:
    """``chn_apply`` through the kernels, with ``fault`` (a context) planted,
    that also runs each call's inputs through the plain versions and sums
    the squared differences of ``y_hat`` over the hole pixels (v_t = 0)."""

    def __init__(self, chn, fault):
        self.chn, self.fault = chn, fault
        self.sq_diff = self.sq_plain = 0.0
        self.calls = 0

    def __call__(self, x_t, v_t, xa, va, vm):
        from master_thesis_tpu_torch.models.chn import chn_infer_apply

        with self.fault():
            out = chn_infer_apply(self.chn, x_t, v_t, xa, va, vm)
        with plain_kernels():
            y_plain, _ = chn_infer_apply(self.chn, x_t, v_t, xa, va, vm)
        hole = (v_t == 0)[:, None].expand_as(y_plain)
        self.sq_diff += ((out[0] - y_plain)[hole].norm() ** 2).item()
        self.sq_plain += (y_plain[hole].norm() ** 2).item()
        self.calls += 1
        return out

    def rel_l2(self, label):
        if not self.sq_plain > 0:
            raise RuntimeError(f"{label}: the plain path's y_hat is zero on every hole pixel")
        return (self.sq_diff / self.sq_plain) ** 0.5


def planted_chn(chn):
    """A context within which ``chn`` runs with the x4 fault planted in
    every RDB (planted_trunk), packed once."""
    trunk_w, tail_w = chn.nn.packed()
    bad = planted_trunk(trunk_w)

    @contextlib.contextmanager
    def ctx():
        chn.nn.packed = lambda: (bad, tail_w)
        try:
            yield
        finally:
            del chn.nn.packed

    return ctx

# The CLI phase: a tree at the datasets' own resolutions (GOT-10k and
# YouTube-VOS 1280x720, DAVIS-2017 854x480), CLI_STEPS train steps in each
# train mode's epoch and CLI_VAL validation batches, the steps after tick
# CLI_TIMED[0] up to CLI_TIMED[1] timed and those after it profiled.
CLI_STEPS, CLI_VAL, CLI_TIMED = 10, 2, (2, 6)
CLI_GOT, CLI_VOS, CLI_DAVIS_F = (4, 12), (10, 6), 12  # (sequences, frames); the one clip's frames
CLI_B, CLI_WORKERS = 8, 8


def smooth_frames(rng, n, h, w, pan):
    """``n`` frames ``(n, h, w, 3)`` uint8 of smooth seeded content, a random
    colour field bilinearly upsampled from 10 rows, panning ``pan`` pixels a
    frame: it compresses as the smooth parts of photographs do."""
    from master_thesis_tpu_torch.ops.interp import resize_hw_np

    cw = w + pan * (n - 1)
    low = rng.rand(10, 10 * cw // h + 2, 3).astype(np.float32)
    canvas = (resize_hw_np(low, (h, cw)) * 255).round().astype(np.uint8)
    return [canvas[:, t * pan: t * pan + w] for t in range(n)]


def ellipse_mask(h, w, cy, cx, ry, rx):
    yy, xx = np.mgrid[:h, :w]
    return ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1).astype(np.uint8) * 255


def write_tree(root, rng):
    """Writes a GOT-10k / YouTube-VOS / DAVIS-2017 tree in the layout the
    scanners read: OpenCV's JPEG backgrounds and PNG masks where it is
    installed, else every file a PNG from the zlib writer (the backgrounds
    under their ``.jpg`` names, which both pipelines read). The masks cover
    ~10% of a frame, inside the default mask-size band (0.05, 0.15).
    Returns (files written, how)."""
    from master_thesis_tpu_torch.data.decode import opencv
    from master_thesis_tpu_torch.runtime.png import write_png

    cv2 = opencv()
    files = []

    def write(path, img):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if cv2 is None:
            write_png(path, img)
        elif not cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img):
            raise RuntimeError(f"cv2 could not write {path}")
        files.append(path)

    n_seq, n_f = CLI_GOT
    for split, names in (("train", [f"GOT-10k_Train_{i:06d}" for i in range(1, n_seq + 1)]),
                         ("val", ["GOT-10k_Val_000001"])):
        for name in names:
            for t, frame in enumerate(smooth_frames(rng, n_f, 720, 1280, 6)):
                write(f"{root}/GOT10k/{split}/{name}/{t + 1:08d}.jpg", frame)
        with open(f"{root}/GOT10k/{split}/list.txt", "w") as f:
            f.write("\n".join(names) + "\n")
    n_vid, n_m = CLI_VOS
    for i in range(n_vid):
        cy, cx = rng.randint(200, 520), rng.randint(300, 980)
        for t in range(n_m):
            write(f"{root}/YouTubeVOS/train/Annotations/vid{i:04d}/{5 * t:05d}.png",
                  ellipse_mask(720, 1280, cy, cx + 8 * t, 122, 240))
    davis = f"{root}/DAVIS-2017"
    for t, frame in enumerate(smooth_frames(rng, CLI_DAVIS_F, 480, 854, 4)):
        write(f"{davis}/JPEGImages/480p/clip0/{t:05d}.jpg", frame)
        write(f"{davis}/Annotations_Dense/480p/clip0/{t:05d}.png",
              ellipse_mask(480, 854, 240 + 4 * t, 300 + 10 * t, 70, 110))
    os.makedirs(f"{davis}/ImageSets", exist_ok=True)
    with open(f"{davis}/ImageSets/custom.txt", "w") as f:
        f.write("clip0\n")
    return len(files), ("OpenCV (JPEG backgrounds, PNG masks)" if cv2 is not None
                        else "the zlib PNG writer (every file PNG)")


def cli_config(argv):
    import argparse

    from master_thesis_tpu_torch.config import Config

    parser = argparse.ArgumentParser()
    Config.add_argparse_args(parser)
    return Config.from_args(parser.parse_args(argv))


def phase_cli_loader(cfg, device_line):
    """The train loader of ``cfg`` on the card's host: samples/s with
    threads and with worker processes at 1 and CLI_WORKERS workers (the
    first batch, which starts the pool, left out), and their first
    batches, which must be bit-equal."""
    from master_thesis_tpu_torch.data import meta, pipeline
    from master_thesis_tpu_torch.train.build import build_loaders

    ds = build_loaders(cfg, meta.prepare_data(cfg), splits=("train",))["train"].dataset
    # Where an item's host time goes: CLI_B items on this thread under
    # cProfile (which slows Python calls, not the native work inside them).
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for i in range(CLI_B):
        ds.get_item(i, np.random.RandomState(i))
    prof.disable()
    per_item = 1e3 * (time.perf_counter() - t0) / CLI_B
    stats = pstats.Stats(prof).stats
    top = sorted(((tt, nc, f"{os.path.basename(fn)}:{ln}({name})") for (fn, ln, name), (_, nc, tt, _, _)
                  in stats.items()), reverse=True)[:8]
    print(f"CLI loader item: {per_item:.3f} ms an item on one thread (cProfile); by own time, ms "
          "an item: " + "; ".join(f"{1e3 * tt / CLI_B:.3f} {where} x{nc / CLI_B:g}" for tt, nc, where in top))
    firsts = {}
    for procs, workers in ((False, 1), (False, CLI_WORKERS), (True, 1), (True, CLI_WORKERS)):
        label = f"{'processes' if procs else 'threads'}, {workers} worker{'s' * (workers > 1)}"
        loader = pipeline.Loader(ds, CLI_B, seed=cfg.seed, num_workers=workers, use_processes=procs)
        t0 = time.perf_counter()
        try:
            batches = iter(loader)
            firsts[label] = next(batches)
            t1 = time.perf_counter()
            n = sum(1 for _ in batches)
            t2 = time.perf_counter()
        finally:
            loader.close()
        print(f"CLI loader, {label}: {CLI_B * n / (t2 - t1):.3f} samples/s over {n} batches of "
              f"{CLI_B} at {cfg.train_size[0]}x{cfg.train_size[1]}, frames_n {cfg.frames_n} from "
              f"1280x720 frames (first batch after {t1 - t0:.3f} s) on the host of {device_line}")
    want = firsts["threads, 1 worker"]
    for label, got in firsts.items():
        same = all(np.array_equal(got[k], want[k]) for k in ("x", "m", "y", "flow_gt", "m_movement",
                                                              "flows_use"))
        if not same or got["names"] != want["names"] or got["indexes"] != want["indexes"]:
            raise RuntimeError(f"CLI loader: the first batch with {label} differs from one thread's")
    print(f"check CLI loader: the first batches of threads and processes are bit-equal ({len(firsts)})")


def phase_cli(results, device_line, synthetic):
    """``__main__.main(argv)`` on the card in its four modes over a tree the
    phase writes: DFPN train (B=8, frames_n 2, 256x256, base 256, worker
    processes), a resume of it, DFPN test, CHN train (nb 20, the CPN
    aligner; these two with loader threads) and CHN test (ff / ip / cp over the DAVIS clip at the default
    test_size). Each mode's kernel launches, with the counters set to 0
    just before it and read just after, against the expected ones; the
    batches and parameters on the card; finite losses, moved parameters;
    the checkpoint reloaded and resumed; CHN test's frames in [0, 1] and the
    input's where visible; the loader's samples/s; each train mode's
    ms/step and busy share with the real loader, beside the synthetic-batch
    step of the same shape (``synthetic``: (s/step, busy ms) by mode)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from master_thesis_tpu_torch import __main__ as cli
    from master_thesis_tpu_torch.data import meta
    from master_thesis_tpu_torch.infer.video import write_video
    from master_thesis_tpu_torch.data.decode import opencv
    from master_thesis_tpu_torch.models.chn import RRDBNet
    from master_thesis_tpu_torch.ops import conv_stack, rrdb, rrdb_bwd, tail, tail_bwd
    from master_thesis_tpu_torch.runtime import native
    from master_thesis_tpu_torch.train import build, loop

    t_phase = time.perf_counter()
    cli_f32 = {}
    counters = {"K1": rrdb.rdb_cuda, "K2": rrdb.rdb_banded_cuda, "K3": rrdb_bwd.rrdb_bwd_cuda,
                "K4": tail.tail_cuda, "K5": tail.tail_banded_cuda, "K6": tail_bwd.tail_bwd_cuda,
                "K7": conv_stack.conv_stack_tiles_cuda, "K8": conv_stack.conv_stack_banded_cuda}
    none = dict.fromkeys(counters, 0)
    libs = native.is_available()
    why = [ln for ln in native.error("codec").splitlines() if "error" in ln] if not libs["codec"] else []
    print(f"CLI: host libraries {libs}" + ("" if libs["codec"] else
          f"; the codec did not build ({(why or ['?'])[0].strip()[:160]}), so "
          f"{'OpenCV' if opencv() is not None else 'nothing'} decodes the JPEGs"))

    devices, ticks, chn_calls = set(), [], [0]
    prof = {}
    batch_args, step_timer, rrdbnet_forward = cli.batch_args, loop.StepTimer, RRDBNet.forward

    def recording_batch_args(batch, keys, device):
        out = batch_args(batch, keys, device)
        devices.update(t.device.type for t in out)
        return out

    class CLITimer(step_timer):
        """The Trainer's timer, synchronised at each tick: times the steps
        after tick CLI_TIMED[0] up to CLI_TIMED[1], and profiles the card
        (CUDA activity only) from there to the last step."""

        def tick(self):
            torch.cuda.synchronize()
            ticks.append(time.perf_counter())
            if len(ticks) == CLI_TIMED[1]:
                prof["p"] = profile(activities=[ProfilerActivity.CUDA])
                prof["p"].start()
            elif len(ticks) == CLI_STEPS and "p" in prof:
                prof["p"].stop()
            super().tick()

    def counting_forward(self, *a, **k):
        chn_calls[0] += 1
        return rrdbnet_forward(self, *a, **k)

    def run(label, argv, want, **kw):
        """main(argv) with the counters set to 0 just before and read just
        after. Returns (result, counts, host seconds)."""
        for c in counters.values():
            c.launches = 0
        devices.clear()
        ticks.clear()
        prof.clear()
        chn_calls[0] = 0
        t0 = time.perf_counter()
        out = cli.main(argv, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: c.launches for k, c in counters.items()}
        want = want(chn_calls[0]) if callable(want) else want
        print(f"CLI {label}: {secs:.3f} s on the host; kernel launches {counts} (expected {want})")
        if counts != want:
            raise RuntimeError(f"CLI {label} did not launch each kernel as expected")
        if devices - {"cuda"}:
            raise RuntimeError(f"CLI {label}: batches on {devices}")
        return out, counts, secs

    def train_checks(label, state, logger, fresh):
        if not all(p.is_cuda for p in state.model.parameters()):
            raise RuntimeError(f"CLI {label}: a parameter is not on the card")
        items = [(prefix, step, k, v) for prefix, step, sc in logger.scalars for k, v in sc.items()
                 if k != "step_time_s"]
        if not items or not all(np.isfinite(v) for *_, v in items):
            raise RuntimeError(f"CLI {label}: logged items missing or not finite: {items[:8]}")
        moved = sum(not torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                                          fresh.state_dict().values()))
        n = len(fresh.state_dict())
        if moved != n:
            raise RuntimeError(f"CLI {label}: only {moved} of {n} parameters moved")
        first = next(sc for prefix, step, sc in logger.scalars if prefix == "training/" and step == 1)
        print(f"CLI {label}: step 1 " + ", ".join(f"{k} {v:.6g}" for k, v in first.items()
                                                  if k != "step_time_s")
              + f"; all logged items finite; all {moved} parameters moved; batches and "
              f"parameters on cuda")
        # Ticks 1..CLI_STEPS follow the steps; each interval holds a step and
        # the wait for the next batch.
        t = np.asarray(ticks)
        ms = 1e3 * (t[CLI_TIMED[1] - 1] - t[CLI_TIMED[0] - 1]) / (CLI_TIMED[1] - CLI_TIMED[0])
        profiled = CLI_STEPS - CLI_TIMED[1]
        busy = sum(e.self_device_time_total for e in prof["p"].key_averages()
                   if str(e.device_type).endswith("CUDA")) / 1e3 / profiled
        return ms, busy

    cli.batch_args, loop.StepTimer, RRDBNet.forward = recording_batch_args, CLITimer, counting_forward
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            n_files, how = write_tree(f"{tmp}/data", np.random.RandomState(SEED + 30))
            print(f"CLI tree: {n_files} files written with {how} in {time.perf_counter() - t0:.3f} s")
            common = ["--device", "cuda", "--data_path", f"{tmp}/data", "--data_ckpt_path",
                      f"{tmp}/data.ckpt", "--default_root_dir", f"{tmp}/logs", "--seed", str(SEED)]
            train = ["--batch_size", str(CLI_B), "--frames_n", "2", "--train_size", str(H), str(W),
                     "--train_max_iterations", str(CLI_STEPS), "--validation_max_iterations",
                     str(CLI_VAL), "--max_epochs", "1", "--num_workers", str(CLI_WORKERS)]
            # DFPN trains with worker processes, CHN and the resume with
            # threads (a spawned worker takes seconds to start here).
            dfpn_argv = common + train + ["--dfpn_base_size", str(DFPN_BASE)]
            chn_argv = common + train + ["--chn", "--chn_nb", str(NB)]
            cfg = cli_config(dfpn_argv)
            t0 = time.perf_counter()
            metas = meta.prepare_data(cfg)
            print(f"CLI data.ckpt: {[len(m) for m in metas]} sequences (train backgrounds, train "
                  f"masks, validation backgrounds, validation masks, test) in "
                  f"{time.perf_counter() - t0:.3f} s")
            if min(len(m) for m in metas) == 0:
                raise RuntimeError("CLI: a split of the tree is empty after the mask-size filter")
            phase_cli_loader(cfg, device_line)

            timing = {}
            logger = MemoryLogger()
            state, counts, secs = run("DFPN train", dfpn_argv + ["--loader_processes", "true"], none,
                                      logger=logger)
            timing["dfpn"] = train_checks("DFPN train", state, logger, cli.load_dfpn(cfg))
            version = f"{tmp}/logs/version_0"
            saved = torch.load(f"{version}/checkpoints/step_{CLI_STEPS}.pt", map_location="cuda",
                               weights_only=True)
            if any(not torch.equal(saved["model"][k], v) for k, v in state.model.state_dict().items()):
                raise RuntimeError("CLI DFPN train: the checkpoint does not hold the trained parameters")
            resumed, _, _ = run("DFPN train resumed for a second epoch",
                                dfpn_argv + ["--max_epochs", "2", "--resume_from_checkpoint", version],
                                none, logger=MemoryLogger())
            if resumed.step != 2 * CLI_STEPS or not os.path.isfile(
                    f"{tmp}/logs/version_1/checkpoints/step_{2 * CLI_STEPS}.pt"):
                raise RuntimeError(f"CLI DFPN resume: step {resumed.step}, not {2 * CLI_STEPS}")
            print(f"check CLI DFPN checkpoint: step_{CLI_STEPS}.pt holds the trained parameters; the "
                  f"resume from it ran steps {CLI_STEPS + 1}..{resumed.step}")

            test_logger = MemoryLogger()
            means, counts, _ = run("DFPN test", common + ["--test", "--test_checkpoint", version,
                                                          "--dfpn_base_size", str(DFPN_BASE)],
                                   {**none, "K7": 11, "K8": 50}, logger=test_logger)
            if not all(np.isfinite(v) for v in means.values()) or not test_logger.images:
                raise RuntimeError(f"CLI DFPN test: {means}, {len(test_logger.images)} image strips")
            print("CLI DFPN test: " + ", ".join(f"{k} {v:.6g}" for k, v in means.items())
                  + f"; {len(test_logger.images)} aligned-frame strips logged")
            cli_counts = {"DFPN train": none, "DFPN test": counts}

            logger = MemoryLogger()
            steps, evals = CLI_STEPS, CLI_VAL
            want = {**none, "K1": 3 * NB * (steps + evals), "K3": NB * steps,
                    "K4": tail.TAIL_KERNELS * (steps + evals), "K6": tail_bwd.TAIL_BWD_KERNELS * steps}
            state, counts, _ = run("CHN train", chn_argv, want, logger=logger)
            cli_counts["CHN train"] = counts
            timing["chn"] = train_checks("CHN train", state, logger, build.build_chn(cli_config(chn_argv)))

            frames = {}

            def writer(y_hat, name):
                frames[name] = y_hat
                return write_video(y_hat, name, out_dir=f"{tmp}/videos") if opencv() else name

            test_argv = common + ["--chn", "--test", "--chn_nb", str(NB), "--test_checkpoint",
                                  f"{tmp}/logs/version_2"]
            per_call = lambda calls: {**none, "K1": 3 * NB * calls, "K4": tail.TAIL_KERNELS * calls}
            means, counts, _ = run("CHN test", test_argv, per_call, logger=MemoryLogger(),
                                   video_writer=writer)
            cli_counts["CHN test"] = counts
            if not chn_calls[0]:
                raise RuntimeError("CLI CHN test: the CHN's kernel route was not called")
            tcfg = cli_config(test_argv)
            clip = next(iter(build.build_loaders(tcfg, meta.prepare_data(tcfg), splits=("test",))["test"]))
            x, m = clip["x"][0], clip["m"][0]
            for name, y_hat in frames.items():
                if y_hat.shape != x.shape or not np.isfinite(y_hat).all() or y_hat.min() < 0 \
                        or y_hat.max() > 1:
                    raise RuntimeError(f"CLI CHN test {name}: frames {y_hat.shape} not finite in [0, 1]")
                visible = np.broadcast_to(m == 0, x.shape)
                if not np.array_equal(y_hat[visible], x[visible]):
                    raise RuntimeError(f"CLI CHN test {name}: frames differ from the input where visible")
            if sorted(frames) != ["clip0_cp", "clip0_ff", "clip0_ip"] or not all(np.isfinite(list(means.values()))):
                raise RuntimeError(f"CLI CHN test: videos {sorted(frames)}, measures {means}")
            print(f"CLI CHN test: {x.shape[0]} frames at {x.shape[1]}x{x.shape[2]}, " + ", ".join(
                f"{k} {v:.4f}" for k, v in means.items()) + f"; {chn_calls[0]} CHN calls; frames in "
                f"[0, 1], the input's where visible; videos {sorted(frames)}")

            # The f32 runs: DFPN test, CHN train and CHN test with the DFPN
            # aligner at --compute_dtype float32 on the kernels (F32_CLI_STEPS
            # steps; the CHN test's frames at F32_TEST_SIZE, past the f32 band
            # thresholds). Each takes the f32 routes it runs and no bf16 kernel.
            f32c = f32_counters()
            f32_want = {"DFPN test": {"K7"}, "CHN train": {"K1", "K3", "K4", "K6", "K7"},
                        "CHN test": {"K2", "K5", "K7"}}

            def run_f32(label, argv, **kw):
                for c in (*counters.values(), *f32c.values()):
                    c.launches = 0
                ticks.clear()
                prof.clear()
                t0 = time.perf_counter()
                out = cli.main(argv + ["--compute_dtype", "float32"], **kw)
                torch.cuda.synchronize()
                got = {k: c.launches for k, c in f32c.items()}
                bf16 = {k: c.launches for k, c in counters.items()}
                print(f"CLI {label}, f32: {time.perf_counter() - t0:.3f} s on the host; f32 route launches "
                      f"{got} (expected above 0 on {sorted(f32_want[label])} alone); bf16 kernels {bf16}")
                if any(bf16.values()) or {k for k, v in got.items() if v} != f32_want[label]:
                    raise RuntimeError(f"CLI {label}, f32: the f32 routes did not launch as expected")
                cli_f32[label] = got
                return out

            aligner = ["--chn_aligner", "dfpn", "--chn_aligner_checkpoint", version,
                       "--dfpn_base_size", str(DFPN_BASE)]
            means = run_f32("DFPN test", common + ["--test", "--test_checkpoint", version, "--dfpn_base_size",
                                                   str(DFPN_BASE)], logger=MemoryLogger())
            if not all(np.isfinite(v) for v in means.values()):
                raise RuntimeError(f"CLI DFPN test, f32: {means}")
            logs32 = ["--default_root_dir", f"{tmp}/logs32"]
            logger = MemoryLogger()
            state = run_f32("CHN train", chn_argv + logs32 + aligner + [
                "--train_max_iterations", str(F32_CLI_STEPS), "--validation_max_iterations", "1"],
                logger=logger)
            items = [v for prefix, _, sc in logger.scalars for k, v in sc.items() if k != "step_time_s"]
            if state.step != F32_CLI_STEPS or not items or not all(np.isfinite(items)):
                raise RuntimeError(f"CLI CHN train, f32: step {state.step}, items {items[:8]}")
            frames32 = {}

            def keep(y_hat, name):
                frames32[name] = y_hat
                return name

            means = run_f32("CHN test", common + logs32 + aligner + [
                "--chn", "--test", "--chn_nb", str(NB), "--test_checkpoint", f"{tmp}/logs32/version_0",
                "--test_size", *map(str, F32_TEST_SIZE)], logger=MemoryLogger(), video_writer=keep)
            bad = [k for k, v in frames32.items() if not np.isfinite(v).all() or v.min() < 0 or v.max() > 1]
            if sorted(frames32) != ["clip0_cp", "clip0_ff", "clip0_ip"] or bad or not all(
                    np.isfinite(list(means.values()))):
                raise RuntimeError(f"CLI CHN test, f32: videos {sorted(frames32)}, bad {bad}, {means}")
            print(f"CLI CHN test, f32, DFPN aligner: {F32_TEST_SIZE[0]}x{F32_TEST_SIZE[1]}, " + ", ".join(
                f"{k} {v:.4f}" for k, v in means.items()) + "; frames finite in [0, 1]")
    finally:
        cli.batch_args, loop.StepTimer, RRDBNet.forward = batch_args, step_timer, rrdbnet_forward

    for mode, (ms, busy) in timing.items():
        syn_s, syn_busy = synthetic[mode]
        label, workers = {"dfpn": ("DFPN train (module VGG; the synthetic step's on K8)", "processes"),
                          "chn": ("CHN train (CPN aligner)", "threads")}[mode]
        print(f"CLI {label}: B={CLI_B} frames_n 2 {H}x{W}: {ms:.3f} ms/step with the real loader "
              f"({CLI_WORKERS} worker {workers}, steps {CLI_TIMED[0] + 1}-{CLI_TIMED[1]}), "
              f"{1e3 * CLI_B / ms:.3f} samples/s; device busy {busy:.3f} ms a step (steps "
              f"{CLI_TIMED[1] + 1}-{CLI_STEPS} profiled), {100 * busy / ms:.1f}% of it; the "
              f"synthetic-batch step: {1e3 * syn_s:.3f} ms/step, busy {syn_busy:.3f} ms "
              f"({100 * syn_busy / (1e3 * syn_s):.1f}%) on {device_line}")
    for k in ("K1", "K3", "K4", "K6", "K7"):
        results[k]["launches_cli"] = {mode: c[k] for mode, c in cli_counts.items()}
    print(f"phase CLI: {time.perf_counter() - t_phase:.1f} s")
    return cli_f32


def tensor_groups(named):
    """``(name, tensor)`` pairs (a model's parameters or their grads),
    flattened in f32, by group: the first part of each name (the CHN's
    trunk and tail, DFPN's stages) and weight / bias."""
    groups = {}
    for name, t in named:
        parts = name.split(".")
        top = parts[1] if parts[0] == "nn" else parts[0]
        groups.setdefault(f"{top}.{parts[-1]}", []).append(t.detach().float().reshape(-1))
    return {k: torch.cat(v) for k, v in groups.items()}


def dist_task(task, mesh):
    """A fresh model from its seed, its train step on ``mesh`` and its
    batches (DIST_STEPS of them), and the counters of its kernels: the CHN
    step of phase 6 (seeds and first batch) or the DFPN step of phase 11 at
    frames_n DIST_DFPN_F."""
    from master_thesis_tpu_torch.models.chn import CHN
    from master_thesis_tpu_torch.models.cpn import CPN
    from master_thesis_tpu_torch.models.vgg import VGGFeatures
    from master_thesis_tpu_torch.ops import conv_stack, rrdb, rrdb_bwd, tail, tail_bwd
    from master_thesis_tpu_torch.train import chn_task, dfpn_task
    from master_thesis_tpu_torch.train.build import build_dfpn

    gen = lambda k: torch.Generator().manual_seed(SEED + k)
    if task == "chn":
        cpn = CPN(dtype=torch.bfloat16, generator=gen(0)).eval()
        model = CHN(nb=NB, dtype=torch.bfloat16, generator=gen(1)).train()
        vgg = VGGFeatures(dtype=torch.bfloat16, generator=gen(2)).requires_grad_(False)
        step = chn_task.make_train_step(model, cpn.align, vgg, mesh=mesh)
        batches = [make_train_batch(TRAIN_B, TRAIN_F, H, W, SEED + 3 + i) for i in range(DIST_STEPS)]
        counters = {"K1": rrdb.rdb_cuda, "K3": rrdb_bwd.rrdb_bwd_cuda, "K4": tail.tail_cuda,
                    "K6": tail_bwd.tail_bwd_cuda}
    else:
        vgg = VGGFeatures(dtype=torch.bfloat16, generator=gen(20)).requires_grad_(False)
        model = build_dfpn(base_size=DFPN_BASE, dtype=torch.bfloat16, generator=gen(24))
        step = dfpn_task.make_train_step(model, vgg, pallas_vgg=True, mesh=mesh)
        batches = [make_dfpn_batch(DFPN_TRAIN_B, DIST_DFPN_F, H, W, SEED + 40 + i)
                   for i in range(DIST_STEPS)]
        counters = {"K8": conv_stack.conv_stack_banded_cuda, "K8 frame": conv_stack.conv_frame_cuda}
    return model, step, batches, counters


def dist_run(task, mesh, steps=DIST_STEPS):
    """``steps`` train steps of ``task`` on ``mesh`` (None: this process
    alone) from the seeded model: each step's items (summed over the
    ranks), the first step's grads (after the all-reduce) and the parameter
    updates by group, the launches of the last step,
    ms/step (host clock over the steps after the first, each ending in a
    synchronize), the all-reduce's ms an update (CUDA events) and the peak
    memory of this process."""
    from master_thesis_tpu_torch.parallel import mesh as mesh_lib
    from master_thesis_tpu_torch.train import state

    model, step, batches, counters = dist_task(task, mesh)
    st = state.create_train_state(model, state.OptimConfig(), steps_per_epoch=2000, mesh=mesh)
    mesh_lib.broadcast_params(model, mesh)
    before = tensor_groups(model.named_parameters())
    grads = {}

    def first_grads(*_):
        if not grads:
            grads.update(tensor_groups((n, p.grad) for n, p in model.named_parameters()))

    hook = st.optimizer.register_step_pre_hook(first_grads)
    reduce_ms = []
    real = mesh_lib.all_reduce_grads

    def timed(params, m):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        real(params, m)
        ev[1].record()
        ev[1].synchronize()
        reduce_ms.append(ev[0].elapsed_time(ev[1]))

    items, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh_lib.all_reduce_grads = timed
    try:
        for i, batch in enumerate(batches[:steps]):
            local = mesh_lib.shard_batch(dict(enumerate(batch)), mesh)
            if i == steps - 1:
                for c in counters.values():
                    c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(st, *(local[j] for j in range(len(batch))))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            items.append(mesh_lib.sum_scalars(out, mesh))
    finally:
        mesh_lib.all_reduce_grads = real
        hook.remove()
    after = tensor_groups(model.named_parameters())
    return {"items": items, "grads": grads, "updates": {k: after[k] - before[k] for k in before},
            "launches": {k: c.launches for k, c in counters.items()},
            "ms": 1e3 * float(np.mean(times[1:] or times)),
            "reduce_ms": float(np.mean(reduce_ms)) if reduce_ms else None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "model": model}


def dist_compare(run, ref):
    """``run`` against ``ref``: the largest relative error of the items
    (over the items and steps), and by group the relative L2 of the first
    step's grads and of the parameter updates."""
    items = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                for a, b in zip(run["items"], ref["items"]) for k in b)
    rel = lambda part: {k: ((run[part][k] - v).norm() / v.norm()).item() for k, v in ref[part].items()}
    return {"items": items, "grads": rel("grads"), "updates": rel("updates")}


def dist_verdict(label, reading, planted=None):
    """Prints a distributed run's readings (:func:`dist_compare`) against
    the limits and returns whether they hold."""
    grads, updates = reading["grads"], reading["updates"]
    ok = (reading["items"] <= L2_DIST_ITEMS and max(grads.values()) <= L2_DIST_GRADS
          and max(updates.values()) <= L2_DIST_UPDATES)
    verdict = ("MISSED" if ok else "caught") if planted else ("ok" if ok else "FAIL")
    worst = lambda d: f"{max(d.values()):.6g} ({max(d, key=d.get)})"
    print(f"{'planted' if planted else 'check'} {label}{f' ({planted})' if planted else ''}: "
          f"items max rel err {reading['items']:.6g} (limit {L2_DIST_ITEMS:g}), first grads rel L2 "
          f"max {worst(grads)} (limit {L2_DIST_GRADS:g}), updates rel L2 max {worst(updates)} "
          f"(limit {L2_DIST_UPDATES:g}) {verdict}")
    return ok


def ranks_equal(model, mesh):
    """Whether every rank holds rank 0's parameters bit for bit (a broadcast
    of rank 0's and an all-reduce of the ranks' answers)."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()
    mine = flat.clone()
    dist.broadcast(flat, 0)
    differ = torch.tensor([0 if torch.equal(flat, mine) else 1])
    dist.all_reduce(differ)
    return differ.item() == 0


@contextlib.contextmanager
def dist_fault(fault, rank):
    """Plants one of DIST_FAULTS in this process (None: none)."""
    from master_thesis_tpu_torch.parallel import mesh as mesh_lib

    saved = (mesh_lib.global_sum, mesh_lib.all_reduce_grads)
    if fault == "local":
        mesh_lib.global_sum = lambda t, mesh: t
    elif fault == "skip":
        real = mesh_lib.all_reduce_grads

        def keep_own(params, mesh):
            params = [p for p in params if p.grad is not None]
            own = [p.grad.clone() for p in params]
            real(params, mesh)
            if rank == 1:
                for p, g in zip(params, own):
                    p.grad.copy_(g)

        mesh_lib.all_reduce_grads = keep_own
    try:
        yield
    finally:
        mesh_lib.global_sum, mesh_lib.all_reduce_grads = saved


def dist_rank(rank, workdir):
    """One of phase 13's two ranks on cuda:0 (gloo): the CHN step on a 2x1
    mesh and the DFPN step on a 1x2 mesh, each correct and with each planted
    fault; writes its readings to ``workdir/rank{rank}.pt``."""
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from master_thesis_tpu_torch.parallel import init_distributed, make_mesh

    workdir = Path(workdir)
    init_distributed("cuda:0", backend="gloo", init_method=f"file://{workdir / 'rendezvous'}",
                     rank=rank, world_size=2)
    out = {}
    try:
        for task, shape in (("chn", (2, 1)), ("dfpn", (1, 2))):
            mesh = make_mesh(*shape)
            ref = torch.load(workdir / f"ref_{task}.pt", map_location="cuda:0")
            for fault in (None, *DIST_FAULTS):
                with dist_fault(fault, rank):
                    run = dist_run(task, mesh)
                out[task, fault] = {"reading": dist_compare(run, ref),
                                    "equal": ranks_equal(run["model"], mesh),
                                    **{k: run[k] for k in ("launches", "ms", "reduce_ms", "peak_gib")}}
                del run
                torch.cuda.empty_cache()
        torch.save(out, workdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_distribution(results, device_line):
    """Phase 13: (a) the CHN train step on a 1x1 NCCL mesh against the
    one-process step; (b) / (c) two gloo ranks on the card, CHN on a 2x1
    mesh and DFPN on a 1x2 mesh, against one-process runs of the same
    steps, each read also with the planted faults."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from master_thesis_tpu_torch.parallel import init_distributed, make_mesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        tmp = Path(tmp)
        # (a) One process twice (the spread of the card's backward), then
        # on a 1x1 NCCL mesh, whose collectives run on the card.
        one = [dist_run("chn", None, steps=1) for _ in range(2)]
        init_distributed("cuda:0", init_method=f"file://{tmp / 'nccl'}", rank=0, world_size=1)
        try:
            nccl = dist_run("chn", make_mesh(1, 1), steps=1)
        finally:
            dist.destroy_process_group()
        print(f"distribution (a): CHN B={TRAIN_B} frames_n {TRAIN_F} {H}x{W} nb {NB} bf16, one step "
              f"from the same seeds and batch: one process {one[0]['ms']:.3f} ms, 1x1 NCCL mesh "
              f"{nccl['ms']:.3f} ms (all-reduce {nccl['reduce_ms']:.3f} ms) on {device_line}")
        dist_verdict("distribution (a) one process against itself (spread)", dist_compare(one[1], one[0]))
        want = {"K1": NB * 3, "K3": NB, "K4": 4, "K6": 11}
        if nccl["launches"] != want:
            raise RuntimeError(f"the 1x1 mesh step launched {nccl['launches']}, expected {want}")
        if not dist_verdict("distribution (a) 1x1 NCCL mesh vs one process", dist_compare(nccl, one[0])):
            raise RuntimeError("the CHN step on a 1x1 NCCL mesh disagrees with the one-process step")
        del one, nccl

        # (b) / (c): the one-process runs (twice: their own spread), then two
        # ranks on the card.
        refs = {}
        for task in ("chn", "dfpn"):
            run, again = dist_run(task, None), dist_run(task, None)
            dist_verdict(f"distribution {task} one process against itself (spread)",
                         dist_compare(again, run))
            torch.save({k: run[k] for k in ("items", "grads", "updates")}, tmp / f"ref_{task}.pt")
            refs[task] = {k: run[k] for k in ("ms", "peak_gib", "launches")}
            del run, again
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = mp.spawn(dist_rank, args=(str(tmp),), nprocs=2, join=False)
        deadline = time.monotonic() + DIST_JOIN_S
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"a rank of phase 13 did not end within {DIST_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        print(f"distribution: two ranks ran in {time.perf_counter() - t0:.1f} s")
        ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]

    labels = {"chn": ("(b) CHN 2x1 mesh (DP)", f"B={TRAIN_B} ({TRAIN_B // 2} a rank) frames_n {TRAIN_F}"
                      f" {H}x{W} nb {NB}"),
              "dfpn": ("(c) DFPN 1x2 mesh (SP)", f"B={DFPN_TRAIN_B} frames_n {DIST_DFPN_F} (one "
                       f"reference a rank) {H}x{W} base {DFPN_BASE}")}
    expected = {"chn": {"K1": NB * 3, "K3": NB, "K4": 4, "K6": 11}, "dfpn": {"K8": 30, "K8 frame": 27}}
    for task, (label, shape) in labels.items():
        ref = refs[task]
        print(f"distribution {label}: {shape} bf16, {DIST_STEPS} steps; one process "
              f"{ref['ms']:.3f} ms/step, peak {ref['peak_gib']:.3f} GiB, launches {ref['launches']} "
              f"on {device_line}")
        for r, rank in enumerate(ranks):
            run = rank[task, None]
            print(f"distribution {label}: rank {r} {run['ms']:.3f} ms/step, all-reduce "
                  f"{run['reduce_ms']:.3f} ms an update (gloo, staged through host memory), peak "
                  f"{run['peak_gib']:.3f} GiB, launches in its last step {run['launches']} on "
                  f"{device_line}; two ranks share the card: a check of correctness, not of scaling")
            if run["launches"] != expected[task]:
                raise RuntimeError(f"{label} rank {r} launched {run['launches']}, expected "
                                   f"{expected[task]}")
            if not dist_verdict(f"distribution {label} rank {r}", run["reading"]):
                raise RuntimeError(f"{label}: rank {r} disagrees with the one-process run")
            if not run["equal"]:
                raise RuntimeError(f"{label}: the ranks' parameters differ")
        print(f"distribution {label}: the two ranks' parameters bit-equal")
        for fault, what in DIST_FAULTS.items():
            caught = [not dist_verdict(f"distribution {label} rank {r}", rank[task, fault]["reading"],
                                       planted=what) for r, rank in enumerate(ranks)]
            equal = ranks[0][task, fault]["equal"]
            print(f"planted distribution {label} ({what}): ranks bit-equal {equal}; "
                  f"{'caught' if any(caught) or not equal else 'MISSED'}")
            if not (any(caught) or not equal):
                raise RuntimeError(f"{label}: the checks do not see a planted fault ({what})")
        for k in expected[task]:
            if k in results:
                results[k]["launches_dist"] = [rank[task, None]["launches"][k] for rank in ranks]
    print(f"phase distribution: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: the f32 routes (csrc/conv_f32.cu), every kernel site in f32.
# ---------------------------------------------------------------------------

# An f32 route against its plain f32 version on the card (f32 sums in another
# order), and the f32 steps' outputs and grads against the plain routes'
# (the same through hundreds of convs).
L2_F32, L2_F32_STEP = 1e-5, 1e-4
# H100 SXM: f32 outside the tensor cores, and TF32 on them (the 3 x TF32
# design's rate: the H100 SXM dense TF32 peak).
PEAK_F32_FLOPS, PEAK_TF32_FLOPS = 67e12, 495e12
# The f32 CPN serving step's batch (cut from the bf16 step's 16 to keep the
# phase short), and the f32 CLI runs' steps and CHN test frame size (its
# trunk grid past the f32 band threshold, so K2 and K5 run).
F32_SERVE_B, F32_CLI_STEPS, F32_TEST_SIZE = 4, 3, (480, 720)
F32_REPLACES = {
    "K1": "master_thesis_tpu/ops/pallas_rrdb.py:181", "K2": "master_thesis_tpu/ops/pallas_rrdb.py:541",
    "K3": "master_thesis_tpu/ops/pallas_rrdb.py:625", "K4": "master_thesis_tpu/ops/pallas_tail.py:263",
    "K5": "master_thesis_tpu/ops/pallas_tail.py:292", "K6": "master_thesis_tpu/ops/pallas_tail.py:732",
    "K7": "master_thesis_tpu/ops/pallas_sep4d.py:192", "K8": "master_thesis_tpu/ops/pallas_sep4d.py:316",
}
# The faults compiled into csrc/conv_f32.cu with -DF32_PLANT=n.
F32_FAULTS = {1: "tap (0, 0) dropped", 2: "channel slice read one group of 8 channels off"}
# The faults compiled into the 3xTF32 kernel (csrc/conv_frame_tf32.cu) with
# -DTF32_PLANT=n; a launch over whole frames can show the first three (the
# fourth needs a row window with x_row0 > 0: K2's and K5's bands; the fifth a
# gc-mode launch: K1's and K2's conv1..conv4).
TF32_FAULTS = {1: "the two correction products dropped (1xTF32)",
               2: "corner tap (-r, -r) left out (phase mode: each phase's tap (0, 0))",
               3: "each tile's top halo row read as zeros",
               4: "a row window's first input row read as zeros (a band's halo row)",
               5: "gc mode: a dense-concat conv's last 32-channel chunk read one chunk early"}
# The backward's (K3's and K6's one call each: csrc/conv_bwd_tf32_wgmma.cuh).
TF32_BWD_FAULTS = {6: "the weight grads' tap (0, 0) left out",
                   7: "the last K-split left out of the weight grads' reduce",
                   8: "the backward's leaky masks at slope 0.25",
                   9: "the phase (0, 1) weight grads reading phase (1, 0)'s cotangent plane"}
TF32_FRAME_FAULTS = (1, 2, 3)
F32_SOURCES = ["master_thesis_tpu_torch/csrc/conv_f32.cu"]
TF32_KERNEL_SOURCES = ["master_thesis_tpu_torch/csrc/conv_frame_tf32.cu",
                       "master_thesis_tpu_torch/csrc/conv_frame_tf32_wgmma.cuh"]
TF32_SOURCES = TF32_KERNEL_SOURCES + F32_SOURCES
TF32_BWD_SOURCES = ["master_thesis_tpu_torch/csrc/conv_bwd_tf32_wgmma.cuh"] + TF32_KERNEL_SOURCES
# Each f32 route by the kernels it launches: the profiler's pattern for
# their names, a label, their source files (the first is the row's
# ``source``), whether conv_f32.cu's two faults can show on it, and the
# 3xTF32 faults that can. The 3xTF32 kernel for K7's and K8's 64-multiple
# convs and the SIMT kernel for the thin ones; the 3xTF32 kernel alone (K4,
# K5: the upconvs in phase mode, hr_conv in conv mode, conv_last in last
# mode; K1, K2: conv1..conv4 in gc mode, conv5 in conv mode); K3, K6: its
# backward's one call each (conv_bwd_tf32_wgmma.cuh).
F32_ROUTES = {
    "tf32+simt": SimpleNamespace(kernels=r"\b(cf|ft)::", label="3xTF32 wgmma frame kernel + conv_f32_fwd",
                                 sources=TF32_SOURCES, simt_faults=True, tf32_faults=TF32_FRAME_FAULTS),
    "tail": SimpleNamespace(kernels=r"\bft::", label="3xTF32 wgmma kernel: upconvs in phase mode, hr_conv in "
                            "conv mode, conv_last in last mode", sources=TF32_KERNEL_SOURCES, simt_faults=False,
                            tf32_faults=TF32_FRAME_FAULTS),
    "rrdb bwd": SimpleNamespace(kernels=r"\bft::", label="3xTF32 wgmma kernel, one call: pulls in gc / conv mode "
                                "(mask, dx epilogues), the 15 weight grads in its weight-grad mode, a reduce",
                                sources=TF32_BWD_SOURCES, simt_faults=False, tf32_faults=(1, 2, 3, 6, 7, 8)),
    "tail bwd": SimpleNamespace(kernels=r"\bft::", label="3xTF32 wgmma kernel, one call: K4's recompute, "
                                "conv_last's two thin kernels, the adjoints in conv mode (the upsample-convs' over "
                                "phase planes), the weight grads in its weight-grad mode (4 phases x 4 taps), a "
                                "reduce", sources=TF32_BWD_SOURCES, simt_faults=False,
                                tf32_faults=(1, 2, 3, 6, 7, 8, 9)),
    "rdb": SimpleNamespace(kernels=r"\bft::", label="3xTF32 wgmma kernel: conv1..conv4 in gc mode, conv5 in conv "
                           "mode with the residual epilogue", sources=TF32_KERNEL_SOURCES, simt_faults=False,
                           tf32_faults=TF32_FRAME_FAULTS + (5,)),
}
F32_ROUTES["tail in bands"] = SimpleNamespace(**{**vars(F32_ROUTES["tail"]), "tf32_faults": (1, 2, 3, 4)})
F32_ROUTES["rdb in bands"] = SimpleNamespace(**{**vars(F32_ROUTES["rdb"]), "tf32_faults": (1, 2, 3, 4, 5)})


def f32_counters():
    """Each site's f32 route's launch counter."""
    from master_thesis_tpu_torch.ops import conv_stack, rrdb, rrdb_bwd, tail, tail_bwd

    return {"K1": rrdb.rdb_f32, "K2": rrdb.rdb_banded_f32, "K3": rrdb_bwd.rrdb_bwd_f32,
            "K4": tail.tail_f32, "K5": tail.tail_banded_f32, "K6": tail_bwd.tail_bwd_f32,
            "K7": conv_stack.conv_stack_tiles_f32, "K8": conv_stack.conv_stack_banded_f32}


@contextlib.contextmanager
def tf32_off():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@contextlib.contextmanager
def f32_plain_convs():
    """Within: the f32 routes' kernels (the SIMT kernels, the tail's and the
    RDB's 3xTF32 launches) run their plain versions on card tensors (the
    routes' own code around them stays): the plain routes."""
    from master_thesis_tpu_torch.ops import conv_f32, rrdb, tail

    orig = (conv_f32.conv_f32_fwd_cuda, conv_f32.conv_f32_wgrad_cuda, tail.tail_stage_tf32_cuda,
            rrdb.rdb_conv_tf32_cuda)
    (conv_f32.conv_f32_fwd_cuda, conv_f32.conv_f32_wgrad_cuda, tail.tail_stage_tf32_cuda,
     rrdb.rdb_conv_tf32_cuda) = (conv_f32.conv_f32_fwd_plain, conv_f32.conv_f32_wgrad_plain,
                                 tail.tail_stage_tf32_plain, rrdb.rdb_conv_tf32_plain)
    try:
        yield
    finally:
        (conv_f32.conv_f32_fwd_cuda, conv_f32.conv_f32_wgrad_cuda, tail.tail_stage_tf32_cuda,
         rrdb.rdb_conv_tf32_cuda) = orig


@contextlib.contextmanager
def planted_f32(fault):
    """Within: the f32 routes launch their kernels from the library built
    with ``-DF32_PLANT=fault`` (csrc/conv_f32.cu)."""
    from master_thesis_tpu_torch.ops import conv_f32

    orig = conv_f32._lib
    conv_f32._lib = lambda _=(): orig((f"-DF32_PLANT={fault}",))
    try:
        yield
    finally:
        conv_f32._lib = orig


@contextlib.contextmanager
def planted_tf32(fault):
    """Within: the f32 routes launch the 3xTF32 kernel from the library
    built with ``-DTF32_PLANT=fault``."""
    from master_thesis_tpu_torch.ops import conv_stack

    orig = conv_stack._tf32_lib
    conv_stack._tf32_lib = lambda _=(): orig((f"-DTF32_PLANT={fault}",))
    try:
        yield
    finally:
        conv_stack._tf32_lib = orig


@contextlib.contextmanager
def f32_plain_backward():
    """Within: the trunk's and the tail's autograd Functions run the plain
    backward versions over the f32 routes' forward (the kept activations,
    and the tail's recompute on K4's f32 stages), as :func:`plain_backward`
    does in bf16: a forward that differs by f32 noise would flip a few
    leaky masks, and the L1 loss's signs."""
    from master_thesis_tpu_torch.ops import rrdb_bwd, tail, tail_bwd
    from master_thesis_tpu_torch.ops.conv_f32 import nhwc

    orig = rrdb_bwd.rrdb_bwd, tail_bwd.tail_bwd

    def rrdb_plain(x, g, rdbs, pulls, kept, out, scratch=None):
        nf = x.shape[1]
        hids = [c[..., nf:].permute(0, 3, 1, 2) for c in kept[1]]
        dx, grads = rrdb_bwd.rrdb_bwd_plain(x, g, rdbs, (kept[0], hids))
        return dx, rrdb_bwd.flat_grads(grads, out)

    def tail_plain(x, g, p):
        hidden = [t.permute(0, 3, 1, 2) for t in tail.tail_f32_stages(nhwc(x), p, keep=3)]
        return tail_bwd.tail_bwd_plain(x, g, p, hidden=hidden)

    rrdb_bwd.rrdb_bwd, tail_bwd.tail_bwd = rrdb_plain, tail_plain
    try:
        yield
    finally:
        rrdb_bwd.rrdb_bwd, tail_bwd.tail_bwd = orig


def f32_library_ms(fn, dtype=torch.float32):
    """The library yardstick of an f32 route: its launches recorded over one
    call, and for each the one PyTorch call that computes it (``F.conv2d``
    at the conv's shape, through x2 at the upsampled size, the 2x2 sums'
    convs at the full size; ``conv2d_weight`` for a weight grad), in
    ``dtype`` (f32 with TF32 off; bf16 for the bf16 table's column: the same
    convs, the bf16 sites' shapes being the f32 ones), channels-last, timed
    alone and summed."""
    import torch.nn.functional as F

    from master_thesis_tpu_torch.ops import conv_f32, conv_stack, rrdb, tail

    shapes = {}
    orig = conv_f32.conv_f32_fwd_cuda, conv_f32.conv_f32_wgrad_cuda
    orig_tf32, orig_tail = conv_stack.conv_frame_tf32_cuda, tail.tail_stage_tf32_cuda
    orig_rdb = rrdb.rdb_conv_tf32_cuda

    def fwd(x, w, out, **kw):
        g = conv_f32.geometry(x, w, out, k=kw.get("k", 3), up=kw.get("up", False),
                              pool=kw.get("pool", False), hin=kw.get("hin"), rows=kw.get("rows"),
                              x_row0=kw.get("x_row0", 0), out_row0=kw.get("out_row0", 0))
        key = ("fwd", x.shape[0], x.shape[3], out.shape[3], (g.r1 - g.r0) * g.so, g.wout * g.so,
               kw.get("k", 3))
        shapes[key] = shapes.get(key, 0) + 1
        return orig[0](x, w, out, **kw)

    def wgrad(x, dy, dw, db, k=3, up=False):
        key = ("wgrad", x.shape[0], x.shape[3], dy.shape[3], dy.shape[1], dy.shape[2], k)
        shapes[key] = shapes.get(key, 0) + 1
        return orig[1](x, dy, dw, db, k=k, up=up)

    def tf32(x, p, i, swap=False):
        k, _, co = p.specs[i]
        key = ("fwd", x.shape[0], x.shape[3], co, x.shape[1], x.shape[2], k)
        shapes[key] = shapes.get(key, 0) + 1
        return orig_tf32(x, p, i, swap)

    def tail_stage(k, x, p, out, **window):  # an upsample-conv: the conv at the upsampled size
        s = 2 if k < 2 else 1
        r0, r1 = window.get("rows") or (0, s * (window.get("hin") or x.shape[1]))
        key = ("fwd", x.shape[0], x.shape[3], out.shape[3], r1 - r0, out.shape[2], 3)
        shapes[key] = shapes.get(key, 0) + 1
        return orig_tail(k, x, p, out, **window)

    def rdb_conv(k, x, p, out, **window):
        r0, r1 = window.get("rows") or (0, window.get("hin") or x.shape[1])
        key = ("fwd", x.shape[0], x.shape[3], out.shape[3], r1 - r0, out.shape[2], 3)
        shapes[key] = shapes.get(key, 0) + 1
        return orig_rdb(k, x, p, out, **window)

    # The wrapped kernels count their launches on the wrappers in their
    # place, and hand the counts back.
    fwd.launches, wgrad.launches, tf32.launches = (orig[0].launches, orig[1].launches,
                                                   orig_tf32.launches)
    conv_f32.conv_f32_fwd_cuda, conv_f32.conv_f32_wgrad_cuda = fwd, wgrad
    conv_stack.conv_frame_tf32_cuda, tail.tail_stage_tf32_cuda, rrdb.rdb_conv_tf32_cuda = tf32, tail_stage, rdb_conv
    try:
        fn()
    finally:
        conv_f32.conv_f32_fwd_cuda, conv_f32.conv_f32_wgrad_cuda = orig
        conv_stack.conv_frame_tf32_cuda, tail.tail_stage_tf32_cuda = orig_tf32, orig_tail
        rrdb.rdb_conv_tf32_cuda = orig_rdb
        orig[0].launches, orig[1].launches, orig_tf32.launches = (fwd.launches, wgrad.launches,
                                                                  tf32.launches)
    total = 0.0
    for (kind, n, cin, cout, h, w, k), count in shapes.items():
        x = channels_last(torch.randn(n, cin, h, w, device="cuda", dtype=dtype))
        wt = channels_last(torch.randn(cout, cin, k, k, device="cuda", dtype=dtype))
        if kind == "fwd":
            call = lambda: F.conv2d(x, wt, padding=k // 2)
        else:
            dy = channels_last(torch.randn(n, cout, h, w, device="cuda", dtype=dtype))
            call = lambda: torch.nn.grad.conv2d_weight(x, wt.shape, dy, padding=k // 2)
        total += count * cuda_ms(call, iters=3, warmup=1)
        del x, wt
    return total


def tail_cudnn(y, p, leaves=None):
    """The tail as the cuDNN route: nearest x2 then ``F.conv2d`` for each
    upconv, hr_conv, conv_last, f32 channels-last (TF32 off); ``leaves``,
    if given, the (kernel, bias) pairs to use (autograd leaves for the
    backward's yardstick). The port never calls it."""
    import torch.nn.functional as F

    convs = leaves or [(channels_last(p[f"{n}_oihw"]), p[f"{n}_b"]) for n in ("up1", "up2", "hr", "last")]
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
    lrelu = lambda t: F.leaky_relu(t, 0.2)
    y = lrelu(F.conv2d(up(y), *convs[0], padding=1))
    y = lrelu(F.conv2d(up(y), *convs[1], padding=1))
    y = lrelu(F.conv2d(y, *convs[2], padding=1))
    return F.conv2d(y, *convs[3], padding=1)


def routed_bound(routed, nbytes_):
    """K7's or K8's routed bound, ``(seconds, bound_by)``: the larger of
    ``nbytes_`` at 3.35 TB/s and the least time of the route's operations,
    over ``routed``, ``(packed stack, frames, h, w)`` of each stack it runs,
    each conv that :func:`conv_stack.f32_plan` sends to the 3xTF32 kernel at
    three tf32 products a FLOP on the tensor cores, each other conv at the
    f32 rate outside them."""
    from master_thesis_tpu_torch.ops import conv_stack

    t_ops = 0.0
    for p, n, h, w in routed:
        for (k, ci, co), kind in zip(p.specs, conv_stack.f32_plan(p)):
            flops = 2 * n * h * w * ci * co * k * k
            t_ops += 3 * flops / PEAK_TF32_FLOPS if kind == "tf32" else flops / PEAK_F32_FLOPS
    t_bytes = nbytes_ / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tail_stage_floor(k, n, h, w):
    """Stage ``k``'s floor on the 3xTF32 kernel, for a tail of an ``(n, 64,
    h, w)`` f32 input: ``(seconds, bound_by, FLOPs)``, the larger of 3 x its
    FLOPs (the upsample-convs in their 4-phase form) at 495 TFLOP/s and its
    input and output at 3.35 TB/s (``tail.tail_stage_cost``)."""
    from master_thesis_tpu_torch.ops import tail

    flops, nbytes_ = tail.tail_stage_cost(k, n, h, w, itemsize=4)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes_ / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def tail_bound(n, h, w):
    """K4's or K5's routed bound, ``(seconds, bound_by)``: the sum of the four
    stages' floors (:func:`tail_stage_floor`), which run one after another;
    bound by what bounds the stages that make up most of it."""
    by_limit = {"operations": 0.0, "bytes": 0.0}
    for k in range(4):
        t, by, _ = tail_stage_floor(k, n, h, w)
        by_limit[by] += t
    return sum(by_limit.values()), max(by_limit, key=by_limit.get)


def rdb_conv_floor(k, n, h, w):
    """Conv ``k`` (1..5) of an RDB on the 3xTF32 kernel, over ``n`` f32
    frames of ``h x w``: ``(seconds, bound_by, FLOPs)``, the larger of 3 x
    its FLOPs at 495 TFLOP/s and its input and output at 3.35 TB/s
    (``rrdb.rdb_conv_cost``)."""
    from master_thesis_tpu_torch.ops import rrdb

    flops, nbytes_ = rrdb.rdb_conv_cost(k, n, h, w, itemsize=4)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes_ / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def rdb_bound(n, h, w):
    """K1's or K2's routed bound for one RRDB over ``n`` frames of ``h x w``
    (the frame's work; K2's halo rows are its design's), ``(seconds,
    bound_by)``: three RDBs' five conv floors (:func:`rdb_conv_floor`), one
    after another; bound by what bounds most of it."""
    by_limit = {"operations": 0.0, "bytes": 0.0}
    for k in range(1, 6):
        t, by, _ = rdb_conv_floor(k, n, h, w)
        by_limit[by] += 3 * t
    return sum(by_limit.values()), max(by_limit, key=by_limit.get)


def bwd_launch_floors(site, n, h, w):
    """Each launch of one K3 (an RRDB's backward) or K6 (the tail's) f32
    call on the 3xTF32 kernel, in launch order, over ``n`` frames of ``h x
    w`` (K6: the tail's input): ``[(label, seconds, bound_by)]``, each the
    larger of its operations (3 tf32 products a FLOP at 495 TFLOP/s on the
    tensor cores; conv_last's thin kernels' FLOPs at 67 outside them; the
    upsample-convs' adjoints and weight grads at their 4-phase count, 16
    phase-taps a low-resolution pixel) and its bytes (each input read and
    each output written once) at 3.35 TB/s."""
    from master_thesis_tpu_torch.ops import rrdb, rrdb_bwd, tail_bwd

    def floor(label, flops, nbytes_, rate=PEAK_TF32_FLOPS, products=3):
        t_ops, t_bytes = products * flops / rate, nbytes_ / PEAK_BYTES
        return label, max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    p1 = n * h * w
    if site == "K3":
        ks = rrdb_bwd.k3_config(n, h, w, torch.cuda.get_device_properties(0).multi_processor_count)[-1]
        out = [floor("prep (the third RDB's dP_5)", 0, p1 * 64 * 4 * 2)]
        for j in (3, 2, 1):
            for s_ in (4, 3, 2, 1):
                cin = 192 - 32 * s_
                out.append(floor(f"rdb{j} pull {s_} (gc mode, {cin} -> 32, mask)", 2 * p1 * 9 * cin * 32,
                                 p1 * (cin + 32 + 32) * 4))
            out.append(floor(f"rdb{j} pull 0 (conv mode, 192 -> 64, dx)", 2 * p1 * 9 * 192 * 64,
                             p1 * (192 + 4 * 64 + 64) * 4))
        wflops = 3 * sum(2 * p1 * 9 * ci * co for ci, co in rrdb._widths(64, 32))
        out.append(floor("weight grads (15 convs, weight-grad mode)", wflops, 3 * p1 * 2 * 192 * 4))
        out.append(floor("reduce", 0, (3 * 14 * ks * 9 * 64 * 32 + 3 * rrdb_bwd.RDB_GRAD_NUMEL) * 4))
        return out
    p2, p4 = 4 * p1, 16 * p1
    ks = tail_bwd.k6_config(n, h, w, torch.cuda.get_device_properties(0).multi_processor_count)[-3:]
    out = []
    for k, label in enumerate(("recompute upconv1 (phase mode)", "recompute upconv2 (phase mode)",
                               "recompute hr_conv (conv mode)")):
        t, by, _ = tail_stage_floor(k, n, h, w)
        out.append((label, t, by))
    last = 2 * p4 * 3 * 64 * 9
    out.append(floor("conv_last's weight grad (thin)", last, p4 * (64 + 3) * 4, PEAK_F32_FLOPS, 1))
    out.append(floor("conv_last's adjoint, masked (thin)", last, p4 * (2 * 64 + 3) * 4, PEAK_F32_FLOPS, 1))
    out.append(floor("hr_conv's adjoint (conv mode, mask)", 2 * p4 * 9 * 64 * 64, p4 * 3 * 64 * 4))
    out.append(floor("upconv2's adjoint (conv mode over phase planes, mask)", 2 * p2 * 16 * 64 * 64,
                     (p4 + 2 * p2) * 64 * 4))
    out.append(floor("upconv1's adjoint (conv mode over phase planes)", 2 * p1 * 16 * 64 * 64,
                     (p2 + p1) * 64 * 4))
    items = 2 * ks[0] + 8 * ks[1] + 8 * ks[2]
    out.append(floor("weight grads (hr_conv; upconv2, upconv1 4 phases x 4 taps)",
                     2 * 64 * 64 * (9 * p4 + 16 * p2 + 16 * p1), (2 * p4 + 2 * p2 + 2 * p1) * 64 * 4))
    out.append(floor("reduce (and the phase fold)", 0, (items * 9 * 64 * 32 + tail_bwd.GRAD_NUMEL) * 4))
    return out


def bwd_bound(site, n, h, w):
    """K3's or K6's routed bound, ``(seconds, bound_by)``: its launches'
    floors (:func:`bwd_launch_floors`), one after another; bound by what
    bounds most of it."""
    by_limit = {"operations": 0.0, "bytes": 0.0}
    for _, t, by in bwd_launch_floors(site, n, h, w):
        by_limit[by] += t
    return sum(by_limit.values()), max(by_limit, key=by_limit.get)


def bwd_launch_times(site, fn, n, h, w, kernels):
    """Each launch of one call of K3's or K6's f32 route (``fn``) by its
    device time under ``torch.profiler``, in launch order, beside its floor
    (:func:`bwd_launch_floors`); ``{label: ms}``. A profile that does not
    count one kernel a launch is read again (at most twice), then reported
    and skipped."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    floors = bwd_launch_floors(site, n, h, w)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and re.search(kernels, e.name)),
                     key=lambda e: e.time_range.start)
        if len(evs) == len(floors):
            break
    else:
        print(f"{site} f32 launches: the profile counted {len(evs)} kernels of {len(floors)}; per-launch times "
              "not matched to the launches; the kernels it counted, in order:")
        for e in evs:
            print(f"{site} f32 kernel {e.time_range.elapsed_us() / 1e3:.4f} ms [{e.name[:90]}]")
        return {}
    times = {}
    for i, (e, (label, t, by)) in enumerate(zip(evs, floors)):
        ms = e.time_range.elapsed_us() / 1e3
        times[label] = ms
        print(f"{site} f32 launch {i:2d} {label}: {ms:.4f} ms, floor {1e3 * t:.4f} ms ({by}; {1e3 * t / ms:.1%} "
              f"of it) [{e.name[:60]}]")
    return times


def f32_check_body(base):
    """An RRDB's f32 check: :func:`f32_check` with the relative L2 over the
    part the convs compute (``base``: the RRDB's identity part, ``1.2 x``,
    left out of its norm, as the bf16 checks read it), where a fault is not
    diluted by the input that the RRDB passes through (~6x at these
    weights)."""
    return lambda name, got, want, planted: check(f"{name}, {planted}" if planted else name, got, want, base,
                                                  L2_F32, max_abs=False, planted=bool(planted))


def f32_site(results, key, name, route, plain, cudnn, flops, nbytes_, launches, check_fn, kind,
             first=None, routed=None, library=None):
    """One site's f32 route, whose kernels are ``F32_ROUTES[kind]``: its check
    against the plain version and on each planted fault that can show on
    those kernels, then its device time with its launch count (the kernels
    whose names match the route's pattern), the bound, the 3 x TF32 figure,
    the plain version, the cuDNN route and the library yardstick. ``first``
    : the f32 first design, every conv on conv_f32.cu (K6's recompute on
    the 3xTF32 kernel), checked and timed beside the route, which must be
    faster; ``routed`` (with it): the route's bound, ``(seconds,
    bound_by)`` from :func:`routed_bound`, :func:`tail_bound`,
    :func:`rdb_bound` or :func:`bwd_bound` (the bound at 67 TFLOP/s kept as
    ``bound_f32_ms``); ``library``: the call whose convs the library
    yardstick times (the route's by default; K3's and K6's first design,
    whose convs go through the wrappers :func:`f32_library_ms` records).
    Returns the route's output."""
    kind = F32_ROUTES[kind]
    got, want = route(), plain()
    err = check_fn(f"{key} f32 {name}", got, want, None)
    for fault, flabel in F32_FAULTS.items() if kind.simt_faults else ():
        with planted_f32(fault):
            check_fn(f"{key} f32 {name}", route(), want, flabel)
    for fault in kind.tf32_faults:
        with planted_tf32(fault):
            check_fn(f"{key} f32 {name}", route(), want,
                     f"3xTF32 kernel: {({**TF32_FAULTS, **TF32_BWD_FAULTS})[fault]}")
    if first is not None:
        check_fn(f"{key} f32 first design {name}", first(), want, None)
    # The time is CUDA events' over 3 calls (a route's launches each take
    # 0.05-5 ms, so the host's gaps between them are a few percent at
    # most); beside it the profiler's device time and its count of the
    # f32 kernels, which late in this process falls a few short of the
    # launches (114 of 120 in three readings running on K2).
    ms = cuda_ms(route, iters=3, warmup=1)
    dev_ms, counted = device_ms(route, iters=1, kernels=kind.kernels)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    cudnn_ms = cuda_ms(cudnn, iters=3, warmup=1)
    lib_ms = f32_library_ms(library or route)
    lib_bf16 = f32_library_ms(library or route, torch.bfloat16)
    first_ms = cuda_ms(first, iters=3, warmup=1) if first is not None else None
    t_f32, t_bytes = flops / PEAK_F32_FLOPS, nbytes_ / PEAK_BYTES
    f32_bound = 1e3 * max(t_f32, t_bytes)
    if routed is None:
        b_ms, b_by = f32_bound, ("operations" if t_f32 >= t_bytes else "bytes")
    else:
        b_ms, b_by = 1e3 * routed[0], routed[1]
    tf32 = 1e3 * 3 * flops / PEAK_TF32_FLOPS
    bound = "bound" if routed is None else "bound of the routed convs (3xTF32 at 495, SIMT at 67 TFLOP/s)"
    print(f"kernel {key} f32 {name}: {ms:.4f} ms (CUDA events; device {dev_ms:.4f} ms, {counted} of "
          f"{launches} {kind.label} launches counted), {bound} {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of it), "
          + ("" if routed is None else f"bound at 67 TFLOP/s f32 {f32_bound:.4f} ms, ")
          + f"3xTF32 {tf32:.4f} ms ({tf32 / ms:.1%} of it), plain "
          f"{plain_ms:.4f} ms, cuDNN f32 route {cudnn_ms:.4f} ms, library {lib_ms:.4f} ms (in bf16 "
          f"{lib_bf16:.4f} ms) "
          f"({flops / ms / 1e9:.2f} TFLOP/s)"
          + ("" if first is None else f", first design (conv_f32 alone) {first_ms:.4f} ms"))
    results[f"{key} f32"] = dict(
        name=f"{name}, f32 route ({kind.label})", route="cuda", source=kind.sources[0],
        replaces=F32_REPLACES[key], launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, library_bf16_ms=lib_bf16, cudnn_ms=cudnn_ms, tf32x3_ms=tf32,
        **({"sources": kind.sources} if len(kind.sources) > 1 else {}))
    if first is not None:
        results[f"{key} f32"].update(first_design_ms=first_ms, bound_f32_ms=f32_bound)
        print(f"kernel {key} f32 old vs new: first design (conv_f32 alone) {first_ms:.4f} ms, 3xTF32 route "
              f"{ms:.4f} ms ({first_ms / ms:.3f}x)")
        if ms >= first_ms:
            raise RuntimeError(f"{key}'s f32 route on the 3xTF32 kernel is not faster than its first design")
    return got


def tf32_conv_items(dfpn, vgg):
    """Every conv that the f32 CHN+DFPN step on every kernel route sends to the
    3xTF32 frame kernel, once a shape: ``{(n, h, w, k, cin, cout, swap): [label,
    packed stack, conv index, count]}`` (sep4d's two stages at 5 120 tiles,
    stage 1's last conv with the swap; the mixer at 20 tiles; K8's three
    callers as ``k8_callers`` lists them)."""
    from master_thesis_tpu_torch.ops import conv_stack

    cs = DFPN_BASE // 16
    nt7 = DFPN_B * DFPN_F * cs * cs
    p1, p2 = dfpn.corr.conv.packed()
    stacks = [("sep4d stage 1", p1, (nt7, cs, cs), True), ("sep4d stage 2", p2, (nt7, cs, cs), False),
              ("mixer", dfpn.corr_mixer.packed(), (DFPN_B * DFPN_F, cs, cs), False)]
    meta = lambda *shape: torch.empty(*shape, device="meta")
    for caller, lst in k8_callers(dfpn, vgg, meta, dtype=torch.float32).items():
        stacks += [(f"{caller} {nm}", p, tuple(xx.shape[:3]), False) for nm, p, _, _, xx in lst]
    items = {}
    for label, p, (n, h, w), swap in stacks:
        for i, kind in enumerate(conv_stack.f32_plan(p)):
            if kind != "tf32":
                continue
            k, ci, co = p.specs[i]
            key = (n, h, w, k, ci, co, swap and i == len(p.specs) - 1)
            if key in items:
                items[key][3] += 1
            else:
                items[key] = [f"{label} conv {i}", p, i, 1]
    return items


def phase_tf32_convs(dfpn, vgg):
    """The 3xTF32 frame kernel alone on each shape the f32 CHN+DFPN step gives
    it: held against its plain f32 version (TF32 off) by relative L2
    (``L2_F32``), a rerun bit-identical, each planted fault (the halo-row one
    where a frame has more than one row tile) caught; its time beside its
    floor (the larger of 3 x FLOPs at 495 TFLOP/s and its input, hi and lo
    weights and output at 3.35 TB/s), the f32 bound (67 TFLOP/s), the SIMT
    kernel (``conv_f32_fwd``, the first design's) and one cuDNN ``F.conv2d``
    (f32, TF32 off, channels-last). Returns ``{site: (sum of count x ms,
    sum of count x floor)}``."""
    import torch.nn.functional as F

    from master_thesis_tpu_torch.ops import conv_f32, conv_stack

    g = torch.Generator().manual_seed(SEED + 44)
    sums = {"K7": [0.0, 0.0], "K8": [0.0, 0.0]}
    for (n, h, w, k, ci, co, swap), (label, p, i, count) in tf32_conv_items(dfpn, vgg).items():
        site = "K7" if label.startswith(("sep4d", "mixer")) else "K8"
        x = torch.randn(n, h, w, ci, generator=g).cuda()
        run = lambda: conv_stack.conv_frame_tf32_cuda(x, p, i, swap)
        name = f"TF32 conv {label}, {k}x{k} {ci}->{co} at {n}x{h}x{w}" + (" with the swap" if swap else "")
        got, want = run(), conv_stack.conv_frame_tf32_plain(x, p, i, swap)
        f32_check(name, got, want, None)
        if not torch.equal(got, run()):
            raise RuntimeError(f"{name}: a rerun is not bit-identical")
        tile = conv_stack.frame_tile_tf32(n, h, w, k, co)
        for fault, flabel in TF32_FAULTS.items():
            if (fault == 3 and tile[1] >= h) or fault in (4, 5):
                print(f"planted {name}, {flabel}: not applicable "
                      + {3: "(one row tile a frame)", 4: "(no row window)", 5: "(conv mode)"}[fault])
                continue
            with planted_tf32(fault):
                f32_check(name, run(), want, flabel)
        del got, want
        ms = cuda_ms(run, iters=3, warmup=1)
        out = torch.empty(n, h, w, co, device="cuda")
        bias = p.biases[i].contiguous()
        simt_ms = cuda_ms(lambda: conv_f32.conv_f32_fwd_cuda(x, p.hwio[i], out, bias=bias, k=k,
                                                             epi="relu" if p.relus[i] else "none"),
                          iters=2, warmup=1)
        xc, wc = x.permute(0, 3, 1, 2), channels_last(p.kernels[i])
        lib_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=k // 2), iters=3, warmup=1)
        flops = 2 * n * h * w * ci * co * k * k
        t_ops = 3 * flops / PEAK_TF32_FLOPS
        t_bytes = (nbytes(x) * (ci + co) // ci + nbytes(p.tf32[i])) / PEAK_BYTES
        floor, by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
        f32_bound = 1e3 * max(flops / PEAK_F32_FLOPS, t_bytes)
        print(f"kernel {name} (x{count} a step; tile {tile}): {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), "
              f"3xTF32 floor {floor:.4f} ms ({by}; {floor / ms:.1%} of it), f32 bound {f32_bound:.4f} ms, "
              f"SIMT conv_f32_fwd {simt_ms:.4f} ms, cuDNN f32 F.conv2d {lib_ms:.4f} ms")
        sums[site][0] += count * ms
        sums[site][1] += count * floor
        del x, out, xc
    for site, (ms, floor) in sums.items():
        print(f"kernel TF32 convs of {site} f32, a CHN+DFPN step: {ms:.4f} ms, floor {floor:.4f} ms "
              f"({floor / ms:.1%} of it)")
    return sums


def tail_stage_input(k, n, h, w, g):
    """Stage ``k``'s NHWC f32 input on the card for a tail of an ``(n, 64, h,
    w)`` input: (n, h, w, 64), (n, 2h, 2w, 64) or (n, 4h, 4w, 64)."""
    s = (1, 2, 4, 4)[k]
    return torch.randn(n, s * h, s * w, 64, generator=g).cuda()


def tail_stage_yardsticks(tail_w, k, x, h, w):
    """Stage ``k`` of the f32 tail on ``x`` (its NHWC input; the tail's input
    is ``h x w``) on its yardsticks: ``conv_f32_fwd`` (the SIMT kernel, the
    first design's launch), one cuDNN ``F.conv2d`` (f32, TF32 off,
    channels-last; an upsample-conv at the upsampled size), and its floor
    (:func:`tail_stage_floor`). Returns ``(simt_ms, cudnn_ms, floor_ms,
    bound_by, flops)``."""
    import torch.nn.functional as F

    from master_thesis_tpu_torch.ops import conv_f32, tail

    name, up, epi = tail.F32_STAGES[k]
    n, hh, ww, _ = x.shape
    s = 2 if up else 1
    out = torch.empty(n, s * hh, s * ww, tail_w[f"{name}_hwio"].shape[3], device="cuda")
    simt_ms = cuda_ms(lambda: conv_f32.conv_f32_fwd_cuda(x, tail_w[f"{name}_hwio"], out,
                                                         bias=tail_w[f"{name}_b"], up=up, epi=epi),
                      iters=3, warmup=1)
    del out
    xc = channels_last(torch.randn(n, 64, s * hh, s * ww, device="cuda"))
    wc = channels_last(tail_w[f"{name}_oihw"])
    cudnn_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), iters=3, warmup=1)
    del xc
    floor, by, flops = tail_stage_floor(k, n, h, w)
    return simt_ms, cudnn_ms, 1e3 * floor, by, flops


def phase_tail_stages_tf32(tail_w):
    """K4's four f32 stages alone on the 3xTF32 kernel at 80 x 64^2, then the
    four launches of one K5 band (the second of 8 x 128x256 in 32-row bands:
    upconv1 reads the frame in place, each later stage a band buffer whose
    row 0 is the frame's x_row0 > 0): each held against its plain f32
    version (TF32 off) by relative L2 (``L2_F32``), a rerun bit-identical,
    each planted fault that applies caught (the halo-row one where a launch
    has more than one row tile, the band one where x_row0 > 0); its time
    beside its floor (the larger of 3 x its FLOPs at 495 TFLOP/s, the
    upsample-convs in their 4-phase form, and its input and output at 3.35
    TB/s), ``conv_f32_fwd`` (the first design's launch) and one cuDNN
    ``F.conv2d`` (f32, TF32 off; an upsample-conv at the upsampled size).
    K4's four floors sum to its routed bound (:func:`tail_bound`)."""
    from torch.nn import functional as nnf

    from master_thesis_tpu_torch.ops import conv_f32, conv_stack, tail

    g = torch.Generator().manual_seed(SEED + 45)
    n, h, w = B * F, H // 4, W // 4
    plans = tail.f32_band_plans(BAND_H, tail.TAIL_BAND_ROWS)[1]
    xb = torch.randn(BAND_N, BAND_H, BAND_WS[1], 64, generator=g).cuda()
    launches = [(f"K4 f32 stage {TAIL_STAGES[k]} at {n}x{h}x{w}", k, tail_stage_input(k, n, h, w, g), {})
                for k in range(4)]
    for k in range(4):  # the band's launches: the windows of tail_banded_f32
        (lo, hi), rows = plans[k], plans[k + 1]
        x = xb if k == 0 else torch.randn(BAND_N, hi - lo, BAND_WS[1] * (1, 2, 4, 4)[k], 64, generator=g).cuda()
        window = dict(hin=BAND_H * (1, 2, 4, 4)[k], rows=rows, x_row0=0 if k == 0 else lo, out_row0=rows[0])
        launches.append((f"K5 f32 band 2 stage {TAIL_STAGES[k]} at {BAND_N}x{BAND_H}x{BAND_WS[1]}, rows "
                         f"{rows[0]}-{rows[1]} from x_row0 {window['x_row0']}", k, x, window))
    floors = 0.0
    for label, k, x, window in launches:
        name, up, epi = tail.F32_STAGES[k]
        mode = tail.TF32_MODES[k]
        s = 2 if up else 1
        co = 3 if k == 3 else 64
        hin = window.get("hin", x.shape[1])
        r0, r1 = window.get("rows", (0, s * hin))
        out_shape = (x.shape[0], r1 - r0, s * x.shape[2], co)
        run = lambda: tail.tail_stage_tf32_cuda(k, x, tail_w, torch.empty(out_shape, device="cuda"), **window)
        got = run()
        want = tail.tail_stage_tf32_plain(k, x, tail_w, torch.empty(out_shape, device="cuda"), **window)
        label = f"{label} ({mode} mode)"
        f32_check(label, got, want, None)
        if not torch.equal(got, run()):
            raise RuntimeError(f"{label}: a rerun is not bit-identical")
        cy0, cy1 = (r0 // 2, (r1 + 1) // 2) if up else (r0, r1)
        x_row0 = window.get("x_row0", 0)
        tile = conv_stack.tf32_tile(mode, x.shape[0], hin, x.shape[2], 3, 256 if up else co, cy0, cy1, x_row0)
        for fault, flabel in TF32_FAULTS.items():
            if (fault == 3 and tile[1] >= cy1 - cy0) or (fault == 4 and x_row0 == 0) or fault == 5:
                print(f"planted {label}, {flabel}: not applicable "
                      + {3: "(one row tile)", 4: "(x_row0 0)", 5: "(not gc mode)"}[fault])
                continue
            with planted_tf32(fault):
                f32_check(label, run(), want, flabel)
        del got, want
        ms = cuda_ms(run, iters=3, warmup=1)
        if not window:
            simt_ms, cudnn_ms, floor, by, flops = tail_stage_yardsticks(tail_w, k, x, h, w)
            floors += floor
        else:
            out = torch.empty(out_shape, device="cuda")
            simt_ms = cuda_ms(lambda: conv_f32.conv_f32_fwd_cuda(x, tail_w[f"{name}_hwio"], out,
                                                                 bias=tail_w[f"{name}_b"], up=up, epi=epi,
                                                                 **window), iters=3, warmup=1)
            xc = channels_last(torch.randn(x.shape[0], 64, r1 - r0, s * x.shape[2], device="cuda"))
            wc = channels_last(tail_w[f"{name}_oihw"])
            cudnn_ms = cuda_ms(lambda: nnf.conv2d(xc, wc, padding=1), iters=3, warmup=1)
            flops = 2 * x.shape[0] * (r1 - r0) * s * x.shape[2] * (4 if up else 9) * 64 * co
            t_ops = 3 * flops / PEAK_TF32_FLOPS
            t_bytes = (nbytes(x[:, max(cy0 - 1 - x_row0, 0):]) + 4 * math.prod(out_shape)) / PEAK_BYTES
            floor, by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
            del out, xc
        print(f"kernel {label} (tile {tile}): {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), floor {floor:.4f} ms "
              f"({by}; {floor / ms:.1%} of it), SIMT conv_f32_fwd {simt_ms:.4f} ms ({simt_ms / ms:.2f}x), "
              f"cuDNN f32 F.conv2d {cudnn_ms:.4f} ms")
    print(f"kernel K4 f32 stages: floors summed {floors:.4f} ms")


def rdb_conv_yardsticks(k, x, p, out, conv_kw, padded):
    """Conv ``k`` (0..4) of the f32 RDB ``p`` on ``x`` (its input's view of the
    dense concat) on its yardsticks: ``conv_f32_fwd`` (the SIMT kernel, the
    first design's launch), one cuDNN ``F.conv2d`` (f32, TF32 off,
    channels-last), and with ``padded`` (whole frames) for conv1..conv4 the
    padded form of the 3xTF32 kernel (conv mode with Cout padded 32 -> 64,
    into scratch; the design gc mode was weighed against), checked against
    the plain conv. Returns ``(simt_ms, cudnn_ms, padded_ms)``."""
    import torch.nn.functional as nnf

    from master_thesis_tpu_torch.ops import conv_f32, conv_stack, fragments, rrdb

    simt_ms = cuda_ms(lambda: conv_f32.conv_f32_fwd_cuda(x, rrdb.hwio_kernels(p)[k], out, **conv_kw),
                      iters=3, warmup=1)
    xc = channels_last(x.permute(0, 3, 1, 2))
    wc = channels_last(p.kernels[k])
    cudnn_ms = cuda_ms(lambda: nnf.conv2d(xc, wc, padding=1), iters=3, warmup=1)
    del xc
    padded_ms = None
    if padded and k < 4:
        w64 = nnf.pad(p.kernels[k], (0, 0, 0, 0, 0, 0, 0, 32))
        mat = fragments.wgmma_tf32_matrix(w64).contiguous()
        b64 = nnf.pad(conv_kw["bias"], (0, 32)).contiguous()
        scratch = torch.empty(x.shape[0], x.shape[1], x.shape[2], 64, device="cuda")
        run = lambda: conv_stack.tf32_launch(x, mat, b64, scratch, mode="conv", k=3, cout=64, epi="leaky")
        run()
        want = torch.empty_like(scratch[..., :32])
        rrdb.rdb_conv_tf32_plain(k, x, p, want)
        n, h, w = x.shape[:3]
        f32_check(f"K1 f32 conv{k + 1} in the padded conv mode at {n}x{h}x{w}", scratch[..., :32], want, None)
        padded_ms = cuda_ms(run, iters=3, warmup=1)
        del scratch, mat
    return simt_ms, cudnn_ms, padded_ms


def phase_rdb_convs_tf32(rdbs):
    """K1's five f32 launches alone on the 3xTF32 kernel at 80 x 64^2
    (conv1..conv4 in gc mode over the dense concat, conv5 in conv mode with
    both residuals), then the five of one K2 band (the second of 8 x
    128x256 in 32-row bands: the band buffer's row 0 is frame row 27): each
    held against its plain f32 version (TF32 off) by relative L2
    (``L2_F32``; conv5's over its output less its residuals' part, 0.2 r +
    r2), a rerun bit-identical, each planted fault that applies
    caught (the halo-row one where a launch has more than one row tile, the
    band one where its rows read row x_row0, the gc one in gc mode); its
    time beside its floor (:func:`rdb_conv_floor`), ``conv_f32_fwd`` (the
    first design's launch), one cuDNN ``F.conv2d`` (f32, TF32 off) and, for
    conv1..conv4 at 80 x 64^2, the padded conv mode. Returns ``(ms,
    floor_ms)`` of an RRDB's 15 launches at 80 x 64^2."""
    from master_thesis_tpu_torch.ops import conv_stack, rrdb

    g = torch.Generator().manual_seed(SEED + 46)
    p = rdbs[2]  # the third RDB: conv5 adds the RRDB residual too
    n, h, w = B * F, H // 4, W // 4
    nf, gc = rrdb.KERNEL_NF, rrdb.KERNEL_GC
    launches = []
    cat = torch.randn(n, h, w, nf + 4 * gc, generator=g).cuda()
    res = torch.randn(n, h, w, nf, generator=g).cuda()
    for k in range(5):
        x = cat[..., :nf + k * gc] if k < 4 else cat
        out = cat[..., nf + k * gc: nf + (k + 1) * gc] if k < 4 else torch.empty(n, h, w, nf, device="cuda")
        kw = {} if k < 4 else dict(r=cat[..., :nf], r2=res)
        launches.append((f"K1 f32 conv{k + 1} at {n}x{h}x{w}", k, x, out, kw, {}))
    lo = rrdb.TRUNK_BAND_ROWS - rrdb.BAND_HALO  # band 2, rows [32, 64), with its 5-row halo
    hi = 2 * rrdb.TRUNK_BAND_ROWS + rrdb.BAND_HALO
    wins = rrdb.band_windows(BAND_H, rrdb.TRUNK_BAND_ROWS, 2 * rrdb.TRUNK_BAND_ROWS)
    bn, bw_ = BAND_N, BAND_WS[1]
    band = torch.randn(bn, hi - lo, bw_, nf + 4 * gc, generator=g).cuda()
    frame_x = torch.randn(bn, BAND_H, bw_, nf, generator=g).cuda()
    for k in range(5):
        x = band[..., :nf + k * gc] if k < 4 else band
        if k < 4:
            out, kw = band[..., nf + k * gc: nf + (k + 1) * gc], dict(rows=wins[k], hin=BAND_H, x_row0=lo, out_row0=lo)
        else:
            out = torch.empty(bn, BAND_H, bw_, nf, device="cuda")
            kw = dict(rows=wins[k], hin=BAND_H, x_row0=lo, r=frame_x)
        launches.append((f"K2 f32 band 2 conv{k + 1} at {bn}x{BAND_H}x{bw_}, rows {wins[k][0]}-{wins[k][1]} from "
                         f"x_row0 {lo}", k, x, out, kw, {"band": True}))
    ms_sum = floor_sum = 0.0
    for label, k, x, out, kw, opt in launches:
        mode = "gc" if k < 4 else "conv"
        label = f"{label} ({mode} mode)"
        run = lambda: rrdb.rdb_conv_tf32_cuda(k, x, p, out, **kw)
        want = rrdb.rdb_conv_tf32_plain(k, x, p, torch.empty_like(out), **kw)
        r0, r1 = kw.get("rows", (0, x.shape[1]))
        sl = slice(r0 - kw.get("out_row0", 0), r1 - kw.get("out_row0", 0))
        # conv5's output is mostly its residuals (0.2 r + r2): read it over the
        # part its products make, as the RRDB checks read the RRDB's body.
        base = None if k < 4 else 0.2 * kw["r"][:, sl] + (0 if kw.get("r2") is None else kw["r2"][:, sl])
        chk = lambda got_, planted: check(f"{label}, {planted}" if planted else label, got_, want[:, sl], base,
                                          L2_F32, max_abs=False, planted=bool(planted))
        run()
        got = out[:, sl].clone()
        chk(got, None)
        run()
        if not torch.equal(got, out[:, sl]):
            raise RuntimeError(f"{label}: a rerun is not bit-identical")
        hin = kw.get("hin", x.shape[1])
        x_row0 = kw.get("x_row0", 0)
        tile = conv_stack.tf32_tile(mode, x.shape[0], hin, x.shape[2], 3, gc if k < 4 else nf, r0, r1, x_row0)
        for fault, flabel in TF32_FAULTS.items():
            why = {3: "(one row tile)" if tile[1] >= r1 - r0 else None,
                   4: "(its rows do not read row x_row0)" if x_row0 == 0 or r0 - 1 > x_row0 else None,
                   5: "(conv mode)" if k == 4 else None}.get(fault)
            if why:
                print(f"planted {label}, {flabel}: not applicable {why}")
                continue
            with planted_tf32(fault):
                run()
                chk(out[:, sl], flabel)
        run()
        ms = cuda_ms(run, iters=3, warmup=1)
        conv_kw = dict(rrdb._conv_args(k, p, kw.get("r"), kw.get("r2")),
                       **{a: kw[a] for a in ("rows", "hin", "x_row0", "out_row0") if a in kw})
        simt_ms, cudnn_ms, padded_ms = rdb_conv_yardsticks(k, x, p, out, conv_kw, not opt)
        if opt:
            flops = 2 * x.shape[0] * (r1 - r0) * x.shape[2] * 9 * x.shape[3] * out.shape[3]
            t_ops = 3 * flops / PEAK_TF32_FLOPS
            t_bytes = 4 * x.shape[0] * x.shape[2] * ((r1 - r0 + 2) * x.shape[3] + (r1 - r0) * out.shape[3]) / PEAK_BYTES
            floor, by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
        else:
            t, by, flops = rdb_conv_floor(k + 1, n, h, w)
            floor = 1e3 * t
            ms_sum += 3 * ms
            floor_sum += 3 * floor
        print(f"kernel {label} (tile {tile}): {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), floor {floor:.4f} ms "
              f"({by}; {floor / ms:.1%} of it), SIMT conv_f32_fwd {simt_ms:.4f} ms ({simt_ms / ms:.2f}x), "
              f"cuDNN f32 F.conv2d {cudnn_ms:.4f} ms"
              + ("" if padded_ms is None else f", padded conv mode (Cout 32 -> 64) {padded_ms:.4f} ms "
                 f"({padded_ms / ms:.2f}x)"))
        del got, want
    print(f"kernel K1 f32 convs, an RRDB's 15 launches at {n}x{h}x{w}: {ms_sum:.4f} ms, floors {floor_sum:.4f} ms "
          f"({floor_sum / ms_sum:.1%} of it)")
    del cat, res, band, frame_x, launches
    return ms_sum, floor_sum


def f32_check(name, got, want, planted):
    return check(f"{name}, {planted}" if planted else name, got, want, None, L2_F32, max_abs=False,
                 planted=bool(planted))


def f32_check_groups(name, got, want, planted):
    worst = check_groups(name, got, want, L2_F32, planted=planted or None)
    return max((got[k] - want[k]).abs().max().item() for k in want) if not planted else worst


def record_bf16_library(results, lib7, lib8):
    """The bf16 table's library column: each site's yardstick (one
    ``F.conv2d`` / ``conv2d_weight`` a launch, bf16, channels-last, summed)
    over the convs its f32 route (K3, K6: first design) records at the bf16
    rows' shapes, into the bf16 rows where this run made them; K7's sep4d
    and mixer, K8 by caller. Printed either way."""
    for k in ("K1", "K2", "K3", "K4", "K5", "K6"):
        ms = results[f"{k} f32"]["library_bf16_ms"]
        print(f"library {k} bf16 (one F.conv2d / conv2d_weight a launch, bf16, channels-last): {ms:.4f} ms")
        if k in results:
            results[k]["library_ms"] = ms
    print(f"library K7 bf16: sep4d {lib7['sep4d']:.4f} ms, mixer {lib7['mixer']:.4f} ms; K8 bf16: "
          + ", ".join(f"{label} {ms:.4f} ms" for label, ms in lib8.items()))
    if "K7" in results:
        results["K7"].update(library_ms=lib7["sep4d"], mixer_library_ms=lib7["mixer"])
    if "K8" in results:
        results["K8"]["library_ms"] = lib8["flow_256"]
        results["K8"].update({f"{label}_library_ms": ms for label, ms in lib8.items()})


def bwd_rerun(site, first, again):
    """K3's or K6's f32 route run twice on the same input: every output
    (dx, each dW and db) bit for bit the same, or the run fails."""
    same = all(torch.equal(first[k], again[k]) for k in first)
    print(f"check {site} f32 rerun bit-identical (dx, every dW and db): " + ("ok" if same else "FAIL"))
    if not same:
        raise RuntimeError(f"{site}'s f32 route is not bit-identical between two runs")


def live_mixer(dfpn):
    """The correlation mixer packed in f32 with the biases of conv 10 and the
    three after it at 0, for K7's f32 check. At the seeded weights conv 10's 4
    channels are below 0 before their ReLU for every input (biases -0.08 to
    -0.25), so the mixer's output is its tail's biases alone and no fault
    upstream can show in it; with these 4 biases at 0 the part of the output
    that its input moves is ~25% of its norm, and the route's work is the
    same."""
    from master_thesis_tpu_torch.models.dfpn import _convs
    from master_thesis_tpu_torch.ops import conv_stack

    convs, relus = _convs(dfpn.corr_mixer.mixer)
    return conv_stack.pack_stack([(c.weight, torch.zeros_like(c.bias) if i >= 10 else c.bias)
                                  for i, c in enumerate(convs)], relus, torch.float32)


def phase_f32(results, device_line):
    """Every site's f32 route on the card (phase 14): held against its
    plain f32 version by relative L2 (TF32 off) and read on both planted
    faults, timed beside its bound, the 3 x TF32 figure, the plain version,
    the cuDNN route and the library yardstick; then the f32 CPN serving
    step, the f32 CHN train step (grads against the plain routes') and a
    CHN+DFPN step on every kernel route in f32, full width, nb 20, 256x256,
    with their launches."""
    from master_thesis_tpu_torch.models.chn import CHN, chn_infer_apply
    from master_thesis_tpu_torch.models.cpn import CPN
    from master_thesis_tpu_torch.models.vgg import VGGFeatures
    from master_thesis_tpu_torch.ops import conv_stack, rrdb, rrdb_bwd, tail, tail_bwd
    from master_thesis_tpu_torch.ops.conv_f32 import nhwc as nhwc32
    from master_thesis_tpu_torch.train import chn_task, state
    from master_thesis_tpu_torch.train.build import build_dfpn, dfpn_align_fn

    t_phase = time.perf_counter()
    f32 = torch.float32
    g = torch.Generator().manual_seed(SEED + 40)
    rnd = lambda *s: torch.randn(*s, generator=g).cuda()
    chn = CHN(nb=NB, dtype=f32, generator=torch.Generator().manual_seed(SEED + 1)).eval()
    trunk_w, tail_w = chn.nn.packed()
    rdbs = trunk_w[0]
    n, h, w = B * F, H // 4, W // 4  # the bf16 checks' main-path shapes: 80 x 64^2
    with torch.inference_mode():
        # K1 / K4 at 80 x 64^2; K2 / K5 at 8 x 128 x 256 in bands.
        x = channels_last(rnd(n, 64, h, w))
        f32_site(results, "K1", "RRDB (3 RDBs x 5 convs)", lambda: rrdb.rrdb_trunk(x, [rdbs]),
                 lambda: rrdb.rrdb_trunk(x, [rdbs], rdb_fn=rrdb.rdb_plain), lambda: rrdb_cudnn(x, rdbs),
                 3 * rrdb.rdb_flops(n, h, w), 2 * nbytes(x), 3 * rrdb.RDB_CONVS, f32_check_body(1.2 * x),
                 kind="rdb", first=lambda: rrdb.rrdb_trunk(x, [rdbs], rdb_fn=rrdb.rdb_f32_first),
                 routed=rdb_bound(n, h, w))
        # The train step's forward runs K1 on 8 frames: too few tiles for 132
        # SMs to be the serving step's tenth.
        xt = x[:TRAIN_B]
        t_new = cuda_ms(lambda: rrdb.rrdb_trunk(xt, [rdbs]), iters=3, warmup=1)
        t_first = cuda_ms(lambda: rrdb.rrdb_trunk(xt, [rdbs], rdb_fn=rrdb.rdb_f32_first), iters=3, warmup=1)
        print(f"kernel K1 f32 at the train step's {TRAIN_B}x64x{h}x{w}: {t_new:.4f} ms, first design (conv_f32 "
              f"alone) {t_first:.4f} ms ({t_first / t_new:.2f}x), bound {1e3 * rdb_bound(TRAIN_B, h, w)[0]:.4f} ms")
        f32_site(results, "K4", "tail (4 convs)", lambda: tail.tail(x, tail_w),
                 lambda: tail.tail_plain(x, tail_w), lambda: tail_cudnn(x, tail_w),
                 tail.tail_flops(n, h, w), nbytes(x) + n * 3 * 16 * h * w * 4, tail.TAIL_KERNELS,
                 f32_check, kind="tail", first=lambda: tail.tail_f32_first(x, tail_w), routed=tail_bound(n, h, w))
        del x
        xb = channels_last(rnd(BAND_N, 64, BAND_H, BAND_WS[1]))
        bands_k2 = len(rrdb.bands(BAND_H, rrdb.TRUNK_BAND_ROWS))
        k2 = f32_site(results, "K2", f"RRDB in {rrdb.TRUNK_BAND_ROWS}-row bands",
                      lambda: rrdb.rrdb_trunk_banded(xb, [rdbs]),
                      lambda: rrdb.rrdb_trunk_banded_plain(xb, [rdbs]), lambda: rrdb_cudnn(xb, rdbs),
                      3 * rrdb.rdb_flops(BAND_N, BAND_H, BAND_WS[1]), 2 * nbytes(xb),
                      3 * rrdb.RDB_CONVS * bands_k2, f32_check_body(1.2 * xb), kind="rdb in bands",
                      first=lambda: rrdb.rrdb_trunk(xb, [rdbs], rdb_fn=functools.partial(
                          rrdb.rdb_banded_f32_first, band_rows=rrdb.TRUNK_BAND_ROWS)),
                      routed=rdb_bound(BAND_N, BAND_H, BAND_WS[1]))
        # K2 sums each output's products in K1's order: the two agree bit for
        # bit on an input both take.
        k1 = rrdb.rrdb_trunk(xb, [rdbs])
        print(f"check K2 f32 == K1 f32 at {BAND_N}x64x{BAND_H}x{BAND_WS[1]}, bit for bit: "
              + ("ok" if torch.equal(k2, k1) else f"FAIL (max|diff| {(k2 - k1).abs().max().item():.3g})"))
        if not torch.equal(k2, k1):
            raise RuntimeError("K2's f32 route does not equal K1's bit for bit")
        del k1, k2
        bands_k5 = len(rrdb.bands(BAND_H, tail.TAIL_BAND_ROWS))
        k5 = f32_site(results, "K5", f"tail in {tail.TAIL_BAND_ROWS}-row bands",
                      lambda: tail.tail_banded(xb, tail_w), lambda: tail.tail_banded_plain(xb, tail_w),
                      lambda: tail_cudnn(xb, tail_w), tail.tail_flops(BAND_N, BAND_H, BAND_WS[1]),
                      nbytes(xb) + BAND_N * 3 * 16 * BAND_H * BAND_WS[1] * 4, tail.TAIL_KERNELS * bands_k5,
                      f32_check, kind="tail in bands", first=lambda: tail.tail_banded_f32_first(xb, tail_w),
                      routed=tail_bound(BAND_N, BAND_H, BAND_WS[1]))
        # K5 sums each output's products in K4's order: the two agree bit for
        # bit on an input both take.
        k4 = tail.tail(xb, tail_w)
        print(f"check K5 f32 == K4 f32 at {BAND_N}x64x{BAND_H}x{BAND_WS[1]}, bit for bit: "
              + ("ok" if torch.equal(k5, k4) else f"FAIL (max|diff| {(k5 - k4).abs().max().item():.3g})"))
        if not torch.equal(k5, k4):
            raise RuntimeError("K5's f32 route does not equal K4's bit for bit")
        del xb, k4, k5
        phase_tail_stages_tf32(tail_w)
        results["K1 f32"].update(zip(("tf32_convs_ms", "tf32_convs_floor_ms"), phase_rdb_convs_tf32(rdbs)))
    with torch.no_grad():
        # K3 / K6 at the train step's 8 x 64^2.
        nt = TRAIN_B
        x, gy = channels_last(rnd(nt, 64, h, w)), channels_last(rnd(nt, 64, h, w))
        _, kept = rrdb_bwd.rrdb_forward_kept_f32(x, rdbs)
        convs = rrdb.rrdb_convs(chn.nn.rrdb_trunk[0])
        pulls, pulls_first = rrdb_bwd.pack_rdb_pulls_tf32(convs), rrdb_bwd.pack_rdb_pulls_f32(convs)

        def k3():
            dx, flat = rrdb_bwd.rrdb_bwd(x, gy, rdbs, pulls, kept)
            return rrdb_groups(dx, rrdb_bwd.rdb_grads(flat))

        def k3_first():
            dx, flat = rrdb_bwd.rrdb_bwd_f32_first(x, gy, rdbs, pulls_first, kept)
            return rrdb_groups(dx, rrdb_bwd.rdb_grads(flat))

        # The backward checks' plain versions sum in f64: cuDNN's f32 weight
        # grads (TF32 off) read 8.7e-6 to 3.5e-5 from f64 at these sizes, the
        # kernel's 3e-7 (PERF.md, Findings).
        rdbs64 = [rrdb.PackedRDB(None, p.b.double(), tuple(k.double() for k in p.kernels)) for p in rdbs]
        kept64 = ([t.double() for t in kept[0]], [c[..., 64:].permute(0, 3, 1, 2).double() for c in kept[1]])

        def k3_plain():
            dx, grads = rrdb_bwd.rrdb_bwd_plain(x.double(), gy.double(), rdbs64, kept64)
            return rrdb_groups(dx, grads)

        bwd_cudnn = rrdb_cudnn_backward(x, rdbs)
        k3_out = f32_site(results, "K3", "RRDB backward", k3, k3_plain, lambda: bwd_cudnn(gy),
                          rrdb_bwd.rrdb_bwd_flops(nt, h, w), 3 * nbytes(x) + sum(nbytes(c) for c in kept[1]),
                          rrdb_bwd.RRDB_BWD_F32_KERNELS, f32_check_groups, kind="rrdb bwd", first=k3_first,
                          routed=bwd_bound("K3", nt, h, w), library=k3_first)
        bwd_rerun("K3", k3_out, k3())
        results["K3 f32"]["launch_ms"] = bwd_launch_times("K3", k3, nt, h, w, F32_ROUTES["rrdb bwd"].kernels)
        del kept, kept64, bwd_cudnn, k3_out
        gt = channels_last(rnd(nt, 3, 4 * h, 4 * w))

        def k6():
            dx, grads = tail_bwd.tail_bwd(x, gt, tail_w)
            return {"dx": dx, **grads}

        # The plain version takes its masks from the route's own recompute
        # (K4's stages, checked above), as K3's reads the kept activations:
        # an f32 recompute and an f64 one differ in the sign of an odd one
        # of 33.5 M activations, and one flipped mask moves a bias grad
        # summed over 0.5 M pixels by ~1e-3 of it.
        tail64 = {k: v.double() for k, v in tail_w.items()}
        kept6 = [t.permute(0, 3, 1, 2).double() for t in tail.tail_f32_stages(nhwc32(x), tail_w, keep=3)]

        def k6_plain():
            dx, grads = tail_bwd.tail_bwd_plain(x.double(), gt.double(), tail64, hidden=kept6)
            return {"dx": dx, **grads}

        leaves = [(channels_last(tail_w[f"{k}_oihw"]).requires_grad_(), tail_w[f"{k}_b"].clone().requires_grad_())
                  for k in ("up1", "up2", "hr", "last")]
        xs = x.detach().requires_grad_()
        with torch.enable_grad():
            yt = tail_cudnn(xs, tail_w, leaves)
        flat_leaves = [xs] + [t for pair in leaves for t in pair]
        adj_first = tail_bwd.pack_tail_bwd_f32(tail_w)

        def k6_first():
            dx, grads = tail_bwd.tail_bwd_f32_first(x, gt, tail_w, adj_first)
            return {"dx": dx, **grads}

        k6_out = f32_site(results, "K6", "tail backward", k6, k6_plain,
                          lambda: torch.autograd.grad(yt, flat_leaves, gt, retain_graph=True),
                          tail_bwd.tail_bwd_flops(nt, h, w), 2 * nbytes(x) + nbytes(gt),
                          tail_bwd.TAIL_BWD_F32_KERNELS, f32_check_groups, kind="tail bwd", first=k6_first,
                          routed=bwd_bound("K6", nt, h, w), library=k6_first)
        bwd_rerun("K6", k6_out, k6())
        results["K6 f32"]["launch_ms"] = bwd_launch_times("K6", k6, nt, h, w, F32_ROUTES["tail bwd"].kernels)
        del x, gy, gt, yt, leaves, xs, kept6, k6_out

    dfpn = build_dfpn(base_size=DFPN_BASE, dtype=f32, generator=torch.Generator().manual_seed(SEED + 5))
    vgg = VGGFeatures(dtype=f32, generator=torch.Generator().manual_seed(SEED + 6))
    with torch.inference_mode():
        tf32_sums = phase_tf32_convs(dfpn, vgg)
        # K7: sep4d's two stages (5 120 tiles) and the mixer (20 tiles).
        p1, p2 = dfpn.corr.conv.packed()
        cs = DFPN_BASE // 16
        nt7 = DFPN_B * DFPN_F * cs * cs
        x1 = rnd(nt7, 1, cs, cs).contiguous(memory_format=torch.channels_last)
        y1 = conv_stack.conv_stack_tiles_cl(x1, p1, swap=True)
        x2 = y1.detach()
        mix = live_mixer(dfpn)
        xm = rnd(DFPN_B * DFPN_F, cs * cs, cs, cs).contiguous(memory_format=torch.channels_last)
        stacks7 = ((x1, p1, True), (x2, p2, False), (xm, mix, False))

        def k7():
            return {f"stage {i}": conv_stack.conv_stack_tiles_cl(xx, p, swap=s)
                    for i, (xx, p, s) in enumerate(stacks7)}

        def k7_plain():
            return {f"stage {i}": conv_stack.conv_stack_tiles_cl_plain(xx, p, swap=s)
                    for i, (xx, p, s) in enumerate(stacks7)}

        def k7_cudnn():
            return [conv_stack.conv_stack_plain(xx, p) for xx, p, _ in stacks7]

        def k7_first():
            return {f"stage {i}": conv_stack.conv_stack_tiles_cl_f32_first(xx, p, swap=s)
                    for i, (xx, p, s) in enumerate(stacks7)}

        k7_bytes = sum(2 * nbytes(xx) for xx, _, _ in stacks7) + nbytes(y1)
        f32_site(results, "K7", "sep4d's two stages and the mixer", k7, k7_plain, k7_cudnn,
                 sum(conv_stack.stack_flops(p, xx.shape[0], cs, cs) for xx, p, _ in stacks7),
                 k7_bytes, sum(len(p.specs) for _, p, _ in stacks7), f32_check_groups, kind="tf32+simt",
                 first=k7_first,
                 routed=routed_bound([(p, xx.shape[0], cs, cs) for xx, p, _ in stacks7], k7_bytes))
        lib7 = {part: f32_library_ms(lambda st=st: [conv_stack.conv_stack_tiles_cl(xx, p, swap=sw)
                                                    for xx, p, sw in st], torch.bfloat16)
                for part, st in (("sep4d", stacks7[:2]), ("mixer", stacks7[2:]))}
        del x1, y1, x2, xm
        # K8: flow_256's and flow_64's segments and VGG's pool-4 tower.
        callers8 = k8_callers(dfpn, vgg, lambda *s: rnd(*s), dtype=f32)
        lib8 = {label: f32_library_ms(lambda lst=lst: [conv_stack.conv_stack_banded(xx, p) for _, p, _, _, xx in lst],
                                      torch.bfloat16) for label, lst in callers8.items()}
        items = [it for lst in callers8.values() for it in lst]

        def k8():
            return {nm: conv_stack.conv_stack_banded(xx, p) for nm, p, _, _, xx in items}

        def k8_plain():
            return {nm: conv_stack.conv_stack_banded_plain(xx, p) for nm, p, _, _, xx in items}

        def k8_cudnn():
            return [module_stack(cv, rl, xx.permute(0, 3, 1, 2)) for _, _, cv, rl, xx in items]

        def k8_first():
            return {nm: conv_stack.conv_stack_banded_f32_first(xx, p) for nm, p, _, _, xx in items}

        outs8 = k8()
        k8_bytes = sum(nbytes(xx) + nbytes(outs8[nm]) for nm, _, _, _, xx in items)
        f32_site(results, "K8", "flow_256 / flow_64 segments and VGG pool-4", k8, k8_plain, k8_cudnn,
                 sum(conv_stack.stack_flops(p, xx.shape[0], xx.shape[1], xx.shape[2]) for _, p, _, _, xx in items),
                 k8_bytes, sum(len(p.specs) for _, p, _, _, _ in items), f32_check_groups, kind="tf32+simt",
                 first=k8_first, routed=routed_bound([(p, *xx.shape[:3]) for _, p, _, _, xx in items], k8_bytes))
        del items, outs8, callers8
        record_bf16_library(results, lib7, lib8)
        for site, (ms, floor) in tf32_sums.items():
            results[f"{site} f32"].update(tf32_convs_ms=ms, tf32_convs_floor_ms=floor)
        tf32_want = (sum(count for *_, count in tf32_conv_items(dfpn, vgg).values()) + tail.TAIL_KERNELS
                     + 3 * NB * rrdb.RDB_CONVS)

    # Beside the sites' counters, the 3xTF32 kernel's (K7's and K8's routed
    # convs, the tail's stages).
    counters = {**f32_counters(), "TF32": conv_stack.conv_frame_tf32_cuda}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    # The f32 CPN serving step: CPN.align, then the CHN on the kernels.
    cpn = CPN(dtype=f32, generator=torch.Generator().manual_seed(SEED)).eval()
    inputs = make_inputs(F32_SERVE_B, F, H, W, SEED + 41)

    def serve(x_t, m_t, x_r, m_r):
        aligned = cpn.align(x_t, m_t, x_r, m_r)
        return chn_infer_apply(chn, x_t, 1 - m_t.float(), *aligned)

    with torch.inference_mode():
        (y_hat, y_comp), counts = counted(lambda: serve(*inputs))
        want = {**dict.fromkeys(counters, 0), "K1": 3 * NB * rrdb.RDB_CONVS, "K4": tail.TAIL_KERNELS,
                "TF32": tail.TAIL_KERNELS + 3 * NB * rrdb.RDB_CONVS}
        print(f"f32 serving step launches: {counts} (expected {want})")
        if counts != want:
            raise RuntimeError("the f32 serving step did not launch each f32 route as expected")
        results["K1 f32"]["launches"], results["K4 f32"]["launches"] = counts["K1"], counts["K4"]
        if not torch.isfinite(y_hat).all() or y_hat.min() < 0 or y_hat.max() > 1:
            raise RuntimeError("f32 serving step: y_hat not finite in [0, 1]")
        with f32_plain_convs():
            y_plain, _ = serve(*inputs)
        rel = rel_l2(y_hat, y_plain)
        print(f"check f32 serving step, kernels vs plain routes: rel_l2 {rel:.6g} limit {L2_F32_STEP:g} "
              + ("ok" if rel <= L2_F32_STEP else "FAIL"))
        if rel > L2_F32_STEP:
            raise RuntimeError("the f32 serving step disagrees with its plain routes")
        iters = 5
        for _ in range(2):
            serve(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            serve(*inputs)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        print(f"f32 CPN serving step: B={F32_SERVE_B} F={F} {H}x{W} nb={NB} f32: {1e3 * dt:.3f} ms/step, "
              f"{F32_SERVE_B * F / dt:.3f} frames/s on {device_line}")
        phase_profile(serve, inputs, dt)

    # The f32 CHN train step at B=8, frames_n 2: grads against the plain
    # routes' on the same batch and weights, then 3 timed steps after 1.
    chn_t = CHN(nb=NB, dtype=f32, generator=torch.Generator().manual_seed(SEED + 1))
    chn_t.train()
    vgg.requires_grad_(False)
    batch = make_train_batch(TRAIN_B, TRAIN_F, H, W, SEED + 42)
    t, refs = chn_task.target_ref_indexes(TRAIN_F)
    x, m, y = batch
    with torch.no_grad():
        aligned = cpn.align(x[:, t], m[:, t], x[:, refs], m[:, refs])

    def grads():
        chn_t.zero_grad(set_to_none=True)
        y_hat, y_c = chn_infer_apply(chn_t, x[:, t], 1 - m[:, t], *aligned)
        total, _ = chn_task.compute_loss(y[:, t], 1 - m[:, t], y_hat, y_c, aligned[2], vgg)
        total.backward()
        out = {"loss": total.detach().reshape(1), **grad_groups(chn_t)}
        chn_t.zero_grad(set_to_none=True)
        return out

    got, counts = counted(grads)
    with f32_plain_backward():
        want_g = grads()
    check_groups("f32 CHN train step grads, backward routes vs plain versions from the same forward",
                 got, want_g, L2_F32_STEP)
    # The 3xTF32 kernel's launches through conv_stack.tf32_launch: the
    # trunk's forward (K1) and the tail's four; K3's and K6's launches come
    # from their one call each and count on their own counters.
    want = {**dict.fromkeys(counters, 0), "K1": 3 * NB * rrdb.RDB_CONVS, "K3": NB * rrdb_bwd.RRDB_BWD_F32_KERNELS,
            "K4": tail.TAIL_KERNELS, "K6": tail_bwd.TAIL_BWD_F32_KERNELS,
            "TF32": 3 * NB * rrdb.RDB_CONVS + tail.TAIL_KERNELS}
    print(f"f32 train step launches: {counts} (expected {want})")
    if counts != want:
        raise RuntimeError("the f32 train step did not launch each f32 route as expected")
    results["K3 f32"]["launches"], results["K6 f32"]["launches"] = counts["K3"], counts["K6"]
    st = state.create_train_state(chn_t, state.OptimConfig(), steps_per_epoch=2000)
    step = chn_task.make_train_step(chn_t, cpn.align, vgg)
    step(st, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        items = step(st, *batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    loss = {k: v.item() for k, v in items.items()}
    if not all(np.isfinite(v) for v in loss.values()):
        raise RuntimeError(f"f32 train step loss not finite: {loss}")
    print(f"f32 CHN train step: B={TRAIN_B} frames_n={TRAIN_F} {H}x{W} nb={NB} f32: {1e3 * dt:.3f} ms/step "
          f"(3 steps after 1), {TRAIN_B / dt:.3f} samples/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; " + ", ".join(f"{k} {v:.6g}" for k, v in loss.items())
          + f" on {device_line}")
    # The device's busy share of the f32 step: how far the host's launches
    # (the f32 backward's ~1 000 a step) hold it back.
    phase_profile(lambda *b: step(st, *b), batch, dt, grad=True)
    del st, step, chn_t

    # A CHN+DFPN step in f32 with every kernel route (K7 on sep4d and the
    # mixer, K8 on the flow estimators and VGG's pool-4).
    inputs = make_inputs(DFPN_B, DFPN_F, H, W, SEED + 43)
    align = dfpn_align_fn(dfpn, vgg, **EVERY_KERNEL, pallas_vgg=True)

    def dfpn_step(x_t, m_t, x_r, m_r):
        xa, va, vm = align(x_t, m_t, x_r, m_r)
        return chn_infer_apply(chn, x_t, 1 - m_t.float(), xa, va, vm)

    with torch.inference_mode():
        (y_hat, _), counts = counted(lambda: dfpn_step(*inputs))
        if (not torch.isfinite(y_hat).all() or counts["K7"] == 0 or counts["K8"] == 0 or counts["K1"] == 0
                or counts["TF32"] != tf32_want):
            raise RuntimeError(f"f32 CHN+DFPN step: launches {counts} (3xTF32 kernel: {tf32_want} expected: "
                               "K7's and K8's routed convs, the trunk's and the tail's four), "
                               f"finite {torch.isfinite(y_hat).all()}")
        results["K7 f32"]["launches"], results["K8 f32"]["launches"] = counts["K7"], counts["K8"]
        for k in ("K7", "K8"):
            results[f"{k} f32"]["launches_tf32_step"] = counts["TF32"]
        t0 = time.perf_counter()
        for _ in range(3):
            dfpn_step(*inputs)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 3
    print(f"f32 CHN+DFPN step, every kernel route: B={DFPN_B} F={DFPN_F} {H}x{W} base {DFPN_BASE} nb={NB} "
          f"f32: {1e3 * dt:.3f} ms/step; launches {counts} on {device_line}")
    print(f"phase f32: {time.perf_counter() - t_phase:.1f} s")


def record_f32_cli(results, cli_f32):
    """The CLI's f32 runs' launches (``phase_cli``) in the f32 rows: each
    route's by mode, and K2's and K5's as their main-path launches (the
    CHN test at F32_TEST_SIZE is the f32 path that bands)."""
    for k in F32_REPLACES:
        results[f"{k} f32"]["launches_cli"] = {mode: c[k] for mode, c in cli_f32.items()}
    for k in ("K2", "K5"):
        results[f"{k} f32"]["launches"] = cli_f32["CHN test"][k]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "master_thesis_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from master_thesis_tpu_torch.models.chn import CHN
    from master_thesis_tpu_torch.models.cpn import CPN

    name, smi = phase_device()
    phase_build()
    cpn = CPN(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    chn = CHN(nb=NB, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED + 1))
    cpn.eval()
    chn.eval()
    with torch.inference_mode():
        results = phase_kernels(chn)
    phase_main_path(cpn, chn, results, smi)
    with torch.no_grad():
        phase_kernels_bwd(chn, results)
    chn_step = phase_train(cpn, chn, results, smi)
    from master_thesis_tpu_torch.models.vgg import VGGFeatures
    from master_thesis_tpu_torch.train.build import build_dfpn

    dfpn = build_dfpn(base_size=DFPN_BASE, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(SEED + 5))
    vgg = VGGFeatures(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED + 6))
    with torch.inference_mode():
        phase_kernels_stack(dfpn, results)
        phase_kernels_band(dfpn, vgg, results)
        phase_hybrid_routes(dfpn, vgg, results)
    phase_dfpn_path(chn, dfpn, vgg, results, smi)
    phase_cpn_context(smi)
    with torch.inference_mode():
        phase_kernels_banded(chn, results)
    # The video phase's CHN: the serving weights as seeded (the training
    # phase has moved the shared one).
    video_chn = CHN(nb=NB, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED + 1))
    phase_video(cpn, video_chn, results, smi)
    dfpn_step = phase_dfpn_train(results, smi)
    # The f32 phase runs before the CLI's and distribution's (torch.profiler
    # dropped some of its kernels from device_ms's windows after those, in
    # three readings running); the CLI's f32 runs fill in its launches.
    with tf32_off():
        phase_f32(results, smi)
    record_f32_cli(results, phase_cli(results, smi, {"dfpn": dfpn_step, "chn": chn_step}))
    phase_distribution(results, smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # Beside them, the first design's time where the kernel was redesigned.
    first = ("first_design_ms", "tiles_ms", "first_ms")
    kernels = [{**{k: r[k] for k in keys}, **{"first_design_ms": r[k] for k in first if k in r},
                **{k: r[k] for k in ("sources", "launches_hybrid", "hybrid_ms", "launches_dfpn_train",
                                     "launches_cli", "launches_dist", "cudnn_ms", "tf32x3_ms",
                                     "launches_tf32_step", "tf32_convs_ms", "tf32_convs_floor_ms",
                                     "bound_f32_ms") if k in r}}
               for _, r in sorted(results.items())]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
