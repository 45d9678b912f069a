"""Times variants of the conv-stack kernels on one card, at the CHN+DFPN
step's shapes (B=4, F=5, 256x256).

The fused kernel (``csrc/conv_stack.cu``: K7 and K8): K7 on sep4d's two
stages (5 120 tiles each, fused groups alone, as its first design ran
them) and on the mixer (20 tiles), K8 on flow_256's 7 segments (20 frames)
and on VGG's block 1 (24 frames), fused groups alone (K8's first design).
The wide-conv kernel (``csrc/conv_stack_wgmma.cu``, K7's wide 3x3 convs):
each of sep4d's three wide conv shapes at 5 120 tiles, and sep4d's two
stages as the path runs them (``WIDE_VARIANTS``: outputs a CTA, box and
weight ring stages).

Each variant is the kernel built with its own ``-D`` tuning flags (warps a
block, output channels a warp, how far ahead B is fetched) and a launch
planner: ``ops/conv_stack.py:plan`` (cost-based) or :func:`greedy_plan`
(fuse while an 8x16 tile fits); all build in parallel, then run in turns
on the same seeded inputs, the first variant (the defaults) again at the
end to show the spread. Each
variant's outputs are held against the plain version (relative L2) before
it is timed. CUDA-event times; the card's name and power limit are printed
beside them. Usage, on a machine with the card::

    python3 -m master_thesis_tpu_torch.sweep_conv_stack [fused] [wide]

(both parts without arguments).
"""

from __future__ import annotations

import subprocess
import sys

import torch

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import conv_stack as cst

VARIANTS = {
    # The defaults under both planners.
    "16 warps, 32 ch a warp, B 2 steps ahead, cost planner": ((), "cost"),
    "16 warps, 32 ch, B 2 steps ahead, greedy planner": ((), "greedy"),
    # Warps a block and output channels a warp.
    "8 warps, 32 ch, B 1 step ahead, greedy planner": (("-DSTACK_NWARP=8", "-DSTACK_DEPTH=1"), "greedy"),
    "8 warps, 32 ch, B 2 steps ahead, greedy planner": (("-DSTACK_NWARP=8",), "greedy"),
    "8 warps, 64 ch, B 2 steps ahead, greedy planner": (("-DSTACK_NWARP=8", "-DSTACK_NT=4"), "greedy"),
    "16 warps, 64 ch, B 2 steps ahead, greedy planner": (("-DSTACK_NT=4",), "greedy"),
    # How far ahead B is fetched, and more warps.
    "16 warps, 32 ch, B 3 steps ahead, greedy planner": (("-DSTACK_DEPTH=3",), "greedy"),
    "16 warps, 32 ch, B 4 steps ahead, greedy planner": (("-DSTACK_DEPTH=4",), "greedy"),
    "24 warps, 32 ch, B 2 steps ahead, greedy planner": (("-DSTACK_NWARP=24",), "greedy"),
}
# The wide-conv kernel's variants (csrc/conv3x3_wide_wgmma.cuh): outputs a
# CTA (-DWIDE_COUT), box stages (-DWIDE_SA), weight stages (-DWIDE_SW).
WIDE_VARIANTS = {
    "128 outputs a CTA, 2 box stages, 4 weight stages": (),
    "64 outputs a CTA": ("-DWIDE_COUT=64",),
    "6 weight stages": ("-DWIDE_SW=6",),
    "2 weight stages": ("-DWIDE_SW=2",),
    "3 box stages, 3 weight stages": ("-DWIDE_SA=3", "-DWIDE_SW=3"),
}
L2_LIMIT = 1e-2  # as chip_smoke.py's L2_STACK


def _stack(gen, cin, spec):
    convs = []
    for k, cout in spec:
        w = torch.randn(cout, cin, k, k, generator=gen, device="cuda") * (1.0 / (k * k * cin)) ** 0.5
        convs.append((w, torch.randn(cout, generator=gen, device="cuda") * 0.1))
        cin = cout
    relus = [True] * (len(spec) - 1) + [spec[-1][1] > 2]
    return cst.pack_stack(convs, relus, torch.bfloat16)


def greedy_plan(specs, h, w, tiles, min_fused_pix=128):
    """The first planner: each group takes the largest tile that fits and
    grows while one still fits with at least ``min_fused_pix`` output
    pixels (or the whole image, if smaller)."""
    groups, lo = [], 0
    while lo < len(specs):
        best = None
        for hi in range(lo + 1, min(len(specs), lo + cst.MAX_STAGES) + 1):
            fit = next((g for g in (cst.group_geometry(specs, lo, hi, h, w, *t) for t in tiles)
                        if g.smem <= cst.SMEM_LIMIT), None)
            if fit is None or (hi - lo > 1 and fit.th * fit.tw < min(min_fused_pix, h * w)):
                break
            best = fit
        groups.append(best)
        lo = best.hi
    return groups


def _ms(fn, iters=10, warmup=2):
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


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_conv_stack: no CUDA device is available")
    parts = set(sys.argv[1:]) or {"fused", "wide"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    report = _build.build([], sorted({("conv_stack", flags) for flags, _ in VARIANTS.values()}
                                     | {("conv_stack_wgmma", f) for f in WIDE_VARIANTS.values()}))
    for label, (_, log) in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {label}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    n, cs = 20, 16
    mixer = _stack(gen, 256, [(5, 256), (3, 256), (3, 16), (5, 16), (3, 16), (3, 8), (5, 8), (3, 8),
                              (3, 4), (5, 4), (3, 4), (3, 2), (5, 2), (3, 2)])
    sep1 = _stack(gen, 1, [(3, 128), (3, 256), (3, 256)])
    sep2 = _stack(gen, 256, [(3, 256), (3, 128), (3, 1)])
    flow = [_stack(gen, 10, [(5, 128), (3, 128)])] + [_stack(gen, 128, [(5, 128), (3, 128)])
                                                       for _ in range(5)]
    flow.append(_stack(gen, 128, [(5, 128), (3, 128), (3, 2)]))
    vgg1 = _stack(gen, 3, [(3, 64), (3, 64)])
    x_mix, x1, x2 = rnd(n, 256, 256), rnd(n * 256, 1, 256), rnd(n * 256, 256, 256)
    xs = [rnd(n, hw, hw, p.specs[0][1]) for p, hw in zip(flow, (256, 128, 64, 32, 64, 128, 256))]
    x_vgg = rnd(n + 4, 256, 256, 3)
    tiles = lambda x, p: cst.conv_stack_tiles_cuda(x, p, cs)
    band = cst.conv_stack_banded_first_cuda  # the fused groups alone
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    if "fused" in parts:
        _sweep_fused(tiles, band, cs, (x1, sep1), (x2, sep2), (x_mix, mixer), xs, flow, (x_vgg, vgg1))
    if "wide" in parts:
        _sweep_wide(gen, rnd, n, cs, x1, x2, sep1, sep2)


def _sweep_fused(tiles, band, cs, s1, s2, mix, xs, flow, v1) -> None:
    (x1, sep1), (x2, sep2), (x_mix, mixer), (x_vgg, vgg1) = s1, s2, mix, v1
    want = {"sep4d stage 2": cst.conv_stack_tiles_plain(x2, sep2, cs),
            "flow c15-c17": cst.conv_stack_banded_plain(xs[-1], flow[-1])}
    orig, planners = cst._lib, {"cost": cst.plan, "greedy": greedy_plan}
    print("variant | K7 sep4d ms | K7 mixer ms | K8 flow_256 ms | K8 VGG block 1 ms | worst rel L2")
    for label, (flags, planner) in list(VARIANTS.items()) + [next(iter(VARIANTS.items()))]:
        cst._lib = lambda _=(), flags=flags: orig(flags)
        cst.plan = planners[planner]
        got = {"sep4d stage 2": tiles(x2, sep2), "flow c15-c17": band(xs[-1], flow[-1])}
        rel = max(_rel(got[k], want[k]) for k in want)
        if rel > L2_LIMIT:
            raise RuntimeError(f"{label}: the kernel disagrees with its plain version ({rel:.4g})")
        k7 = _ms(lambda: (tiles(x1, sep1), tiles(x2, sep2)))
        k7m = _ms(lambda: tiles(x_mix, mixer), iters=20)
        k8 = _ms(lambda: [band(x, p) for x, p in zip(xs, flow)])
        k8v = _ms(lambda: band(x_vgg, vgg1))
        print(f"{label} {' '.join(flags) or '(defaults)'} | {k7:.4f} | {k7m:.4f} | {k8:.4f} | "
              f"{k8v:.4f} | {rel:.4g}")
    cst._lib, cst.plan = orig, planners["cost"]


def _sweep_wide(gen, rnd, n, cs, x1, x2, sep1, sep2) -> None:
    # The wide-conv kernel: each wide conv shape alone, then sep4d's stages
    # channels-last as sep4d_apply runs them (thin convs on the defaults).
    shapes = [(128, 256), (256, 256), (256, 128)]
    ones = [_stack(gen, ci, [(3, co)]) for ci, co in shapes]
    xw = {ci: rnd(n * 256, ci, cs, cs).contiguous(memory_format=torch.channels_last) for ci in (128, 256)}
    x1c, x2c = x1.view(n * 256, 1, cs, cs), x2.view(n * 256, cs, cs, 256).permute(0, 3, 1, 2)
    want_w = [cst.conv_stack_plain(xw[ci], one) for (ci, _), one in zip(shapes, ones)]
    orig_w = cst._wide_lib
    print("variant | " + " | ".join(f"{ci}->{co} ms (% of floor)" for ci, co in shapes)
          + " | K7 sep4d ms | worst rel L2")
    for label, flags in list(WIDE_VARIANTS.items()) + [next(iter(WIDE_VARIANTS.items()))]:
        cst._wide_lib = lambda _=(), flags=flags: orig_w(flags)
        rel = max(_rel(cst.conv3x3_wide_cuda(xw[ci], one, 0), w) for (ci, _), one, w in zip(shapes, ones, want_w))
        if rel > L2_LIMIT:
            raise RuntimeError(f"{label}: the kernel disagrees with its plain version ({rel:.4g})")
        cols = []
        for (ci, co), one in zip(shapes, ones):
            t = _ms(lambda: cst.conv3x3_wide_cuda(xw[ci], one, 0))
            floor = 1e3 * cst.stack_flops(one, n * 256, cs, cs) / 989e12
            cols.append(f"{t:.4f} ({100 * floor / t:.1f}%)")
        k7 = _ms(lambda: (cst.conv_stack_tiles_cl_cuda(x1c, sep1), cst.conv_stack_tiles_cl_cuda(x2c, sep2)))
        print(f"{label} {' '.join(flags) or '(defaults)'} | {' | '.join(cols)} | {k7:.4f} | {rel:.4g}")
    cst._wide_lib = orig_w


if __name__ == "__main__":
    main()
