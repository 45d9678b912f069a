"""Times variants of the wgmma tail (``csrc/tail.cu`` with
``csrc/tail_wgmma.cuh``: K4 and K5) on one card.

Shapes: the CPN serving step's tail (80 frames at 64x64), one frame at
128x128 (a refine of the ip video) and 8 frames of 128x256 (K5's video
shape). Each variant is the kernel built with its own ``-D`` tuning flags,
per stage kind: for the upsample-convs rows a warpgroup x consumer
warpgroups x ring stages x phases a pass, for hr_conv and conv_last rows a
warpgroup x warpgroups x stages. All variants build in parallel, then run
in turns on the same seeded inputs, the first variant again at the end to
show the spread. Each variant's tail is held against the plain version
(relative L2) at every shape, and K5 against K4 bit for bit, before it is
timed. Printed per variant: each of the four launches alone at 80x64x64
against its floor (max of its operations at 989 TFLOP/s and its input and
output at 3.35 TB/s), the tail at the three shapes and K5 at 8x128x256.
CUDA-event times; the card's name and power limit are printed beside them.
Usage, on a machine with the card::

    python3 -m master_thesis_tpu_torch.sweep_tail
"""

from __future__ import annotations

import subprocess

import torch

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import tail

# label: -D flags. up = rows x warpgroups x stages x phases a pass;
# hr, last = rows x warpgroups x stages. Each variant moves all three
# stage kinds at once; the stages are timed alone.
VARIANTS = {
    "up 1x2x2x1, hr 2x2x2, last 4x2x2": (),
    "up 1x2x2x2, hr 1x2x3, last 8x1x2": ("-DTAIL_UP_PG=2", "-DTAIL_HR_ROWS=1", "-DTAIL_HR_STAGES=3",
                                         "-DTAIL_LAST_ROWS=8", "-DTAIL_LAST_WG=1"),
    "up 2x1x2x2, hr 4x1x2, last 2x2x3": ("-DTAIL_UP_ROWS=2", "-DTAIL_UP_WG=1", "-DTAIL_UP_PG=2",
                                         "-DTAIL_HR_ROWS=4", "-DTAIL_HR_WG=1", "-DTAIL_LAST_ROWS=2",
                                         "-DTAIL_LAST_STAGES=3"),
    "up 1x1x3x2, hr 1x2x2, last 3x2x3": ("-DTAIL_UP_WG=1", "-DTAIL_UP_STAGES=3", "-DTAIL_UP_PG=2",
                                         "-DTAIL_HR_ROWS=1", "-DTAIL_LAST_ROWS=3", "-DTAIL_LAST_STAGES=3"),
    "up 1x1x2x4, hr 2x1x3, last 4x1x3": ("-DTAIL_UP_WG=1", "-DTAIL_UP_PG=4", "-DTAIL_HR_WG=1",
                                         "-DTAIL_HR_STAGES=3", "-DTAIL_LAST_WG=1", "-DTAIL_LAST_STAGES=3"),
}
L2_LIMIT = 5e-3  # as chip_smoke.py's L2_TAIL
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
STAGES = ("upconv1", "upconv2", "hr_conv", "conv_last")


def _ms(fn, iters=20, warmup=3):
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


def random_tail(gen):
    """The tail's packed weights at the production widths, seeded."""
    def conv(cout):
        w = torch.randn(cout, tail.KERNEL_NF, 3, 3, generator=gen, device="cuda") * (1.0 / (9 * 64)) ** 0.5
        return w, torch.randn(cout, generator=gen, device="cuda") * 0.1

    return tail.pack_tail(conv(64), conv(64), conv(64), conv(3), torch.bfloat16)


def stage_io(x, p):
    """Each stage's NHWC input (the plain version's) and an output buffer."""
    io, src = [], x
    for k in range(len(STAGES)):
        nxt = tail.tail_stage_plain(k, src, p)
        out = torch.empty(nxt.permute(0, 2, 3, 1).shape, dtype=x.dtype, device=x.device)
        io.append((src.permute(0, 2, 3, 1).contiguous(), out))
        src = nxt
    return io


def _variant(label, flags, xs, want, p, io, floors):
    """One variant's line: checked against the plain version, then timed."""
    rel = 0.0
    for k, x in xs.items():
        got = tail.tail_cuda(x, p)
        rel = max(rel, ((got.float() - want[k].float()).norm() / want[k].float().norm()).item())
    wide = xs["8x128x256"]
    if rel > L2_LIMIT or not torch.equal(tail.tail_banded_cuda(wide, p), tail.tail_cuda(wide, p)):
        raise RuntimeError(f"the kernel disagrees with its plain version ({rel:.4g}) or K5 with K4")
    stage_ms = [_ms(lambda k=k, s=s, o=o: tail.tail_stage_cuda(k, s, p, o)) for k, (s, o) in enumerate(io)]
    tail_ms = {k: _ms(lambda x=x: tail.tail_cuda(x, p)) for k, x in xs.items()}
    k5 = _ms(lambda: tail.tail_banded_cuda(wide, p))
    stage_txt = " / ".join(f"{1e3 * t:.1f} ({f / (1e3 * t):.0%})" for t, f in zip(stage_ms, floors))
    return (f"{label} {' '.join(flags) or '(defaults)'} | {stage_txt} | "
            + " | ".join(f"{v:.4f}" for v in tail_ms.values()) + f" | {k5:.4f} | {rel:.4g}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_tail: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    try:
        report = _build.build(["tail"], [("tail", flags) for flags in VARIANTS.values() if flags])
    except RuntimeError as e:  # the variants that failed print FAILED below
        print(e)
        report = {}
    for label, (secs, log) in sorted(report.items()):
        print(f"build {label}: {secs:.1f} s")
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "wgmma", "error")):
                print(f"  ptxas {label}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = random_tail(gen)
    shapes = {"80x64x64": (80, 64, 64), "1x128x128": (1, 128, 128), "8x128x256": (8, 128, 256)}
    xs = {k: torch.randn(n, tail.KERNEL_NF, h, w, generator=gen, device="cuda").to(torch.bfloat16)
          .contiguous(memory_format=torch.channels_last) for k, (n, h, w) in shapes.items()}
    want = {k: tail.tail_plain(x, p) for k, x in xs.items()}
    io = stage_io(xs["80x64x64"], p)
    floors = [1e6 * max(f / PEAK_FLOPS, b / PEAK_BYTES)
              for f, b in (tail.tail_stage_cost(k, 80, 64, 64) for k in range(len(STAGES)))]
    orig_lib = tail._tail_lib
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    print("stage floors at 80x64x64, us: " + " / ".join(f"{f:.1f}" for f in floors)
          + f" (sum {sum(floors):.1f})")
    print(f"variant | {' / '.join(STAGES)} us at 80x64x64 (share of floor) | tail ms 80x64x64 | "
          "1x128x128 | 8x128x256 | K5 8x128x256 | worst rel L2")
    for label, flags in list(VARIANTS.items()) + [next(iter(VARIANTS.items()))]:
        tail._tail_lib = lambda _=(), flags=flags: orig_lib(flags)
        try:
            print(_variant(label, flags, xs, want, p, io, floors), flush=True)
        except RuntimeError as e:  # a variant that does not build, launch or agree
            print(f"{label} {' '.join(flags)} | FAILED: {e}", flush=True)
    tail._tail_lib = orig_lib


if __name__ == "__main__":
    main()
