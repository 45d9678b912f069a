"""Times variants of the RDB kernel (``csrc/rrdb.cu`` with
``csrc/conv3x3_wgmma.cuh``: K1 and K2) on one card.

Shapes: the CPN serving step's trunk (80 frames at 64x64), one frame at
128x128 (a refine of the ip video) and 8 frames of 128x256 (K2's video
shape). Each variant is the kernel built with its own ``-D`` tuning flags
(output rows a warpgroup, consumer warpgroups a CTA, ring stages). All
variants build in parallel, then run in turns on the same seeded inputs,
the first variant again at the end to show the spread. Each variant's RDB
is held against the plain version (relative L2 of its body), and K2
against K1 bit for bit, before it is timed. Printed per variant: each conv
alone at 80x64x64 against its floor (max of its operations at 989 TFLOP/s
and its input and output at 3.35 TB/s), the RDB at the three shapes and
K2 at 8x128x256. CUDA-event times; the card's name and power limit are
printed beside them. Usage, on a machine with the card::

    python3 -m master_thesis_tpu_torch.sweep_rrdb
"""

from __future__ import annotations

import subprocess

import torch

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import rrdb

# label: -D flags. Rows a warpgroup x warpgroups a CTA x ring stages.
VARIANTS = {
    "2x2x3": (),
    "2x2x2": ("-DRDB_STAGES=2",),
    "2x1x3": ("-DRDB_WG=1",),
    "4x1x3": ("-DRDB_ROWS=4", "-DRDB_WG=1"),
    "1x1x3": ("-DRDB_ROWS=1", "-DRDB_WG=1"),
}
L2_LIMIT = 2e-2  # as chip_smoke.py's L2_RRDB
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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


def random_rdb(gen):
    """One RDB's packed weights at the production widths, seeded."""
    convs = []
    for k in range(5):
        cin, cout = rrdb.KERNEL_NF + k * rrdb.KERNEL_GC, rrdb.KERNEL_GC if k < 4 else rrdb.KERNEL_NF
        w = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") * (1.0 / (9 * cin)) ** 0.5
        convs.append((w, torch.randn(cout, generator=gen, device="cuda") * 0.1))
    return rrdb.pack_rdb(convs, torch.bfloat16)


def channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


def conv_floor_us(k, n, h, w):
    flops, nbytes = rrdb.rdb_conv_cost(k, n, h, w)
    return 1e6 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def conv_times(x, p):
    """Each conv alone (``rrdb.rdb_conv_cuda``) over x's frames, in ms,
    after one RDB has filled the x1..x4 scratch."""
    out, hid = rrdb.rdb_cuda(x, p, keep_hidden=True)
    return [_ms(lambda k=k: rrdb.rdb_conv_cuda(k, x, p, out, hid)) for k in range(1, 6)]


def _variant(label, flags, xs, want, p, floors):
    """One variant's line: checked against the plain version, then timed."""
    rel = 0.0
    for k, x in xs.items():
        got = rrdb.rdb_cuda(x, p)
        rel = max(rel, ((got.float() - want[k].float()).norm()
                        / (want[k].float() - x.float()).norm()).item())
    band = rrdb.rdb_banded_cuda(xs["8x128x256"], p)
    if rel > L2_LIMIT or not torch.equal(band, rrdb.rdb_cuda(xs["8x128x256"], p)):
        raise RuntimeError(f"the kernel disagrees with its plain version ({rel:.4g}) or K2 with K1")
    convs = conv_times(xs["80x64x64"], p)
    rdb_ms = {k: _ms(lambda x=x: rrdb.rdb_cuda(x, p)) for k, x in xs.items()}
    k2 = _ms(lambda: rrdb.rdb_banded_cuda(xs["8x128x256"], p))
    conv_txt = " / ".join(f"{1e3 * t:.1f} ({f / (1e3 * t):.0%})" for t, f in zip(convs, floors))
    return (f"{label} {' '.join(flags) or '(defaults)'} | {conv_txt} | "
            + " | ".join(f"{v:.4f}" for v in rdb_ms.values()) + f" | {k2:.4f} | {rel:.4g}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_rrdb: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    try:
        report = _build.build(["rrdb"], [("rrdb", flags) for flags in VARIANTS.values() if flags])
    except RuntimeError as e:  # the variants that failed print FAILED below
        print(e)
        report = {}
    for label, (secs, log) in sorted(report.items()):
        print(f"build {label}: {secs:.1f} s")
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "wgmma", "warning")):
                print(f"  ptxas {label}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    p = random_rdb(gen)
    shapes = {"80x64x64": (80, 64, 64), "1x128x128": (1, 128, 128), "8x128x256": (8, 128, 256)}
    xs = {k: channels_last(rnd(n, 64, h, w)) for k, (n, h, w) in shapes.items()}
    want = {k: rrdb.rdb_plain(x, p) for k, x in xs.items()}
    floors = [conv_floor_us(k, 80, 64, 64) for k in range(1, 6)]
    orig_lib = rrdb._rdb_lib
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    print("conv floors at 80x64x64, us: " + " / ".join(f"{f:.1f}" for f in floors)
          + f" (sum {sum(floors):.1f})")
    print("variant | conv1..conv5 us at 80x64x64 (share of floor) | RDB ms 80x64x64 | 1x128x128 | "
          "8x128x256 | K2 8x128x256 | worst rel L2")
    for label, flags in list(VARIANTS.items()) + [next(iter(VARIANTS.items()))]:
        rrdb._rdb_lib = lambda _=(), flags=flags: orig_lib(flags)
        try:
            print(_variant(label, flags, xs, want, p, floors), flush=True)
        except RuntimeError as e:  # a variant that does not build, launch or agree
            print(f"{label} {' '.join(flags)} | FAILED: {e}", flush=True)
    rrdb._rdb_lib = orig_lib


if __name__ == "__main__":
    main()
