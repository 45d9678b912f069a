"""Times variants of the RRDB backward kernel (K3: ``csrc/rrdb_bwd.cu`` with
``csrc/conv_bwd_wgmma.cuh``) on one card.

Shape: one RRDB of the train step's trunk (8 frames at 64x64), over the
activations K1 keeps. Each variant is the kernel built with its own
``-D`` tuning flags (the pulls' rows a warpgroup, warpgroups and ring
stages; the wgrad's rows a tile, stages and K-splits). All variants build
in parallel, then run in turns on the same seeded inputs, the first
variant again at the end to show the spread. Each variant is held against
the plain version (the worst relative L2 over dx and every dW / db, also
on a ragged 2x60x120 input) and against itself (two runs bit-identical)
before it is timed. Printed per variant: the RRDB's time by CUDA events
and by the kernels' device time under ``torch.profiler``, split into the
pulls (N = 32 and N = 64), the wgrads and the rest, and the host's
enqueue time a call; the first K3 design on the same input once. The
card's name and power limit are printed beside them. Usage, on a machine
with the card::

    python3 -m master_thesis_tpu_torch.sweep_rrdb_bwd
"""

from __future__ import annotations

import subprocess
import time

import torch

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import rrdb, rrdb_bwd

# label: -D flags. Pulls: rows a warpgroup x warpgroups x stages; wgrad:
# rows a tile x stages x K-splits.
VARIANTS = {
    "pull 2x2x3, wgrad 4x3x9": (),
    "pull 1x2x3": ("-DPULL_ROWS=1",),
    "wgrad 2x4x9": ("-DWGRAD_ROWS=2", "-DWGRAD_STAGES=4"),
    "wgrad 4x3x6": ("-DWGRAD_KS=6",),
}
# K3's kernels as their mangled names show them in ptxas's report.
KERNELS = ("pull_kernelILi32", "pull_kernelILi64", "wgrad_kernel", "prep_kernel", "reduce_kernel")
L2_LIMIT = 5e-2  # as chip_smoke.py's L2_K3
PEAK_FLOPS = 989e12
SHAPE = (8, 64, 64)


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


def _device_ms(fn, iters=5):
    """The kernels' device time a call under ``torch.profiler``, in total
    and by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")}
    return sum(by.values()), by


def random_rrdb(gen):
    """One RRDB's three RDBs at the production widths, seeded: packed
    forward weights, pull matrices, first-design adjoints."""
    convs = []
    for _ in range(3):
        c = []
        for cin, cout in rrdb._widths(rrdb.KERNEL_NF, rrdb.KERNEL_GC):
            w = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") * (1.0 / (9 * cin)) ** 0.5
            c.append((w, torch.randn(cout, generator=gen, device="cuda") * 0.1))
        convs.append(c)
    bf = torch.bfloat16
    return ([rrdb.pack_rdb(c, bf) for c in convs], rrdb.pack_rdb_pulls(convs, bf),
            rrdb.pack_rdb_adjoints(convs, bf))


def _groups(dx, grads):
    return [dx] + [t for dws, dbs in grads for t in dws + dbs]


def _worst_rel(got, want):
    return max(((a.float() - b.float()).norm() / b.float().norm()).item() for a, b in zip(got, want))


def _variant(label, flags, cases, pulls):
    """One variant's line: checked against the plain version and itself,
    then timed."""
    rel = 0.0
    for x, g, kept, want in cases:
        dx, flat = rrdb_bwd.rrdb_bwd_cuda(x, g, pulls, kept)
        dx2, flat2 = rrdb_bwd.rrdb_bwd_cuda(x, g, pulls, kept)
        if not (torch.equal(dx, dx2) and torch.equal(flat, flat2)):
            raise RuntimeError("two runs differ")
        rel = max(rel, _worst_rel(_groups(dx, rrdb_bwd.rdb_grads(flat)), want))
    if rel > L2_LIMIT:
        raise RuntimeError(f"the kernel disagrees with its plain version ({rel:.4g})")
    x, g, kept, _ = cases[0]
    out = torch.empty(3 * rrdb_bwd.RDB_GRAD_NUMEL, dtype=torch.float32, device="cuda")
    scratch = torch.empty(rrdb_bwd.scratch_bytes(*SHAPE), dtype=torch.uint8, device="cuda")
    run = lambda: rrdb_bwd.rrdb_bwd_cuda(x, g, pulls, kept, out, scratch)
    events = _ms(run)
    dev, by = _device_ms(run)
    part = lambda key: sum(v for k, v in by.items() if key in k)
    pull32, pull64, wgrad = part("pull_kernel<32>"), part("pull_kernel<64>"), part("wgrad_kernel")
    t0 = time.perf_counter()
    for _ in range(50):
        run()
    host = 1e3 * (time.perf_counter() - t0) / 50
    torch.cuda.synchronize()
    return (f"{label} {' '.join(flags) or '(defaults)'} | {events:.4f} | {dev:.4f} | {pull32:.4f} | "
            f"{pull64:.4f} | {wgrad:.4f} | {dev - pull32 - pull64 - wgrad:.4f} | {host:.4f} | "
            f"{rel:.4g}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_rrdb_bwd: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    try:
        report = _build.build(["rrdb", "rrdb_bwd"],
                              [("rrdb_bwd", flags) for flags in VARIANTS.values() if flags])
    except RuntimeError as e:  # the variants that failed print FAILED below
        print(e)
        report = {}
    for label, (secs, log) in sorted(report.items()):
        print(f"build {label}: {secs:.1f} s")
        entry = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = next((k for k in KERNELS if k in line and "_ZN2kb" in line), None)
            elif entry is not None and any(k in line for k in ("registers", "spill")):
                print(f"  ptxas {label} {entry}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rdbs, pulls, adjs = random_rrdb(gen)
    cases = []
    for n, h, w in (SHAPE, (2, 60, 120)):
        x, g = (torch.randn(n, 64, h, w, generator=gen, device="cuda").to(torch.bfloat16)
                .contiguous(memory_format=torch.channels_last) for _ in range(2))
        _, kept = rrdb_bwd.rrdb_forward_kept(x, rdbs)
        dx, grads = rrdb_bwd.rrdb_bwd_plain(x, g, rdbs, kept)
        cases.append((x, g, kept, _groups(dx, grads)))
    x, g = cases[0][0].contiguous(), cases[0][1].contiguous()
    first = _ms(lambda: rrdb_bwd.rrdb_bwd_first(x, g, rdbs, adjs), iters=10)
    first_dev, _ = _device_ms(lambda: rrdb_bwd.rrdb_bwd_first(x, g, rdbs, adjs))
    flops = rrdb_bwd.rrdb_bwd_flops(*SHAPE)
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    print(f"one RRDB at {SHAPE}: bound {1e3 * flops / PEAK_FLOPS:.4f} ms ({flops / 1e9:.1f} GFLOP); "
          f"first design {first:.4f} ms by events, {first_dev:.4f} device")
    print("variant | ms (events) | device ms | pulls N=32 | pulls N=64 | wgrads | prep + reduce | "
          "host ms a call | worst rel L2")
    orig_lib = rrdb_bwd._lib
    for label, flags in list(VARIANTS.items()) + [next(iter(VARIANTS.items()))]:
        rrdb_bwd._lib = lambda _=(), flags=flags: orig_lib(flags)
        try:
            print(_variant(label, flags, cases, pulls), flush=True)
        except RuntimeError as e:  # a variant that does not build, launch or agree
            print(f"{label} {' '.join(flags)} | FAILED: {e}", flush=True)
    rrdb_bwd._lib = orig_lib


if __name__ == "__main__":
    main()
