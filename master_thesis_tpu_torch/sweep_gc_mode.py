"""Where the 3xTF32 kernel's gc mode (``csrc/conv_frame_tf32.cu`` with
``csrc/conv_frame_tf32_wgmma.cuh``: K1's / K2's f32 conv1..conv4) spends
its time, on one card.

Times an RDB's four dense-concat convs (3x3, Cin 64 .. 160 -> 32, leaky,
over 80 frames of 64x64 in one 192-channel NHWC buffer: the CPN serving
step's trunk) on the kernel as it is, beside variants built from patched
copies of ``csrc/``:

- ``e1``: the epilogue's exchange and stores left out (the accumulators
  summed into a value that is never stored, so the products stay);
- ``w1``: the weights loaded once a CTA (its later tiles reuse stale
  weight stages);
- ``w1e1``: both.

The variants compute wrong outputs by design; only their times are read,
each against the conv's floor (the larger of 3 x its FLOPs at 495 TFLOP/s
and its input and output at 3.35 TB/s). Two rounds of CUDA-event times;
the card's name and power limit are printed beside them. Usage, on a
machine with the card::

    python3 -m master_thesis_tpu_torch.sweep_gc_mode
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import conv_stack, rrdb

W1 = ("""            cw::mbar_expect_tx(wfull0 + 8 * sw, 2 * W_BYTES);""",
      """            if (MODE == GC && u != (int)blockIdx.x) { cw::mbar_expect_tx(wfull0 + 8 * sw, 0); continue; }
            cw::mbar_expect_tx(wfull0 + 8 * sw, 2 * W_BYTES);""")
E1 = ("""      // Epilogue: output column n's output o is row n's dx 0 column plus row""",
      """      {  // the sums used, nothing exchanged or stored (a value no sum takes)
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < LAST_MB; ++j)
#pragma unroll
          for (int i = 0; i < 48; ++i) sum += acc[j][i];
        if (sum == 1234.5678f) a.out[threadIdx.x] = sum;
        continue;
      }
      // Epilogue: output column n's output o is row n's dx 0 column plus row""")
VARIANTS = {"e1": [E1], "w1": [W1], "w1e1": [W1, E1]}
N, H, W = 80, 64, 64
PEAK_TF32_FLOPS, PEAK_BYTES = 495e12, 3.35e12


def _ms(fn, iters=5, warmup=2):
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


def _floor_ms(k: int) -> float:
    """Conv k's (1..5) floor at N x H x W in f32 on the 3xTF32 kernel."""
    flops, nbytes = rrdb.rdb_conv_cost(k, N, H, W, itemsize=4)
    return 1e3 * max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)


def build_variants():
    """``{name: library}``: the kernel as it is and each variant, the
    variants' nvcc runs in parallel."""
    root = _build.BUILD_DIR / "sweep_gc_mode"
    procs = {}
    for name, patches in VARIANTS.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        header = d / "conv_frame_tf32_wgmma.cuh"
        src = header.read_text()
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel no longer holds {old.strip()!r} once")
            src = src.replace(old, new)
        header.write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "conv_frame_tf32.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _build.build(["conv_frame_tf32"])
    libs = {"as is": conv_stack._tf32_lib()}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}:\n{err[-2000:]}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.conv_frame_tf32_forward.argtypes = [ctypes.POINTER(conv_stack._TF32Call), ctypes.c_void_p]
        lib.conv_frame_tf32_forward.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_gc_mode needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build_variants()
    g = torch.Generator().manual_seed(0)
    convs = [(torch.randn(co, ci, 3, 3, generator=g) / (9 * ci) ** 0.5, torch.randn(co, generator=g) / 10)
             for ci, co in rrdb._widths(rrdb.KERNEL_NF, rrdb.KERNEL_GC)]
    p = rrdb.pack_rdb([(w.cuda(), b.cuda()) for w, b in convs], torch.float32)
    cat = torch.randn(N, H, W, rrdb.KERNEL_NF + 4 * rrdb.KERNEL_GC, generator=g).cuda()
    floors = [_floor_ms(k + 1) for k in range(4)]
    as_is = conv_stack._tf32_lib
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                conv_stack._tf32_lib = lambda _=(), lib=lib: lib
                times = []
                for k in range(4):
                    cin = rrdb.KERNEL_NF + k * rrdb.KERNEL_GC
                    x, out = cat[..., :cin], cat[..., cin:cin + rrdb.KERNEL_GC]
                    times.append(_ms(lambda: rrdb.rdb_conv_tf32_cuda(k, x, p, out)))
                print(f"gc mode {name:6s} round {rnd}: " + ", ".join(
                    f"conv{k + 1} {t:.4f} ms ({f / t:.1%} of its floor {f:.4f})"
                    for k, (t, f) in enumerate(zip(times, floors))))
    finally:
        conv_stack._tf32_lib = as_is
    return 0


if __name__ == "__main__":
    sys.exit(main())
