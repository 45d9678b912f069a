"""K4's and K5's f32 route (the RRDBNet tail) on the 3xTF32 kernel
(``csrc/conv_frame_tf32_wgmma.cuh``: the upsample-convs in phase mode,
hr_conv in conv mode, conv_last in last mode), on the CPU: each launch
emulated (``tests/test_torch_tf32x3.py:_emulate_launch``) against the plain
f32 stage, the emulated tail against the plain tail, the JAX package's
``rrdbnet_tail_pallas`` in f32 interpret mode and f64; the banded tail
against the full frame bit for bit; the planted faults; the packing; and
which kernel the f32 routes launch.

Tolerances: 5e-5, the JAX tests' own (tests/test_pallas_tail.py), against
JAX; chip_smoke.py's f32 limit, a relative L2 of 1e-5, against the plain f32
tail and f64."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from master_thesis_tpu.ops.pallas_tail import rrdbnet_tail_pallas
from master_thesis_tpu_torch.models.nn_ext import fused_upsample_conv_kernel
from master_thesis_tpu_torch.ops import conv_f32, conv_stack, fragments, tail
from tests.test_torch_tail import _pack, _tail_params
from tests.test_torch_tf32x3 import _emulate_launch, _one_thread, _rel_l2  # noqa: F401 (fixture)

ATOL_JAX = 5e-5
L2_F32 = 1e-5
NF = tail.KERNEL_NF
N, H, W = 2, 6, 10  # the tail's input grid: a 24x40 output, ragged against every tile


def _emulate_stage(k, x, p, out, plant=0, **window):
    """:func:`tail.tail_stage_tf32_cuda`'s launch, emulated into ``out``."""
    name, up, epi = tail.F32_STAGES[k]
    return _emulate_launch(x, p[f"{name}_tf32"], p[f"{name}_b"], mode=tail.TF32_MODES[k], k=3,
                           cout=4 * NF if up else out.shape[3], epi=epi, out_shape=tuple(out.shape),
                           plant=plant, out=out, **window)


def _stage(plant):
    return lambda k, x, p, out, **window: _emulate_stage(k, x, p, out, plant=plant, **window)


def _emulated_tail(x, p, plant=0):
    """K4's four launches emulated: NHWC (N, 4H, 4W, 3)."""
    return tail.tail_f32_stages(conv_f32.nhwc(x), p, stage=_stage(plant))[-1]


def _emulated_banded(x, p, band_rows, plant=0):
    """K5's launches, four a band, emulated: NHWC (N, 4H, 4W, 3)."""
    y = tail._banded_f32(x, p, band_rows, _stage(plant), SimpleNamespace(launches=0))
    return y.permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def case():
    """nf 64 tail weights, an input on a 2 x 6x10 grid, both as numpy (JAX's
    layout) and packed / NCHW for the port; the emulated tail, plain and f64."""
    rng = np.random.RandomState(18)
    p = _tail_params(rng, NF)
    for name in ("upconv1", "upconv2", "hr_conv", "conv_last"):
        p[f"{name}_kernel"] *= np.float32((1 / (0.04 * 9 * NF)) ** 0.5)  # unit-variance activations
    y = rng.randn(N, H, W, NF).astype(np.float32)
    packed = _pack(p)
    x = torch.from_numpy(y).permute(0, 3, 1, 2)
    f64 = x.double()
    for name, up, epi in tail.F32_STAGES:
        f64 = F.interpolate(f64, scale_factor=2, mode="nearest") if up else f64
        f64 = F.conv2d(f64, packed[f"{name}_oihw"].double(), packed[f"{name}_b"].double(), padding=1)
        f64 = F.leaky_relu(f64, 0.2) if epi == "leaky" else f64
    f64 = f64.permute(0, 2, 3, 1)
    return SimpleNamespace(p=p, y=y, packed=packed, x=x, emu=_emulated_tail(x, packed),
                           plain=tail.tail_f32(x, packed).permute(0, 2, 3, 1), f64=f64)


def test_tf32_tail_packing(case):
    """The phase operand holds phase (a, b)'s tap (ti, tj) of
    ``fused_upsample_conv_kernel`` at chunk ``c // 32``, tap ``2 ti + tj``,
    row ``64 (2a + b) + o``, 16-byte position ``(c % 32 // 4) ^ row % 8``,
    hi then lo; conv_last's one block of 24 rows ``8 kx + o`` a (chunk, row of
    taps ky), outputs 3-7 zero; hr_conv's is ``wgmma_tf32_matrix``'s; f32
    alone, at the kernel's width alone."""
    p = case.packed
    w1 = torch.from_numpy(case.p["upconv1_kernel"])
    fused = fused_upsample_conv_kernel(w1)
    hi, lo = fragments.tf32_split(fused)
    blocks = p["up1_tf32"].view(2, NF // 32, 4, 4 * NF, 8, 4)
    for a, b, ti, tj, c, o in ((0, 0, 0, 0, 0, 0), (1, 0, 1, 1, 37, 5), (0, 1, 0, 1, 63, 63), (1, 1, 1, 0, 8, 17)):
        row, ph = 64 * (2 * a + b) + o, 2 * a + b
        pos = (c % 32 // 4) ^ (row % 8)
        assert blocks[0, c // 32, 2 * ti + tj, row, pos, c % 4] == hi[a + ti, b + tj, c, ph * NF + o]
        assert blocks[1, c // 32, 2 * ti + tj, row, pos, c % 4] == lo[a + ti, b + tj, c, ph * NF + o]
    last = p["last_tf32"].view(2, NF // 32, 3, 3, 8, 8, 4)  # (hi / lo, chunk, ky, kx, o, 16 B, c % 4)
    w = torch.from_numpy(case.p["conv_last_kernel"]).permute(3, 2, 0, 1)
    lh, ll = fragments.tf32_split(w)
    for o, c, ky, kx in ((0, 0, 0, 0), (2, 45, 2, 1), (1, 31, 1, 2)):
        pos = (c % 32 // 4) ^ o  # row 8 kx + o: its swizzle is o's
        assert last[0, c // 32, ky, kx, o, pos, c % 4] == lh[o, c, ky, kx]
        assert last[1, c // 32, ky, kx, o, pos, c % 4] == ll[o, c, ky, kx]
    assert (last[:, :, :, :, 3:] == 0).all()
    hr = torch.from_numpy(case.p["hr_conv_kernel"]).permute(3, 2, 0, 1)
    assert torch.equal(p["hr_tf32"], fragments.wgmma_tf32_matrix(hr))
    assert "up1_tf32" not in _pack(case.p, torch.bfloat16)
    assert "up1_tf32" not in _pack(_tail_params(np.random.RandomState(0), 16))


@pytest.mark.parametrize("k", range(4))
def test_tf32_tail_stage_emulation_matches_plain(case, k):
    """Each of the four launches emulated (phase mode on a 6x10 and a 12x20
    input, conv and last mode on 24x40: tiles ragged in rows and columns)
    against the plain f32 stage within L2_F32, max|diff| 1e-4."""
    x = conv_f32.nhwc(case.x)
    x = tail.tail_f32_stages(x, case.packed, keep=k)[-1] if k else x
    s = 2 if k < 2 else 1
    out = torch.empty(N, s * x.shape[1], s * x.shape[2], 3 if k == 3 else NF)
    want = tail.tail_stage_tf32_plain(k, x, case.packed, out.clone())
    got = _emulate_stage(k, x, case.packed, out.zero_())
    assert _rel_l2(got, want) <= L2_F32
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_tf32_tail_emulation_matches_plain_f64_and_the_jax_pallas_kernel(case):
    """The emulated tail (four launches) against the plain f32 tail and f64
    within L2_F32, and ``rrdbnet_tail_pallas`` in f32 (interpret mode,
    ``Precision.HIGHEST``) at the JAX tests' 5e-5."""
    with jax.default_matmul_precision("highest"):
        want = rrdbnet_tail_pallas({k: jnp.asarray(v) for k, v in case.p.items()}, jnp.asarray(case.y),
                                   jnp.float32, interpret=True)
    assert _rel_l2(case.emu, case.plain) <= L2_F32
    assert _rel_l2(case.emu, case.f64) <= L2_F32 / 4
    np.testing.assert_allclose(case.emu.numpy(), np.asarray(want), atol=ATOL_JAX)


def test_tf32_banded_tail_emulation_equals_the_full_frame(case):
    """K5's launches emulated in bands of 2 rows (their row windows: x read
    in place, then band buffers whose row 0 is the frame's x_row0, outputs
    at out_row0, each phase masked to its window) equal K4's bit for bit:
    each output sums the same products in the same order."""
    assert torch.equal(_emulated_banded(case.x, case.packed, 2), case.emu)


@pytest.mark.parametrize("plant", [1, 2, 3, 4])
def test_tf32_tail_emulation_sees_the_planted_faults(case, plant):
    """Each ``-DTF32_PLANT`` fault moves the emulated tail past L2_F32 from the
    plain tail: 1 (1xTF32, also past L2_F32 from f64), 2 (the corner tap,
    each phase's tap (0, 0)), 3 (each tile's top halo row below the first
    row tile: hr_conv's and conv_last's tiles at 24x40) on the full frame; 4
    (a band buffer's first row, the halo row above the band) on the bands
    alone: the full frame reads no such row."""
    if plant < 4:
        got = _emulated_tail(case.x, case.packed, plant)
    else:
        assert torch.equal(_emulated_tail(case.x, case.packed, 4), case.emu)
        got = _emulated_banded(case.x, case.packed, 2, plant)
    assert _rel_l2(got, case.plain) > L2_F32
    if plant == 1:
        assert _rel_l2(got, case.f64) > 10 * L2_F32


def _meta_tail():
    conv = lambda o: (torch.empty(o, NF, 3, 3, device="meta"), torch.empty(o, device="meta"))
    return tail.pack_tail(conv(NF), conv(NF), conv(NF), conv(3), torch.float32)


def test_f32_tail_routes_send_every_stage_to_the_tf32_kernel(monkeypatch):
    """Off the CPU (the meta device, each launch recorded) K4, K5 and K6's
    recompute launch the 3xTF32 kernel's modes (phase, phase, conv, last; K6
    the first three) and no ``conv_f32_fwd``, at the f32 checks' shapes (80 x
    64^2; 8 x 128x256 in 32-row bands: per band the rows the next stage
    reads, conv_last the band's own), every tile within the shared memory."""
    calls = []

    def launch(x, mat, bias, out, *, mode, k, cout, epi, hin=None, rows=None, x_row0=0, out_row0=0, addr=None):
        n, x_rows, w, _ = x.shape
        hin = x_row0 + x_rows if hin is None else hin
        r0, r1 = rows or (0, (2 if mode == "phase" else 1) * hin)
        cy0, cy1 = (r0 // 2, (r1 + 1) // 2) if mode == "phase" else (r0, r1)
        fr, trows, tw, nh = conv_stack.tf32_tile(mode, n, hin, w, k, cout, cy0, cy1, x_row0)
        cols = 64 * conv_stack.TF32_LAST_BLOCKS if mode == "last" else None
        assert conv_stack.tf32_smem(fr, trows, tw, k, nh, cols=cols) <= conv_stack.SMEM_LIMIT
        assert x_row0 <= max(cy0 - 1, 0) and x_row0 + x_rows >= min(cy1 + 1, hin) and out_row0 <= r0
        calls.append((mode, epi, (r0, r1)))

    def simt(*a, **k):
        raise AssertionError("the f32 tail launched conv_f32_fwd")

    monkeypatch.setattr(conv_stack, "tf32_launch", launch)
    monkeypatch.setattr(tail, "conv_f32_fwd", simt)
    p = _meta_tail()
    x = torch.empty(80, NF, 64, 64, device="meta")
    tail.tail_f32(x, p)
    assert calls == [("phase", "leaky", (0, 128)), ("phase", "leaky", (0, 256)), ("conv", "leaky", (0, 256)),
                     ("last", "none", (0, 256))]
    calls.clear()
    tail.tail_f32_stages(conv_f32.nhwc(torch.empty(8, NF, 64, 64, device="meta")), p, keep=3)
    assert [c[0] for c in calls] == ["phase", "phase", "conv"]
    calls.clear()
    tail.tail_banded_f32(torch.empty(8, NF, 128, 256, device="meta"), p)
    assert [c[0] for c in calls] == ["phase", "phase", "conv", "last"] * 4
    assert [c[2] for c in calls if c[0] == "last"] == [(0, 128), (128, 256), (256, 384), (384, 512)]
    assert [c[2] for c in calls[4:8]] == [(62, 130), (126, 258), (127, 257), (128, 256)]


def test_f32_tail_routes_other_widths_to_the_simt_kernel(monkeypatch):
    """Off the CPU (the meta device) a tail packed at a width other than the
    kernel's (nf 16: no 3xTF32 operands) runs each stage as one
    ``conv_f32_fwd`` (the SIMT kernel), as K7 / K8 send their thin convs, the
    upsample-convs at the high resolution, in bands too; it never reaches
    the 3xTF32 kernel. At nf 64 the plan is the 3xTF32 kernel."""
    calls = []

    def simt(x, w, out, *, bias, up, epi, **window):
        calls.append((up, epi, tuple(out.shape)))
        return out

    def refuse(*a, **k):
        raise AssertionError("a tail at nf 16 reached the 3xTF32 kernel")

    monkeypatch.setattr(conv_stack, "tf32_launch", refuse)
    monkeypatch.setattr(tail, "conv_f32_fwd", simt)
    conv = lambda o: (torch.empty(o, 16, 3, 3, device="meta"), torch.empty(o, device="meta"))
    p = tail.pack_tail(conv(16), conv(16), conv(16), conv(3), torch.float32)
    assert tail.tail_f32_plan(p) == "simt" and tail.tail_f32_plan(_meta_tail()) == "tf32"
    tail.tail_f32(torch.empty(2, 16, 8, 8, device="meta"), p)
    assert calls == [(True, "leaky", (2, 16, 16, 16)), (True, "leaky", (2, 32, 32, 16)),
                     (False, "leaky", (2, 32, 32, 16)), (False, "none", (2, 32, 32, 3))]
    calls.clear()
    tail.tail_banded_f32(torch.empty(2, 16, 8, 8, device="meta"), p, band_rows=4)
    assert [c[:2] for c in calls] == [(True, "leaky"), (True, "leaky"), (False, "leaky"), (False, "none")] * 2


def test_f32_tail_route_on_the_cpu_runs_the_plain_stages(case, monkeypatch):
    """On a CPU tensor the f32 tail never reaches the 3xTF32 kernel's
    wrapper: every stage is its plain version; the wrapper itself refuses a
    CPU tensor, bf16 operands and a tail packed at another width."""
    x = conv_f32.nhwc(case.x).contiguous()
    out = torch.empty(N, 2 * H, 2 * W, NF)
    with pytest.raises(ValueError, match="CUDA"):
        tail.tail_stage_tf32_cuda(0, x, case.packed, out)
    with pytest.raises(ValueError, match="kernel's width"):
        tail.tail_stage_tf32_cuda(0, x, _pack(case.p, torch.bfloat16), out)
    with pytest.raises(ValueError, match="kernel's width"):
        tail.tail_stage_tf32_cuda(0, x, _pack(_tail_params(np.random.RandomState(0), 16)), out)

    def refuse(*a, **k):
        raise AssertionError("the 3xTF32 wrapper was called on the CPU")

    monkeypatch.setattr(tail, "tail_stage_tf32_cuda", refuse)
    got = tail.tail_f32(case.x, case.packed)
    assert torch.equal(got.permute(0, 2, 3, 1), case.plain)
    torch.testing.assert_close(got, tail.tail_plain(case.x, case.packed), atol=1e-4, rtol=0)
