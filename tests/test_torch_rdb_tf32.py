"""K1's and K2's f32 route (the RRDB trunk) on the 3xTF32 kernel
(``csrc/conv_frame_tf32_wgmma.cuh``: conv1..conv4 in gc mode, conv5 in conv
mode with the residual epilogue, all five reading the dense-concat buffer
in place), on the CPU: each launch emulated
(``tests/test_torch_tf32x3.py:_emulate_launch``) against the plain f64
conv, the emulated RRDB against the plain f32 route and the JAX package's
``rrdb_pallas`` in f32 interpret mode; the banded RRDB against the full
frame bit for bit; the planted faults; the packing; and which kernel the
f32 routes launch.

Tolerances: 5e-5, the JAX tests' own (tests/test_pallas_rrdb.py), against
JAX; chip_smoke.py's f32 limit, a relative L2 of 1e-5, against the plain f32
route and f64."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from master_thesis_tpu.ops.pallas_rrdb import rrdb_pallas
from master_thesis_tpu_torch.ops import conv_f32, conv_stack, fragments, rrdb
from tests.test_torch_rrdb import _pack, _rrdb_params, _to_jax
from tests.test_torch_tf32x3 import _emulate_launch, _one_thread, _rel_l2  # noqa: F401 (fixture)

ATOL_JAX = 5e-5
L2_F32 = 1e-5
NF, GC = rrdb.KERNEL_NF, rrdb.KERNEL_GC
# One frame of 16x16: gc mode's tile is 8 rows x 16 (two row tiles, so the
# halo-row fault shows); K2 in bands of 8 rows (the second one's buffer from
# frame row 3).
N, H, W, BAND = 1, 16, 16, 8


def _emulate_conv(k, x, p, out, *, r=None, r2=None, plant=0, **window):
    """:func:`rrdb.rdb_conv_tf32_cuda`'s launch, emulated into ``out``."""
    mat, bias = p.tf32[k], p.b.split([w.shape[0] for w in p.kernels])[k]
    if k < 4:
        return _emulate_launch(x, mat, bias, mode="gc", k=3, cout=GC, epi="leaky", out=out, plant=plant,
                               **window)
    return _emulate_launch(x, mat, bias, mode="conv", k=3, cout=NF, epi="resid", out=out, r=r, r2=r2,
                           plant=plant, **window)


def _conv(plant):
    return lambda k, x, p, out, **kw: _emulate_conv(k, x, p, out, plant=plant, **kw)


def _rrdb(x, rdbs, rdb_fn):
    y = x
    for j, p in enumerate(rdbs):
        y = rdb_fn(y, p, x if j == 2 else None)
    return y


def _emulated(x, rdbs, plant=0):
    """K1's 15 launches emulated: NCHW (channels-last strides)."""
    return _rrdb(x, rdbs, lambda y, p, res: rrdb._rdb_f32(y, p, res, _conv(plant))[0])


def _emulated_banded(x, rdbs, plant=0):
    """K2's launches, 15 a band, emulated."""
    return _rrdb(x, rdbs, lambda y, p, res: rrdb._rdb_banded_f32(y, p, res, BAND, _conv(plant))[0])


def _f64(x, rdbs):
    """The RRDB in f64 with ``F.conv2d``, independent of the routes."""
    def rdb(y, p, res):
        feats = [y]
        for k in range(5):
            a = F.conv2d(torch.cat(feats, 1), p.kernels[k].double(), p.b.split([32] * 4 + [64])[k].double(),
                         padding=1)
            if k < 4:
                feats.append(F.leaky_relu(a, 0.2))
        out = 0.2 * a + y
        return out if res is None else 0.2 * out + res
    return _rrdb(x.double(), rdbs, rdb)


@pytest.fixture(scope="module")
def case():
    """One nf 64 / gc 32 RRDB's weights, an input of 1 x 64 x 16x16 (numpy for
    JAX, NCHW for the port); the emulated RRDB, the plain f32 route and f64."""
    rng = np.random.RandomState(19)
    params = _rrdb_params(rng, NF, GC)
    rdbs = _pack(params)
    y = rng.randn(N, NF, H, W).astype(np.float32)
    x = torch.from_numpy(y)
    return SimpleNamespace(params=params, rdbs=rdbs, y=y, x=x, emu=_emulated(x, rdbs),
                           plain=rrdb.rrdb_trunk(x, [rdbs], rdb_fn=rrdb.rdb_f32), f64=_f64(x, rdbs))


def test_tf32_gc_packing(case):
    """``wgmma_tf32_gc_matrix`` holds ``w[o, c, ky, kx]`` at chunk ``c // 32``,
    row of taps ``ky``, row ``32 kx + o``, 16-byte position ``(c % 32 // 4) ^
    row % 8``, hi then lo; ``pack_rdbs`` makes each conv's operand (conv5's
    ``wgmma_tf32_matrix``) in f32 at nf 64 / gc 32 alone, with one gather."""
    p = case.rdbs[1]
    w = p.kernels[2]  # conv3: 128 -> 32
    hi, lo = fragments.tf32_split(w)
    mats = p.tf32
    blocks = mats[2].view(2, 128 // 32, 3, 96, 8, 4)
    for o, c, ky, kx in ((0, 0, 0, 0), (5, 37, 2, 1), (31, 127, 1, 2), (17, 64, 0, 2)):
        row = 32 * kx + o
        pos = (c % 32 // 4) ^ (row % 8)
        assert blocks[0, c // 32, ky, row, pos, c % 4] == hi[o, c, ky, kx]
        assert blocks[1, c // 32, ky, row, pos, c % 4] == lo[o, c, ky, kx]
    for k in range(4):
        assert torch.equal(mats[k], fragments.wgmma_tf32_gc_matrix(p.kernels[k]))
    assert torch.equal(mats[4], fragments.wgmma_tf32_matrix(p.kernels[4]))
    assert [m.numel() for m in mats] == [2 * 288 * cin for cin in (64, 96, 128, 160)] + [2 * 1152 * 192]
    convs = [(k, b) for k, b in zip(p.kernels, p.b.split([32] * 4 + [64]))]
    assert rrdb.pack_rdb(convs, torch.bfloat16).tf32 is None
    thin = _pack(_rrdb_params(np.random.RandomState(0), 16, 8))
    assert thin[0].tf32 is None and p.tf32 is not None
    with pytest.raises(ValueError, match="Cout == 32"):
        fragments.wgmma_tf32_gc_matrix(p.kernels[4])


@pytest.mark.parametrize("k", range(5))
def test_tf32_rdb_conv_emulation_matches_f64(case, k):
    """Each of an RDB's five launches emulated over the dense-concat buffer
    (the input its first Cin channels, conv1..conv4 stored into its channel
    slice, conv5 with both residuals) against the conv in f64 within L2_F32,
    and the plain f32 launch within L2_F32, max|diff| 1e-4."""
    g = torch.Generator().manual_seed(k)
    cat = torch.rand(N, H, W, NF + 4 * GC, generator=g)
    p = case.rdbs[0]
    cin = NF + k * GC
    x = cat[..., :cin] if k < 4 else cat
    a = rrdb._conv_args(k, p, cat[..., :NF], torch.rand(N, H, W, NF, generator=g))
    wt, bias = p.kernels[k].double(), a["bias"].double()
    want = F.conv2d(x.double().permute(0, 3, 1, 2), wt, bias, padding=1).permute(0, 2, 3, 1)
    if k < 4:
        want = F.leaky_relu(want, 0.2)
        out = cat[..., cin:cin + GC]
        got = _emulate_conv(k, x, p, out.clone().zero_())
        plain = rrdb.rdb_conv_tf32_plain(k, x, p, out.clone())
    else:
        want = 0.2 * (0.2 * want + a["r"].double()) + a["r2"].double()
        out = torch.empty(N, H, W, NF)
        got = _emulate_conv(k, x, p, out.clone(), r=a["r"], r2=a["r2"])
        plain = rrdb.rdb_conv_tf32_plain(k, x, p, out.clone(), r=a["r"], r2=a["r2"])
    assert _rel_l2(got, want) <= L2_F32 / 4
    assert _rel_l2(got, plain) <= L2_F32
    torch.testing.assert_close(got, plain.float(), atol=1e-4, rtol=0)


def test_tf32_rrdb_emulation_matches_plain_f64_and_the_jax_pallas_kernel(case):
    """One emulated RRDB (15 launches) against the plain f32 route and f64
    within L2_F32, and ``rrdb_pallas`` in f32 (interpret mode,
    ``Precision.HIGHEST``) at the JAX tests' 5e-5."""
    with jax.default_matmul_precision("highest"):
        want = rrdb_pallas(jnp.asarray(case.y.reshape(N, NF, H * W)), _to_jax(case.params), NF, GC, W,
                           interpret=True)
    assert _rel_l2(case.emu, case.plain) <= L2_F32
    assert _rel_l2(case.emu, case.f64) <= L2_F32 / 4
    np.testing.assert_allclose(case.emu.contiguous().numpy().reshape(N, NF, H * W), np.asarray(want), atol=ATOL_JAX)


def test_tf32_banded_rrdb_emulation_equals_the_full_frame(case):
    """K2's launches emulated in bands of 8 rows (conv k over
    ``band_windows``: the band buffer's row 0 the frame's x_row0, gc mode's
    stores at out_row0, conv5 into the frame with x and the residual read
    in place) equal K1's bit for bit: each output sums the same products
    in the same order."""
    assert torch.equal(_emulated_banded(case.x, case.rdbs), case.emu)


def _body_l2(got, want, x):
    """chip_smoke.py's reading of an RRDB: the relative L2 over the part the
    convs compute, ``want - 1.2 x`` (the identity part left out: it dilutes
    a fault ~6x in the output)."""
    return ((got.double() - want.double()).norm() / (want.double() - 1.2 * x.double()).norm()).item()


@pytest.mark.parametrize("plant", [1, 2, 3, 4, 5])
def test_tf32_rrdb_emulation_sees_the_planted_faults(case, plant):
    """Each ``-DTF32_PLANT`` fault moves the emulated RRDB past L2_F32 from the
    plain route, read over the part the convs compute (:func:`_body_l2`, as
    chip_smoke.py reads it), where the route's own reads 5x below it: 1
    (1xTF32, also past 5 L2_F32 from f64), 2 (the corner tap:
    gc mode's dx 0 columns of row of taps 0, conv mode's tap (0, 0)), 3
    (each tile's top halo row below the first row tile), 5 (a gc-mode conv's
    last chunk loaded from one chunk early) on the full frame; 4 (a band
    buffer's first row, the halo row above the band) on the bands alone:
    the full frame reads no such row."""
    got = (_emulated_banded if plant == 4 else _emulated)(case.x, case.rdbs, plant)
    assert _body_l2(case.emu, case.plain, case.x) < L2_F32 / 5
    assert _body_l2(got, case.plain, case.x) > L2_F32
    if plant == 1:
        assert _body_l2(got, case.f64, case.x) > 5 * L2_F32


def _meta_rdbs(nf=NF, gc=GC):
    convs = [(torch.empty(co, ci, 3, 3, device="meta"), torch.empty(co, device="meta"))
             for ci, co in rrdb._widths(nf, gc)]
    return rrdb.pack_rdbs([convs] * 3, torch.float32)


def test_f32_rdb_routes_send_all_five_convs_to_the_tf32_kernel(monkeypatch):
    """Off the CPU (the meta device, each launch recorded) an f32 RRDB at nf
    64 / gc 32 launches the 3xTF32 kernel 15 times (per RDB conv1..conv4 in
    gc mode, Cin 64 .. 160 of the 192-channel buffer, then conv5 in conv mode
    with the residual epilogue, the RRDB residual on the third) and no
    ``conv_f32_fwd``, at K1's shape (80 x 64^2) and K2's (8 x 128x256 in
    32-row bands: 15 a band, conv k over ``band_windows``); every tile within
    the shared memory."""
    calls = []

    def launch(x, mat, bias, out, *, mode, k, cout, epi, hin=None, rows=None, x_row0=0, out_row0=0, addr=None,
               r=None, r2=None):
        n, x_rows, w, cin = x.shape
        hin = x_row0 + x_rows if hin is None else hin
        r0, r1 = rows or (0, hin)
        fr, trows, tw, nh = conv_stack.tf32_tile(mode, n, hin, w, k, cout, r0, r1, x_row0)
        cols = 64 * conv_stack.TF32_LAST_BLOCKS if mode == "gc" else None
        assert conv_stack.tf32_smem(fr, trows, tw, k, nh, cols=cols) <= conv_stack.SMEM_LIMIT
        assert conv_stack.pixel_strides(x)[0] == NF + 4 * GC
        assert out.stride(2) == (NF + 4 * GC if mode == "gc" else NF)
        calls.append((mode, epi, cin, cout, (r0, r1), r is not None, r2 is not None))

    def simt(*a, **k):
        raise AssertionError("the f32 RDB launched conv_f32_fwd")

    monkeypatch.setattr(conv_stack, "tf32_launch", launch)
    monkeypatch.setattr(rrdb, "conv_f32_fwd", simt)
    rdbs = _meta_rdbs()
    before = rrdb.rdb_f32.launches
    rrdb.rrdb_trunk(torch.empty(80, NF, 64, 64, device="meta"), [rdbs], rdb_fn=rrdb.rdb_f32)
    assert rrdb.rdb_f32.launches - before == 0  # the meta device is not the card: nothing counted
    rdb = [("gc", "leaky", NF + k * GC, GC, (0, 64), False, False) for k in range(4)]
    assert calls == (rdb + [("conv", "resid", 192, NF, (0, 64), True, False)]) * 2 + rdb + [
        ("conv", "resid", 192, NF, (0, 64), True, True)]
    calls.clear()
    rrdb.rrdb_trunk(torch.empty(8, NF, 128, 256, device="meta"), [rdbs],
                    rdb_fn=lambda x, p, res: rrdb.rdb_banded_f32(x, p, res))
    assert len(calls) == 3 * 4 * 5 and {c[0] for c in calls[4::5]} == {"conv"}
    assert [c[4] for c in calls[5:10]] == [list(rrdb.band_windows(128, 32, 64))[k] for k in range(5)]


def test_tf32_input_pixel_strides():
    """The strides the 3xTF32 kernel's TMA map takes: a contiguous NHWC
    tensor's dense ones, whatever free stride a size-1 dimension carries
    (a batch of one frame, as ``is_contiguous`` ignores it); the dense
    concat's channel slices and the band buffer's row slice at the buffer's
    pixel and frame strides; NCHW strides and 8-byte pixel strides refused."""
    x = torch.zeros(1, 16, 16, 256).as_strided((1, 16, 16, 256), (1, 4096, 256, 1))  # frame stride 1
    assert x.is_contiguous() and x.stride(0) == 1
    assert conv_stack.pixel_strides(x) == (256, 16 * 16 * 256)
    cat = torch.zeros(2, 20, 24, NF + 4 * GC)
    assert conv_stack.pixel_strides(cat[..., :NF + 2 * GC]) == (192, 20 * 24 * 192)
    assert conv_stack.pixel_strides(cat[:, :7, :, :NF]) == (192, 20 * 24 * 192)
    assert conv_stack.pixel_strides(cat[:1, :1, :, :NF]) == (192, 24 * 192)
    assert conv_stack.pixel_strides(torch.zeros(2, 64, 20, 24).permute(0, 2, 3, 1)) is None
    assert conv_stack.pixel_strides(torch.zeros(2, 20, 24, 6)[..., :2]) is None


def test_f32_rdb_routes_other_widths_to_the_simt_kernel(monkeypatch):
    """Off the CPU (the meta device) an RDB packed at another width (nf 16 /
    gc 8: no 3xTF32 operands) runs each conv as one ``conv_f32_fwd`` (the
    SIMT kernel), in bands too; it never reaches the 3xTF32 kernel."""
    calls = []

    def simt(x, w, out, *, epi, **kw):
        calls.append((x.shape[3], out.shape[3], epi))
        return out

    def refuse(*a, **k):
        raise AssertionError("an RDB at nf 16 reached the 3xTF32 kernel")

    monkeypatch.setattr(conv_stack, "tf32_launch", refuse)
    monkeypatch.setattr(rrdb, "conv_f32_fwd", simt)
    p = _meta_rdbs(16, 8)[0]
    rrdb.rdb_f32(torch.empty(2, 16, 8, 8, device="meta"), p)
    assert calls == [(16, 8, "leaky"), (24, 8, "leaky"), (32, 8, "leaky"), (40, 8, "leaky"), (48, 16, "resid")]
    calls.clear()
    rrdb.rdb_banded_f32(torch.empty(2, 16, 8, 8, device="meta"), p, band_rows=4)
    assert len(calls) == 10


def test_f32_rdb_route_on_the_cpu_runs_the_plain_convs(case, monkeypatch):
    """On a CPU tensor the f32 RDB never reaches the 3xTF32 kernel's wrapper:
    every conv is its plain version; the wrapper itself refuses a CPU tensor
    and an RDB packed in bf16 or at another width; the first design's plain
    route is the route's."""
    p = case.rdbs[0]
    cat = torch.zeros(N, H, W, NF + 4 * GC)
    with pytest.raises(ValueError, match="CUDA"):
        rrdb.rdb_conv_tf32_cuda(0, cat[..., :NF], p, cat[..., NF:NF + GC])
    thin = _pack(_rrdb_params(np.random.RandomState(0), 16, 8))[0]
    with pytest.raises(ValueError, match="kernel's widths"):
        rrdb.rdb_conv_tf32_cuda(0, cat[..., :NF], thin, cat[..., NF:NF + GC])

    def refuse(*a, **k):
        raise AssertionError("the 3xTF32 wrapper was called on the CPU")

    monkeypatch.setattr(rrdb, "rdb_conv_tf32_cuda", refuse)
    got = rrdb.rrdb_trunk(case.x, [case.rdbs], rdb_fn=rrdb.rdb_f32)
    assert torch.equal(got, case.plain)
    assert torch.equal(_rrdb(case.x, case.rdbs, rrdb.rdb_f32_first), case.plain)
    assert torch.equal(_rrdb(case.x, case.rdbs, lambda y, p, res: rrdb.rdb_banded_f32_first(y, p, res, BAND)),
                       _rrdb(case.x, case.rdbs, lambda y, p, res: rrdb.rdb_banded_f32(y, p, res, BAND)))
    torch.testing.assert_close(got, rrdb.rrdb_trunk(case.x, [case.rdbs], rdb_fn=rrdb.rdb_plain), atol=1e-4,
                               rtol=0)
    assert conv_f32.nhwc(got).is_contiguous()
