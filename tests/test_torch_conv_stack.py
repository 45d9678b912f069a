"""The conv-stack kernels' plain versions (K7 ``conv_stack_tiles``, K8
``conv_stack_banded``) and the DFPN stages on them against the JAX
package's Pallas kernels in interpret mode, in f32 on the same seeded
inputs and weights; the packing and the launch plan the CUDA kernel reads.

Tolerance 2e-4, the JAX tests' own, unless a test states another."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops import pallas_sep4d as jsep
from master_thesis_tpu_torch.ops import conv_stack, fragments

ATOL = 2e-4


def _stack(rng, cin, spec):
    """Seeded ``spec`` = [(k, cout, relu), ...]: the port's packed stack
    and the same weights as JAX ``(kernels HWIO, biases, relus)``."""
    convs, jk, jb, relus = [], [], [], []
    for k, cout, relu in spec:
        w = (rng.randn(cout, cin, k, k) * (1.0 / (k * k * cin)) ** 0.5).astype(np.float32)
        b = (rng.randn(cout) * 0.1).astype(np.float32)
        convs.append((torch.from_numpy(w), torch.from_numpy(b)))
        jk.append(jnp.asarray(w.transpose(2, 3, 1, 0)))
        jb.append(jnp.asarray(b))
        relus.append(relu)
        cin = cout
    return conv_stack.pack_stack(convs, relus, torch.float32), (jk, jb, relus)


@pytest.mark.parametrize("nt,side,cin,spec", [
    (6, 8, 1, [(3, 5, True), (5, 7, True), (3, 2, False)]),  # Cin 1, Cout 2
    (5, 8, 3, [(5, 4, True), (3, 1, False)]),  # Cout 1
])
def test_conv_stack_tiles_matches_jax(rng, nt, side, cin, spec):
    p, (jk, jb, relus) = _stack(rng, cin, spec)
    x = rng.randn(nt, cin, side * side).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.conv_stack_tiles(jnp.asarray(x), jk, jb, relus, tile_side=side, grid_tiles=4,
                                     interpret=True)
    got = conv_stack.conv_stack_tiles(torch.from_numpy(x), p, side)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n,h,w,cin,spec,band_rows", [
    (2, 14, 10, 3, [(5, 6, True), (3, 4, False)], 4),  # 4 bands, halo 3 past both borders
    (1, 12, 9, 10, [(5, 8, True), (3, 2, False)], 5),  # the flow estimators' Cin 10 at 5x5
])
def test_conv_stack_banded_matches_jax(rng, n, h, w, cin, spec, band_rows):
    p, (jk, jb, relus) = _stack(rng, cin, spec)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.conv_stack_banded(jnp.asarray(x), jk, jb, relus, band_rows=band_rows,
                                      interpret=True)
    got = conv_stack.conv_stack_banded(torch.from_numpy(x), p)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _dfpn_and_params(base):
    from master_thesis_tpu.models import convert as jconvert
    from master_thesis_tpu_torch.models.dfpn import DFPN

    dfpn = DFPN(base_size=base, device="cpu", generator=torch.Generator().manual_seed(7))
    return dfpn, jconvert.dfpn_from_torch(dfpn.state_dict())


def test_mixer_apply_matches_jax(rng):
    """At corr_size 8 (64 -> .. -> 2 channels, 5x5 and 3x3 taps)."""
    dfpn, params = _dfpn_and_params(128)
    cs = 8
    corr = (rng.randn(1, 2, cs, cs, cs, cs) * 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.mixer_apply_pallas(params["mixer"], jnp.asarray(corr), corr_size=cs,
                                       dtype=jnp.float32, interpret=True)
    mixer = dfpn.corr_mixer
    got = conv_stack.mixer_apply(mixer.packed(), torch.from_numpy(corr), cs, torch.float32)
    assert got.shape == want.shape == (1, 2, cs, cs, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(mixer(torch.from_numpy(corr)).numpy(), np.asarray(want), atol=ATOL)


def test_sep4d_apply_matches_jax(rng):
    """Both stages and the p <-> q swap at corr_size 4."""
    dfpn, params = _dfpn_and_params(64)
    cs = 4
    corr = (rng.randn(1, 2, cs, cs, cs, cs)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsep.sep4d_apply_pallas(params["separable4d"], jnp.asarray(corr),
                                       dtype=jnp.float32, interpret=True)
    sep = dfpn.corr.conv
    got = conv_stack.sep4d_apply(*sep.packed(), torch.from_numpy(corr), torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(sep(torch.from_numpy(corr)).numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cout,cin,k", [(2, 1, 3), (128, 10, 5), (1, 128, 3), (64, 3, 3)])
def test_conv_matrix_pads_each_tap_to_16_channels(rng, cout, cin, k):
    """The kernel's B matrix: rows (ky, kx, c) with c zero-padded to 16 per
    tap, outputs padded to 16; unpacked it is the padded HWIO kernel."""
    w = torch.from_numpy(rng.randn(cout, cin, k, k).astype(np.float32))
    c16 = -(-cin // 16) * 16
    mat = fragments.unpack(conv_stack.conv_matrix(w), k * k * c16, cout)
    want = torch.zeros(k, k, c16, cout)
    want[:, :, :cin] = w.permute(2, 3, 1, 0)
    assert torch.equal(mat, want.reshape(k * k * c16, cout))


def test_plan_of_the_dfpn_stacks():
    """Every group of the production stacks fits a block's shared memory,
    the groups cover the stack in order, and the launch counts are the ones
    chip_smoke.py expects: K7 5 on the mixer and 3 + 3 on sep4d (each wide
    conv its own launch, :func:`conv_stack.tile_plan`);
    K8 30 on the two flow estimators and 10 on a VGG pool-4 tower (each
    frame conv its own launch, :func:`conv_stack.band_plan`)."""
    mixer = [(5, 256, 256), (3, 256, 256), (3, 256, 16), (5, 16, 16), (3, 16, 16), (3, 16, 8),
             (5, 8, 8), (3, 8, 8), (3, 8, 4), (5, 4, 4), (3, 4, 4), (3, 4, 2), (5, 2, 2), (3, 2, 2)]
    sep1, sep2 = [(3, 1, 128), (3, 128, 256), (3, 256, 256)], [(3, 256, 256), (3, 256, 128), (3, 128, 1)]
    flow = [[(5, 10, 128), (3, 128, 128)]] + [[(5, 128, 128), (3, 128, 128)]] * 5 + [
        [(5, 128, 128), (3, 128, 128), (3, 128, 2)]]
    vgg = [[(3, 3, 64), (3, 64, 64)], [(3, 64, 128), (3, 128, 128)],
           [(3, 128, 256), (3, 256, 256), (3, 256, 256)], [(3, 256, 512), (3, 512, 512), (3, 512, 512)]]
    assert len(conv_stack.plan(tuple(mixer), 4, 4, ((4, 4),))) == 1  # base 64: one launch
    # K7 on the channels-last route dfpn_infer_apply takes (wide convs on
    # the wide-conv kernel); the channel-major first design keeps 5 on the mixer.
    cases = [(mixer, 16, 16, "wide", 5), (mixer, 16, 16, "fused", 5), (sep1, 16, 16, "wide", 3),
             (sep2, 16, 16, "wide", 3)]
    # flow_256's segments (at base 256) and flow_64's (at base 64): 15 + 15.
    cases += [(s, hw, hw, "banded", n) for s, hw, n in zip(flow, (256, 128, 64, 32, 64, 128, 256),
                                                           (2, 2, 2, 2, 2, 2, 3))]
    cases += [(s, hw, hw, "banded", n) for s, hw, n in zip(flow, (64, 32, 16, 8, 16, 32, 64),
                                                           (2, 2, 2, 2, 2, 2, 3))]
    cases += [(s, 256 >> i, 256 >> i, "banded", n) for i, (s, n) in enumerate(zip(vgg, (2, 2, 3, 3)))]
    for specs, h, w, route, launches in cases:
        if route == "banded":
            groups = conv_stack.band_plan(tuple(specs), h, w)
        else:
            groups = conv_stack.tile_plan(tuple(specs), h, route == "wide")
        assert len(groups) == launches, specs
        assert [g.lo for g in groups] == [0] + [g.hi for g in groups[:-1]]
        assert groups[-1].hi == len(specs)
        assert all(g.smem <= conv_stack.SMEM_LIMIT for g in groups)


def test_wrappers_take_the_plain_version_on_the_cpu_only(rng):
    p, _ = _stack(rng, 4, [(3, 4, True)])
    x = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
    before = conv_stack.conv_stack_tiles_cuda.launches
    conv_stack.conv_stack_tiles(x, p, 4)
    assert conv_stack.conv_stack_tiles_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        conv_stack.conv_stack_tiles_cuda(x, p, 4)
    with pytest.raises(ValueError, match="CUDA"):
        conv_stack.conv_stack_banded_cuda(x.reshape(2, 4, 4, 4), p)


def test_tile_plan_routes_the_wide_convs():
    """On the channels-last route sep4d's four wide convs (3x3, 64-multiple
    widths, 16x16 tiles) are one launch each on the wide-conv kernel; 1 ->
    128 and 128 -> 1 stay in fused groups; of the mixer's convs only its
    3x3 256 -> 256 goes wide (not the 5x5, not the thin tail). The
    channel-major route (the first design) is fused groups alone. Other
    tile sides run fused."""
    sep1, sep2 = ((3, 1, 128), (3, 128, 256), (3, 256, 256)), ((3, 256, 256), (3, 256, 128), (3, 128, 1))
    mixer = ((5, 256, 256), (3, 256, 256), (3, 256, 16), (5, 16, 16), (3, 16, 16), (3, 16, 8))
    route = lambda groups: [(g.lo, g.hi, g.kernel == "wide") for g in groups]
    assert route(conv_stack.tile_plan(sep1, 16, True)) == [(0, 1, False), (1, 2, True), (2, 3, True)]
    assert route(conv_stack.tile_plan(sep2, 16, True)) == [(0, 1, True), (1, 2, True), (2, 3, False)]
    assert all(g.kernel == "fused" for g in conv_stack.tile_plan(mixer, 16, False))
    assert [(g.lo, g.hi) for g in conv_stack.tile_plan(mixer, 16, True) if g.kernel == "wide"] == [(1, 2)]
    assert all(g.kernel == "fused"
               for g in conv_stack.tile_plan(sep1, 4, True) + conv_stack.tile_plan(sep2, 8, True))
    # The DFPN's own packings carry the wide operand exactly where routed.
    p1, _ = _stack(np.random.RandomState(0), 1, [(3, 64, True), (3, 128, True), (3, 64, False)])
    assert [m is not None for m in p1.wide] == [False, True, True]


def _swz(addr):
    """The 128-byte swizzle of a 1024-byte-aligned stage: an address's
    16-byte chunk bits (4-6) XOR its row bits (7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _emulate_wide(x, w, b, relu, swap=False, cout_tile=128):
    """One wide conv as ``csrc/conv3x3_wide_wgmma.cuh`` computes it, read
    through its descriptors: ``x (NT, 16, 16, Cin)`` f32 NHWC, ``w`` OIHW,
    ``b`` f32. Per tile and 64-channel chunk the TMA box (18 x 18 pixels
    from (-1, -1), zeros outside the tile) fills a stage 128-byte swizzled;
    per (chunk, tap) the stage of weights is the bytes of
    ``fragments.wgmma_wide_matrix`` at (chunk, tap, n0) as a bulk copy
    writes them. Warpgroup w's A (64 outputs x 16 channels) starts at row
    64 w + 32 bytes a k16 step, each half's B (144 pixel columns x 16
    channels) at pixel 144 h + 18 dy + dx; row r of either at start + 128 r,
    each address swizzled by its own bits (base offset 0). Column n is
    output pixel (n // 18, n % 18), dropped where either is >= 16; f32 sums,
    bias, ReLU; stores at ``conv_stack.wide_out_strides``."""
    nt, side, _, cin = x.shape
    cout = w.shape[0]
    mat = fragments.wgmma_wide_matrix(w)
    cpad = mat.numel() // (9 * cin)
    box = torch.zeros(nt, 18, 18, cin)
    box[:, 1:17, 1:17] = x
    a_elems = 41984 // 2  # one box stage with its slack, in bf16 elements
    pix = torch.arange(18 * 18).view(-1, 1)
    chans = torch.arange(64).view(1, -1)
    dst = _swz(pix * 128 + 2 * chans) // 2  # where TMA puts (pixel, channel)
    rows, ks = torch.arange(144).view(-1, 1), torch.arange(16).view(1, -1)
    cols = torch.arange(288)
    tg, sg, st, sp = conv_stack.wide_out_strides(nt, cout, swap)
    out = torch.zeros(nt * side * side * cout)
    for n0 in range(0, cpad, cout_tile):
        for wg in range(cout_tile // 64):
            acc = torch.zeros(nt, 64, 288)
            for c in range(cin // 64):
                smem = torch.zeros(nt, a_elems)
                smem[:, dst.reshape(-1)] = box[..., 64 * c: 64 * c + 64].reshape(nt, -1)
                for tap in range(9):
                    off = ((c * 9 + tap) * cpad + n0) * 64
                    wstage = mat[off: off + cout_tile * 64]
                    shift = (tap // 3) * 18 + tap % 3
                    for kk in range(4):
                        a = wstage[_swz(64 * wg * 128 + 32 * kk + rows[:64] * 128 + 2 * ks) // 2]
                        for h in range(2):
                            bidx = _swz((144 * h + shift) * 128 + 32 * kk + rows * 128 + 2 * ks) // 2
                            acc[:, :, 144 * h: 144 * h + 144] += a @ smem[:, bidx].transpose(1, 2)
            o = torch.arange(n0 + 64 * wg, n0 + 64 * wg + 64)
            keep = o < cout
            v = acc[:, keep] + b[o[keep]].view(1, -1, 1)
            v = torch.relu(v) if relu else v
            y, xx = cols // 18, cols % 18
            valid = (y < side) & (xx < side)
            t = torch.arange(nt).view(-1, 1, 1)
            idx = ((t // tg) * sg + (t % tg) * st + ((y * side + xx)[valid] * sp).view(1, -1, 1)
                   + o[keep].view(1, 1, -1))
            out[idx] = v[:, :, valid].transpose(1, 2)
    return out.view(nt, side, side, cout)


@pytest.mark.parametrize("nt,cin,cout,relu", [
    (2, 64, 64, True),
    (2, 128, 256, True),  # sep4d's stage-1 widths
    (1, 256, 128, False),  # stage 2's, no ReLU
    (1, 64, 192, True),  # outputs padded to 256: the second tile's upper half dropped
])
def test_wide_kernel_emulation_matches_plain(rng, nt, cin, cout, relu):
    """The wide-conv kernel's addressing emulated on the CPU
    (``_emulate_wide``: the wrapped 18-pixel-stride columns, the two n144
    halves, the tap and k16 descriptor shifts over 128-byte-swizzled boxes,
    the swizzled weight blocks of ``fragments.wgmma_wide_matrix``) equals
    ``conv_stack_plain`` in f32. Tolerance 1e-4: f32 sums in two orders."""
    w = torch.from_numpy((rng.randn(cout, cin, 3, 3) * (1.0 / (9 * cin)) ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.randn(nt, 16, 16, cin).astype(np.float32))
    p = conv_stack.pack_stack([(w, b)], [relu], torch.float32)
    want = conv_stack.conv_stack_plain(x.permute(0, 3, 1, 2), p).permute(0, 2, 3, 1)
    got = _emulate_wide(x, w, b, relu, cout_tile=64 if cout == 64 else 128)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_wide_kernel_emulation_swapped_stores(rng):
    """With ``swap`` (sep4d's p <-> q swap in the epilogue), the emulated
    stores of ``wide_out_strides`` give ``swap_tiles`` of the plain output:
    512 tiles = 2 groups of 256 (tile 256 g + q, pixel t <- tile 256 g + t,
    pixel q)."""
    nt = 512
    w = torch.from_numpy((rng.randn(64, 64, 3, 3) * 0.04).astype(np.float32))
    b = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.randn(nt, 16, 16, 64).astype(np.float32))
    p = conv_stack.pack_stack([(w, b)], [True], torch.float32)
    want = conv_stack.conv_stack_tiles_cl_plain(x.permute(0, 3, 1, 2), p, swap=True)
    got = _emulate_wide(x, w, b, True, swap=True, cout_tile=64)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cin,cout", [(64, 128), (256, 256), (128, 64)])
def test_wgmma_wide_matrix_layout(rng, cin, cout):
    """``fragments.wgmma_wide_matrix``: index ``(c // 64, tap, o, 64)`` with
    outputs padded to 128 by zeros, and row o's 16-byte chunk j at position
    ``j ^ o % 8``."""
    w = torch.from_numpy(rng.randn(cout, cin, 3, 3).astype(np.float32))
    mat = fragments.wgmma_wide_matrix(w)
    cpad = -(-cout // 128) * 128
    blocks = mat.view(cin // 64, 9, cpad, 8, 8)
    for c, tap, o, pos in [(0, 0, 0, 0), (cin // 64 - 1, 4, cout - 1, 3), (0, 8, 13, 6)]:
        j = pos ^ (o % 8)
        assert torch.equal(blocks[c, tap, o, pos], w[o, 64 * c + 8 * j: 64 * c + 8 * j + 8, tap // 3, tap % 3])
    assert not blocks[:, :, cout:].any()
    with pytest.raises(ValueError, match="wide layout"):
        fragments.wgmma_wide_matrix(w[:, :32])


def test_channels_last_entry_matches_the_tile_entry(rng):
    """``conv_stack_tiles_cl`` (sep4d's channels-last path) on the CPU equals
    ``conv_stack_tiles`` on the same tiles, from either input layout, and
    returns channels-last tiles. Tolerance 1e-5: the CPU's conv sums a
    channels-last input in another order."""
    p, _ = _stack(rng, 64, [(3, 64, True), (3, 8, False)])
    x = torch.from_numpy(rng.randn(3, 64, 16, 16).astype(np.float32))
    want = conv_stack.conv_stack_tiles(x.reshape(3, 64, 256), p, 16).reshape(3, 8, 16, 16)
    for t in (x, x.contiguous(memory_format=torch.channels_last)):
        got = conv_stack.conv_stack_tiles_cl(t, p)
        assert got.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k,cin,cout", [(5, 128, 128), (5, 64, 64), (3, 256, 512), (5, 128, 192)])
def test_wgmma_wide_matrix_layout_5x5_and_wide_outputs(rng, k, cin, cout):
    """``fragments.wgmma_wide_matrix`` for the frame kernel: 5x5 kernels
    (tap ``5 ky + kx``) and Cout 64 / 512, index ``(c // 64, tap, o, 64)``
    with outputs padded to 128 by zeros, row o's 16-byte chunk j at
    position ``j ^ o % 8``; other kernel sizes are refused."""
    w = torch.from_numpy(rng.randn(cout, cin, k, k).astype(np.float32))
    mat = fragments.wgmma_wide_matrix(w)
    cpad = -(-cout // 128) * 128
    blocks = mat.view(cin // 64, k * k, cpad, 8, 8)
    for c, tap, o, pos in [(0, 0, 0, 0), (cin // 64 - 1, k * k - 1, cout - 1, 5), (0, k + 1, 13, 6)]:
        j = pos ^ (o % 8)
        assert torch.equal(blocks[c, tap, o, pos], w[o, 64 * c + 8 * j: 64 * c + 8 * j + 8, tap // k, tap % k])
    assert not blocks[:, :, cout:].any()
    with pytest.raises(ValueError, match="wide layout"):
        fragments.wgmma_wide_matrix(torch.zeros(64, 64, 7, 7))


def test_band_plan_routes_the_frame_convs():
    """K8's plan sends exactly the convs that :func:`conv_stack.is_frame`
    (3x3 or 5x5, Cin and Cout multiples of 64) to the frame kernel, one
    launch each, at every width of the flow estimators and VGG's pool-4
    tower, and the thin ones (Cin 10 or 3, Cout 2) to the fused groups;
    the first design's plan (:func:`conv_stack.plan`) has no frame launch.
    The stacks packed for the kernels carry the frame operand exactly
    there."""
    flow = ((5, 10, 128), (3, 128, 128)), ((5, 128, 128), (3, 128, 128), (3, 128, 2))
    vgg = ((3, 3, 64), (3, 64, 64)), ((3, 256, 512), (3, 512, 512), (3, 512, 512))
    for specs in flow + vgg + (((3, 64, 32), (5, 32, 64)),):
        for hw in (256, 128, 64, 32, 16, 8):
            groups = conv_stack.band_plan(specs, hw, hw)
            assert [i for g in groups if g.kernel == "frame" for i in range(g.lo, g.hi)] == [
                i for i, s in enumerate(specs) if conv_stack.is_frame(s)]
            assert {g.kernel for g in groups} <= {"fused", "frame"}
            assert all(g.hi == g.lo + 1 for g in groups if g.kernel == "frame")
            assert [g.lo for g in groups] == [0] + [g.hi for g in groups[:-1]]
            assert groups[-1].hi == len(specs)
            assert all(g.kernel == "fused" for g in conv_stack.plan(specs, hw, hw, conv_stack.BAND_TILES))
    p, _ = _stack(np.random.RandomState(0), 10, [(5, 64, True), (3, 64, True), (5, 128, True), (3, 2, False)])
    assert [m is not None for m in p.wide] == [False, True, True, False]


@pytest.mark.parametrize("n,h,w,k,tile", [
    (20, 256, 256, 5, (1, 4, 64)), (20, 256, 256, 3, (1, 4, 64)),  # flow_256, VGG block 1
    (24, 32, 32, 3, (1, 8, 32)), (20, 32, 32, 5, (1, 8, 32)),  # VGG block 4, flow's c9
    (20, 16, 16, 3, (1, 16, 16)), (20, 16, 16, 5, (1, 8, 16)),  # flow_64 at 16x16
    (20, 8, 8, 3, (3, 8, 8)), (20, 8, 8, 5, (2, 8, 8)), (2, 8, 8, 3, (2, 8, 8)),  # whole frames
    (2, 20, 72, 5, (1, 4, 64)),  # a ragged frame: a second column tile of 8
])
def test_frame_tile_keeps_every_output_below_the_columns(n, h, w, k, tile):
    """:func:`conv_stack.frame_tile` at the routed widths: the tile's last
    output column (row stride ``tw + k - 1``, each frame ``k - 1`` halo rows
    apart) stays below ``FRAME_COLS``, and one row or frame more would not."""
    fr, rows, tw = conv_stack.frame_tile(n, h, w, k)
    assert (fr, rows, tw) == tile
    bw, bh = tw + k - 1, rows + k - 1
    last = lambda fr, rows: ((fr - 1) * (rows + k - 1) + rows - 1) * bw + tw
    assert last(fr, rows) <= conv_stack.FRAME_COLS
    if rows < h:  # one row tile fewer would not fit
        assert last(1, -(-h // (-(-h // rows) - 1))) > conv_stack.FRAME_COLS
    else:
        assert fr == n or last(fr + 1, h) > conv_stack.FRAME_COLS
    assert bh <= 256 and bw <= 256


def _emulate_frame(x, w, b, relu, halo_fault=False, seed=0):
    """One frame conv as ``csrc/conv_frame_wgmma.cuh`` computes it, read
    through its descriptors: ``x (N, H, W, Cin)`` f32 NHWC, ``w`` OIHW (k = 3
    or 5), ``b`` f32. Tiles of ``conv_stack.frame_tile`` (fr frames x rows x
    tw); work units (tile, COUT_T outputs). Per tile and 64-channel chunk the
    TMA box (tw + k - 1 columns x rows + k - 1 rows x fr frames from (x0 - r,
    y0 - r, f0), zeros outside the frames) fills a stage 128-byte swizzled;
    past the box the dropped columns read junk (the next stage or the
    weight ring: random here). Per (chunk, tap) the stage of weights is the
    bytes of ``fragments.wgmma_wide_matrix`` at (chunk, tap, n0). Warpgroup
    mt's A (64 outputs x 16 channels) starts at row 64 mt + 32 bytes a k16
    step, each half's B (144 columns x 16 channels) at pixel 144 h + dy bw +
    dx; row r of either at start + 128 r, each address swizzled by its own
    bits (base offset 0). Column n is output pixel (f0 + n // bw // bh, y0 +
    n // bw % bh, x0 + n % bw), dropped where its column, row or frame is
    past the tile's or the frames'; f32 sums, bias, ReLU. With ``halo_fault`` the
    box's top row reads as zeros in every tile below a frame's first
    (``-DFRAME_PLANT=3``)."""
    n, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[-1]
    fr, rows, tw = conv_stack.frame_tile(n, h, wd, k)
    bw, bh = tw + k - 1, rows + k - 1
    tx_n, ty_n, groups = -(-wd // tw), -(-h // rows), -(-n // fr)
    cout_t = 128 if cout % 128 == 0 else 64
    mat = fragments.wgmma_wide_matrix(w)
    cpad = mat.numel() // (k * k * cin)
    # The frames with every tile's halo reachable: TMA's zero fill.
    xp = torch.zeros(groups * fr, ty_n * rows + k - 1, tx_n * tw + k - 1, cin)
    xp[:n, k // 2: k // 2 + h, k // 2: k // 2 + wd] = x
    tiles = [(g, ty, tx) for g in range(groups) for ty in range(ty_n) for tx in range(tx_n)]
    boxes = torch.stack([xp[g * fr: g * fr + fr, ty * rows: ty * rows + bh, tx * tw: tx * tw + bw]
                         for g, ty, tx in tiles])  # (T, fr, bh, bw, cin)
    if halo_fault:
        for t, (_, ty, _) in enumerate(tiles):
            if ty > 0:
                boxes[t, 0, 0] = 0
    nt, box_px = len(tiles), fr * bh * bw
    stage_px = max(box_px, 288 + (k - 1) * (bw + 1))  # what the dropped columns reach
    pix = torch.arange(box_px).view(-1, 1)
    chans = torch.arange(64).view(1, -1)
    dst = _swz(pix * 128 + 2 * chans) // 2  # where TMA puts (pixel, channel)
    junk = torch.Generator().manual_seed(seed)
    r144, r64, ks = torch.arange(144).view(-1, 1), torch.arange(64).view(-1, 1), torch.arange(16).view(1, -1)
    cols = torch.arange(144)
    out = torch.zeros(n, h, wd, cout)
    for n0 in range(0, cout, cout_t):
        for mt in range(cout_t // 64):
            for half in range(2):
                acc = torch.zeros(nt, 64, 144)
                for c in range(cin // 64):
                    smem = torch.randn(nt, stage_px * 64, generator=junk)
                    smem[:, dst.reshape(-1)] = boxes[..., 64 * c: 64 * c + 64].reshape(nt, -1)
                    for tap in range(k * k):
                        off = ((c * k * k + tap) * cpad + n0) * 64
                        wstage = mat[off: off + cout_t * 64]
                        shift = (tap // k) * bw + tap % k
                        for kk in range(4):
                            a = wstage[_swz(64 * mt * 128 + 32 * kk + r64 * 128 + 2 * ks) // 2]
                            bidx = _swz((144 * half + shift) * 128 + 32 * kk + r144 * 128 + 2 * ks) // 2
                            acc += a @ smem[:, bidx].transpose(1, 2)
                o = torch.arange(n0 + 64 * mt, n0 + 64 * mt + 64)
                v = acc + b[o].view(1, -1, 1)
                v = torch.relu(v) if relu else v
                col = 144 * half + cols
                q, xc = col // bw, col % bw
                fl, y = q // bh, q % bh
                for t, (g, ty, tx) in enumerate(tiles):
                    f, yy, xx = g * fr + fl, ty * rows + y, tx * tw + xc
                    keep = (xc < tw) & (y < rows) & (fl < fr) & (f < n) & (yy < h) & (xx < wd)
                    out[f[keep], yy[keep], xx[keep], n0 + 64 * mt:n0 + 64 * mt + 64] = v[t][:, keep].T
    return out


@pytest.mark.parametrize("n,h,w,cin,cout,k,relu", [
    (2, 12, 64, 64, 64, 3, True),  # W 64: three row tiles, 64 outputs a CTA
    (1, 12, 64, 128, 128, 5, False),  # 5x5 at 128 channels, two chunks
    (2, 16, 32, 64, 128, 3, True),  # W 32: two row tiles of 8
    (1, 16, 32, 128, 64, 5, True),
    (2, 16, 16, 64, 128, 5, True),  # W 16: row tiles of 8, the dropped columns reach row 12
    (5, 8, 8, 64, 64, 3, True),  # W 8: three whole frames a tile, a ragged last group
    (3, 8, 8, 128, 128, 5, False),  # two whole frames a tile
    (2, 20, 72, 64, 128, 5, True),  # a ragged frame: 5 row tiles, a second column tile of 8
])
def test_frame_kernel_emulation_matches_plain(rng, n, h, w, cin, cout, k, relu):
    """The frame kernel's addressing emulated on the CPU (``_emulate_frame``:
    the tile of ``frame_tile``, the wrapped columns of a TMA box with its
    halo across tile boundaries and stacked frames, the two n144 halves,
    the tap and k16 descriptor shifts over 128-byte-swizzled boxes, the
    swizzled weight blocks, the masked stores) equals ``conv_stack_plain`` in
    f32. Tolerance 1e-4: f32 sums in two orders."""
    wt = torch.from_numpy((rng.randn(cout, cin, k, k) * (1.0 / (k * k * cin)) ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32))
    p = conv_stack.pack_stack([(wt, b)], [relu], torch.float32)
    want = conv_stack.conv_stack_banded_plain(x, p)
    torch.testing.assert_close(_emulate_frame(x, wt, b, relu), want, atol=1e-4, rtol=0)


def test_frame_emulation_sees_a_dropped_halo_row(rng):
    """The fault planted with ``-DFRAME_PLANT=3`` (each tile's top halo row,
    the tile above's, read as zeros) moves the output far past the
    tolerance, and only in the first output row of each tile below the
    first."""
    n, h, w, c = 1, 12, 64, 64
    wt = torch.from_numpy((rng.randn(c, c, 3, 3) * (1.0 / (9 * c)) ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    p = conv_stack.pack_stack([(wt, b)], [False], torch.float32)
    err = (_emulate_frame(x, wt, b, False, halo_fault=True) - conv_stack.conv_stack_banded_plain(x, p)).abs()
    bad_rows = sorted(set(torch.nonzero(err.amax(dim=(0, 2, 3)) > 1e-4).flatten().tolist()))
    assert bad_rows == [4, 8]
    assert err.max() > 0.1
