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
    K8 29 on the two flow estimators and 9 on a VGG pool-4 tower."""
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
    # flow_256's segments (at base 256) and flow_64's (at base 64): 15 + 14.
    cases += [(s, hw, hw, "banded", n) for s, hw, n in zip(flow, (256, 128, 64, 32, 64, 128, 256),
                                                           (2, 2, 2, 2, 2, 2, 3))]
    cases += [(s, hw, hw, "banded", n) for s, hw, n in zip(flow, (64, 32, 16, 8, 16, 32, 64),
                                                           (2, 2, 2, 1, 2, 2, 3))]
    cases += [(s, 256 >> i, 256 >> i, "banded", n) for i, (s, n) in enumerate(zip(vgg, (1, 2, 3, 3)))]
    for specs, h, w, route, launches in cases:
        if route == "banded":
            groups = conv_stack.plan(tuple(specs), h, w, conv_stack.BAND_TILES)
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
    route = lambda groups: [(g.lo, g.hi, g.wide) for g in groups]
    assert route(conv_stack.tile_plan(sep1, 16, True)) == [(0, 1, False), (1, 2, True), (2, 3, True)]
    assert route(conv_stack.tile_plan(sep2, 16, True)) == [(0, 1, True), (1, 2, True), (2, 3, False)]
    assert not any(g.wide for g in conv_stack.tile_plan(mixer, 16, False))
    assert [(g.lo, g.hi) for g in conv_stack.tile_plan(mixer, 16, True) if g.wide] == [(1, 2)]
    assert not any(g.wide for g in conv_stack.tile_plan(sep1, 4, True) + conv_stack.tile_plan(sep2, 8, True))
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
