"""The port's tail backward (``TailFunction`` on the CPU, i.e. the plain
backward ``tail_bwd_plain``) against ``jax.grad`` through the JAX
``make_hybrid_tail``, whose backward is the fused ``tail_bwd_pallas`` in
interpret mode, f32 on both sides; and K6 (``csrc/tail_bwd_wgmma.cuh``)
emulated on the CPU through its tiles, descriptors and partial sums
(``_emulate_tail_bwd``), held against both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from master_thesis_tpu.ops.pallas_tail import fused_upsample_conv_kernel_adjoint, make_hybrid_tail
from master_thesis_tpu_torch.ops import conv_bwd, fragments
from master_thesis_tpu_torch.ops import tail as ttail
from master_thesis_tpu_torch.ops import tail_bwd
from tests.test_torch_tail import _pack, _tail_params, _wide_params

_JAX_NAMES = {"up1": "upconv1", "up2": "upconv2", "hr": "hr_conv", "last": "conv_last"}


@pytest.mark.parametrize("n,h,w", [(2, 8, 8), (1, 6, 10)], ids=["square", "rectangular"])
def test_tail_function_grads_match_jax(rng, n, h, w):
    """dx and all 8 parameter grads; the upsample-convs' weight grads are the
    original 3x3 kernels' (the JAX kernel folds its 4-phase grads back
    through ``fused_upsample_conv_kernel_adjoint``). Tolerance 1e-4
    relative and absolute, the JAX test's own for this backward
    (tests/test_pallas_tail.py:50)."""
    nf = 16
    p = _tail_params(rng, nf)
    y = rng.randn(n, h, w, nf).astype(np.float32)
    cot = rng.randn(n, 4 * h, 4 * w, 3).astype(np.float32)
    tail = make_hybrid_tail(jnp.float32, interpret=True)
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(
            lambda a, q: jnp.vdot(tail(a, q), jnp.asarray(cot)), argnums=(0, 1)
        )(jnp.asarray(y), {k: jnp.asarray(v) for k, v in p.items()})

    params = []
    for name in tail_bwd.PARAM_NAMES:
        key, kind = name.rsplit("_", 1)
        a = p[f"{_JAX_NAMES[key]}_{'kernel' if kind == 'w' else 'bias'}"]
        t = torch.from_numpy(a).permute(3, 2, 0, 1).contiguous() if kind == "w" else torch.from_numpy(a).clone()
        params.append(t.requires_grad_())
    x = torch.from_numpy(y).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = tail_bwd.TailFunction.apply(x, torch.float32, *params)
    assert out.shape == (n, 3, 4 * h, 4 * w)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-4)
    for name, t in zip(tail_bwd.PARAM_NAMES, params):
        key, kind = name.rsplit("_", 1)
        ref = np.asarray(want_p[f"{_JAX_NAMES[key]}_{'kernel' if kind == 'w' else 'bias'}"])
        ref = ref.transpose(3, 2, 0, 1) if kind == "w" else ref
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4, atol=1e-4, err_msg=name)


def test_pack_adjoint_is_the_flipped_transposed_kernel(rng):
    """The adjoint B matrix holds, at row ``(ky, kx, o)`` and column ``c``,
    ``W[o, c, 2 - ky, 2 - kx]``; conv_last's 3 rows per tap pad to 32."""
    w = torch.from_numpy(rng.randn(3, 64, 3, 3).astype(np.float32))
    mat = fragments.unpack(conv_bwd.pack_adjoint(w, torch.float32, o_pad=32), 9 * 32, 64)
    mat = mat.reshape(3, 3, 32, 64)
    assert torch.equal(mat[:, :, 3:], torch.zeros_like(mat[:, :, 3:]))
    assert torch.equal(mat[0, 2, 1, 5], w[1, 5, 2, 0])
    assert torch.equal(mat[:, :, :3].permute(2, 3, 0, 1), w.flip(2, 3))


def test_tail_bwd_flops_counts_phase_form():
    """184 GFLOP for the train step's tail backward (8 frames, 64x64):
    adjoint and weight grads at the forward's phase-form count (62 each)
    plus the recompute of h1..h3."""
    assert round(tail_bwd.tail_bwd_flops(8, 64, 64) / 1e9) == 184
    assert tail_bwd.tail_bwd_flops(8, 64, 64) > 2 * ttail.tail_flops(8, 64, 64)


# K6's tiling (csrc/tail_bwd_wgmma.cuh): the adjoints' output rows a tile
# (hr_conv 2 warpgroups x 2 rows, the upsample-convs 2 x 1), conv_last's
# (2 x 1), the weight grads' tile rows and K-splits.
_RUN, _ADJ_ROWS, _LAST_ROWS, _WG_ROWS = 64, {"hr": 4, "up": 2}, 2, 2
_KS = {"hr": 128, "up": 32}
# t(a, k): the phase tap of a 3x3 kernel row (or column) k in phase a.
_PHASE_TAP = ((0, 1, 1), (0, 0, 1))


def _swizzle(addr):
    """The 128-byte swizzle of a byte address in a 1024-byte-aligned tile:
    its 16-byte chunk bits (4-6) XOR its 128-byte row bits (7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _box(t, y0, x0, rows, cols):
    """A TMA box of frame ``t`` (H, W, 64) from (y0, x0): zeros outside."""
    h, w, c = t.shape
    out = torch.zeros(rows, cols, c)
    ys, xs, ye, xe = max(y0, 0), max(x0, 0), min(y0 + rows, h), min(x0 + cols, w)
    if ys < ye and xs < xe:
        out[ys - y0: ye - y0, xs - x0: xe - x0] = t[ys:ye, xs:xe]
    return out


def _smem(box):
    """The box as TMA writes it with the 128-byte swizzle, as a flat tensor
    of 2-byte slots: pixel P's 16-byte chunk j at P * 128 + (j ^ P % 8) * 16."""
    flat = box.reshape(-1, 8, 8)
    pix = torch.arange(flat.shape[0]).view(-1, 1, 1)
    dst = (pix * 128 + (torch.arange(8).view(1, 8, 1) ^ pix % 8) * 16) // 2 + torch.arange(8)
    sm = torch.zeros(flat.numel())
    sm[dst.reshape(-1)] = flat.reshape(-1)
    return sm


_M, _K16 = torch.arange(64).view(64, 1), torch.arange(16).view(1, 16)
# A K-major (64 pixels x 16 channels from a shifted start), and B K-major
# from the packed weights (no swizzle: LBO 1024 bytes, SBO 128): byte offsets.
_A_KMAJOR = _M * 128 + (_K16 // 8) * 16 + (_K16 % 8) * 2
_B_PACKED = (_K16.T // 8) * 1024 + (_M.T // 8) * 128 + (_M.T % 8) * 16 + (_K16.T % 8) * 2  # (k, n)
# MN-major (64 channels x 16 pixels, a pixel one 128-byte row): (mn, k).
_MN_MAJOR = _K16 * 128 + _M * 2


def _emulate_last(g, h3, bbuf):
    """conv_last's launch as the kernel reads it: per tile of 2 x 64 pixels,
    g's box from (y0 - 1, x0 - 1) (4 x 66) written as an 8-channel plane (3
    channels, 5 zeros, 16 bytes a pixel, no swizzle) beside a plane of
    zeros, and h3's box 128-byte swizzled. The adjoint: per tap a K-major
    read of g's plane (element (m, k) at start + 16 m + 2 (k % 8), k >= 8
    from the zero plane) times the tap's k16 block of ``last_adj``; the
    weight grad: h3's box MN-major (element (c, pixel) at start + 128 pixel
    + 2 c, swizzled) times g's centre pixels MN-major (element (o, pixel) at
    start + 16 pixel + 2 o). Returns dh3 (n, H, W, 64) and dW OIHW."""
    n, hh, ww, _ = g.shape
    rows, tr, twc = _LAST_ROWS, _LAST_ROWS + 2, _RUN + 2
    g8 = torch.nn.functional.pad(g, (0, 5))
    dh3, dw = torch.zeros(n, hh, ww, 64), torch.zeros(9, 64, 8)
    a_off, a_zero = _M * 16 + (_K16 % 8) * 2, (_K16 >= 8).expand(64, 16)
    b_off = _K16.T * 16 + torch.arange(8).view(1, 8) * 2  # (pixel, o)
    for f in range(n):
        for y0 in range(0, hh, rows):
            for x0 in range(0, ww, _RUN):
                gpl = _box(g8[f], y0 - 1, x0 - 1, tr, twc).reshape(-1)
                hs = _smem(_box(h3[f], y0 - 1, x0 - 1, tr, twc))
                acc = torch.zeros(rows, _RUN, 64)
                for r in range(rows):
                    for tap in range(9):
                        start = ((r + tap // 3) * twc + tap % 3) * 16
                        a = torch.where(a_zero, 0.0, gpl[(start + a_off) // 2])
                        acc[r] += a @ bbuf[(tap * 2048 + _B_PACKED) // 2]
                    for kk in range(_RUN // 16):
                        b = gpl[(((r + 1) * twc + 1 + 16 * kk) * 16 + b_off) // 2]
                        for tap in range(9):
                            start = ((r + tap // 3) * twc + tap % 3 + 16 * kk) * 128
                            dw[tap] += hs[_swizzle(start + _MN_MAJOR) // 2] @ b
                rr, cols = min(rows, hh - y0), min(_RUN, ww - x0)
                dh3[f, y0: y0 + rr, x0: x0 + cols] = acc[:rr, :cols]
    return dh3, dw[:, :, :3].reshape(3, 3, 64, 3).permute(3, 2, 0, 1)


def _emulate_adjoint(planes, bbuf, mode):
    """An adjoint launch as the kernel reads it: ``planes`` (n, P, H, W,
    64), P = 1 for hr_conv (dP_C) or the 4 phase planes (a, b) of the
    upsample-convs' dP; ``bbuf`` the packed B (``pack_tail_bwd``). Per tile
    of rows x 64 output pixels and plane, the box from (y0 - 1, x0 - 1) (6
    x 66, hr_conv) or (y0 - a, x0 - b) (3 x 65), 128-byte swizzled; tap
    (ky, kx), or (ti, tj) at tile pixel (r + 1 - ti, m + 1 - tj), a shifted
    start; B block (plane, chunk, tap, step). Returns the f32 sums (n, H,
    W, 64) before the epilogue."""
    n, np_, h, w, _ = planes.shape
    hr = mode == "hr"
    rows, taps, ext = _ADJ_ROWS[mode], 9 if hr else 4, 2 if hr else 1
    tr, twc = rows + ext, _RUN + ext
    out = torch.zeros(n, h, w, 64)
    for f in range(n):
        for y0 in range(0, h, rows):
            for x0 in range(0, w, _RUN):
                acc = torch.zeros(rows, _RUN, 64)
                for pl in range(np_):
                    oy, ox = (1, 1) if hr else (pl >> 1, pl & 1)
                    sm = _smem(_box(planes[f, pl], y0 - oy, x0 - ox, tr, twc))
                    for cc in range(2):
                        for tap in range(taps):
                            ky, kx = divmod(tap, 3) if hr else (1 - (tap >> 1), 1 - (tap & 1))
                            for st in range(2):
                                b0 = pl * taps * 64 * 64 * 2 + ((cc * taps + tap) * 2 + st) * 2 * 8 * 128
                                bmat = bbuf[(b0 + _B_PACKED) // 2]
                                for r in range(rows):
                                    start = ((r + ky) * twc + kx) * 128 + 32 * (2 * cc + st)
                                    acc[r] += sm[_swizzle(start + _A_KMAJOR) // 2] @ bmat
                rr, cols = min(rows, h - y0), min(_RUN, w - x0)
                out[f, y0: y0 + rr, x0: x0 + cols] = acc[:rr, :cols]
    return out


def _emulate_wgrad(dps, src, mode):
    """A weight-grad launch as the kernel reads it: ``dps`` (n, P, H, W, 64)
    dP (hr_conv: P = 1; an upsample-conv: its phase planes, one unit each),
    ``src`` (n, H, W, 64). CTA (unit u, K-split ks) takes the tiles ks, ks
    + KS, ... of 2 x 64 pixels of dP; A = the dP tile, B = the source box
    from (-1, -1) (4 x 66) or (a - 1, b - 1) (3 x 65), both read MN-major
    through the 128-byte swizzle, tap (wg, k) a shift of B's start by tile
    pixel (r + wg, m + k). Returns the partial rows (KS, units, taps, 64 o,
    64 c)."""
    n, units, h, w, _ = dps.shape
    hr = mode == "hr"
    tpw, ext, ks_n = (3, 2, _KS["hr"]) if hr else (2, 1, _KS["up"])
    rows, tws = _WG_ROWS, _RUN + ext
    runs, groups = -(-w // _RUN), -(-h // rows)
    part = torch.zeros(ks_n, units, tpw * tpw, 64, 64)
    for u in range(units):
        oy, ox = (-1, -1) if hr else ((u >> 1) - 1, (u & 1) - 1)
        for t in range(runs * groups * n):
            x0, y0, f = (t % runs) * _RUN, (t // runs % groups) * rows, t // (runs * groups)
            dsm = _smem(_box(dps[f, u], y0, x0, rows, _RUN))
            ssm = _smem(_box(src[f], y0 + oy, x0 + ox, rows + ext, tws))
            for r in range(rows):
                for kk in range(_RUN // 16):
                    a = dsm[_swizzle((r * _RUN + 16 * kk) * 128 + _MN_MAJOR) // 2]  # (o, pixel)
                    for wg in range(tpw):
                        for k in range(tpw):
                            start = ((r + wg) * tws + k + 16 * kk) * 128
                            b = ssm[_swizzle(start + _MN_MAJOR) // 2]  # (c, pixel)
                            part[t % ks_n, u, wg * tpw + k] += a @ b.T
    return part


def _fold(dphi):
    """The reduce's fold of an upsample-conv's phase weight grads, (4
    phases 2a + b, 4 taps 2ti + tj, O, C), to its 3x3 kernel's, OIHW:
    dW[ky, kx] = sum over a, b of dWphi[a, b, t(a, ky), t(b, kx)]."""
    out = torch.zeros(dphi.shape[2], dphi.shape[3], 3, 3)
    for ky in range(3):
        for kx in range(3):
            for a in (0, 1):
                for b in (0, 1):
                    out[:, :, ky, kx] += dphi[2 * a + b, 2 * _PHASE_TAP[a][ky] + _PHASE_TAP[b][kx]]
    return out


def _phase_major(t):
    """(n, 2H, 2W, C) -> (n, 4, H, W, C): pixel (2i + a, 2j + b) to plane
    2a + b at (i, j), the adjoints' store."""
    n, hh, ww, c = t.shape
    return t.reshape(n, hh // 2, 2, ww // 2, 2, c).permute(0, 2, 4, 1, 3, 5).reshape(n, 4, hh // 2, ww // 2, c)


def _mask(sign, v):
    return torch.where(sign >= 0, v, 0.2 * v)


def _emulate_tail_bwd(x, g, p):
    """K6's eleven launches emulated in f32 on NHWC ``x`` (n, h, w, 64) and
    ``g`` (n, 4h, 4w, 3), ``p`` from ``pack_tail`` (f32): the recompute
    (K4's stages: the plain stages here; test_torch_tail.py emulates them),
    conv_last on CUDA cores, then each adjoint and weight grad through
    :func:`_emulate_adjoint` / :func:`_emulate_wgrad` over the phase-major
    dP_B and dP_A, and the reduce (K-split rows in order, the fold).
    Returns ``dx`` NHWC and the grads keyed by ``PARAM_NAMES``."""
    adj = tail_bwd.pack_tail_bwd(p)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    h1 = ttail.tail_stage_plain(0, x.permute(0, 3, 1, 2), p)
    h2 = ttail.tail_stage_plain(1, h1, p)
    h3 = nhwc(ttail.tail_stage_plain(2, h2, p))
    h1, h2 = nhwc(h1), nhwc(h2)
    grads = {}
    # conv_last: its adjoint and weight grad on the tensor cores, g padded.
    dh3, grads["last_w"] = _emulate_last(g, h3, adj["last_adj"])
    grads["last_b"] = g.sum(dim=(0, 1, 2))
    v = _mask(h3, dh3)
    grads["hr_b"], dpc = v.sum(dim=(0, 1, 2)), v
    # hr_conv: adjoint over dP_C, masked by h2, stored phase-major (dP_B).
    v = _mask(h2, _emulate_adjoint(dpc[:, None], adj["hr_adj"], "hr"))
    grads["up2_b"], dpb = v.sum(dim=(0, 1, 2)), _phase_major(v)
    part = _emulate_wgrad(dpc[:, None], h2, "hr").sum(dim=0)[0]  # (9, o, c)
    grads["hr_w"] = part.reshape(3, 3, 64, 64).permute(2, 3, 0, 1)
    # upconv2: the 16 phase-taps over dP_B's planes, masked by h1 (dP_A).
    v = _mask(h1, _emulate_adjoint(dpb, adj["up2_adj"], "up"))
    grads["up1_b"], dpa = v.sum(dim=(0, 1, 2)), _phase_major(v)
    grads["up2_w"] = _fold(_emulate_wgrad(dpb, h1, "up").sum(dim=0))
    # upconv1: the same over dP_A into dx.
    dx = _emulate_adjoint(dpa, adj["up1_adj"], "up")
    grads["up1_w"] = _fold(_emulate_wgrad(dpa, x, "up").sum(dim=0))
    return dx, grads


def _jax_tail_grads(raw, y, cot):
    """``jax.grad`` through ``make_hybrid_tail`` (its backward the fused
    ``tail_bwd_pallas`` in interpret mode), f32 and HIGHEST: dx (NHWC) and
    the grads keyed by ``PARAM_NAMES`` (kernels OIHW)."""
    tail = make_hybrid_tail(jnp.float32, interpret=True)
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(
            lambda a, q: jnp.vdot(tail(a, q), jnp.asarray(cot)), argnums=(0, 1)
        )(jnp.asarray(y), {k: jnp.asarray(v) for k, v in raw.items()})
    out = {}
    for name in tail_bwd.PARAM_NAMES:
        key, kind = name.rsplit("_", 1)
        ref = np.array(want_p[f"{_JAX_NAMES[key]}_{'kernel' if kind == 'w' else 'bias'}"])
        out[name] = torch.from_numpy(ref.transpose(3, 2, 0, 1) if kind == "w" else ref)
    return torch.from_numpy(np.array(want_x)), out


@pytest.mark.parametrize("n,h,w", [(1, 8, 8), (2, 5, 3)], ids=["square", "ragged"])
def test_tail_bwd_emulation_matches_plain_and_jax(rng, n, h, w):
    """K6 emulated through its index math (``_emulate_tail_bwd``: the
    phase-major dP_B and dP_A, the 16 phase-taps of the upsample-convs'
    adjoints over their plane boxes, the weight grads through MN-major
    swizzled reads and K-split rows, the fold) at the kernel's width,
    against ``tail_bwd_plain`` and against ``jax.grad`` through
    ``make_hybrid_tail(interpret=True)``, f32 (HIGHEST on the JAX side).
    5 x 3 is ragged: tiles past the last row and column, an odd row count
    (a last plane row that is half there). Tolerance 1e-4 relative to each
    group's largest value and absolute, the existing JAX test's."""
    raw = _wide_params(rng)
    p = _pack(raw)
    y = rng.randn(n, h, w, ttail.KERNEL_NF).astype(np.float32)
    cot = rng.randn(n, 4 * h, 4 * w, 3).astype(np.float32)
    dx, grads = _emulate_tail_bwd(torch.from_numpy(y), torch.from_numpy(cot), p)
    dx_p, grads_p = tail_bwd.tail_bwd_plain(torch.from_numpy(y).permute(0, 3, 1, 2),
                                            torch.from_numpy(cot).permute(0, 3, 1, 2), p)
    dx_j, grads_j = _jax_tail_grads(raw, y, cot)
    for name, want_p_, want_j in [("dx", dx_p.permute(0, 2, 3, 1), dx_j)] + [
            (k, grads_p[k], grads_j[k]) for k in tail_bwd.PARAM_NAMES]:
        got = dx if name == "dx" else grads[name]
        for want in (want_p_, want_j):
            tol = 1e-4 * max(1.0, want.abs().max().item())
            torch.testing.assert_close(got, want.float(), atol=tol, rtol=1e-4, msg=name)


def test_fold_matches_fused_upsample_conv_kernel_adjoint(rng):
    """The reduce's fold (``_fold``: dW[ky, kx] = sum over a, b of
    dWphi[a, b, t(a, ky), t(b, kx)]) against the JAX package's adjoint of
    ``fused_upsample_conv_kernel`` on a random (3, 3, C, 4 O) 4-phase grad,
    read into phase-tap form as K6's weight grads lay it out: phase (a, b),
    tap (ti, tj) is the 4-phase kernel's [a + ti, b + tj, :, (a, b, o)]."""
    c, o = 16, 8
    dw4 = rng.randn(3, 3, c, 4 * o).astype(np.float32)
    d6 = torch.from_numpy(dw4).reshape(3, 3, c, 2, 2, o)
    dphi = torch.stack([torch.stack([d6[a + ti, b + tj, :, a, b, :].T for ti in (0, 1) for tj in (0, 1)])
                        for a in (0, 1) for b in (0, 1)])  # (phase, tap, O, C)
    want = np.array(fused_upsample_conv_kernel_adjoint(jnp.asarray(dw4)))  # (3, 3, C, O)
    torch.testing.assert_close(_fold(dphi), torch.from_numpy(want).permute(3, 2, 0, 1), atol=1e-5, rtol=0)


def test_pack_tail_bwd_operands(rng):
    """K6's B operands against their formulas: hr_conv's adjoint is its
    kernel transposed and flipped (``hr_adj`` unpacks to W[o, c, 2 - ky, 2 -
    kx] at [c][o][ky][kx]); an upsample-conv's adjoint block (phase (a, b),
    tap (ti, tj)) holds, at K row o and N column c, the 4-phase kernel's
    [a + ti, b + tj, c, (a, b, o)], in the order (phase, chunk, tap, step,
    half, c // 8, c % 8, o % 8); conv_last's adjoint is its kernel
    transposed and flipped, 3 channels padded to one k16 step a tap."""
    nf = ttail.KERNEL_NF
    p = _pack(_wide_params(rng))
    adj = tail_bwd.pack_tail_bwd(p)
    hr = fragments.wgmma_unpack(adj["hr_adj"], nf, nf)  # (c, o, ky, kx)
    torch.testing.assert_close(hr, p["hr_oihw"].transpose(0, 1).flip(2, 3), atol=0, rtol=0)
    assert torch.equal(hr[5, 9, 0, 2], p["hr_oihw"][9, 5, 2, 0])
    fused = p["up2_fused"].permute(2, 3, 1, 0).reshape(3, 3, nf, 2, 2, nf)  # HWIO, phases (a, b, o)
    for a, b, ti, tj, o, c in [(1, 0, 0, 1, 53, 19), (0, 1, 1, 0, 7, 60), (1, 1, 1, 1, 32, 0)]:
        chunk, step, half, o8 = o // 32, o % 32 // 16, o % 16 // 8, o % 8
        idx = (((((2 * a + b) * 2 + chunk) * 4 + 2 * ti + tj) * 2 + step) * 2 + half) * 64 * 8
        idx += c * 8 + o8
        assert adj["up2_adj"][idx].item() == fused[a + ti, b + tj, c, a, b, o].item()
    assert adj["up1_adj"].numel() == adj["up2_adj"].numel() == 16 * nf * nf
    last = adj["last_adj"].reshape(9, 2, 8, 8, 8)  # (tap, half, c // 8, c % 8, o % 8)
    for tap, o, c in [(0, 0, 0), (5, 2, 37), (8, 1, 63)]:
        ky, kx = divmod(tap, 3)
        assert last[tap, 0, c // 8, c % 8, o].item() == p["last_oihw"][o, c, 2 - ky, 2 - kx].item()
    assert not last[:, 0, :, :, 3:].any() and not last[:, 1].any()  # channels 3..15 zero
