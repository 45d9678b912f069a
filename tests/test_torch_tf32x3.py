"""K7's and K8's f32 convs on the 3xTF32 frame kernel
(``csrc/conv_frame_tf32_wgmma.cuh``), on the CPU: the kernel's arithmetic
and addressing emulated (``_emulate_tf32``) against the plain f32 conv, the
JAX package's Pallas kernels in f32 interpret mode and f64; its tile and
shared-memory budget; which convs the f32 routes send to it.

Tolerances: 2e-4, the JAX tests' own (tests/test_pallas_sep4d.py), against
JAX; the f32 limit of chip_smoke.py, a relative L2 of 1e-5, against the
plain f32 conv and against f64."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from master_thesis_tpu.ops import pallas_sep4d as jsep
from master_thesis_tpu_torch.ops import conv_stack, fragments

ATOL_JAX = 2e-4
L2_F32 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is thousands of small matmuls: run them on one intra-op
    thread, so that with several test processes on the machine its threads
    do not spin against theirs for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _swz(addr):
    """The 128-byte swizzle of a 1024-byte-aligned stage: an address's
    16-byte chunk bits (4-6) XOR its row bits (7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _rel_l2(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def _boxes(x, tiles, fr, bh, bw, r, x_row0, valid):
    """The TMA boxes of ``tiles`` ((f0, y0, x0) each) over NHWC ``x``, whose
    row 0 is the frame's row ``x_row0`` and which holds ``valid`` of its
    rows: ``(T, fr * bh * bw, C)``, zeros outside the frames and the rows x
    holds (the zero fill)."""
    n, _, wd, cin = x.shape
    f0, y0, x0 = (torch.tensor(v).view(-1, 1, 1, 1) for v in zip(*tiles))
    fs = f0 + torch.arange(fr).view(1, -1, 1, 1)
    ys = y0 - r - x_row0 + torch.arange(bh).view(1, 1, -1, 1)
    xs = x0 - r + torch.arange(bw).view(1, 1, 1, -1)
    ok = (fs < n) & (ys >= 0) & (ys < valid) & (xs >= 0) & (xs < wd)
    got = x[fs.clamp(0, n - 1), ys.clamp(0, valid - 1), xs.clamp(0, wd - 1)]
    return torch.where(ok.unsqueeze(-1), got, 0.0).reshape(len(tiles), -1, cin)


def _group(a, b):
    """One k8 group of products of tf32 values, summed exactly (in f64, so
    that the sum does not depend on how the matmul orders it)."""
    return a.double() @ b.double()


def _emulate_launch(x, mat, bias, *, mode, k, cout, epi, out_shape=None, hin=None, rows=None, x_row0=0,
                    out_row0=0, addr=None, plant=0, seed=0, out=None, r=None, r2=None, m=None, rs=1.0,
                    out2=None, sums=None):
    """One launch of ``csrc/conv_frame_tf32_wgmma.cuh`` read through its
    descriptors, with ``conv_stack.tf32_launch``'s arguments (``x`` NHWC f32,
    contiguous or the first Cin channels of a wider buffer, ``mat`` the
    packed hi then lo matrix); returns the NHWC output: ``out`` (any view
    with contiguous channels, such as a channel slice of the dense concat)
    written in place where the launch stores, or zeros of ``out_shape``
    elsewhere without it. The tile is ``conv_stack.tf32_tile``'s; the rows
    computed ``[cy0, cy1)`` (phase mode: ``(r0 // 2, (r1 + 1) // 2)`` of the
    output rows). Per tile and 32-channel chunk the TMA box (tw + k - 1 x
    rows + k - 1 x fr pixels from (x0 - r, y0 - r, f0), zeros outside the
    frames and x's rows) lands 128-byte swizzled at the stage's start; the
    split rounds it in place to its hi half (``fragments.tf32_split``) and
    writes its lo half a box further on, each 128-byte row swizzled by its
    own address bits; past that the dropped columns read junk (random here).
    Conv and phase modes (the swapped GEMM): work units (tile, COUT_T
    outputs); per (chunk, tap) the weight stage is the hi and the lo block
    of ``mat`` at (chunk, tap, n0). Warpgroup mt's A (64 outputs x 8
    channels) starts at row 64 mt + 32 bytes a k8 step, a half's B (144
    columns x 8 channels) at pixel 144 h + dy bw + dx of the hi or the lo
    copy, the tap's (dy, dx): (tap // k, tap % k), in phase mode (a + tap //
    2, b + tap % 2) for the warpgroup's phase (a, b). Last and gc modes (the
    unswapped GEMM, nd = 8 or 32 outputs a dx): a unit is a tile; m64 block
    blk's A (64 pixel rows x 8 channels) starts at pixel 64 blk + dy bw, the
    B (3 nd columns nd dx + o x 8 channels) is the (chunk, row of taps dy)
    block of ``mat``; column n's output sums rows n, n + 1, n + 2 of its dx
    columns, in that order, then the bias. Three products a k8 step (A's lo
    with B's hi, A's hi with B's lo, hi with hi), each k8 group summed
    exactly, rounded to f32 and added in f32, each row of taps (k taps; 2 in
    phase mode; one (chunk, dy) in last and gc modes) into a partial sum
    then added to the unit's. Column n is tile pixel (f0 + n // bw // bh, y0
    + n // bw % bh, x0 + n % bw), dropped past the tile, the frames or the
    rows computed; bias, the epilogue (the activation; "resid": 0.2 (0.2 v
    + r) + r2, each step one rounding, r and r2 whole frames read at the
    pixel), stored at (f // tg) sg + (f %
    tg) st + (y - out_row0) sr + x sp + o (phase mode: pixel (2y + a, 2x +
    b) of channel o - 64 (2a + b), within the output rows). The backward's
    epilogues (no bias: pass zeros): "mask", the sums where ``m`` (read at
    the pixel) >= 0, else 0.2 of them; "dx", ``rs r + v`` in one rounding
    (+ ``r2``), 0.2 of it also into ``out2`` (an NHWC view); each tile's
    sums of the masked values (of 0.2 v) appended to ``sums`` where given
    (the bias partial rows). An s2d launch is emulated over the phase
    planes of its input (``tail_bwd._phase_planes``, NHWC): what its 5-D
    map's boxes hold. ``plant`` emulates ``-DTF32_PLANT``: 1 drops the two
    correction products, 2 the corner tap (phase mode: tap (0, 0) of each
    phase; last and gc modes: row of taps 0's dx 0 columns), 3 reads each
    tile's top halo row below a frame's first row tile as zeros, 4 reads
    x's row 0 (the frame's row x_row0) as zeros where x_row0 > 0, 5 (gc
    mode) loads the last chunk's box from one chunk early, 8 sets the mask
    slope to 0.25."""
    n, x_rows, wd, cin = x.shape
    hin = x_row0 + x_rows if hin is None else hin
    r0, r1 = (0, (2 if mode == "phase" else 1) * hin) if rows is None else rows
    cy0, cy1 = (r0 // 2, (r1 + 1) // 2) if mode == "phase" else (r0, r1)
    fr, trows, tw, nh = conv_stack.tf32_tile(mode, n, hin, wd, k, cout, cy0, cy1, x_row0)
    rows_n = mode in ("last", "gc")
    resid = r, r2
    r, taps, tpr = k // 2, (4 if mode == "phase" else k * k), (2 if mode == "phase" else k)
    bw, bh = tw + k - 1, trows + k - 1
    tiles = [(g * fr, cy0 + ty * trows, tx * tw) for g in range(-(-n // fr))
             for ty in range(-(-(cy1 - cy0) // trows)) for tx in range(-(-wd // tw))]
    boxes = _boxes(x, tiles, fr, bh, bw, r, x_row0, min(x_rows, hin - x_row0))
    nt, box_px = boxes.shape[:2]
    lo_off = mat.numel() // 2
    cpad = lo_off // (taps * cin)
    cols_read = 64 * conv_stack.TF32_LAST_BLOCKS if rows_n else nh * 144
    reach = 2 * box_px + cols_read + (k - 1) * (bw + 1)  # 128-byte rows the reads reach
    pix, ch = torch.arange(box_px).view(-1, 1), torch.arange(32).view(1, -1)
    hi_dst = (_swz(pix * 128 + 4 * ch) // 4).reshape(-1)  # where TMA puts (pixel, channel)
    lo_dst = (_swz((box_px + pix) * 128 + 4 * ch) // 4).reshape(-1)
    t_y0 = torch.tensor([y0 for _, y0, _ in tiles]).view(-1, 1, 1)
    prow = (torch.arange(box_px) // bw % bh).view(1, -1, 1)  # a box pixel's row in the box
    zero = torch.zeros(nt, box_px, 1, dtype=torch.bool)
    if plant == 3:
        zero = (t_y0 > 0) & (torch.arange(box_px) < bw).view(1, -1, 1)
    if plant == 4 and x_row0 > 0:
        zero = t_y0 - r + prow == x_row0
    junk = torch.Generator().manual_seed(seed)
    smems = []
    nch = cin // 32
    for c in range(nch):
        cc = c - 1 if plant == 5 and mode == "gc" and c == nch - 1 and c > 0 else c
        hi, lo = fragments.tf32_split(boxes[..., 32 * cc: 32 * cc + 32])
        hi, lo = hi.masked_fill(zero, 0.0), lo.masked_fill(zero, 0.0)
        smem = torch.randn(nt, reach * 32, generator=junk)
        smem[:, hi_dst] = hi.reshape(nt, -1)
        smem[:, lo_dst] = lo.reshape(nt, -1)
        smems.append(smem)
    r144, r64, ks = torch.arange(144).view(-1, 1), torch.arange(64).view(-1, 1), torch.arange(8).view(1, -1)
    if out is None:
        out = torch.zeros(out_shape)
    flat = torch.as_strided(out, (sum((sz - 1) * st for sz, st in zip(out.shape, out.stride())) + 1,), (1,))
    tg, sg, st, sr, sp = addr or (n, 0, out.stride(0), out.stride(1), out.stride(2))
    act = {"none": lambda v: v, "relu": torch.relu, "leaky": lambda v: torch.where(v >= 0, v, 0.2 * v)}[
        "none" if epi in ("resid", "mask", "dx") else epi]
    slope, mask = (0.25 if plant == 8 else 0.2), m

    def finish(v, f, yy, xx, outs):
        """v (K, len(outs)) at pixels (f, yy, xx): the epilogue after the bias."""
        if epi == "mask":
            v = torch.where(mask[f, yy, xx][:, outs] >= 0, v, slope * v)
            if sums is not None:
                sums.append(F.pad(v.sum(0), (int(outs[0]), 64 - int(outs[-1]) - 1)))
            return v
        if epi == "dx":
            v = (torch.tensor(rs).double() * resid[0][f, yy, xx][:, outs].double() + v.double()).float()
            if resid[1] is not None:
                v = v + resid[1][f, yy, xx][:, outs]
            if out2 is not None:
                out2[f.view(-1, 1), yy.view(-1, 1), xx.view(-1, 1), outs.view(1, -1)] = 0.2 * v
                if sums is not None:
                    sums.append(F.pad((0.2 * v).sum(0), (int(outs[0]), 64 - int(outs[-1]) - 1)))
            return v
        if epi != "resid":
            return act(v)
        for t in resid:
            if t is not None:
                v = (0.2 * v.double() + t[f, yy, xx][:, outs].double()).float()
        return v

    def products(part, a_hi, a_lo, b_hi, b_lo):  # the A operand's hi / lo, then the B operand's
        for g in ([] if plant == 1 else [_group(a_lo, b_hi), _group(a_hi, b_lo)]) + [_group(a_hi, b_hi)]:
            part = part + g.float()
        return part

    def store(v, cols, outs, phase=None):
        """v (T, len(outs), len(cols)): output channel outs of tile column cols
        before its epilogue (the bias added)."""
        q, xc = cols // bw, cols % bw
        fl, y = q // bh, q % bh
        for t, (f0, y0, x0) in enumerate(tiles):
            f, yy, xx = f0 + fl, y0 + y, x0 + xc
            keep = (xc < tw) & (y < trows) & (fl < fr) & (f < n) & (yy < cy1) & (xx < wd)
            if phase is not None:
                yy, xx = 2 * yy + phase[0], 2 * xx + phase[1]
                keep &= (yy >= r0) & (yy < r1)
            f, yy, xx = f[keep], yy[keep], xx[keep]
            base = (f // tg) * sg + (f % tg) * st + (yy - out_row0) * sr + xx * sp
            flat[base.view(-1, 1) + outs.view(1, -1)] = finish(v[t][:, keep].T, f, yy, xx, outs)

    if rows_n:
        # n24 / n96 products: column nd dx + o of pixel row m sums tap (dy,
        # dx) over row m + dy bw, a partial sum a (chunk, row of taps); the
        # epilogue adds rows m, m + 1 and m + 2's dx columns in that order,
        # then the bias.
        # The m64 blocks' rows side by side: each row's sums are its own.
        nd, mrows = (8 if mode == "last" else 32), 64 * conv_stack.TF32_LAST_BLOCKS
        rm = torch.arange(mrows).view(-1, 1)
        acc = torch.zeros(nt, mrows, 3 * nd)
        for c in range(nch):
            for dy in range(3):
                part = torch.zeros(nt, mrows, 3 * nd)
                off = (c * 3 + dy) * 3 * nd * 32
                for kk in range(4):
                    bidx = _swz(32 * kk + torch.arange(3 * nd).view(-1, 1) * 128 + 4 * ks) // 4
                    w_hi, w_lo = mat[off:][bidx].T, mat[lo_off + off:][bidx].T  # (8 channels, 3 nd)
                    if plant == 2 and dy == 0:  # the corner tap (0, 0): columns 0 .. nd - 1
                        w_hi, w_lo = F.pad(w_hi[:, nd:], (nd, 0)), F.pad(w_lo[:, nd:], (nd, 0))
                    col = dy * bw * 128 + 32 * kk + rm * 128 + 4 * ks
                    a_hi, a_lo = smems[c][:, _swz(col) // 4], smems[c][:, _swz(col + box_px * 128) // 4]
                    part = products(part, a_hi, a_lo, w_hi, w_lo)
                acc = acc + part
        ex = F.pad(acc, (0, 0, 0, 8))
        m = torch.arange(mrows)
        v = ex[:, m, 0:cout] + ex[:, m + 1, nd:nd + cout] + ex[:, m + 2, 2 * nd:2 * nd + cout]
        store((v + bias.view(1, 1, -1)).transpose(1, 2), m, torch.arange(cout))
        return out

    cout_t = 128 // nh
    cols = torch.arange(144)
    for n0 in range(0, cout, cout_t):
        for mt in range(cout_t // 64):
            ph = (n0 + 64 * mt) // 64
            for half in range(nh):
                acc, part = torch.zeros(nt, 64, 144), torch.zeros(nt, 64, 144)
                for c in range(nch):
                    for tap in range(taps):
                        if tap % tpr == 0:  # each row of taps summed apart, then added
                            acc, part = acc + part, torch.zeros_like(part)
                        if plant == 2 and tap == 0:
                            continue
                        off = ((c * taps + tap) * cpad + n0) * 32
                        w_hi = mat[off: off + cout_t * 32]
                        w_lo = mat[lo_off + off: lo_off + off + cout_t * 32]
                        if mode == "phase":
                            shift = (ph // 2 + tap // 2) * bw + ph % 2 + tap % 2
                        else:
                            shift = (tap // k) * bw + tap % k
                        for kk in range(4):
                            aidx = _swz(64 * mt * 128 + 32 * kk + r64 * 128 + 4 * ks) // 4
                            col = (144 * half + shift) * 128 + 32 * kk + r144 * 128 + 4 * ks
                            b_hi = smems[c][:, _swz(col) // 4].transpose(1, 2)
                            b_lo = smems[c][:, _swz(col + box_px * 128) // 4].transpose(1, 2)
                            part = products(part, w_hi[aidx], w_lo[aidx], b_hi, b_lo)
                if mode == "phase":
                    o = torch.arange(64)
                    store(acc + part + bias.view(1, -1, 1), 144 * half + cols, o, phase=(ph // 2, ph % 2))
                else:
                    o = torch.arange(n0 + 64 * mt, n0 + 64 * mt + 64)
                    store(acc + part + bias[o].view(1, -1, 1), 144 * half + cols, o)
    return out


def _emulate_wgrad(job, plant=0):
    """One job of ``csrc/conv_bwd_tf32_wgmma.cuh``'s weight-grad mode
    (``rrdb_bwd.WgJob``): its item slots ``(ks, 9, 64, 32)``. Per tile (one
    frame row x 32 pixels, the grid's columns past its width zero) the
    cotangent's 64 channels and the source box (3 rows x 34 columns, zeros
    outside the frame) are split into hi and lo (``fragments.tf32_split``);
    the planes are the box's rows row0 + r, columns dx0 + dx + k (phase job
    (a, b): row0 = a, dx0 = b, 2 x 2; else 3 x 3); warpgroup r's product
    per k8 step is three exact groups (lo hi, hi lo, hi hi) each rounded to
    f32 and added into a fresh partial sum a tile; item ks adds its tiles
    ks, ks + KS, ... in order in f32. Tap slot 3 r + dx. ``plant`` 1 keeps
    hi hi alone, 6 zeros slot 0, 7 zeros the last K-split's slots (what the
    reduce then leaves out), 9 reads phase (1, 0)'s plane for phase
    (0, 1)."""
    if job.phase is None:
        d, kt, row0, dx0 = job.cot[..., job.dc0: job.dc0 + 64], 3, 0, 0
    else:
        a, b = job.phase
        row0, dx0, kt = a, b, 2
        if plant == 9 and (a, b) == (0, 1):
            a, b = 1, 0
        d = job.cot[:, a::2, b::2, :64]
    x = job.src[..., job.sc0: job.sc0 + 32]
    n, h, w, _ = d.shape
    tx = -(-w // 32)
    a_t = F.pad(d, (0, 0, 0, 32 * tx - w)).reshape(n * h * tx, 32, 64).transpose(1, 2)  # (T, 64 o, 32 k)
    xp = F.pad(x, (0, 0, 1, 32 * tx + 1 - w, 1, 1))  # (n, h + 2, 32 tx + 2, 32)
    boxes = torch.stack([xp[:, y: y + 3, 32 * t: 32 * t + 34] for y in range(h) for t in range(tx)], dim=1)
    boxes = boxes.reshape(n * h * tx, 3, 34, 32)
    a_hi, a_lo = fragments.tf32_split(a_t)
    parts = []
    for r in range(kt):
        planes = torch.cat([boxes[:, row0 + r, dx0 + dx: dx0 + dx + 32].transpose(1, 2) for dx in range(kt)], dim=1)
        b_hi, b_lo = fragments.tf32_split(planes)  # (T, 32 kt, 32 k)
        part = torch.zeros(a_t.shape[0], 64, 32 * kt)
        for kk in range(4):
            ks8 = slice(8 * kk, 8 * kk + 8)
            groups = [] if plant == 1 else [_group(a_lo[..., ks8], b_hi[..., ks8].transpose(1, 2)),
                                            _group(a_hi[..., ks8], b_lo[..., ks8].transpose(1, 2))]
            for g in groups + [_group(a_hi[..., ks8], b_hi[..., ks8].transpose(1, 2))]:
                part = part + g.float()
        parts.append(part)
    slots = torch.zeros(job.ks, 9, 64, 32)
    for k in range(job.ks):
        for r in range(kt):
            acc = torch.zeros(64, 32 * kt)
            for t in range(k, a_t.shape[0], job.ks):
                acc = acc + parts[r][t]
            for dx in range(kt):
                slots[k, 3 * r + dx] = acc[:, 32 * dx: 32 * dx + 32]
    if plant == 6:
        slots[:, 0] = 0.0
    if plant == 7 and job.ks > 1:
        slots[-1] = 0.0
    return slots


def _emulate_tf32(x, w, b, relu, swap=False, plant=0, seed=0):
    """One K7 / K8 conv (conv mode, whole frames) as
    ``csrc/conv_frame_tf32_wgmma.cuh`` computes it (:func:`_emulate_launch`):
    ``x (N, H, W, Cin)`` f32 NHWC, ``w`` OIHW (k = 3 or 5), ``b`` f32,
    ReLU with ``relu``, stored as ``conv_stack._tf32_out`` addresses it
    (``swap``: sep4d's regrouping)."""
    n, h, wd, _ = x.shape
    cout, k = w.shape[0], w.shape[-1]
    return _emulate_launch(x, fragments.wgmma_tf32_matrix(w), b, mode="conv", k=k, cout=cout,
                           epi="relu" if relu else "none", out_shape=(n, h, wd, cout),
                           addr=conv_stack._tf32_out(n, h, wd, cout, swap), plant=plant, seed=seed)


def _conv(rng, cin, cout, k):
    w = torch.from_numpy((rng.randn(cout, cin, k, k) * (1.0 / (k * k * cin)) ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))
    return w, b


def test_tf32_split_is_the_cards_rounding():
    """``tf32_round`` keeps 10 mantissa bits (the low 13 zero), rounds to the
    nearest with ties away from zero; ``hi + lo`` holds ``x`` to 2^-21 of it
    and ``x - hi`` is exact in f32."""
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 1.0 + 3 * 2 ** -11, 0.0, 3.0e-30])
    hi = fragments.tf32_round(x)
    assert hi.tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0, 1.0 + 2 ** -9, 0.0, hi[5].item()]
    r = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32)) * 100
    hi, lo = fragments.tf32_split(r)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - hi).abs() <= r.abs() * 2 ** -11).all()
    assert ((r.double() - hi.double() - lo.double()).abs() <= r.double().abs() * 2 ** -21).all()
    assert torch.equal((r - hi).double(), r.double() - hi.double())


def test_wgmma_tf32_matrix_layout():
    """Element ``(o, c, ky, kx)`` of the hi and the lo matrix sits at chunk
    ``c // 32``, tap ``k ky + kx``, row ``o``, 16-byte position ``(c % 32 //
    4) ^ o % 8``, outputs padded to 128 with zeros."""
    rng = np.random.RandomState(1)
    w, _ = _conv(rng, 64, 64, 5)
    mat = fragments.wgmma_tf32_matrix(w)
    hi, lo = fragments.tf32_split(w)
    assert mat.numel() == 2 * 2 * 25 * 128 * 32
    blocks = mat.view(2, 2, 25, 128, 8, 4)
    for o, c, ky, kx in ((0, 0, 0, 0), (5, 37, 2, 4), (63, 63, 4, 1), (17, 8, 3, 3)):
        pos = (c % 32 // 4) ^ (o % 8)
        assert blocks[0, c // 32, 5 * ky + kx, o, pos, c % 4] == hi[o, c, ky, kx]
        assert blocks[1, c // 32, 5 * ky + kx, o, pos, c % 4] == lo[o, c, ky, kx]
    assert (blocks[:, :, :, 64:] == 0).all()
    with pytest.raises(ValueError, match="Cin % 32"):
        fragments.wgmma_tf32_matrix(torch.zeros(64, 16, 3, 3))


@pytest.mark.parametrize("n,h,w,k,cout,tile", [
    (5120, 16, 16, 3, 256, (1, 16, 16, 2)),  # sep4d's wide convs, the mixer's 3x3
    (20, 16, 16, 5, 256, (1, 6, 16, 1)),  # the mixer's 5x5 256 -> 256
    (20, 256, 256, 5, 128, (1, 4, 32, 1)),  # flow_256's 5x5s
    (20, 256, 256, 3, 128, (1, 16, 16, 2)),  # flow_256's 3x3s
    (24, 256, 256, 3, 64, (1, 16, 16, 2)),  # VGG block 1's 64 -> 64: 64 outputs a CTA
    (24, 32, 32, 3, 512, (1, 16, 16, 2)),  # VGG block 4
    (20, 8, 8, 3, 128, (3, 8, 8, 2)), (20, 8, 8, 5, 128, (2, 8, 8, 2)),  # flow_64 at 8x8: whole frames
    (2, 20, 36, 5, 64, (1, 4, 36, 2)),  # a ragged frame, 64 outputs
])
def test_frame_tile_tf32_fits_the_columns_and_shared_memory(n, h, w, k, cout, tile):
    """:func:`conv_stack.frame_tile_tf32` at the routed shapes: every output
    column below the halves' 144 each, the kernel's shared memory (hi and lo
    copies of two box stages, two hi + lo weight stages, and the dropped
    columns' reach) within the card's 232 448 bytes, and one row or frame
    more would not fit."""
    got = conv_stack.frame_tile_tf32(n, h, w, k, cout)
    assert got == tile
    fr, rows, tw, nh = got
    assert conv_stack._tf32_fits(fr, rows, tw, k, nh)
    if rows < h:
        assert not conv_stack._tf32_fits(1, -(-h // (-(-h // rows) - 1)), tw, k, nh)
    else:
        assert fr == n or not conv_stack._tf32_fits(fr + 1, h, tw, k, nh)
    assert conv_stack.tf32_smem(fr, rows, tw, k, nh) <= conv_stack.SMEM_LIMIT


@pytest.mark.parametrize("n,h,w,cin,cout,k,relu", [
    (2, 16, 16, 64, 128, 3, True),  # a 16x16 tile on two halves
    (1, 20, 36, 64, 64, 5, False),  # 64 outputs a CTA, ragged rows
    (1, 12, 40, 32, 128, 5, True),  # one half, column tiles of 32 and 8
    (5, 8, 8, 32, 128, 3, True),  # three whole frames a tile, a ragged last group
    (3, 8, 8, 32, 64, 5, False),  # two whole frames a tile, 64 outputs
])
def test_tf32_emulation_matches_plain(rng, n, h, w, cin, cout, k, relu):
    """The 3xTF32 kernel emulated on the CPU (``_emulate_tf32``: its tile, the
    wrapped columns of the TMA box, the split of the box into a hi copy in
    place and a lo copy behind it, the tap and k8 shifts of both over
    128-byte-swizzled rows, the hi and lo weight blocks, three products, the
    masked stores) equals the plain f32 conv (``conv_frame_tf32_plain``)
    within L2_F32, and max|diff| 1e-4."""
    wt, b = _conv(rng, cin, cout, k)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32))
    p = conv_stack.pack_stack([(wt, b)], [relu], torch.float32)
    want = conv_stack.conv_frame_tf32_plain(x, p, 0)
    got = _emulate_tf32(x, wt, b, relu)
    assert _rel_l2(got, want) <= L2_F32
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("side", [16, 8])  # base 256's corr tiles, base 128's
def test_tf32_emulation_swaps_sep4d_tiles_in_the_epilogue(rng, side):
    """Stage 1's last conv with the p <-> q swap in its store addresses:
    ``side**2`` tiles of ``side x side`` regroup as
    ``conv_frame_tf32_plain(swap=True)`` (one permute) does; a tile count
    that is not a multiple of ``side**2`` is refused."""
    wt, b = _conv(rng, 32, 64, 3)
    x = torch.from_numpy(rng.randn(side * side, side, side, 32).astype(np.float32))
    p = conv_stack.pack_stack([(wt, b)], [False], torch.float32)
    want = conv_stack.conv_frame_tf32_plain(x, p, 0, swap=True)
    assert _rel_l2(_emulate_tf32(x, wt, b, False, swap=True), want) <= L2_F32
    with pytest.raises(ValueError, match="regroups"):
        conv_stack.conv_frame_tf32_plain(x[:side * side - 8], p, 0, swap=True)


@pytest.fixture(scope="module")
def k7_k8_convs():
    """One K7 conv (4 tiles of 16x16, 128 -> 256, 3x3) and one K8 conv (5x5,
    64 -> 64, 2 frames of 20x36) with their inputs, emulated in 3xTF32 and
    in 1xTF32, and in f64."""
    rng = np.random.RandomState(17)
    cases = {}
    for name, (n, h, w, cin, cout, k) in {"K7": (4, 16, 16, 128, 256, 3), "K8": (2, 20, 36, 64, 64, 5)}.items():
        wt, b = _conv(rng, cin, cout, k)
        x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32))
        f64 = torch.relu(F.conv2d(x.double().permute(0, 3, 1, 2), wt.double(), padding=k // 2)
                         + b.double().view(1, -1, 1, 1)).permute(0, 2, 3, 1)
        cases[name] = (x, wt, b, _emulate_tf32(x, wt, b, True), _emulate_tf32(x, wt, b, True, plant=1), f64)
    return cases


@pytest.mark.parametrize("site", ["K7", "K8"])
def test_tf32x3_arithmetic_matches_the_jax_pallas_kernel(k7_k8_convs, site):
    """The emulated 3xTF32 conv against the TPU kernel's function in f32
    (``conv_stack_tiles`` on 16x16 tiles for K7, ``conv_stack_banded`` for
    K8, interpret mode, ``Precision.HIGHEST``) at the JAX tests' 2e-4."""
    x, wt, b, got, _, _ = k7_k8_convs[site]
    jk, jb = [jnp.asarray(wt.numpy().transpose(2, 3, 1, 0))], [jnp.asarray(b.numpy())]
    with jax.default_matmul_precision("highest"):
        if site == "K7":
            nt, side, _, cin = x.shape
            xin = x.permute(0, 3, 1, 2).reshape(nt, cin, side * side).numpy()
            want = jsep.conv_stack_tiles(jnp.asarray(xin), jk, jb, [True], tile_side=side, grid_tiles=4,
                                         interpret=True)
            want = np.asarray(want).reshape(nt, -1, side, side).transpose(0, 2, 3, 1)
        else:
            want = np.asarray(jsep.conv_stack_banded(jnp.asarray(x.numpy()), jk, jb, [True], band_rows=8,
                                                     interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_JAX)


@pytest.mark.parametrize("site", ["K7", "K8"])
def test_1xtf32_fails_the_f32_limit_and_3xtf32_holds_it(k7_k8_convs, site):
    """Against f64, the emulated 3xTF32 conv is within chip_smoke.py's f32
    limit (a relative L2 of 1e-5) and one TF32 product alone
    (``-DTF32_PLANT=1``) is past it: the limit tells the two apart."""
    _, _, _, three, one, f64 = k7_k8_convs[site]
    assert _rel_l2(three, f64) <= L2_F32 / 10
    assert _rel_l2(one, f64) > 10 * L2_F32


def test_tf32_emulation_sees_the_planted_faults(rng):
    """The corner tap left out (``-DTF32_PLANT=2``) moves every output; each
    tile's top halo row read as zeros (``-DTF32_PLANT=3``) moves only the
    first output row of each row tile below the first (rows 14 and 28 of
    40: tiles of 14 rows); both far past the tolerance."""
    wt, b = _conv(rng, 32, 128, 3)
    x = torch.from_numpy(rng.randn(1, 40, 16, 32).astype(np.float32))
    p = conv_stack.pack_stack([(wt, b)], [False], torch.float32)
    want = conv_stack.conv_frame_tf32_plain(x, p, 0)
    assert conv_stack.frame_tile_tf32(1, 40, 16, 3, 128) == (1, 14, 16, 2)
    assert _rel_l2(_emulate_tf32(x, wt, b, False, plant=2), want) > 0.1
    err = (_emulate_tf32(x, wt, b, False, plant=3) - want).abs()
    bad_rows = sorted(set(torch.nonzero(err.amax(dim=(0, 2, 3)) > 1e-4).flatten().tolist()))
    assert bad_rows == [14, 28] and err.max() > 0.1


def _truncated_sums(rng, k_in, steps_a_partial):
    """The 3xTF32 dot products of ``k_in`` inputs as the tensor cores add
    them: each k8 group of each of the three products summed exactly, then
    added to the accumulator with the result rounded toward zero to f32; with
    ``steps_a_partial`` the accumulator restarts every that many k8 groups
    and is added to an f32 sum (round to nearest). Relative L2 against
    f64 over 400 outputs."""
    a = (rng.randn(400, k_in) / np.sqrt(k_in)).astype(np.float32)
    b = rng.randn(400, k_in).astype(np.float32)
    (ah, al), (bh, bl) = (tuple(t.numpy().astype(np.float64) for t in fragments.tf32_split(torch.from_numpy(m)))
                          for m in (a, b))
    ref = (a.astype(np.float64) * b).sum(1)
    groups = [(x * y).reshape(400, -1, 8).sum(2) for x, y in ((al, bh), (ah, bl), (ah, bh))]
    part, total = np.zeros(400, np.float32), np.zeros(400, np.float32)
    for s in range(k_in // 8):
        for g in groups:  # the three wgmmas of a k8 step, each one truncated add
            exact = part.astype(np.float64) + g[:, s]
            part = exact.astype(np.float32)
            over = np.abs(part.astype(np.float64)) > np.abs(exact)
            part[over] = np.nextafter(part[over], np.float32(0))
        if steps_a_partial and (s + 1) % steps_a_partial == 0:
            total, part = total + part, np.zeros_like(part)
    total = total + part
    return np.linalg.norm(total - ref) / np.linalg.norm(ref)


def test_truncated_sums_need_a_partial_sum_a_row_of_taps():
    """Why the kernel sums each row of taps apart: with the tensor cores'
    truncated adds, one accumulator over a 5x5 conv's 25 x 256 inputs drifts
    past chip_smoke.py's f32 limit, while a partial sum a row of taps (5
    taps x 4 k8 groups of 32 channels) stays far below it."""
    rng = np.random.RandomState(3)
    assert _truncated_sums(rng, 25 * 256, None) > 2 * L2_F32
    assert _truncated_sums(rng, 25 * 256, 20) < L2_F32 / 4


def _meta_stack(specs, relus):
    convs = [(torch.empty(co, ci, k, k, device="meta"), torch.empty(co, device="meta")) for k, ci, co in specs]
    return conv_stack.pack_stack(convs, relus, torch.float32)


def test_f32_routes_send_the_frame_convs_to_the_tf32_kernel(monkeypatch):
    """At the CHN+DFPN step's shapes (B=4, F=5, base 256; on the meta
    device, each launch recorded) the f32 routes send exactly the convs that
    :func:`conv_stack.is_frame` to the 3xTF32 kernel, stage 1's last with
    the swap, and the thin ones to ``conv_f32_fwd``: K7 20 launches, 6 on the
    new kernel (sep4d's four wide convs, the mixer's 256 -> 256 5x5 and
    3x3); K8 50, 44 on it (13 a flow estimator, 9 a VGG call); every tile
    within the shared memory."""
    from master_thesis_tpu_torch.models.dfpn import _FLOW_LAYERS, _FLOW_SEGMENTS, _mixer_schedule
    from master_thesis_tpu_torch.models.vgg import _POOL4_BLOCKS, VGG16_CFG

    calls = []

    def tf32(x, p, i, swap=False):
        k, _, co = p.specs[i]
        n, h, w, _ = x.shape
        fr, rows, tw, nh = conv_stack.frame_tile_tf32(n, h, w, k, co)
        assert conv_stack.tf32_smem(fr, rows, tw, k, nh) <= conv_stack.SMEM_LIMIT
        calls.append(("tf32", p.specs[i], swap))
        return torch.empty(n, h, w, co, device=x.device)

    def simt(x, w, out, **kw):
        calls.append(("simt", (kw["k"], x.shape[3], out.shape[3]), False))
        return out

    monkeypatch.setattr(conv_stack, "conv_frame_tf32_cuda", tf32)
    monkeypatch.setattr(conv_stack, "conv_f32_fwd", simt)
    n, cs = 20, 16
    before = conv_stack.conv_stack_tiles_f32.launches
    sep1 = _meta_stack([(3, 1, 128), (3, 128, 256), (3, 256, 256)], [True, True, False])
    sep2 = _meta_stack([(3, 256, 256), (3, 256, 128), (3, 128, 1)], [True, True, False])
    sched = _mixer_schedule(cs)
    cins = [cs * cs] + [c for c, _, _ in sched[:-1]]
    mixer = _meta_stack([(k, ci, co) for ci, (co, k, _) in zip(cins, sched)], [r for _, _, r in sched])
    y = conv_stack.conv_stack_tiles_cl_f32(torch.empty(n * 256, 1, cs, cs, device="meta"), sep1, swap=True)
    conv_stack.conv_stack_tiles_cl_f32(y, sep2)
    conv_stack.conv_stack_tiles_cl_f32(torch.empty(n, cs * cs, cs, cs, device="meta"), mixer)
    k7 = list(calls)
    assert conv_stack.conv_stack_tiles_f32.launches - before == 20
    assert [c for c in k7 if c[0] == "tf32"] == [
        ("tf32", (3, 128, 256), False), ("tf32", (3, 256, 256), True), ("tf32", (3, 256, 256), False),
        ("tf32", (3, 256, 128), False), ("tf32", (5, 256, 256), False), ("tf32", (3, 256, 256), False)]

    calls.clear()
    before = conv_stack.conv_stack_banded_f32.launches
    spec = {name: k for name, k, _ in _FLOW_LAYERS}
    for base in (256, 64):
        for (names, _), hw in zip(_FLOW_SEGMENTS, [base >> i for i in (0, 1, 2, 3, 2, 1, 0)]):
            specs = [(spec[nm], 10 if nm == "c0" else 128, 2 if nm == "c17" else 128) for nm in names]
            p = _meta_stack(specs, [nm != "c17" for nm in names])
            conv_stack.conv_stack_banded_f32(torch.empty(n, hw, hw, specs[0][1], device="meta"), p)
    widths = [v for v in VGG16_CFG if v != "M"]
    for frames in (4, n):
        cin = 3
        for i, block in enumerate(_POOL4_BLOCKS):
            specs = []
            for j in range(len(block)):
                co = widths[sum(len(b) for b in _POOL4_BLOCKS[:i]) + j]
                specs.append((3, cin, co))
                cin = co
            hw = 256 >> i
            conv_stack.conv_stack_banded_f32(torch.empty(frames, hw, hw, specs[0][1], device="meta"),
                                             _meta_stack(specs, [True] * len(specs)))
    assert conv_stack.conv_stack_banded_f32.launches - before == 50
    routed = [c[1] for c in calls if c[0] == "tf32"]
    assert len(routed) == 44 and all(conv_stack.is_frame(s) for s in routed)
    assert sorted({c[1] for c in calls if c[0] == "simt"}) == [(3, 3, 64), (3, 128, 2), (5, 10, 128)]


def test_f32_route_on_the_cpu_runs_the_plain_convs(rng, monkeypatch):
    """On a CPU tensor the f32 routes never reach the 3xTF32 kernel's wrapper:
    every conv is ``conv_f32_fwd``'s plain version, the swap one permute;
    the wrapper itself refuses a CPU tensor."""
    def refuse(*a, **k):
        raise AssertionError("the 3xTF32 wrapper was called on the CPU")

    wt, b = _conv(rng, 64, 64, 3)
    w2, b2 = _conv(rng, 64, 8, 3)
    p = conv_stack.pack_stack([(wt, b), (w2, b2)], [True, False], torch.float32)
    assert conv_stack.f32_plan(p) == ("tf32", "simt")
    x = torch.from_numpy(rng.randn(2, 16, 16, 64).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        conv_stack.conv_frame_tf32_cuda(x, p, 0)
    monkeypatch.setattr(conv_stack, "conv_frame_tf32_cuda", refuse)
    got = conv_stack.conv_stack_banded(x, p)
    torch.testing.assert_close(got, conv_stack.conv_stack_banded_plain(x, p), atol=1e-5, rtol=0)
    p3 = conv_stack.pack_stack([(wt, b)], [True], torch.float32)
    xt = torch.from_numpy(rng.randn(256, 64, 16, 16).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    torch.testing.assert_close(conv_stack.conv_stack_tiles_cl_f32(xt, p3, swap=True),
                               conv_stack.conv_stack_tiles_cl_plain(xt, p3, swap=True), atol=1e-5, rtol=0)
