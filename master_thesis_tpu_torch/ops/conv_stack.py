"""Fused stacks of same-padded convs: the plain version and the CUDA
kernels K7 and K8 (master_thesis_tpu/ops/pallas_sep4d.py: conv_stack_tiles,
conv_stack_banded, sep4d_apply_pallas, mixer_apply_pallas).

A stack is a list of odd k x k convs (k = 3 or 5), each same-padded with
zeros, with its f32 bias and optionally a ReLU. Rounding, shared by the
kernels and :func:`conv_stack_plain` (``_accum_taps_tile`` /
``_conv_stack_kernel``): operands in the working dtype, sums in f32, the
f32 bias added, then ReLU, each conv's output rounded to the working dtype
before the next conv.

- :func:`conv_stack_tiles` (K7) maps ``(NT, Cin, hw)`` to ``(NT, Cout,
  hw)``: NT independent ``tile_side``-square images, channel-major, zero
  padding at each tile's own border; :func:`conv_stack_tiles_cl` is the
  same on channels-last ``(NT, Cin, side, side)`` tensors. They carry the
  DFPN correlation mixer (:func:`mixer_apply`) and the separable 4-D conv
  (:func:`sep4d_apply`).
- :func:`conv_stack_banded` (K8) maps NHWC ``(N, H, W, Cin)`` to ``(N, H,
  W, Cout)`` over full frames, zero padding only at the frame's border. It
  carries the flow estimators' segments and VGG's pool-4 tower.

Three kernels. ``csrc/conv_stack.cu`` runs a group of consecutive convs
in one block over one output tile, a whole image for K7 and a piece of a
frame with a halo for K8; :func:`plan` cuts a stack into groups whose
buffers fit a block's shared memory and picks each group's tile (the JAX
package's VMEM budget, ``_stack_band_rows``, does not carry over).
``csrc/conv_stack_wgmma.cu`` runs one conv as a channels-last implicit GEMM
on ``wgmma``: a wide 3x3 conv of K7 (16x16 tiles, Cin and Cout multiples
of 64; ``conv3x3_wide_wgmma.cuh``), or a 3x3 or 5x5 conv of K8 with Cin and
Cout multiples of 64 over whole NHWC frames (``conv_frame_wgmma.cuh``,
:func:`conv_frame_cuda`). On channels-last tiles (:func:`conv_stack_tiles_cl`,
the mixer's and sep4d's) :func:`tile_plan` sends each wide conv to its
kernel, one launch each, and the rest of the stack to the fused groups,
channels-last between the launches; channel-major tiles
(:func:`conv_stack_tiles`, the JAX-shaped entry) run the fused groups
alone, K7's first design. K8 (:func:`band_plan`) sends each frame conv to
the frame kernel and the thin convs to the fused groups, NHWC between the
launches; :func:`conv_stack_banded_first_cuda` keeps K8's first design,
the fused groups alone. A CUDA tensor goes through the kernels, a CPU
tensor through the plain version; nothing falls back.

In f32 each entry takes its f32 route (:func:`conv_stack_tiles_f32`,
:func:`conv_stack_tiles_cl_f32`, :func:`conv_stack_banded_f32`): one
:func:`.conv_f32.conv_f32_fwd` launch a conv, NHWC, bias and ReLU in its
epilogue, f32 throughout as the TPU kernel takes it under
``Precision.HIGHEST``; K7's tiles are the launch's images (each tile's own
border is its zero padding). :func:`.conv_f32.kernel_route` picks the route
by the working dtype.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Hashable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import fragments
from master_thesis_tpu_torch.ops.conv_f32 import conv_f32_fwd, hwio, kernel_route, nhwc

SMEM_LIMIT = 232448  # bytes of shared memory a block can have on an H100
MAX_STAGES = 16  # convs per launch (csrc/conv_stack.cu)
SM_COUNT = 132
# The wide-conv kernel's tile side (csrc/conv3x3_wide_wgmma.cuh: two n144
# halves of an 18-pixel-stride box cover a 16x16 tile's outputs).
WIDE_SIDE = 16
# The frame kernel's pixel columns a tile (csrc/conv_frame_wgmma.cuh: two
# n144 halves) and its widest tile.
FRAME_COLS, FRAME_TW = 288, 64
# Tile candidates (rows, cols) of K8's fused groups, largest first.
BAND_TILES = ((32, 32), (16, 32), (16, 16), (8, 16), (4, 16), (2, 16), (1, 16))
# The planner's exchange rate: a byte of device memory costs about as much
# time as this many bf16 multiply-adds of the kernel (~150 TFLOP/s against
# ~3 TB/s on an H100).
MAC_PER_BYTE = 25


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


class PackedStack(NamedTuple):
    """A stack's weights in the layouts both versions read, made once per
    weight set by :func:`pack_stack`."""

    w: torch.Tensor  # the kernel's B operands, one matrix per conv (working dtype)
    b: torch.Tensor  # the biases, each zero-padded to a multiple of 16 (f32)
    kernels: Tuple[torch.Tensor, ...]  # OIHW (working dtype), for the plain version
    biases: Tuple[torch.Tensor, ...]  # f32
    relus: Tuple[bool, ...]
    w_offs: Tuple[int, ...]  # each matrix's offset in w, in 16-byte words
    b_offs: Tuple[int, ...]  # each bias's offset in b
    # The A operand of csrc/conv_stack_wgmma.cu (fragments.wgmma_wide_matrix)
    # of each conv that :func:`is_frame`, None for the others. A K7 stack's
    # 5x5 convs get one too, which no kernel reads (K7 routes 3x3s alone).
    wide: Tuple[Optional[torch.Tensor], ...]
    # Each conv's HWIO kernel for the f32 route (f32 stacks only, else empty).
    hwio: Tuple[torch.Tensor, ...] = ()

    @property
    def specs(self) -> List[Tuple[int, int, int]]:
        """``(k, cin, cout)`` of each conv."""
        return [_spec(k) for k in self.kernels]


def _spec(w: torch.Tensor) -> Tuple[int, int, int]:
    return w.shape[-1], w.shape[1], w.shape[0]


def is_wide(spec: Tuple[int, int, int], side: int) -> bool:
    """Whether conv ``(k, cin, cout)`` of a tile stack over ``side``-square
    tiles runs on the wide-conv kernel: 3x3, both widths multiples of 64,
    16x16 tiles."""
    k, ci, co = spec
    return side == WIDE_SIDE and k == 3 and ci % 64 == 0 and co % 64 == 0


def is_frame(spec: Tuple[int, int, int]) -> bool:
    """Whether conv ``(k, cin, cout)`` of a banded stack runs on the frame
    kernel: 3x3 or 5x5, both widths multiples of 64. Such a conv carries
    the ``wgmma`` operand a wide conv of K7 reads too."""
    k, ci, co = spec
    return k in (3, 5) and ci % 64 == 0 and co % 64 == 0


def frame_tile(n: int, h: int, w: int, k: int) -> Tuple[int, int, int]:
    """The frame kernel's tile ``(frames, rows, cols)`` for a ``k x k`` conv
    over ``n`` frames of ``h x w``: ``cols = min(w, 64)``; as many rows as
    keep every output column of the wrapped box (row stride ``cols + k -
    1``) below ``FRAME_COLS``, spread evenly over the frame; where a whole
    frame fits, as many whole frames as fit (each with its own ``k - 1``
    halo rows)."""
    tw = min(w, FRAME_TW)
    bw = tw + k - 1
    fit = (FRAME_COLS - tw) // bw  # the last output row's index a tile allows
    if fit + 1 < h:
        ty = -(-h // (fit + 1))
        return 1, -(-h // ty), tw
    return min(n, (fit - (h - 1)) // (h + k - 1) + 1), h, tw


def conv_matrix(w: torch.Tensor) -> torch.Tensor:
    """OIHW kernel -> the kernel's packed ``(k * k * cin16, O)`` B matrix:
    rows ``(ky, kx, c)`` with each tap's channels zero-padded to a multiple
    of 16 (so a K-step of 16 rows is one tap), columns padded to 16."""
    o, c, k, _ = w.shape
    hwio = F.pad(w.permute(2, 3, 1, 0), (0, 0, 0, _pad16(c) - c))
    return fragments.pack(hwio.reshape(k * k * _pad16(c), o))


def pack_stack(
    convs: Sequence[Tuple[torch.Tensor, torch.Tensor]], relus: Sequence[bool], dtype: torch.dtype
) -> PackedStack:
    """``(weight OIHW, bias)`` pairs and their ReLU flags -> :class:`PackedStack`
    on the weights' device."""
    if len(convs) != len(relus) or not convs:
        raise ValueError("one ReLU flag per conv, and at least one conv")
    kernels = tuple(w.detach().to(dtype) for w, _ in convs)
    for a, b in zip(kernels, kernels[1:]):
        if a.shape[0] != b.shape[1]:
            raise ValueError(f"conv widths do not chain: {tuple(a.shape)} -> {tuple(b.shape)}")
    for k in kernels:
        if k.shape[-1] != k.shape[-2] or k.shape[-1] % 2 == 0:
            raise ValueError(f"kernels must be odd and square, got {tuple(k.shape)}")
    mats = [conv_matrix(k) for k in kernels]
    biases = tuple(b.detach().float() for _, b in convs)
    padded = [F.pad(b, (0, _pad16(b.numel()) - b.numel())) for b in biases]
    w_offs = tuple(itertools.accumulate([m.numel() // 8 for m in mats[:-1]], initial=0))
    b_offs = tuple(itertools.accumulate([b.numel() for b in padded[:-1]], initial=0))
    wide = tuple(fragments.wgmma_wide_matrix(k) if is_frame(_spec(k)) else None for k in kernels)
    f32 = tuple(hwio(k) for k in kernels) if dtype == torch.float32 else ()
    return PackedStack(torch.cat(mats).contiguous(), torch.cat(padded).contiguous(), kernels,
                       biases, tuple(bool(r) for r in relus), w_offs, b_offs, wide, f32)


class StackCache:
    """Packed stacks of a module's convs, made on first use and made again
    when a parameter changed since (keyed on each parameter's storage and
    version counter, which every in-place update advances)."""

    def __init__(self):
        self._entries = {}

    def get(self, name: Hashable, convs: Sequence, relus: Sequence[bool], dtype: torch.dtype) -> PackedStack:
        """``convs``: modules with ``weight`` and ``bias``; ``name`` keys the
        stack (two stacks of one module need two names: the flow
        estimators key theirs by the tuple of their convs' names)."""
        key = (dtype,) + tuple((p.data_ptr(), p._version) for m in convs for p in (m.weight, m.bias))
        hit = self._entries.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, pack_stack([(m.weight, m.bias) for m in convs], relus, dtype))
            self._entries[name] = hit
        return hit[1]


def refuse_grad_path(module: torch.nn.Module, route: str) -> None:
    """Raises ``ValueError`` when ``route`` (a K7 / K8 route of ``module``'s
    convs) runs under grad mode while a parameter of ``module`` requires
    grad: the kernels have no backward and :class:`StackCache` packs the
    weights without grad, so the parameters would get no gradient."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters()):
        raise ValueError(
            f"{route} runs the conv-stack kernels K7 / K8, which have no backward: "
            f"{type(module).__name__}'s parameters would get no gradient. On a grad path "
            "route its convs through the modules, or run under torch.no_grad()")


def conv_stack_plain(x: torch.Tensor, p: PackedStack) -> torch.Tensor:
    """The stack on NCHW ``x`` in its dtype, one ``F.conv2d`` per conv."""
    dt = x.dtype
    for k, b, relu in zip(p.kernels, p.biases, p.relus):
        y = F.conv2d(x.float(), k.float(), padding=k.shape[-1] // 2) + b.view(1, -1, 1, 1)
        x = (torch.relu(y) if relu else y).to(dt)
    return x


# ---------------------------------------------------------------------------
# Launch planning
# ---------------------------------------------------------------------------


class Group(NamedTuple):
    """One launch: convs ``[lo, hi)`` of the stack over ``th x tw`` tiles, on
    ``kernel``: ``"fused"`` (``csrc/conv_stack.cu``), or one conv on a
    ``wgmma`` kernel, ``"wide"`` (K7's wide-conv kernel) or ``"frame"`` (K8's
    frame kernel), whose buffers are its own rings: the buffer fields then
    read 0."""

    lo: int
    hi: int
    th: int
    tw: int
    border: int
    halo: int
    rs: int
    cs: int
    slack: int
    cpa: int
    cpb: int
    smem: int
    kernel: str = "fused"


def group_geometry(specs: Sequence[Tuple[int, int, int]], lo: int, hi: int, h: int, w: int,
                   th: int, tw: int) -> Group:
    """The buffers of convs ``[lo, hi)`` over ``th x tw`` tiles of ``h x w``
    images. A tile that covers the image needs a border of the largest
    radius only (nothing outside the image is computed); a piece of a
    frame needs the group's halo, the sum of its radii."""
    part = specs[lo:hi]
    radii = [k // 2 for k, _, _ in part]
    halo, rmax = sum(radii), max(radii)
    whole = th >= h and tw >= w
    th, tw = min(th, h), min(tw, w)
    border = rmax if whole else halo
    rs, cs = th + 2 * border, tw + 2 * border
    slack = 32  # the last M-tile pair's overrun (csrc/conv_stack.cu)
    last = len(part) - 1
    a_ch = [_pad16(part[0][1])] + [_pad16(part[s][2]) for s in range(1, last, 2)]
    b_ch = [_pad16(part[s][2]) for s in range(0, last, 2)]
    cpa = max(a_ch) + 8
    cpb = max(b_ch) + 8 if b_ch else 0
    smem = (rs * cs + slack) * (cpa + cpb) * 2
    return Group(lo, hi, th, tw, border, halo, rs, cs, slack, cpa, cpb, smem)


def group_cost(specs: Sequence[Tuple[int, int, int]], g: Group, h: int, w: int) -> int:
    """The planner's cost of group ``g`` per image, in multiply-adds: each
    stage over the flat pixel range it computes (halo and wrapped columns
    included, rounded up to the 32-pixel steps of a warp) with padded
    channels, plus each block's input tile and the group's output at
    ``MAC_PER_BYTE``."""
    tiles = -(-h // g.th) * -(-w // g.tw)
    macs, done = 0, 0
    for k, ci, co in specs[g.lo:g.hi]:
        done += k // 2
        rows, cols = min(g.th + 2 * (g.halo - done), h), min(g.tw + 2 * (g.halo - done), w)
        pixels = -(-((rows - 1) * g.cs + cols) // 32) * 32
        macs += pixels * k * k * _pad16(ci) * _pad16(co)
    load = g.rs * g.cs * specs[g.lo][1] * 2
    return tiles * (macs + MAC_PER_BYTE * load) + MAC_PER_BYTE * h * w * specs[g.hi - 1][2] * 2


@functools.lru_cache(maxsize=None)
def plan(specs: Tuple[Tuple[int, int, int], ...], h: int, w: int,
         tiles: Tuple[Tuple[int, int], ...]) -> List[Group]:
    """Cuts the stack into launches at the least :func:`group_cost`, each
    group with its cheapest tile of ``tiles`` whose buffers fit
    ``SMEM_LIMIT``, the larger on a tie (by dynamic programming over the
    cut points). Fusing
    convs saves a device-memory round trip; on halo tiles it also
    recomputes the halo at every stage, on tiles small enough for both
    buffers. Made once per shape: callers must not modify the list."""
    best = [(0, [])] + [None] * len(specs)
    for hi in range(1, len(specs) + 1):
        for lo in range(max(0, hi - MAX_STAGES), hi):
            fits = [g for g in (group_geometry(specs, lo, hi, h, w, *t) for t in tiles)
                    if g.smem <= SMEM_LIMIT]
            if best[lo] is None or not fits:
                continue
            cost, _, g = min((group_cost(specs, g, h, w), -g.th * g.tw, g) for g in fits)
            if best[hi] is None or best[lo][0] + cost < best[hi][0]:
                best[hi] = (best[lo][0] + cost, best[lo][1] + [g])
        if best[hi] is None:
            raise ValueError(f"conv {hi - 1} of the stack {list(specs)} does not fit in shared memory")
    return best[-1][1]


def _route(specs: Tuple[Tuple[int, int, int], ...], routed, fused, one) -> List[Group]:
    """Each conv ``i`` with ``routed(spec)`` as the group ``one(i)``, each run
    of the other convs as the groups ``fused(run)``, in stack order."""
    groups, lo = [], 0
    for i in range(len(specs) + 1):
        if i < len(specs) and not routed(specs[i]):
            continue
        if lo < i:
            groups += [g._replace(lo=g.lo + lo, hi=g.hi + lo) for g in fused(specs[lo:i])]
        if i < len(specs):
            groups.append(one(i))
        lo = i + 1
    return groups


@functools.lru_cache(maxsize=None)
def tile_plan(specs: Tuple[Tuple[int, int, int], ...], side: int, wide: bool) -> List[Group]:
    """K7's launches over ``side``-square tiles: with ``wide`` (the
    channels-last route), each conv that :func:`is_wide` one launch of the
    wide-conv kernel, and each run of the other convs the fused groups of
    :func:`plan` (a tile is one block's whole image); without (the
    channel-major route), the fused groups alone. Made once per shape:
    callers must not modify the list."""
    return _route(specs, lambda s: wide and is_wide(s, side),
                  lambda run: plan(run, side, side, ((side, side),)),
                  lambda i: Group(i, i + 1, side, side, 1, 1, 0, 0, 0, 0, 0, 0, "wide"))


@functools.lru_cache(maxsize=None)
def band_plan(specs: Tuple[Tuple[int, int, int], ...], h: int, w: int) -> List[Group]:
    """K8's launches over ``h x w`` frames: each conv that
    :func:`is_frame` one launch of the frame kernel (its group's ``th x tw``
    the rows and columns of :func:`frame_tile`), each run of the thin convs
    the fused groups of :func:`plan` over ``BAND_TILES``. Made once per
    shape: callers must not modify the list."""
    def one(i):
        k = specs[i][0]
        _, rows, tw = frame_tile(1, h, w, k)
        return Group(i, i + 1, rows, tw, k // 2, k // 2, 0, 0, 0, 0, 0, 0, "frame")

    return _route(specs, is_frame, lambda run: plan(run, h, w, BAND_TILES), one)


def plan_tiles(p: PackedStack, tile_side: int, wide: bool = False) -> List[Group]:
    """K7's launches for stack ``p`` (:func:`tile_plan`; ``wide`` for
    :func:`conv_stack_tiles_cl_cuda`, not for :func:`conv_stack_tiles_cuda`)."""
    return tile_plan(tuple(p.specs), tile_side, wide)


def plan_banded(p: PackedStack, h: int, w: int) -> List[Group]:
    """K8's launches over ``h x w`` frames (:func:`band_plan`)."""
    return band_plan(tuple(p.specs), h, w)


def stack_flops(p: PackedStack, images: int, h: int, w: int) -> int:
    """Multiply-adds x2 of the stack over ``images`` frames of ``h x w``."""
    return 2 * images * h * w * sum(k * k * ci * co for k, ci, co in p.specs)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------


class _Stage(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("k", "cin16", "cout", "cout16", "relu", "w_off", "b_off")]


class _Launch(ctypes.Structure):
    """``Launch`` of csrc/conv_stack.cu, field for field."""

    _fields_ = (
        [("st", _Stage * MAX_STAGES)]
        + [(n, ctypes.c_int) for n in ("nst", "cin", "H", "W", "TH", "TW", "tiles_x", "tiles",
                                       "border", "halo", "RS", "CS", "slack", "cpa", "cpb",
                                       "n_chunk")]
        + [("in_sn", ctypes.c_longlong), ("out_sn", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in ("in_sc", "in_sp", "out_sc", "out_sp")]
    )


@functools.lru_cache(maxsize=None)
def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("conv_stack", defines)
    lib.conv_stack_forward.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(_Launch), ctypes.c_int, ctypes.c_void_p]
    lib.conv_stack_forward.restype = ctypes.c_int
    return lib


def _n_chunk(g: Group, cout16: int, blocks: int) -> int:
    """Output channels per block of a single-conv group: split across
    blocks (in 32s) until about two blocks per SM are in flight."""
    if g.hi - g.lo > 1 or cout16 < 64:
        return cout16
    split = min(cout16 // 32, max(1, -(-2 * SM_COUNT // blocks)))
    return -(-cout16 // split // 32) * 32


def _check_input(x: torch.Tensor, p: PackedStack, dims: int, channel_axis: int) -> None:
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.dim() != dims:
        raise ValueError(f"x must be a contiguous {dims}-D bfloat16 CUDA tensor")
    if x.shape[channel_axis] != p.specs[0][1]:
        raise ValueError(f"x has {x.shape[channel_axis]} channels, the stack takes {p.specs[0][1]}")
    if p.w.dtype != torch.bfloat16 or p.w.device != x.device or p.b.device != x.device:
        raise ValueError("the stack must be packed in bfloat16 on x's device")


def _launch(x: torch.Tensor, out: torch.Tensor, p: PackedStack, g: Group, n: int, h: int, w: int,
            in_strides: Tuple[int, int, int], out_strides: Tuple[int, int, int],
            lib: ctypes.CDLL) -> None:
    specs = p.specs
    desc = _Launch()
    for s, i in enumerate(range(g.lo, g.hi)):
        k, ci, co = specs[i]
        desc.st[s] = _Stage(k, _pad16(ci), co, _pad16(co), int(p.relus[i]), p.w_offs[i], p.b_offs[i])
    tiles_x = -(-w // g.tw)
    tiles = -(-h // g.th) * tiles_x
    cout16 = _pad16(specs[g.hi - 1][2])
    desc.nst, desc.cin, desc.H, desc.W = g.hi - g.lo, specs[g.lo][1], h, w
    desc.TH, desc.TW, desc.tiles_x, desc.tiles = g.th, g.tw, tiles_x, tiles
    desc.border, desc.halo, desc.RS, desc.CS, desc.slack = g.border, g.halo, g.rs, g.cs, g.slack
    desc.cpa, desc.cpb, desc.n_chunk = g.cpa, g.cpb, _n_chunk(g, cout16, n * tiles)
    desc.in_sn, desc.in_sc, desc.in_sp = in_strides
    desc.out_sn, desc.out_sc, desc.out_sp = out_strides
    rc = lib.conv_stack_forward(x.data_ptr(), out.data_ptr(), p.w.data_ptr(), p.b.data_ptr(),
                                ctypes.byref(desc), n, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "conv_stack_forward")


@functools.lru_cache(maxsize=None)
def _wide_lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _build.load("conv_stack_wgmma", defines)
    lib.conv3x3_wide_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    lib.conv3x3_wide_forward.restype = ctypes.c_int
    lib.conv_frame_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.conv_frame_forward.restype = ctypes.c_int
    return lib


def _check_cl(x: torch.Tensor, p: PackedStack, cin: int) -> None:
    if (not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4
            or not x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("x must be a channels-last (NT, C, side, side) bfloat16 CUDA tensor")
    if x.shape[2] != x.shape[3] or x.shape[1] != cin:
        raise ValueError(f"x is {tuple(x.shape)}: square tiles of {cin} channels expected")
    if p.w.dtype != torch.bfloat16 or p.w.device != x.device or p.b.device != x.device:
        raise ValueError("the stack must be packed in bfloat16 on x's device")


def wide_out_strides(nt: int, cout: int, swap: bool) -> Tuple[int, int, int, int]:
    """The wide-conv kernel's output addressing ``(tg, sg, st, sp)``: tile t's
    pixel q, channel o at ``(t // tg) sg + (t % tg) st + q sp + o``; NHWC, or
    with ``swap`` tile ``256 g + t``'s pixel q at tile ``256 g + q``'s pixel t."""
    hw = WIDE_SIDE * WIDE_SIDE
    return (hw, hw * hw * cout, cout, hw * cout) if swap else (nt, 0, hw * cout, cout)


def conv3x3_wide_cuda(x: torch.Tensor, p: PackedStack, i: int, swap: bool = False) -> torch.Tensor:
    """Conv ``i`` of stack ``p`` (one that :func:`is_wide`) on channels-last
    ``(NT, Cin, 16, 16)`` bf16: one launch of ``csrc/conv_stack_wgmma.cu``.
    Returns channels-last ``(NT, Cout, 16, 16)``. With ``swap`` the tiles come
    back regrouped, NT = G x 256: output tile ``256 g + q`` holds at pixel
    ``t`` input tile ``256 g + t``'s pixel ``q`` (sep4d's p <-> q swap), by
    the epilogue's store addresses."""
    _, ci, co = p.specs[i]
    _check_cl(x, p, ci)
    nt = x.shape[0]
    mat = p.wide[i]
    if not is_wide(p.specs[i], x.shape[2]):
        raise ValueError(f"conv {i} {p.specs[i]} on {tuple(x.shape)} is not a wide conv")
    if mat.dtype != torch.bfloat16 or mat.device != x.device:
        raise ValueError("the stack must be packed in bfloat16 on x's device")
    if swap and nt % WIDE_SIDE**2:
        raise ValueError(f"swap regroups the tiles by {WIDE_SIDE**2}; got {nt}")
    out = torch.empty((nt, WIDE_SIDE, WIDE_SIDE, co), dtype=x.dtype, device=x.device)
    tg, sg, st, sp = wide_out_strides(nt, co, swap)
    lib = _wide_lib()
    rc = lib.conv3x3_wide_forward(x.data_ptr(), mat.data_ptr(), p.b.data_ptr() + 4 * p.b_offs[i],
                                  out.data_ptr(), nt, ci, co, mat.numel() // (9 * ci),
                                  int(p.relus[i]), tg, sg, st, sp,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "conv3x3_wide_forward")
    conv3x3_wide_cuda.launches += 1
    return out.permute(0, 3, 1, 2)


conv3x3_wide_cuda.launches = 0


def conv_frame_cuda(x: torch.Tensor, p: PackedStack, i: int) -> torch.Tensor:
    """Conv ``i`` of stack ``p`` (one that :func:`is_frame`) on contiguous
    NHWC ``(N, H, W, Cin)`` bf16 frames, zero-padded at the frame's border:
    one launch of ``csrc/conv_stack_wgmma.cu``'s frame kernel over the tiles
    of :func:`frame_tile`. Returns NHWC ``(N, H, W, Cout)``. Other strides
    (an NCHW tensor's NHWC view), dtypes and a conv without its packed
    operand are refused."""
    k, ci, co = p.specs[i]
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (N, H, W, C) bfloat16 CUDA tensor")
    if x.shape[3] != ci:
        raise ValueError(f"x has {x.shape[3]} channels, conv {i} takes {ci}")
    mat = p.wide[i]
    if mat is None:
        raise ValueError(f"conv {i} {p.specs[i]} is not a frame conv")
    if mat.dtype != torch.bfloat16 or mat.device != x.device or p.b.device != x.device:
        raise ValueError("the stack must be packed in bfloat16 on x's device")
    n, h, w, _ = x.shape
    fr, rows, tw = frame_tile(n, h, w, k)
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    lib = _wide_lib()
    rc = lib.conv_frame_forward(x.data_ptr(), mat.data_ptr(), p.b.data_ptr() + 4 * p.b_offs[i],
                                out.data_ptr(), n, h, w, ci, co, mat.numel() // (k * k * ci), k,
                                int(p.relus[i]), fr, rows, tw,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "conv_frame_forward")
    conv_frame_cuda.launches += 1
    return out


conv_frame_cuda.launches = 0


def _run(x: torch.Tensor, p: PackedStack, groups: List[Group], n: int, h: int, w: int,
         channel_major: bool, counter, swap: bool = False) -> torch.Tensor:
    """The groups in turn; the first reads ``x`` and the last writes the
    result in ``x``'s layout, the groups between pass pixel-major
    intermediates (``(n, hw, C)``). A ``"frame"`` group is one
    :func:`conv_frame_cuda`, a ``"wide"`` group one :func:`conv3x3_wide_cuda`
    (both pixel-major ``x`` only); with ``swap`` the last group, wide,
    regroups the tiles."""
    hw, specs, lib = h * w, p.specs, None
    cur, cur_cm = x, channel_major
    for gi, g in enumerate(groups):
        cin, cout = specs[g.lo][1], specs[g.hi - 1][2]
        last = gi == len(groups) - 1
        out_cm = channel_major and last
        if g.kernel == "frame":
            out = conv_frame_cuda(cur.view(n, h, w, cin), p, g.lo).view(n, hw, cout)
        elif g.kernel == "wide":
            y = conv3x3_wide_cuda(cur.view(n, h, w, cin).permute(0, 3, 1, 2), p, g.lo, swap and last)
            out = y.permute(0, 2, 3, 1).reshape(n, hw, cout)
        else:
            out = torch.empty((n, cout, hw) if out_cm else (n, hw, cout), dtype=x.dtype,
                              device=x.device)
            in_strides = (cin * hw, hw, 1) if cur_cm else (cin * hw, 1, cin)
            out_strides = (cout * hw, hw, 1) if out_cm else (cout * hw, 1, cout)
            lib = lib or _lib()
            _launch(cur, out, p, g, n, h, w, in_strides, out_strides, lib)
        counter.launches += 1
        cur, cur_cm = out, out_cm
    return cur


def conv_stack_tiles_cuda(x: torch.Tensor, p: PackedStack, tile_side: int) -> torch.Tensor:
    """K7 on channel-major ``(NT, Cin, tile_side**2)`` bf16: one launch per
    fused group of :func:`plan_tiles`, each block one tile (the first
    design's route: the JAX-shaped entry, and the yardstick chip_smoke.py
    times the channels-last route against)."""
    _check_input(x, p, 3, 1)
    nt, _, hw = x.shape
    if hw != tile_side * tile_side:
        raise ValueError(f"x holds {hw} pixels per tile, not {tile_side}**2")
    return _run(x, p, plan_tiles(p, tile_side), nt, tile_side, tile_side, True,
                conv_stack_tiles_cuda)


conv_stack_tiles_cuda.launches = 0  # every K7 launch, wide ones included


def conv_stack_tiles_cl_cuda(x: torch.Tensor, p: PackedStack, swap: bool = False) -> torch.Tensor:
    """K7 on channels-last ``(NT, Cin, side, side)`` bf16 (NCHW strides and
    other dtypes are refused): one launch per group of :func:`plan_tiles`
    with the wide convs on the wide-conv kernel, channels-last between
    them. Returns channels-last ``(NT, Cout, side, side)``; with ``swap`` the
    tiles regrouped as :func:`conv3x3_wide_cuda` says, by the last launch's
    store addresses where it is wide (chip_smoke.py measures that faster
    than one permute of sep4d's 671 MB), else by one permute."""
    _check_cl(x, p, p.specs[0][1])
    nt, _, side, _ = x.shape
    groups = plan_tiles(p, side, wide=True)
    in_kernel = swap and groups[-1].kernel == "wide"
    y = _run(x.permute(0, 2, 3, 1).reshape(nt, side * side, -1), p, groups, nt, side, side,
             False, conv_stack_tiles_cuda, in_kernel)
    y = y.view(nt, side, side, -1).permute(0, 3, 1, 2)
    return swap_tiles(y) if swap and not in_kernel else y


def conv_stack_banded_cuda(x: torch.Tensor, p: PackedStack) -> torch.Tensor:
    """K8 on NHWC ``(N, H, W, Cin)`` bf16: one launch per group of
    :func:`plan_banded`, the frame convs on the frame kernel, NHWC between
    the launches."""
    _check_input(x, p, 4, 3)
    n, h, w, _ = x.shape
    out = _run(x, p, plan_banded(p, h, w), n, h, w, False, conv_stack_banded_cuda)
    return out.view(n, h, w, -1)


conv_stack_banded_cuda.launches = 0  # every K8 launch, the frame kernel's included


def conv_stack_banded_first_cuda(x: torch.Tensor, p: PackedStack) -> torch.Tensor:
    """K8's first design on NHWC ``(N, H, W, Cin)`` bf16: the fused groups of
    :func:`plan` over ``BAND_TILES`` alone (the yardstick chip_smoke.py times
    the frame kernel's route against; no path calls it)."""
    _check_input(x, p, 4, 3)
    n, h, w, _ = x.shape
    groups = plan(tuple(p.specs), h, w, BAND_TILES)
    return _run(x, p, groups, n, h, w, False, conv_stack_banded_first_cuda).view(n, h, w, -1)


conv_stack_banded_first_cuda.launches = 0


def swap_tiles(y: torch.Tensor) -> torch.Tensor:
    """``(G x hw, C, s, s)`` tiles (``hw = s**2``) -> channels-last tiles with
    tile ``hw g + q``'s pixel ``t`` = ``y``'s tile ``hw g + t``'s pixel ``q``."""
    nt, c, s, _ = y.shape
    hw = s * s
    t = y.permute(0, 2, 3, 1).reshape(nt // hw, hw, hw, c).transpose(1, 2)
    return t.reshape(nt, s, s, c).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def conv_stack_tiles_plain(x: torch.Tensor, p: PackedStack, tile_side: int) -> torch.Tensor:
    """K7's plain version on any device."""
    nt, cin, hw = x.shape
    return conv_stack_plain(x.reshape(nt, cin, tile_side, tile_side), p).reshape(nt, -1, hw)


def conv_stack_tiles_cl_plain(x: torch.Tensor, p: PackedStack, swap: bool = False) -> torch.Tensor:
    """K7's plain version on ``(NT, Cin, side, side)`` tiles of either
    layout: channels-last output, regrouped with ``swap``."""
    y = conv_stack_plain(x, p).contiguous(memory_format=torch.channels_last)
    return swap_tiles(y) if swap else y


def conv_stack_banded_plain(x: torch.Tensor, p: PackedStack) -> torch.Tensor:
    """K8's plain version on any device."""
    return conv_stack_plain(x.permute(0, 3, 1, 2), p).permute(0, 2, 3, 1).contiguous()


def _stack_f32(x: torch.Tensor, p: PackedStack, counter) -> torch.Tensor:
    """The stack's f32 route on NHWC ``(N, H, W, Cin)`` f32 (any strides
    with contiguous channels): one :func:`.conv_f32.conv_f32_fwd` a conv,
    NHWC between them; launches count in ``counter.launches``."""
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[3] != p.specs[0][1]:
        raise ValueError(f"x must be f32 NHWC with {p.specs[0][1]} channels, got {tuple(x.shape)} {x.dtype}")
    if not p.hwio or p.hwio[0].device != x.device:
        raise ValueError("the stack must be packed in float32 on x's device")
    n, h, w, _ = x.shape
    for (k, _, co), wk, b, relu in zip(p.specs, p.hwio, p.biases, p.relus):
        out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
        x = conv_f32_fwd(x, wk, out, bias=b.contiguous(), k=k, epi="relu" if relu else "none")
    if x.is_cuda:
        counter.launches += len(p.specs)
    return x


def conv_stack_tiles_f32(x: torch.Tensor, p: PackedStack, tile_side: int) -> torch.Tensor:
    """K7's f32 route on channel-major ``(NT, Cin, tile_side**2)``: the
    tiles as NHWC images, one launch a conv (``conv_stack_tiles_f32.launches``,
    which counts both K7 entries' f32 launches)."""
    nt, cin, hw = x.shape
    if hw != tile_side * tile_side:
        raise ValueError(f"x holds {hw} pixels per tile, not {tile_side}**2")
    y = _stack_f32(x.view(nt, cin, tile_side, tile_side).permute(0, 2, 3, 1).contiguous(), p,
                   conv_stack_tiles_f32)
    return y.permute(0, 3, 1, 2).reshape(nt, -1, hw)


conv_stack_tiles_f32.launches = 0


def conv_stack_tiles_cl_f32(x: torch.Tensor, p: PackedStack, swap: bool = False) -> torch.Tensor:
    """K7's f32 route on ``(NT, Cin, side, side)`` tiles (channels-last, or
    copied so once): channels-last output, regrouped by one permute with
    ``swap`` (:func:`swap_tiles`)."""
    y = _stack_f32(nhwc(x), p, conv_stack_tiles_f32).permute(0, 3, 1, 2)
    return swap_tiles(y) if swap else y


def conv_stack_banded_f32(x: torch.Tensor, p: PackedStack) -> torch.Tensor:
    """K8's f32 route on NHWC ``(N, H, W, Cin)``: one launch a conv over
    the whole frames (``conv_stack_banded_f32.launches``)."""
    return _stack_f32(x, p, conv_stack_banded_f32)


conv_stack_banded_f32.launches = 0


def _f32(x: torch.Tensor) -> bool:
    """Whether a CUDA tensor takes the f32 route (else the bf16 kernels)."""
    return kernel_route(x.dtype) == "f32"


def _check_cpu(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"no conv-stack implementation for device {x.device}")


def conv_stack_tiles(x: torch.Tensor, p: PackedStack, tile_side: int) -> torch.Tensor:
    """``(NT, Cin, hw)`` -> ``(NT, Cout, hw)``: the kernel for a CUDA tensor
    (bf16, or the f32 route in f32), the plain version for a CPU tensor."""
    if x.is_cuda:
        return (conv_stack_tiles_f32 if _f32(x) else conv_stack_tiles_cuda)(x, p, tile_side)
    _check_cpu(x)
    return conv_stack_tiles_plain(x, p, tile_side)


def conv_stack_tiles_cl(x: torch.Tensor, p: PackedStack, swap: bool = False) -> torch.Tensor:
    """Channels-last ``(NT, Cin, side, side)`` -> channels-last ``(NT, Cout,
    side, side)``, regrouped with ``swap``: the kernels for a CUDA tensor
    (bf16, or the f32 route in f32), the plain version for a CPU tensor."""
    if x.is_cuda:
        return (conv_stack_tiles_cl_f32 if _f32(x) else conv_stack_tiles_cl_cuda)(x, p, swap=swap)
    _check_cpu(x)
    return conv_stack_tiles_cl_plain(x, p, swap)


def conv_stack_banded(x: torch.Tensor, p: PackedStack) -> torch.Tensor:
    """NHWC ``(N, H, W, Cin)`` -> ``(N, H, W, Cout)``: the kernel for a CUDA
    tensor (bf16, or the f32 route in f32), the plain version for a CPU
    tensor."""
    if x.is_cuda:
        return (conv_stack_banded_f32 if _f32(x) else conv_stack_banded_cuda)(x, p)
    _check_cpu(x)
    return conv_stack_banded_plain(x, p)


# ---------------------------------------------------------------------------
# The DFPN stages on K7
# ---------------------------------------------------------------------------

def mixer_apply(p: PackedStack, corr: torch.Tensor, corr_size: int, dtype: torch.dtype) -> torch.Tensor:
    """The correlation mixer on K7 (``mixer_apply_pallas``): one tile per
    (b, f), p-space as channels, channels-last (its 3x3 256 -> 256 on the
    wide-conv kernel at 16x16 tiles). ``corr (B, F, cs, cs, cs, cs)`` ->
    ``(B, F, cs, cs, 2)``; ``corr.reshape(b * f, cs**2, cs, cs)`` is
    channel-major, so the volume is copied once into channels-last."""
    b, f = corr.shape[:2]
    cs = corr_size
    x = corr.reshape(b * f, cs * cs, cs, cs).to(dtype).contiguous(memory_format=torch.channels_last)
    y = conv_stack_tiles_cl(x, p)  # (b*f, 2, cs, cs), channels-last
    return y.permute(0, 2, 3, 1).reshape(b, f, cs, cs, -1)


def sep4d_apply(p1: PackedStack, p2: PackedStack, corr: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The separable 4-D conv on K7 (``sep4d_apply_pallas``), channels-last:
    stage 1 over q-space with one tile per (b, f, p), its output ``(b f p, q,
    C)``; the p <-> q swap to ``(b f q, p, C)`` (in the epilogue of stage 1's
    last conv where that runs on the wide-conv kernel, else one permute);
    stage 2 over p-space with one tile per (b, f, q). ``corr (B, F, h, w, h,
    w)`` -> the same shape in ``dtype``."""
    b, f, h, w = corr.shape[:4]
    hw = h * w
    x = corr.reshape(b * f * hw, 1, h, w).to(dtype).contiguous()  # 1 channel: channels-last too
    y = conv_stack_tiles_cl(x, p1, swap=True)  # (b*f*q, C, p)
    y = conv_stack_tiles_cl(y, p2)  # (b*f*q, 1, p)
    return y.reshape(b * f, hw, hw).transpose(1, 2).reshape(b, f, h, w, h, w)
