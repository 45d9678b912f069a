"""Python side of the backward kernels' shared launches
(``csrc/conv_bwd.cuh``): argument binding, checks and the launch count.

The first K6 and K3 designs (``csrc/tail_bwd.cu``, ``csrc/rrdb_bwd.cu``,
each kept beside the current one) each export ``bwd_prep``, ``bwd_conv``,
``bwd_wgrad`` and ``bwd_reduce`` over their own instantiations. Each
helper here launches one kernel of the library it is given and adds one to
``owner.launches``, the count of the wrapper that drives the chain
(:func:`..tail_bwd.tail_bwd_first_cuda`, :func:`..rrdb_bwd.rrdb_bwd_first`).

Adjoint weights: the adjoint of a 3x3 conv with OIHW kernel ``W`` is the
3x3 conv with ``W`` transposed and flipped; :func:`pack_adjoint` stores it
as the kernels' ``(9 * O, C)`` B matrix, rows ``(tap, o)``
(``fragments.adjoint_matrix``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from master_thesis_tpu_torch import _build
from master_thesis_tpu_torch.ops import fragments

OUT_F32, OUT_BF16_LRELU, OUT_RRDB_DX = 0, 1, 2

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument types of the shared entry points of ``lib``."""
    lib.bwd_prep.argtypes = [_VP, _VP, _F, _I, _I, _VP, _I, _I, _VP, _I, _I, _VP, _LL, _LL] + [_I] * 6 + [_VP]
    lib.bwd_conv.argtypes = [_I, _I, _I, _VP, _I, _I, _VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP] + [_I] * 3 + [_VP]
    lib.bwd_wgrad.argtypes = [_I, _I, _VP, _I, _VP, _I, _I, _VP, _I, _I, _VP, _LL, _LL] + [_I] * 4 + [_VP]
    lib.bwd_reduce.argtypes = [_VP, _I, _LL, _VP, _VP]
    for fn in (lib.bwd_prep, lib.bwd_conv, lib.bwd_wgrad, lib.bwd_reduce):
        fn.restype = _I
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() or t.dim() != 4:
        raise ValueError(f"{what} must be a contiguous 4-D {dtype} CUDA tensor")


def _launched(lib, rc: int, what: str, owner) -> None:
    _build.check(lib, rc, what)
    owner.launches += 1


def prep(lib, owner, inp: torch.Tensor, ci0: int, c: int, *, scale: float = 1.0,
         sign: Optional[torch.Tensor] = None, cs0: int = 0,
         out: Optional[torch.Tensor] = None, co0: int = 0,
         partial: Optional[torch.Tensor] = None, poff: int = 0, pool: bool = False,
         ks: int = 1) -> None:
    """``out[:, co0:co0+c] = bf16(mask(scale * inp[:, ci0:ci0+c]))`` with
    ``mask`` from ``sign[:, cs0:cs0+c]`` (lrelu slope 0.2 where negative);
    with ``pool`` ``inp`` is at twice the resolution and each 2x2 block is
    summed; ``partial[k, poff + j]`` = block k's sum of channel j."""
    _check(inp, inp.dtype, "prep input")
    if inp.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("prep input must be f32 or bf16")
    n, in_cs, h, w = inp.shape
    if pool:
        if inp.dtype != torch.float32:
            raise ValueError("a pooled prep input must be f32")
        h, w = h // 2, w // 2
    for t, name in ((sign, "sign"), (out, "out")):
        if t is not None:
            _check(t, torch.bfloat16, name)
            if (t.shape[0], t.shape[2], t.shape[3]) != (n, h, w):
                raise ValueError(f"{name} must be ({n}, C, {h}, {w})")
    if partial is not None and (partial.dtype != torch.float32 or partial.dim() != 2
                                or partial.shape[0] != ks or poff + c > partial.shape[1]):
        raise ValueError("partial must be a (ks, cols) f32 tensor with room for c sums")
    f32 = inp.dtype == torch.float32
    rc = lib.bwd_prep(
        _ptr(inp) if f32 else None, None if f32 else _ptr(inp), scale, in_cs, ci0,
        _ptr(sign), 0 if sign is None else sign.shape[1], cs0,
        _ptr(out), 0 if out is None else out.shape[1], co0,
        _ptr(partial), 0 if partial is None else partial.shape[1], poff,
        c, n, h, w, int(pool), ks, _stream(inp),
    )
    _launched(lib, rc, "bwd_prep", owner)


def conv(lib, owner, inp: torch.Tensor, cin: int, cin_real: int, w: torch.Tensor, cout: int,
         mode: int, *, bias: Optional[torch.Tensor] = None,
         acc_f32: Optional[torch.Tensor] = None, accumulate: bool = False,
         out_f32: Optional[torch.Tensor] = None, out_bf16: Optional[torch.Tensor] = None,
         gout: Optional[torch.Tensor] = None, gres: Optional[torch.Tensor] = None) -> None:
    """A same-padded 3x3 conv of ``inp[:, :cin_real]`` (padded to ``cin``)
    by the packed ``(9 * cin, cout)`` matrix ``w``, with the epilogue
    ``mode`` (``csrc/conv_bwd.cuh``: conv3x3_kernel)."""
    _check(inp, torch.bfloat16, "conv input")
    n, in_cs, h, wd = inp.shape
    if w.dtype != torch.bfloat16 or w.numel() != fragments.numel(9 * cin, cout) or w.device != inp.device:
        raise ValueError(f"w must be a packed bf16 (9 * {cin}, {cout}) matrix on the input's device")
    out_cs = 0
    if acc_f32 is not None:
        _check(acc_f32, torch.float32, "acc_f32")
        out_cs = acc_f32.shape[1]
    if mode == OUT_BF16_LRELU:
        _check(out_bf16, torch.bfloat16, "out_bf16")
        out_cs = out_bf16.shape[1]
    for t in (acc_f32, out_f32, out_bf16, gout, gres):
        if t is not None and (t.shape[0], t.shape[2], t.shape[3]) != (n, h, wd):
            raise ValueError("every conv tensor must share the input's (N, H, W)")
    rc = lib.bwd_conv(
        cin, cout, mode, _ptr(inp), in_cs, cin_real, _ptr(w), _ptr(bias), _ptr(acc_f32),
        out_cs, int(accumulate), _ptr(out_f32), _ptr(out_bf16), _ptr(gout), _ptr(gres),
        n, h, wd, _stream(inp),
    )
    _launched(lib, rc, f"bwd_conv({cin}, {cout}, mode {mode})", owner)


def wgrad(lib, owner, src_a: torch.Tensor, src_b: Optional[torch.Tensor], cin: int,
          dp: torch.Tensor, coutp: int, cout_real: int, partial: torch.Tensor, poff: int,
          ks: int, up: bool = False) -> None:
    """``partial[k, poff + (tap * cin + c) * cout_real + o]`` = K-split k's
    share of ``sum_p src[c, p + tap] * dp[o, p]``; ``src`` is
    ``cat(src_a, src_b)`` on channels (read as its nearest-2x upsampling
    with ``up``)."""
    _check(src_a, torch.bfloat16, "src_a")
    _check(dp, torch.bfloat16, "dp")
    n, _, h, w = dp.shape
    ca = src_a.shape[1]
    cb = 0 if src_b is None else src_b.shape[1]
    for s in (src_a,) if src_b is None else (src_a, src_b):
        _check(s, torch.bfloat16, "src")
        if (s.shape[0], s.shape[2] * (1 + up), s.shape[3] * (1 + up)) != (n, h, w):
            raise ValueError("src must match dp's frames (at half its size with up)")
    if cin % 32 or cin > ca + cb or ca % 32:
        raise ValueError("wgrad reads 32-channel chunks of src")
    if partial.dtype != torch.float32 or partial.shape[0] != ks or poff + 9 * cin * cout_real > partial.shape[1]:
        raise ValueError("partial must be a (ks, cols) f32 tensor with room for the weight grad")
    rc = lib.bwd_wgrad(
        coutp, int(up), _ptr(src_a), ca, _ptr(src_b), cb, cin, _ptr(dp), dp.shape[1],
        cout_real, _ptr(partial), partial.shape[1], poff, n, h, w, ks, _stream(dp),
    )
    _launched(lib, rc, f"bwd_wgrad({coutp}, up={up})", owner)


def reduce(lib, owner, partial: torch.Tensor) -> torch.Tensor:
    """The column sums of ``partial`` ``(rows, cols)``, rows added in order."""
    out = torch.empty(partial.shape[1], dtype=torch.float32, device=partial.device)
    rc = lib.bwd_reduce(_ptr(partial), partial.shape[0], partial.shape[1], _ptr(out), _stream(partial))
    _launched(lib, rc, "bwd_reduce", owner)
    return out


def pack_adjoint(w: torch.Tensor, dtype: torch.dtype, o_pad: Optional[int] = None) -> torch.Tensor:
    """OIHW ``w`` -> the adjoint conv's packed B matrix
    (``fragments.adjoint_matrix``) in ``dtype``, rounded as
    ``_adj_from_flat`` / ``_rrdb_adj_weights`` round it."""
    return fragments.adjoint_matrix(w.detach().to(dtype), o_pad).contiguous()


def split_weight_grads(flat: torch.Tensor, convs) -> list:
    """``flat`` holds, in order, each conv's ``(3, 3, cin, cout)`` weight
    grad; ``convs`` lists ``(cin, cout)``. Returns OIHW tensors."""
    out, off = [], 0
    for cin, cout in convs:
        size = 9 * cin * cout
        out.append(flat[off: off + size].view(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous())
        off += size
    return out
