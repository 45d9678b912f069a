"""Operations and bytes of the cells' work, from shapes alone.

A conv's FLOPs are ``2 x`` its multiply-adds over its output pixels (a
transposed conv's over its input pixels). ``mfu`` counts the conv and
matmul products of the step as the reference model writes them (an
upsample-conv as a 3x3 conv over the upsampled frame), each once forward
and once for each gradient the step needs; recompute is not counted. A
roofline counts its layer's least work: the upsample-convs in their
4-phase form (4 taps an output pixel), each input read and each output
written once, ``itemsize`` bytes an element, weights once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

HEAD_STRIDES = (1, 1, 2, 1, 2)

# (name, k, stride, cin, cout) of CPN's alignment encoder at 224² input.
CPN_ENCODER = (("conv12", 5, 2, 4, 64), ("conv2", 3, 1, 64, 64), ("conv23", 3, 2, 64, 128),
               ("conv3", 3, 1, 128, 128), ("conv34", 3, 2, 128, 256), ("conv4a", 3, 1, 256, 256),
               ("conv4b", 3, 1, 256, 256))
CPN_REGRESSOR = (("conv45", 2), ("conv5a", 1), ("conv5b", 1), ("conv56", 2), ("conv5a", 1), ("conv5b", 1))
VGG16 = ((3, 64), (64, 64), "M", (64, 128), (128, 128), "M", (128, 256), (256, 256), (256, 256), "M",
         (256, 512), (512, 512), (512, 512), "M", (512, 512), (512, 512), (512, 512), "M")
# (k, stride, transposed) of the flow estimator's 21 layers; widths 10 ->
# 128 ... 128 -> 2.
FLOW = ((5, 1, 0), (3, 1, 0), (5, 2, 0), (5, 1, 0), (3, 1, 0), (3, 2, 0), (5, 1, 0), (3, 1, 0),
        (3, 2, 0), (5, 1, 0), (3, 1, 0), (3, 2, 1), (5, 1, 0), (3, 1, 0), (3, 2, 1), (5, 1, 0),
        (3, 1, 0), (5, 2, 1), (5, 1, 0), (3, 1, 0), (3, 1, 0))
MIXER_K = (5, 3, 3, 5, 3, 3, 5, 3, 3, 5, 3, 3, 5, 3)


def conv_flops(n: int, h: int, w: int, cin: int, cout: int, k: int) -> int:
    """``2 x`` the multiply-adds of a ``k x k`` conv with ``h x w`` outputs."""
    return 2 * n * h * w * cin * cout * k * k


def rdb_widths(nf: int = 64, gc: int = 32) -> List[Tuple[int, int]]:
    return [(nf + i * gc, gc) for i in range(4)] + [(nf + 4 * gc, nf)]


def chn_head(n: int, h: int, w: int, in_nc: int = 9, nf: int = 64) -> List[int]:
    out, cin = [], in_nc
    for s in HEAD_STRIDES:
        h, w = h // s, w // s
        out.append(conv_flops(n, h, w, cin, nf, 3))
        cin = nf
    return out


def chn_trunk(n: int, h: int, w: int, nb: int, nf: int = 64, gc: int = 32) -> int:
    """The trunk's products at the trunk grid ``h x w`` (a quarter of the
    frame's sides)."""
    return 3 * nb * sum(conv_flops(n, h, w, ci, co, 3) for ci, co in rdb_widths(nf, gc))


def tail_stages(n: int, h: int, w: int, nf: int = 64, out_nc: int = 3, four_phase: bool = True) -> List[int]:
    """upconv1, upconv2, hr_conv, conv_last from a trunk grid of ``h x w``;
    the upsample-convs at 4 taps an output pixel (``four_phase``) or 9."""
    taps = 4 if four_phase else 9
    return [2 * n * 4 * h * w * taps * nf * nf, 2 * n * 16 * h * w * taps * nf * nf,
            conv_flops(n, 4 * h, 4 * w, nf, nf, 3), conv_flops(n, 4 * h, 4 * w, nf, out_nc, 3)]


def chn_parts(n: int, h: int, w: int, nb: int) -> Dict[str, int]:
    """CHN's forward products over ``n`` frames of ``h x w``, by part."""
    return {"head": sum(chn_head(n, h, w)), "trunk": chn_trunk(n, h // 4, w // 4, nb),
            "trunk_conv": conv_flops(n, h // 4, w // 4, 64, 64, 3),
            "tail": sum(tail_stages(n, h // 4, w // 4, four_phase=False))}


def cpn_parts(b: int, f: int) -> Dict[str, int]:
    """CPN.align's products: the encoder over ``b`` targets and ``b f``
    references at 224², the regressor over ``b f`` pairs, fc."""
    enc, h = 0, 224
    for _, k, s, ci, co in CPN_ENCODER:
        h //= s
        enc += conv_flops(1, h, h, ci, co, k)
    reg, h = 0, 28
    for _, s in CPN_REGRESSOR:
        h //= s
        reg += conv_flops(1, h, h, 512, 512, 3)
    return {"encoder": enc * (b + b * f), "regressor": (reg + 2 * 512 * 6) * b * f}


def vgg_layers(h: int, w: int, pools: int = 5) -> List[Tuple[int, int, int, int]]:
    """``(h, w, cin, cout)`` of VGG-16's 3x3 convs before its ``pools``-th
    pool, from an ``h x w`` input."""
    out, seen = [], 0
    for layer in VGG16:
        if layer == "M":
            h, w, seen = h // 2, w // 2, seen + 1
            if seen == pools:
                break
            continue
        out.append((h, w, layer[0], layer[1]))
    return out


def vgg_flops(n: int, h: int, w: int, pools: int = 5) -> int:
    return sum(conv_flops(n, hh, ww, ci, co, 3) for hh, ww, ci, co in vgg_layers(h, w, pools))


def flow_layers(h: int, w: int) -> List[Tuple[int, int, int, int, int, bool]]:
    """``(h, w, cin, cout, k, stride_1)`` of the flow estimator's 21 layers
    from an ``h x w`` input: each conv's output grid (a transposed conv's
    input grid, over which its products are counted), ``stride_1`` for
    the convs of the fixed-resolution segments."""
    out = []
    for i, (k, s, transposed) in enumerate(FLOW):
        cin, cout = (10 if i == 0 else 128), (2 if i == len(FLOW) - 1 else 128)
        if not transposed:
            h, w = h // s, w // s
        out.append((h, w, cin, cout, k, s == 1))
        if transposed:
            h, w = h * s, w * s
    return out


def flow_estimator(n: int, h: int, w: int) -> List[int]:
    return [conv_flops(n, hh, ww, ci, co, k) for hh, ww, ci, co, k, _ in flow_layers(h, w)]


def sep4d_convs() -> List[Tuple[int, int, int]]:
    """(cin, cout, k) of the separable 4-D conv's six convs."""
    return [(1, 128, 3), (128, 256, 3), (256, 256, 3), (256, 256, 3), (256, 128, 3), (128, 1, 3)]


def mixer_convs(cs: int) -> List[Tuple[int, int, int]]:
    feats = [cs * cs, cs * cs, cs, cs, cs, cs // 2, cs // 2, cs // 2, cs // 4, cs // 4, cs // 4, 2, 2, 2]
    cins = [cs * cs] + feats[:-1]
    return list(zip(cins, feats, MIXER_K))


def dfpn_parts(b: int, f: int, base: int) -> Dict[str, int]:
    """DFPN's forward products over ``b`` targets with ``f`` references each
    (the correlation, sep4d, the mixer, both estimators)."""
    cs = base // 16
    n, tiles = b * f, b * f * cs * cs
    return {"correlation": 2 * n * (cs * cs) ** 2 * 512,
            "sep4d": sum(conv_flops(tiles, cs, cs, ci, co, k) for ci, co, k in sep4d_convs()),
            "mixer": sum(conv_flops(n, cs, cs, ci, co, k) for ci, co, k in mixer_convs(cs)),
            "flow_64": sum(flow_estimator(n, base // 4, base // 4)),
            "flow_256": sum(flow_estimator(n, base, base))}


def serve_step_flops(aligner: str, b: int, f: int, h: int, w: int, nb: int, base: int = 256) -> int:
    """Model FLOPs of one serving step: the aligner, then CHN over ``b f``
    frames."""
    total = sum(chn_parts(b * f, h, w, nb).values())
    if aligner == "cpn":
        return total + sum(cpn_parts(b, f).values())
    return total + vgg_flops(b + b * f, base, base, pools=4) + sum(dfpn_parts(b, f, base).values())


def chn_train_step_flops(b: int, frames: int, h: int, w: int, nb: int) -> int:
    """The CHN train step: CPN forward over the references; CHN forward and
    both gradients (the first head conv needs no input gradient); VGG-16
    forward over the predicted and the clean frames (no gradient)."""
    f = frames - 1
    n = b * f
    parts = chn_parts(n, h, w, nb)
    first = chn_head(n, h, w)[0]
    return (sum(cpn_parts(b, f).values()) + 3 * sum(parts.values()) - first
            + vgg_flops(2 * n, h, w))


# ---------------------------------------------------------------- rooflines
#
# A layer's least time is the larger of its FLOPs at the peak and its
# bytes at the memory's peak, where the bytes are what crosses the layer's
# boundary: its input read once, its output written once, its weights
# once. What a design keeps between its own launches is the design's.


def least_seconds(cost: Tuple[int, int], peak_flops: float, peak_bytes: float) -> float:
    return max(cost[0] / peak_flops, cost[1] / peak_bytes)


def _weights(convs: Sequence[Tuple[int, int, int]], itemsize: int) -> int:
    return sum(itemsize * k * k * ci * co + 4 * co for ci, co, k in convs)


def trunk_cost(n: int, h: int, w: int, nb: int, itemsize: int = 2) -> Tuple[int, int]:
    """The trunk over ``n`` frames of the trunk grid ``h x w``."""
    convs = [(ci, co, 3) for ci, co in rdb_widths()] * (3 * nb)
    return chn_trunk(n, h, w, nb), itemsize * n * h * w * 64 * 2 + _weights(convs, itemsize)


def tail_cost(n: int, h: int, w: int, itemsize: int = 2) -> Tuple[int, int]:
    """The tail from ``n`` frames of the trunk grid ``h x w``, the
    upsample-convs in their 4-phase form."""
    convs = [(64, 64, 4), (64, 64, 4), (64, 64, 3), (64, 3, 3)]
    flops = sum(tail_stages(n, h, w, four_phase=True))
    return flops, itemsize * n * h * w * (64 + 16 * 3) + _weights(convs, itemsize)


def dfpn_stack_convs(b: int, f: int, base: int) -> List[Tuple[int, int, int, int, int, int]]:
    """``(images, h, w, cin, cout, k)`` of each conv that DFPN's bf16 serving
    route runs on the conv-stack kernels (K7 / K8) for ``b`` targets with
    ``f`` references each: sep4d's six over the ``b f cs²`` tiles of ``cs x
    cs``, the mixer's 14 over ``b f`` tiles, both flow estimators' 15
    stride-1 convs over ``b f`` frames (their stride-2 downs and transposed
    ups run elsewhere), and VGG's pool-4 tower over the ``b`` targets and
    the ``b f`` references."""
    cs, n = base // 16, b * f
    out = [(n * cs * cs, cs, cs, ci, co, k) for ci, co, k in sep4d_convs()]
    out += [(n, cs, cs, ci, co, k) for ci, co, k in mixer_convs(cs)]
    for side in (base // 4, base):
        out += [(n, h, w, ci, co, k) for h, w, ci, co, k, stride_1 in flow_layers(side, side) if stride_1]
    for images in (b, n):
        out += [(images, h, w, ci, co, 3) for h, w, ci, co in vgg_layers(base, base, pools=4)]
    return out


def convs_cost(convs: Sequence[Tuple[int, int, int, int, int, int]], itemsize: int = 2) -> Tuple[int, int]:
    """Convs ``(images, h, w, cin, cout, k)`` (stride 1, same padding), each
    bounded as a launch of its own: its input read and its output written
    once, its weights once."""
    flops = sum(conv_flops(n, h, w, ci, co, k) for n, h, w, ci, co, k in convs)
    acts = sum(itemsize * n * h * w * (ci + co) for n, h, w, ci, co, _ in convs)
    return flops, acts + _weights([(ci, co, k) for *_, ci, co, k in convs], itemsize)


def backward_cost(n: int, h: int, w: int, nb: int, itemsize: int = 2) -> Tuple[int, int]:
    """The trunk's and the tail's backward from ``n`` frames of the trunk
    grid ``h x w``: each conv's input gradient and weight gradient at the
    forward's products (the upsample-convs in their 4-phase form); bytes:
    the tail's output cotangent and the trunk's input read, the trunk's
    input cotangent written, the weights read and their f32 gradients
    written."""
    trunk_flops, trunk_bytes = trunk_cost(n, h, w, nb, itemsize)
    tail_flops, tail_bytes = tail_cost(n, h, w, itemsize)
    weights = trunk_bytes + tail_bytes - itemsize * n * h * w * (64 * 3 + 16 * 3)
    return (2 * (trunk_flops + tail_flops),
            itemsize * n * h * w * (16 * 3 + 64 + 64) + weights + weights * 4 // itemsize)
