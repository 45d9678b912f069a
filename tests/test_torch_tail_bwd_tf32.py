"""K6's f32 route (the RRDBNet tail's backward) on the 3xTF32 kernel
(``csrc/conv_bwd_tf32_wgmma.cuh``: K4's recompute, conv_last's two thin
kernels, hr_conv's masked adjoint in conv mode, the upsample-convs'
adjoints over their cotangent's phase planes (s2d), the weight grads of
hr_conv and, per phase, of the upsample-convs in the weight-grad mode, a
reduce that folds the phases back), on the CPU: each launch emulated
(``tests/test_torch_tf32x3.py``) against f64, the emulated tail backward
(``tail_bwd.tail_bwd_tf32_plan`` over emulated launches) against the plain
backward in f64 and the JAX package's ``tail_bwd_pallas`` in f32 interpret
mode; the fold-back against ``fused_upsample_conv_kernel_adjoint``; the
planted faults; the packing; and what the route launches on the card.

Tolerances: 5e-5 against JAX (``jax.default_matmul_precision("highest")``);
chip_smoke.py's f32 limit, a relative L2 of 1e-5, against f64."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from master_thesis_tpu.ops.pallas_tail import fused_upsample_conv_kernel_adjoint, make_hybrid_tail
from master_thesis_tpu_torch.ops import conv_stack, fragments, rrdb_bwd, tail, tail_bwd
from tests.test_torch_f32_kernels import _OnCard
from tests.test_torch_tail import _pack, _tail_params
from tests.test_torch_tail_bwd import _JAX_NAMES
from tests.test_torch_tail_tf32 import _emulate_stage
from tests.test_torch_tf32x3 import _emulate_launch, _emulate_wgrad, _one_thread, _rel_l2  # noqa: F401 (fixture)

ATOL_JAX = 5e-5
L2_F32 = 1e-5
NF = tail.KERNEL_NF
# One frame of 6 x 8 (the tail's output 24 x 32): hr_conv's weight grads in
# one 32-pixel tile a row, the phase jobs' in one ragged tile a row.
N, H, W = 1, 6, 8
KS = tail_bwd.k6_config(N, H, W)[-3:]


def _nhwc_planes(t):
    return tail_bwd._phase_planes(t).permute(0, 2, 3, 1)


class _Emulated(tail_bwd.K6Launches):
    """K6's launches emulated (conv_last's two thin SIMT kernels stay plain,
    with the planted mask slope)."""

    def __init__(self, plant=0):
        self.plant = plant

    def stage(self, k, x, p, out):
        return _emulate_stage(k, x, p, out, plant=self.plant if self.plant == 1 else 0)

    def last_adj(self, g, w, h3):
        d = F.conv2d(g.permute(0, 3, 1, 2), w.transpose(0, 1).flip(2, 3), padding=1).permute(0, 2, 3, 1)
        v = torch.where(h3 >= 0, d, (0.25 if self.plant == 8 else 0.2) * d)
        h3.copy_(v)
        return v.sum(dim=(0, 1, 2)).view(1, -1)

    def adj(self, mat, w, x, out, m=None, s2d=False):
        sums = []
        _emulate_launch(_nhwc_planes(x) if s2d else x, mat, torch.zeros(NF), mode="conv", k=3, cout=NF,
                        epi="mask" if m is not None else "none", out=out, m=m, sums=sums, plant=self.plant)
        return torch.stack(sums) if m is not None else None

    def wgrad(self, jobs):
        return [_emulate_wgrad(j, self.plant) for j in jobs]


def _emulated(case, plant=0):
    flat = torch.empty(tail_bwd.GRAD_NUMEL)
    return tail_bwd.tail_bwd_tf32_plan(case.xv, case.gv, case.p, case.adj, flat, _Emulated(plant), KS)


@pytest.fixture(scope="module")
def case():
    """The tail at nf 64, 1 x 64 x 6x8 (numpy for JAX, NCHW for the port):
    its packing, the recompute (the masks), the emulated backward and f64."""
    rng = np.random.RandomState(20)
    # _tail_params' 0.2 scale at fan-in 576 grows each layer ~5x: a fifth of
    # it keeps the grads near 1, where ATOL_JAX is a relative bound.
    params = {k: v * np.float32(0.2) if k.endswith("kernel") else v for k, v in _tail_params(rng, NF).items()}
    p = _pack(params)
    y = rng.randn(N, H, W, NF).astype(np.float32)
    cot = rng.randn(N, 4 * H, 4 * W, 3).astype(np.float32)
    x, g = torch.from_numpy(y).permute(0, 3, 1, 2), torch.from_numpy(cot).permute(0, 3, 1, 2)
    c = SimpleNamespace(params=params, p=p, y=y, cot=cot, x=x, g=g, xv=torch.from_numpy(y),
                        gv=torch.from_numpy(cot), adj=tail_bwd.pack_tail_bwd_tf32(p))
    c.emu = _emulated(c)
    hid = [t.permute(0, 3, 1, 2).double() for t in tail.tail_f32_stages(c.xv, p, keep=3)]
    p64 = tail.pack_tail(*[(p[f"{k}_oihw"].double(), p[f"{k}_b"].double()) for k in ("up1", "up2", "hr", "last")],
                         torch.float64)
    dx, grads = tail_bwd.tail_bwd_plain(x.double(), g.double(), p64, hidden=hid)
    c.f64 = dx.permute(0, 2, 3, 1), grads
    c.hid = [t.permute(0, 2, 3, 1).float() for t in hid]
    return c


def test_adjoint_tf32_packing_and_the_phase_planes(case):
    """``pack_tail_bwd_tf32`` holds each adjoint's kernel (transposed and
    flipped) as ``wgmma_tf32_matrix``; an upsample-conv's adjoint as a 3x3
    conv of its cotangent's phase planes (channels (a, b, o)) with the
    4-phase kernel's adjoint equals its adjoint at the high resolution with
    the 2x2 sums (the plain version's form), in f64 (up to the 4-phase
    kernel's f32 sums of taps)."""
    p = case.p
    for name in ("hr", "up2", "up1"):
        assert torch.equal(case.adj[f"{name}_adj_tf32"], fragments.wgmma_tf32_matrix(tail_bwd._adjoint_oihw(p, name)))
        assert case.adj[f"{name}_adj_tf32"].numel() == tail_bwd._ADJ_TF32_NUMEL[f"{name}_adj_tf32"]
    dp = torch.randn(2, 12, 16, NF, dtype=torch.float64)
    got = F.conv2d(tail_bwd._phase_planes(dp), tail_bwd._adjoint_oihw(p, "up2").double(), padding=1)
    high = F.conv2d(dp.permute(0, 3, 1, 2), p["up2_oihw"].double().transpose(0, 1).flip(2, 3), padding=1)
    assert _rel_l2(got, tail_bwd._pool2x(high)) <= 1e-6  # the 4-phase kernel's f32 sums of taps
    planes = tail_bwd._phase_planes(dp)
    assert torch.equal(planes[:, 64 * 3 + 5, 2, 4], dp[:, 2 * 2 + 1, 2 * 4 + 1, 5])  # phase (1, 1), channel 5


def test_fold_back_matches_fused_upsample_conv_kernel_adjoint(rng):
    """:func:`tail_bwd.fold_phase_grads` (the reduce's fold over each
    phase's four taps) equals ``fused_upsample_conv_kernel_adjoint`` of the
    whole 4-phase grad."""
    c, o = 5, 7
    dw4 = rng.randn(3, 3, c, 4 * o).astype(np.float32)
    want = np.asarray(fused_upsample_conv_kernel_adjoint(jnp.asarray(dw4))).transpose(3, 2, 0, 1)
    d = torch.from_numpy(dw4).view(3, 3, c, 2, 2, o)
    v = torch.stack([torch.stack([torch.stack([torch.stack([d[a + ti, b + tj, :, a, b].T for tj in range(2)])
                                               for ti in range(2)]) for b in range(2)]) for a in range(2)])
    np.testing.assert_allclose(tail_bwd.fold_phase_grads(v).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["hr", "up2", "up1"])
def test_adjoint_emulation_matches_f64(case, name):
    """Each adjoint launch emulated (conv mode; hr_conv's masked by h2,
    upconv2's over the phase planes masked by h1, upconv1's over the phase
    planes) against f64 within L2_F32, and its bias rows' sum."""
    h1, h2, _ = case.hid
    x = {"hr": torch.randn(N, 4 * H, 4 * W, NF), "up2": torch.randn(N, 4 * H, 4 * W, NF),
         "up1": torch.randn(N, 2 * H, 2 * W, NF)}[name]
    m = {"hr": h2, "up2": h1, "up1": None}[name]
    w = tail_bwd._adjoint_oihw(case.p, name)
    xin = x.permute(0, 3, 1, 2).double() if name == "hr" else tail_bwd._phase_planes(x.double())
    want = F.conv2d(xin, w.double(), padding=1).permute(0, 2, 3, 1)
    if m is not None:
        want = torch.where(m >= 0, want, 0.2 * want)
    out = torch.empty(want.shape)
    rows = _Emulated().adj(case.adj[f"{name}_adj_tf32"], w, x, out, m=m, s2d=name != "hr")
    assert _rel_l2(out, want) <= L2_F32
    if m is not None:
        assert _rel_l2(rows.sum(0), want.sum(dim=(0, 1, 2))) <= L2_F32


@pytest.mark.parametrize("phase", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_wgrad_phase_emulation_matches_f64(case, phase):
    """A phase job of the weight-grad mode emulated (taps (a + ti, b + tj)
    of the 3x3 window over the cotangent's phase plane (a, b)) against the
    4-phase kernel's grad in f64 at those taps within L2_F32."""
    a, b = phase
    cot = torch.randn(N, 4 * H, 4 * W, NF, generator=torch.Generator().manual_seed(2 * a + b))
    src = case.hid[0]
    job = rrdb_bwd.WgJob(cot, src, 0, 32, KS[1], phase)
    got = rrdb_bwd.slot_sums(_emulate_wgrad(job))
    full = torch.nn.grad.conv2d_weight(src[..., 32:].double().permute(0, 3, 1, 2), (64, 32, 3, 3),
                                       cot[:, a::2, b::2].double().permute(0, 3, 1, 2), padding=1)
    for ti in range(2):
        for tj in range(2):
            assert _rel_l2(got[3 * ti + tj], full[:, :, a + ti, b + tj]) <= L2_F32
    assert torch.equal(rrdb_bwd.wgrad_job_plain(job)[2], torch.zeros(64, 32))


def test_k6_emulation_matches_f64_and_plain(case):
    """The emulated K6 (10 launches) against the plain backward in f64 within
    L2_F32 (dx and every grad), and the CPU route (:func:`tail_bwd_f32`, the
    plan with the plain launches) likewise."""
    dx, grads = case.emu
    want_dx, want = case.f64
    assert _rel_l2(dx, want_dx) <= L2_F32
    for k in tail_bwd.PARAM_NAMES:
        assert _rel_l2(grads[k], want[k]) <= L2_F32, k
    pdx, pgrads = tail_bwd.tail_bwd_f32(case.x, case.g, case.p, case.adj)
    assert _rel_l2(pdx.permute(0, 2, 3, 1), want_dx) <= L2_F32
    assert all(_rel_l2(pgrads[k], want[k]) <= L2_F32 for k in tail_bwd.PARAM_NAMES)


def test_k6_emulation_matches_tail_bwd_pallas(case):
    """The emulated K6 against ``jax.grad`` through ``make_hybrid_tail``
    (its backward ``tail_bwd_pallas`` in interpret mode), f32 under
    highest precision: dx and every weight and bias grad within ATOL_JAX."""
    fn = make_hybrid_tail(jnp.float32, interpret=True)
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(lambda a, q: jnp.vdot(fn(a, q), jnp.asarray(case.cot)), argnums=(0, 1))(
            jnp.asarray(case.y), {k: jnp.asarray(v) for k, v in case.params.items()})
    dx, grads = case.emu
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_x), atol=ATOL_JAX)
    for name in tail_bwd.PARAM_NAMES:
        key, kind = name.rsplit("_", 1)
        ref = np.asarray(want_p[f"{_JAX_NAMES[key]}_{'kernel' if kind == 'w' else 'bias'}"])
        ref = ref.transpose(3, 2, 0, 1) if kind == "w" else ref
        np.testing.assert_allclose(grads[name].numpy(), ref, atol=ATOL_JAX, err_msg=name)


@pytest.mark.parametrize("plant,keys", [(6, ("hr_w", "up2_w", "up1_w")), (7, ("hr_w", "up2_w", "up1_w")),
                                        (8, ("hr_b", "up2_b", "up1_b")), (9, ("up2_w", "up1_w"))])
def test_k6_planted_faults_move_the_emulation(case, plant, keys):
    """Each fault the card's check must catch moves the emulated K6 past
    L2_F32 against f64 in the grads it reaches: 6 (tap (0, 0) left out of
    the weight grads), 7 (the last K-split left out of the reduce), 8 (the
    masks' slope at 0.25), 9 (phase (0, 1)'s weight grads read phase
    (1, 0)'s cotangent plane)."""
    _, grads = _emulated(case, plant)
    _, want = case.f64
    for k in keys:
        assert _rel_l2(grads[k], want[k]) > L2_F32, k


def test_k6_config_and_launches():
    """One K6 call: 10 launches against 15 on the first design; its tiles
    are the forward's (``conv_stack.tf32_tile``), its K-splits give the
    three kinds of job about the same work an item."""
    assert tail_bwd.TAIL_BWD_F32_KERNELS == 10 and tail_bwd.TAIL_BWD_F32_FIRST_KERNELS == 15
    cfg = tail_bwd.k6_config(8, 64, 64, 132)
    tiles = [cfg[4 * i: 4 * i + 4] for i in range(5)]
    assert tiles[0] == conv_stack.tf32_tile("phase", 8, 64, 64, 3, 4 * NF, 0, 64, 0)
    assert tiles[2] == conv_stack.tf32_tile("conv", 8, 256, 256, 3, NF, 0, 256, 0) and tiles[2][3] == 2
    ks = cfg[20:]
    works = [16384 * 9 / ks[0], 4096 * 4 / ks[1], 1024 * 4 / ks[2]]
    assert max(works) / min(works) < 1.3 and 2 * 132 <= 2 * ks[0] + 8 * ks[1] + 8 * ks[2] <= 4 * 132


def test_k6_route_on_the_card_is_one_tf32_call(case, monkeypatch):
    """For an f32 tensor on the card at nf 64 the route (and the
    dispatcher, with ``pack_tail_bwd_tf32``) is one ``tail_bwd_tf32_cuda``
    call (10 launches counted) and reaches no SIMT kernel; at another width
    the first design runs."""
    calls = []

    def call(x, g, p, adj):
        calls.append((tuple(x.shape), tuple(g.shape), sorted(adj)))
        return torch.zeros_like(x), torch.zeros(tail_bwd.GRAD_NUMEL)

    def refuse(*a, **k):
        raise AssertionError("the SIMT kernel was reached")

    monkeypatch.setattr(tail_bwd, "tail_bwd_tf32_cuda", call)
    monkeypatch.setattr(tail_bwd, "conv_f32_fwd", refuse)
    monkeypatch.setattr(tail_bwd, "conv_f32_wgrad", refuse)
    before = tail_bwd.tail_bwd_f32.launches
    tail_bwd.tail_bwd(case.x.as_subclass(_OnCard), case.g, case.p)
    assert calls == [((N, H, W, NF), (N, 4 * H, 4 * W, 3), ["hr_adj_tf32", "up1_adj_tf32", "up2_adj_tf32"])]
    assert tail_bwd.tail_bwd_f32.launches == before + tail_bwd.TAIL_BWD_F32_KERNELS
    thin = _pack(_tail_params(np.random.RandomState(0), 16))
    assert tail.tail_f32_plan(thin) == "simt" and tail.tail_f32_plan(case.p) == "tf32"
    monkeypatch.setattr(tail_bwd, "tail_bwd_f32_first", lambda *a, **k: calls.append("first"))
    tail_bwd.tail_bwd_f32(torch.zeros(1, 16, 2, 2).as_subclass(_OnCard), None, thin, None)
    assert calls[-1] == "first"
