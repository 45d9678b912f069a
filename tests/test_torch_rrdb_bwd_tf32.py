"""K3's f32 route (an RRDB's backward) on the 3xTF32 kernel
(``csrc/conv_bwd_tf32_wgmma.cuh``: the pulls in gc and conv mode with the
mask and dx epilogues, the 15 weight grads in the weight-grad mode, a
fixed-order reduce), on the CPU: each launch emulated
(``tests/test_torch_tf32x3.py:_emulate_launch``, ``_emulate_wgrad``) against
f64, the emulated RRDB (``rrdb_bwd.rrdb_bwd_tf32_plan`` over emulated
launches) against the plain backward in f64 and the JAX package's
``rrdb_bwd_pallas`` in f32 interpret mode; the planted faults; the packing;
and what the route launches for a tensor on the card.

Tolerances: 5e-5 against JAX (``jax.default_matmul_precision("highest")``);
chip_smoke.py's f32 limit, a relative L2 of 1e-5, against f64."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from master_thesis_tpu.ops.pallas_rrdb import make_hybrid_trunk
from master_thesis_tpu_torch.ops import conv_stack, fragments, rrdb, rrdb_bwd
from tests.test_torch_f32_kernels import _OnCard
from tests.test_torch_rrdb import _pack, _rrdb_params, _to_jax
from tests.test_torch_tf32x3 import _emulate_launch, _emulate_wgrad, _one_thread, _rel_l2  # noqa: F401 (fixture)

ATOL_JAX = 5e-5
L2_F32 = 1e-5
NF, GC = rrdb.KERNEL_NF, rrdb.KERNEL_GC
# One frame of 16x16: gc mode's tile is 8 rows x 16 (two row tiles), conv
# mode's one 16x16 frame on two halves; 16 weight-grad tiles a job.
N, H, W = 1, 16, 16
KS = rrdb_bwd.k3_config(N, H, W)[-1]


class _Emulated(rrdb_bwd.K3Launches):
    """K3's launches emulated (the prep's elementwise step stays plain)."""

    def __init__(self, plant=0):
        self.plant = plant

    def pull(self, mat, w, x, out, *, m=None, r=None, rs=1.0, r2=None, out2=None):
        sums = []
        gc = out.shape[3] == GC
        _emulate_launch(x, mat, torch.zeros(out.shape[3]), mode="gc" if gc else "conv", k=3, cout=out.shape[3],
                        epi="mask" if m is not None else "dx", out=out, m=m, r=r, rs=rs, r2=r2, out2=out2,
                        sums=sums, plant=self.plant)
        return torch.stack(sums) if sums else None

    def wgrad(self, jobs):
        return [_emulate_wgrad(j, self.plant) for j in jobs]


def _f64(case):
    """The plain backward in f64 over the route's kept activations."""
    hids = [c[..., NF:].permute(0, 3, 1, 2).double() for c in case.cats]
    r64 = [rrdb.PackedRDB(p.w, p.b.double(), tuple(k.double() for k in p.kernels), None, None, None)
           for p in case.rdbs]
    dx, grads = rrdb_bwd.rrdb_bwd_plain(case.x.double(), case.g.double(), r64,
                                        ([t.double() for t in case.ins], hids))
    return dx.permute(0, 2, 3, 1), rrdb_bwd.flat_grads(grads)


def _emulated(case, plant=0):
    out = torch.empty(3 * rrdb_bwd.RDB_GRAD_NUMEL)
    dx = rrdb_bwd.rrdb_bwd_tf32_plan(case.gv, case.rdbs, case.pulls, case.cats, out, _Emulated(plant), KS)
    return dx, out


@pytest.fixture(scope="module")
def case():
    """One nf 64 / gc 32 RRDB, 1 x 64 x 16x16 (numpy for JAX, NCHW for the
    port): its kept forward, pull matrices, the emulated backward and f64."""
    rng = np.random.RandomState(20)
    params = _rrdb_params(rng, NF, GC)
    rdbs = _pack(params)
    y = rng.rand(N, H, W, NF).astype(np.float32)
    cot = rng.randn(N, H, W, NF).astype(np.float32)
    x, g = torch.from_numpy(y).permute(0, 3, 1, 2), torch.from_numpy(cot).permute(0, 3, 1, 2)
    _, (ins, cats) = rrdb_bwd.rrdb_forward_kept_f32(x, rdbs)
    convs = [[(k, b) for k, b in zip(p.kernels, p.b.split([GC] * 4 + [NF]))] for p in rdbs]
    c = SimpleNamespace(params=params, rdbs=rdbs, y=y, cot=cot, x=x, g=g, ins=ins, cats=cats, gv=g.permute(0, 2, 3, 1),
                        convs=convs, pulls=rrdb_bwd.pack_rdb_pulls_tf32(convs))
    c.emu = _emulated(c)
    c.f64 = _f64(c)
    return c


def test_pull_tf32_packing(case):
    """``pack_rdb_pulls_tf32`` holds each source's pull kernel (every conv
    it feeds, transposed and flipped: ``[c, (u, o), ky, kx] = conv_u[o,
    lo + c, 2 - ky, 2 - kx]``) as ``wgmma_tf32_matrix`` (pull 0) and
    ``wgmma_tf32_gc_matrix`` (pulls 1..4), in one row an RDB."""
    pulls = case.pulls
    assert pulls.shape == (3, rrdb_bwd.PULLS_TF32) and rrdb_bwd.PULLS_TF32 == sum(rrdb_bwd.PULL_SIZES)
    k = case.rdbs[1].kernels
    parts = pulls[1].split(rrdb_bwd.PULL_SIZES)
    for s in range(5):
        lo, width = (0, NF) if s == 0 else (NF + (s - 1) * GC, GC)
        want = torch.cat([k[u][:, lo:lo + width] for u in range(s, 5)]).transpose(0, 1).flip(2, 3)
        ref = fragments.wgmma_tf32_matrix(want) if s == 0 else fragments.wgmma_tf32_gc_matrix(want)
        assert torch.equal(parts[s], ref), s
        # pull s of conv u at D channel (u, o), source channel c, tap (ky, kx)
        assert torch.equal(rrdb_bwd._pull_oihw(k, s)[3, -1, 0, 2], k[4][-1, lo + 3, 2, 0])


@pytest.mark.parametrize("s", range(5))
def test_pull_emulation_matches_f64(case, s):
    """Each pull launch emulated over a random cotangent buffer D (pulls 4..1
    in gc mode over D's suffix, masked by the kept x_s, stored into D's
    slice; pull 0 in conv mode with the dx epilogue, 0.2 of it into the next
    D) against the conv in f64 within L2_F32; the bias rows' sum against the
    f64 sum of what they sum."""
    gen = torch.Generator().manual_seed(s)
    d = torch.randn(N, H, W, 192, generator=gen)
    w = rrdb_bwd._pull_oihw([t.float() for t in case.rdbs[0].kernels], s)
    mat = case.pulls[0].split(rrdb_bwd.PULL_SIZES)[s]
    want = F.conv2d(d[..., 32 * s:].double().permute(0, 3, 1, 2), w.double(), padding=1).permute(0, 2, 3, 1)
    launches = _Emulated()
    if s > 0:
        m = case.cats[0][..., NF + GC * (s - 1): NF + GC * s]
        want = torch.where(m >= 0, want, 0.2 * want)
        out = d[..., 32 * (s - 1): 32 * s]
        rows = launches.pull(mat, w, d[..., 32 * s:], out, m=m)
        got, wsum = out, want.sum(dim=(0, 1, 2))
    else:
        r, r2 = torch.randn(N, H, W, NF, generator=gen), torch.randn(N, H, W, NF, generator=gen)
        want = 0.2 * r.double() + want + r2.double()
        got, nxt = torch.empty(N, H, W, NF), torch.zeros(N, H, W, 192)
        rows = launches.pull(mat, w, d, got, r=r, rs=0.2, r2=r2, out2=nxt[..., 128:])
        assert _rel_l2(nxt[..., 128:], 0.2 * want) <= L2_F32
        wsum = (0.2 * want).sum(dim=(0, 1, 2))
    assert _rel_l2(got, want) <= L2_F32
    assert _rel_l2(rows.sum(0)[: wsum.numel()], wsum) <= L2_F32


@pytest.mark.parametrize("unit", [0, 5, 6, 11, 13])
def test_wgrad_emulation_matches_f64(case, unit):
    """A weight-grad job emulated (transposed hi / lo planes, one per dx
    shift, three products a k8 step into a fresh partial sum a tile, K-split
    items) against ``conv2d_weight`` in f64 within L2_F32, over D's
    64-channel block and the source's 32 channels."""
    s, mb, ch = rrdb_bwd.K3_UNITS[unit]
    d = torch.randn(N, H, W, 192, generator=torch.Generator().manual_seed(unit))
    job = rrdb_bwd.WgJob(d, case.cats[0], 64 * mb, ch, KS)
    slots = _emulate_wgrad(job)
    assert slots.shape == (KS, 9, 64, 32)
    got = rrdb_bwd.slot_sums(slots)
    want = torch.nn.grad.conv2d_weight(case.cats[0][..., ch: ch + 32].double().permute(0, 3, 1, 2), (64, 32, 3, 3),
                                       d[..., 64 * mb: 64 * mb + 64].double().permute(0, 3, 1, 2), padding=1)
    assert _rel_l2(got, want.permute(2, 3, 0, 1).reshape(9, 64, 32)) <= L2_F32
    assert _rel_l2(got, rrdb_bwd.wgrad_job_plain(job)) <= L2_F32


def test_k3_emulation_matches_f64_and_plain(case):
    """The emulated K3 (18 launches) against the plain backward in f64 within
    L2_F32 (dx and every conv's weight and bias grad), and the CPU route
    (:func:`rrdb_bwd_f32`, the plan with the plain launches) likewise."""
    dx, flat = case.emu
    want_dx, want = case.f64
    assert _rel_l2(dx, want_dx) <= L2_F32
    for got_g, want_g in zip(rrdb_bwd.rdb_grads(flat), rrdb_bwd.rdb_grads(want)):
        for k in range(5):
            assert _rel_l2(got_g[0][k], want_g[0][k]) <= L2_F32
            assert _rel_l2(got_g[1][k], want_g[1][k]) <= L2_F32
    pdx, pflat = rrdb_bwd.rrdb_bwd_f32(case.x, case.g, case.rdbs, case.pulls, (case.ins, case.cats))
    assert _rel_l2(pdx.permute(0, 2, 3, 1), want_dx) <= L2_F32 and _rel_l2(pflat, want) <= L2_F32


def test_k3_emulation_matches_rrdb_bwd_pallas(case):
    """The emulated K3 against ``jax.grad`` through ``make_hybrid_trunk``
    (its backward ``rrdb_bwd_pallas`` in interpret mode), f32 under
    highest precision: dx and every weight and bias grad within ATOL_JAX."""
    trunk = make_hybrid_trunk(nb=1, nf=NF, gc=GC, dtype=jnp.float32, interpret=True)
    with jax.default_matmul_precision("highest"):
        want_x, want_p = jax.grad(lambda a, q: jnp.vdot(trunk(a, q), jnp.asarray(case.cot)), argnums=(0, 1))(
            jnp.asarray(case.y), {"rrdb_0": _to_jax(case.params)})
    dx, flat = case.emu
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_x), atol=ATOL_JAX)
    for j, (dws, dbs) in enumerate(rrdb_bwd.rdb_grads(flat), start=1):
        jp = want_p["rrdb_0"][f"rdb{j}"]
        for k in range(5):
            np.testing.assert_allclose(dws[k].numpy(), np.asarray(jp[f"conv{k + 1}_kernel"]).transpose(3, 2, 0, 1),
                                       atol=ATOL_JAX, err_msg=f"rdb{j} conv{k + 1}")
            np.testing.assert_allclose(dbs[k].numpy(), np.asarray(jp[f"conv{k + 1}_bias"]), atol=ATOL_JAX)


@pytest.mark.parametrize("plant,what", [(6, "weights"), (7, "weights"), (8, "all"), (1, "all")])
def test_k3_planted_faults_move_the_emulation(case, plant, what):
    """Each fault the card's check must catch moves the emulated K3 past
    L2_F32 against f64: 6 (the weight grads' tap (0, 0) left out), 7 (the
    last K-split left out of the reduce), 8 (the mask slope at 0.25), 1
    (1xTF32)."""
    dx, flat = _emulated(case, plant)
    want_dx, want = case.f64
    worst = max(_rel_l2(got_g[0][k], want_g[0][k])
                for got_g, want_g in zip(rrdb_bwd.rdb_grads(flat), rrdb_bwd.rdb_grads(want)) for k in range(5))
    assert worst > L2_F32
    if what == "all":
        assert _rel_l2(dx, want_dx) > L2_F32


def test_k3_config_and_launches():
    """One K3 call: 18 launches (prep, 3 x 5 pulls, one weight-grad launch,
    the reduce) against 45 on the first design; its tiles are the forward's
    (``conv_stack.tf32_tile``) and its K-splits put ~3 items on each SM."""
    assert rrdb_bwd.RRDB_BWD_F32_KERNELS == 1 + 3 * 5 + 1 + 1 <= 19
    assert rrdb_bwd.RRDB_BWD_F32_FIRST_KERNELS == 45
    gc_rows, gc_tw, *conv, ks = rrdb_bwd.k3_config(8, 64, 64, 132)
    assert (1, gc_rows, gc_tw, 1) == conv_stack.tf32_tile("gc", 8, 64, 64, 3, GC, 0, 64, 0)
    assert tuple(conv) == conv_stack.tf32_tile("conv", 8, 64, 64, 3, NF, 0, 64, 0) and conv[3] == 2
    assert 2 * 132 <= 42 * ks <= 4 * 132
    assert rrdb_bwd.wgrad_splits([(42, 16, 3)], 132) == [9]


def test_k3_route_on_the_card_is_one_tf32_call(case, monkeypatch):
    """For an f32 tensor on the card at nf 64 / gc 32 the route is one
    ``rrdb_bwd_tf32_cuda`` call (18 launches counted), and no SIMT kernel
    (``conv_f32_fwd`` / ``conv_f32_wgrad``) is reached; at other widths the
    first design runs."""
    calls = []

    def call(g, pulls, cats, out, scratch=None):
        calls.append((tuple(g.shape), tuple(pulls.shape), len(cats)))
        return torch.zeros_like(g)

    def refuse(*a, **k):
        raise AssertionError("the SIMT kernel was reached")

    monkeypatch.setattr(rrdb_bwd, "rrdb_bwd_tf32_cuda", call)
    monkeypatch.setattr(rrdb_bwd, "conv_f32_fwd", refuse)
    monkeypatch.setattr(rrdb_bwd, "conv_f32_wgrad", refuse)
    before = rrdb_bwd.rrdb_bwd_f32.launches
    rrdb_bwd.rrdb_bwd_f32(case.x.as_subclass(_OnCard), case.g, case.rdbs, case.pulls, (case.ins, case.cats))
    assert calls == [((N, H, W, NF), (3, rrdb_bwd.PULLS_TF32), 3)]
    assert rrdb_bwd.rrdb_bwd_f32.launches == before + rrdb_bwd.RRDB_BWD_F32_KERNELS
    thin = _pack(_rrdb_params(np.random.RandomState(0), 16, 8))
    assert not rrdb_bwd.tf32_widths(thin) and rrdb_bwd.tf32_widths(case.rdbs)
    monkeypatch.setattr(rrdb_bwd, "rrdb_bwd_f32_first", lambda *a, **k: calls.append("first"))
    rrdb_bwd.rrdb_bwd_f32(torch.zeros(1, 16, 4, 4).as_subclass(_OnCard), torch.zeros(1, 16, 4, 4), thin, None, None)
    assert calls[-1] == "first"
