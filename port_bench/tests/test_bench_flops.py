"""The FLOP and byte counts against counts made by hand (PERF.md §3's
figures for the serving steps; the rest worked out layer by layer)."""

import pytest

from port_bench.benchlib import flops

T = 1e12


@pytest.mark.parametrize("part, frames, want", [
    ("trunk", 80, 9.42), ("tail", 80, 0.89), ("head", 80, 0.66),
    ("trunk", 20, 2.36), ("tail", 20, 0.22), ("head", 20, 0.17),
])
def test_chn_parts_at_256(part, frames, want):
    assert flops.chn_parts(frames, 256, 256, 20)[part] / T == pytest.approx(want, abs=0.006)


def test_rdb_at_one_frame_of_the_trunk_grid():
    # 2 * 64² pixels * 9 taps * (64·32 + 96·32 + 128·32 + 160·32 + 192·64)
    assert flops.chn_trunk(1, 64, 64, 1) == 3 * 2 * 4096 * 9 * 26624


def test_cpn_align_b16_f5():
    parts = flops.cpn_parts(16, 5)
    assert sum(parts.values()) / T == pytest.approx(0.74, abs=0.005)


def test_dfpn_parts_b4_f5():
    parts = flops.dfpn_parts(4, 5, 256)
    assert parts["sep4d"] / T == pytest.approx(4.64, abs=0.005)
    assert flops.vgg_flops(24, 256, 256, pools=4) / T == pytest.approx(0.88, abs=0.006)
    # flow_256 by hand, GFLOP a frame: c0 4.19, c1 19.33, c2 13.42, c3 13.42,
    # c4 4.83, c5 1.21, c6 3.36, c7 1.21, c8 0.30, c9 0.84, c10 0.30,
    # t0 0.30, c11 3.36, c12 1.21, t1 1.21, c13 13.42, c14 4.83, t2 13.42,
    # c15 53.69, c16 19.33, c17 0.30: 173.47 (PERF.md §3's 2.87 TFLOP for
    # 20 frames is not this layer list's count).
    assert parts["flow_256"] / T == pytest.approx(20 * 173.47e9 / T, rel=1e-3)


def test_serve_steps():
    assert flops.serve_step_flops("cpn", 16, 5, 256, 256, 20) / T == pytest.approx(11.73, abs=0.01)
    assert flops.serve_step_flops("dfpn", 4, 5, 256, 256, 20) / T == pytest.approx(11.98, abs=0.01)


def test_train_steps_count_each_gradient_once():
    fwd = sum(flops.chn_parts(32, 256, 256, 20).values())
    first = flops.chn_head(32, 256, 256)[0]
    want = sum(flops.cpn_parts(32, 1).values()) + 3 * fwd - first + flops.vgg_flops(64, 256, 256)
    assert flops.chn_train_step_flops(32, 2, 256, 256, 20) == want
    assert flops.chn_train_step_flops(32, 2, 256, 256, 20) / T == pytest.approx(16.15, abs=0.01)


def test_roofline_bounds():
    peak, bw = 989e12, 3.35e12
    # Compute bound: the trunk at 80 x 64² is 9.42 TFLOP at 989 TFLOP/s.
    assert flops.least_seconds(flops.trunk_cost(80, 64, 64, 20), peak, bw) == pytest.approx(9.42e12 / peak, rel=1e-3)
    # The tail at 4 phase-taps: 0.619 TFLOP (PERF.md §6's K4 bound 0.626 ms).
    assert flops.least_seconds(flops.tail_cost(80, 64, 64), peak, bw) * 1e3 == pytest.approx(0.626, abs=0.001)
    # The backward: input and weight gradients of the same products.
    fl, _ = flops.backward_cost(32, 64, 64, 20)
    assert fl == 2 * (flops.chn_trunk(32, 64, 64, 20) + sum(flops.tail_stages(32, 64, 64)))
    # The mixer at 20 tiles of 16²: 23.3 GFLOP, compute bound.
    fl, by = flops.convs_cost([(20, 16, 16, ci, co, k) for ci, co, k in flops.mixer_convs(16)])
    assert fl / 1e9 == pytest.approx(23.33, abs=0.01) and fl / peak > by / bw


def test_the_conv_stack_kernels_of_dfpn_serving_b4():
    """dfpn_serve_b4's K7 / K8 convs: 70 (sep4d 6, mixer 14, two flow
    estimators' 15 stride-1 convs, VGG's 10 twice); TFLOP: sep4d 4.64,
    mixer 0.023, flow_256 20 x 143.61 GFLOP (173.47 less the downs c2, c5,
    c8 at 13.42 + 1.21 + 0.30 and the ups t0-t2 at 0.30 + 1.21 + 13.42),
    flow_64 a sixteenth of it, VGG pool-4 0.88: 8.59, compute bound at
    8.69 ms; bytes by hand for sep4d's first conv: 5 120 x 16² pixels x (1 +
    128) channels x 2 bytes."""
    convs = flops.dfpn_stack_convs(4, 5, 256)
    assert len(convs) == 70
    assert convs[0] == (5120, 16, 16, 1, 128, 3)
    fl, by = flops.convs_cost(convs[:1])
    assert by == 5120 * 256 * 129 * 2 + 2 * 9 * 128 + 4 * 128
    flow_256 = 20 * 143.61e9
    want = 4.64e12 + 23.33e9 + flow_256 * (1 + 1 / 16) + flops.vgg_flops(24, 256, 256, pools=4)
    fl, by = flops.convs_cost(convs)
    assert fl == pytest.approx(want, rel=2e-3) and fl / T == pytest.approx(8.59, abs=0.01)
    assert flops.least_seconds((fl, by), 989e12, 3.35e12) * 1e3 == pytest.approx(8.69, abs=0.01)
    assert by / 3.35e12 < fl / 989e12
