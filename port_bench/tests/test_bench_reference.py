"""The plain reference against the port's CPU route at a tiny size (CHN of
2 RRDBs, 32² frames, DFPN at base 64), both in float32 on the same
weights: each network, each aligner, and the CHN train step's aligned
references, loss items, first ``y_hat``, first gradient and update."""

import pytest
import torch

from port_bench.benchlib import check
from port_bench.benchlib.cells import Cell
from port_bench.benchlib.manifest import Manifest
from port_bench.reference import nets
from port_bench.reference.precision import reference_mode
from port_bench.tests.conftest import tiny

F32 = {"compute_dtype": "float32"}
MAN = Manifest()


def _cell(config_name, traffic_name, seed=11):
    traffic, cli = tiny(traffic_name, **F32)
    config = MAN.config(config_name)
    config = {**config, "cli": {**config["cli"], **cli}}
    traffic = {**MAN.traffic(traffic_name), **traffic}
    return Cell(config, traffic, seed, "cpu", MAN.kind(traffic["kind"])), config


def _close(got, want, rel=1e-5):
    got, want = got.float(), want.float()
    assert float((got - want).norm() / want.norm().clamp(min=1e-30)) < rel


@pytest.mark.parametrize("names", [("chn_cpn", "serve_b16"), ("chn_dfpn", "serve_b4")])
def test_serving_step_against_the_reference(names):
    cell, config = _cell(*names)
    batch = cell.pool[0]
    xa, va, vm, y, yc = cell.step(0)
    w = cell.reference_weights()
    with reference_mode(), torch.no_grad():
        ra, rv, rm = check.reference_align(config, w, batch)
        ry, ryc = nets.chn(w["chn"], 2, batch[0], 1 - batch[1], xa, va, vm)
    _close(xa, ra)
    assert torch.equal(va, rv) and torch.equal(vm, rm)
    _close(y, ry)
    _close(yc, ryc)


def test_vgg_features_against_the_module():
    cell, _ = _cell("chn_dfpn", "serve_b4")
    vgg = cell.tags["vgg"]
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    w = cell.reference_weights()["vgg"]
    for got, want in zip(vgg(x), nets.vgg_features(w, x)):
        _close(got, want)


def test_train_step_against_the_reference():
    cell, config = _cell("chn_cpn", "chn_train_b32")
    first = cell.kind.first_steps(cell)
    batches = [cell.kind.batch(cell.seed, i, cell.traffic, "cpu") for i in range(3)]
    w = cell.reference_weights()
    with reference_mode():
        own = check.reference_aligned(config, w, batches)
        for got, want in zip(first["aligned"], own):
            _close(got[0], want[0])
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        want = check.reference_train(config, w, batches, first["aligned"])
    for g, r in zip(first["steps"], want["steps"]):
        assert g.keys() == r.keys()
        for k in r:
            assert g[k] == pytest.approx(r[k], rel=1e-4, abs=1e-6)
    numbers = {**check.train_numbers(first, want), **check.look_numbers(first, want)}
    assert max(numbers.values()) < 1e-3, numbers
