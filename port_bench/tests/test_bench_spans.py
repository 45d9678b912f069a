"""The span readers (``benchlib/spans.py``) and the per-layer metrics that
use them, on a hand-built profile: two steps, a ``chn`` span holding a
nested ``chn.head`` and a ``chn.trunk``, an ``align`` span after it, device
work launched inside and outside the spans, and an idle gap inside each
span and one between them."""

from types import SimpleNamespace

import pytest

from port_bench.benchlib import spans
from port_bench.benchlib.manifest import Manifest
from port_bench.benchlib.trace import Trace

MAN = Manifest()


def span_metrics(man: Manifest):
    """The per-layer metrics of ``man`` whose readers read spans: those
    that declare the spans they read (``SPANS``)."""
    return [m["name"] for m in man.data["per_layer"] if hasattr(man.reader(m["name"]), "SPANS")]


SPAN_METRICS = span_metrics(MAN)


def _ev(name, start, end, device=False, id=0):
    return SimpleNamespace(name=name, id=id, device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
                           time_range=SimpleNamespace(start=start, end=end))


def _ctx(host, device, steps=2):
    tr = Trace.__new__(Trace)
    tr.steps, tr.window_s = steps, 1.0
    tr.events = host + device
    tr.device = sorted(device, key=lambda e: e.time_range.start)
    return SimpleNamespace(trace=tr, steps=steps)


def _profile(names=("chn", "chn.head", "chn.trunk", "align")):
    """Times in µs. Spans: ``chn`` [0, 100] holding ``chn.head`` [10, 40]
    and ``chn.trunk`` [40, 80], ``align`` [120, 160]. Device work (id: host
    launch -> device interval): 1: 2 -> [5, 25] (in ``chn``), 2: 15 -> [25,
    50] (in ``chn.head``, under an op whose own id is 3), 3: 45 -> [60, 90]
    (``chn.trunk``), 4: 121 -> [125, 135] (``align``), 5: 165 -> [170, 180]
    (outside every span). ``names`` renames the spans."""
    n = dict(zip(("chn", "chn.head", "chn.trunk", "align"), names))
    launch = {k: _ev("cudaLaunchKernel", t, t + 1, id=k) for k, t in ((1, 2), (2, 15), (3, 45), (4, 121), (5, 165))}
    conv = _ev("aten::conv", 12, 30, id=3)
    head = _ev(n["chn.head"], 10, 40, id=11)
    trunk = _ev(n["chn.trunk"], 40, 80, id=12)
    chn = _ev(n["chn"], 0, 100, id=10)
    align = _ev(n["align"], 120, 160, id=13)
    device = [_ev("k", s, t, device=True, id=k) for k, (s, t) in
              ((3, (60, 90)), (1, (5, 25)), (2, (25, 50)), (4, (125, 135)), (5, (170, 180)))]
    return _ctx([chn, head, conv, trunk, align, *launch.values()], device)


def test_device_ms_counts_what_was_launched_inside_each_kernel_once():
    ctx = _profile()
    assert spans.device_ms(ctx, ["chn"]) == pytest.approx(75 / 2e3)
    assert spans.device_ms(ctx, ["chn", "chn.head"]) == pytest.approx(75 / 2e3)
    assert spans.device_ms(ctx, ["chn.head"]) == pytest.approx(25 / 2e3)  # not the op id's kernel 3
    assert spans.device_ms(ctx, ["chn.trunk"]) == pytest.approx(30 / 2e3)
    assert spans.device_ms(ctx, ["chn", "align"]) == pytest.approx(85 / 2e3)  # not kernel 5


def test_host_ms_is_the_union_of_the_spans():
    ctx = _profile()
    assert spans.host_ms(ctx, ["chn", "chn.head"]) == pytest.approx(100 / 2e3)
    assert spans.host_ms(ctx, ["chn", "align"]) == pytest.approx(140 / 2e3)
    assert spans.host_ms(ctx, ["chn.head", "chn.trunk"]) == pytest.approx(70 / 2e3)


def test_idle_ms_puts_each_gap_down_to_the_span_it_falls_in():
    ctx = _profile()
    assert spans.idle_ms(ctx, ["chn"]) == pytest.approx(25 / 2e3)  # [0, 5], [50, 60], [90, 100]
    assert spans.idle_ms(ctx, ["align"]) == pytest.approx(30 / 2e3)  # [120, 125], [135, 160]
    assert spans.idle_ms(ctx, ["chn", "align"]) == pytest.approx(55 / 2e3)  # not [100, 120], [160, 170]
    assert spans.idle_ms(ctx, ["chn.head", "chn"]) == pytest.approx(25 / 2e3)  # nested: once
    assert spans.idle_ms(ctx, ["chn.head"]) == pytest.approx(0.0)


@pytest.mark.parametrize("reader", [spans.device_ms, spans.host_ms, spans.idle_ms])
def test_a_missing_span_reads_none(reader):
    ctx = _profile(names=("chn_", "chn.head_", "chn.trunk_", "align_"))
    assert reader(ctx, ["chn", "align"]) is None
    assert reader(_profile(), ["chn.tail"]) is None


def check_span_metric(man: Manifest, name: str) -> None:
    """On a profile that holds none of the reader's ``SPANS`` it reads None
    and does not raise (a parent program without them); on one that holds
    each of them, with a launch and an idle gap inside each, a number."""
    reader = man.reader(name)
    assert reader.SPANS and all(isinstance(s, str) for s in reader.SPANS)
    absent = tuple(f"{s}.absent" for s in ("chn", "chn.head", "chn.trunk", "align"))
    assert reader.read(_profile(names=absent)) is None
    host, device = [], []
    for i, s in enumerate(reader.SPANS):
        host += [_ev(s, 10 * i, 10 * i + 5, id=100 + i), _ev("cudaLaunchKernel", 10 * i + 1, 10 * i + 2, id=1 + i)]
        device.append(_ev("k", 10 * i + 2, 10 * i + 4, device=True, id=1 + i))
    assert isinstance(reader.read(_ctx(host, device)), float)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_metric_reads_none_on_a_program_without_spans(name):
    check_span_metric(MAN, name)


def check_every_span_metric_is_found(man: Manifest) -> None:
    """Every per-layer reader that uses the span readers declares the spans
    it reads, so that none escapes :func:`check_span_metric`."""
    uses = [m["name"] for m in man.data["per_layer"]
            if "benchlib import spans" in (man.bench / "metrics" / f"{m['name']}.py").read_text()]
    assert uses == span_metrics(man)


def test_every_span_metric_is_found():
    check_every_span_metric_is_found(MAN)
