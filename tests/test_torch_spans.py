"""The port's named spans (``master_thesis_tpu_torch/runtime/spans.py``) on
the CPU at tiny sizes: no ``record_function`` without a profiler; under
one, each span of the CHN forward, the two aligners and the CHN train step
once a call, under the parent its docstring gives; and outputs bit for bit
the same with and without a profiler."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from master_thesis_tpu_torch.models.chn import CHN
from master_thesis_tpu_torch.models.vgg import VGGFeatures
from master_thesis_tpu_torch.runtime import spans
from master_thesis_tpu_torch.train import build, chn_task, state
from tests.test_torch_cpn import make_cpn

NB, NF, GC = 1, 16, 8
DFPN_BASE = 64

CHN_KIDS = ("chn.input", "chn.head", "chn.trunk", "chn.trunk_conv", "chn.tail", "chn.output")
CHN_SPANS = Counter({("chn", None): 1, **{(k, "chn"): 1 for k in CHN_KIDS}})


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """1 intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _frames(b, f, h, w, seed=0):
    """Targets, target holes, references and their holes: ``(B, H, W, C)``
    and ``(B, F, H, W, C)``, holes over about a fifth of the pixels."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(b, h, w, 3, generator=g), (torch.rand(b, h, w, 1, generator=g) > 0.8).float(),
            torch.rand(b, f, h, w, 3, generator=g), (torch.rand(b, f, h, w, 1, generator=g) > 0.8).float())


def _cpn():
    return make_cpn(seed=2).requires_grad_(False).eval()


def _chn():
    return CHN(nb=NB, nf=NF, gc=GC, device="cpu", generator=torch.Generator().manual_seed(4))


def _chn_serving():
    """Two calls of the CHN forward through ``chn_infer_fn``: the first packs
    the kernels' weights, the second finds them packed."""
    chn = _chn().requires_grad_(False).eval()
    fn = build.chn_infer_fn(chn)
    x_t, m_t, x_r, m_r = _frames(1, 2, 32, 32)
    call = lambda: fn(x_t, 1 - m_t, x_r, 1 - m_r, (1 - m_r) * m_t[:, None])
    return [call, call], [CHN_SPANS + Counter({("chn.pack", "chn"): 1}), CHN_SPANS]


def _cpn_align():
    cpn = _cpn()
    frames = _frames(1, 2, 32, 40)
    return [lambda: cpn.align(*frames)], [Counter({("align", None): 1, ("align.warp", "align"): 1})]


def _dfpn_align():
    dfpn = build.build_dfpn(base_size=DFPN_BASE, device="cpu")
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(1)).requires_grad_(False)
    align = build.dfpn_align_fn(dfpn, vgg)
    frames = _frames(1, 2, DFPN_BASE, DFPN_BASE)
    want = Counter({("align", None): 1, ("align.vgg", "align"): 1, ("align.corr", "align"): 1,
                    ("align.flow", "align"): 2, ("align.warp", "align"): 1})
    return [lambda: align(*frames)], [want]


def _train_step():
    """One CHN micro-step with an update: CPN aligns, the default
    ``chn_apply`` (``TrunkFunction`` and ``TailFunction`` on their CPU
    paths), VGG's loss, Adam. The CPU's trunk backward packs no pulls, so
    ``chn.pack`` comes twice, from the two Functions' forwards."""
    chn = _chn()
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(1)).requires_grad_(False)
    st = state.create_train_state(chn, state.OptimConfig(), steps_per_epoch=10)
    step = chn_task.make_train_step(chn, _cpn().align, vgg)
    _, _, y, _ = _frames(2, 2, 32, 32, seed=1)
    m = torch.zeros(2, 2, 32, 32, 1)
    m[:, :, 10:20, 10:20] = 1
    x = (1 - m) * y + m * 0.5

    def call():
        items = step(st, x, m, y)
        return [*items.values(), *(p.detach().clone() for p in chn.parameters())]

    want = Counter({("train.step", None): 1, ("align", "train.step"): 1, ("align.warp", "align"): 1,
                    ("chn", "train.step"): 1, **{(k, "chn"): 1 for k in CHN_KIDS},
                    ("chn.pack", "chn.trunk"): 1, ("chn.pack", "chn.tail"): 1,
                    ("train.loss", "train.step"): 1, ("train.backward", "train.step"): 1,
                    ("train.update", "train.step"): 1})
    return [call], [want]


CASES = {"chn_serving": _chn_serving, "cpn_align": _cpn_align, "dfpn_align": _dfpn_align,
         "train_step": _train_step}


def _span_tree(events) -> Counter:
    """``(span, nearest enclosing span or None)`` of every span event."""
    names = {e.name for e in events if e.name.startswith(("align", "chn", "train."))}
    out = Counter()
    for e in events:
        if e.name in names:
            parent = e.cpu_parent
            while parent is not None and parent.name not in names:
                parent = parent.cpu_parent
            out[(e.name, None if parent is None else parent.name)] += 1
    return out


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    """No profiler: every span is one shared null context and no profiler
    range is built; under a profiler, a recorded span, an op (``cpu_op``)
    and not a user annotation."""
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} built with no profiler running")

    with monkeypatch.context() as mp:
        mp.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        mp.setattr(torch.profiler, "record_function", refuse)
        assert spans.span("chn") is spans.span("align.flow") is spans._NULL
        with spans.span("train.step"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("train.step"):
            torch.ones(2).sum()
    assert _span_tree(prof.events()) == Counter({("train.step", None): 1})
    assert not [e for e in prof.events() if e.name == "train.step" and e.is_user_annotation]


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_as_documented_and_leave_outputs_unchanged(case):
    """Each call's spans under a CPU profiler, counted by (name, parent),
    against the module docstring's table; the outputs of the same calls on
    a second build of the same models, with no profiler, equal bit for
    bit."""
    plain_calls, _ = CASES[case]()
    with torch.no_grad() if case != "train_step" else torch.enable_grad():
        want = [list(call()) for call in plain_calls]
    traced_calls, trees = CASES[case]()
    for i, (call, tree) in enumerate(zip(traced_calls, trees)):
        with torch.no_grad() if case != "train_step" else torch.enable_grad():
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                got = list(call())
        assert _span_tree(prof.events()) == tree, f"call {i}"
        assert len(got) == len(want[i])
        for a, b in zip(got, want[i]):
            assert torch.equal(a, b), f"call {i}: an output moved under the profiler"
