"""Named spans at the port's layer boundaries, for ``torch.profiler``.

:func:`span` opens a profiler range named ``name`` while a profiler is
recording, and otherwise returns one shared null context: with no
profiler a span costs one check of the profiler's state (about 0.13 µs on
a CPU). The range is ``torch._C._profiler._RecordFunctionFast``, which the
profiler records as an op (``cpu_op``), not ``record_function``'s user
annotation: on the card the profiler also draws each user annotation as a
device-side range over the kernels it holds, which a reading of the
device's events takes for busy time. An op range puts nothing on the
device's timeline and costs less with the profiler on (1.2-2.1 µs a span
on an H100 machine's host, ``record_function`` 7.3-12.2). The spans reach
any profiler that runs, on its clock and beside the device's kernels: the
``trace.json`` of ``--profile_dir`` (:func:`..train.logging.maybe_profile`)
and the benchmark's traced window (``port_bench/benchlib/spans.py`` reads
them). There is no flag and no recorder of their own.

Every span, with its layer; names may recur within a step, no span sits
inside a per-RDB, per-band or per-launch loop:

- ``align`` (aligner): the whole aligner call, ``models/cpn.py:CPN.align``
  or ``train/build.py:dfpn_align_fn``'s ``align_fn``.
- ``align.vgg`` (aligner, DFPN): the two VGG pool-4 calls of ``align_fn``.
- ``align.corr`` (aligner, DFPN): ``models/dfpn.py:dfpn_infer_apply``'s
  correlation, sep4d, softmax and mixer, up to ``flow_16``.
- ``align.flow`` (aligner, DFPN): each flow estimator with the resize of
  its input flow (``flow_64``, ``flow_256``), two a call.
- ``align.warp`` (aligner): the warp of the references and their
  visibility (``CPN.align``'s affine grid and ``grid_sample``,
  ``models/dfpn.py:dfpn_align``'s ``align_set``), with ``v_map``.
- ``chn`` (inpainter): ``models/chn.py:chn_infer_apply``, serving and
  training.
- ``chn.input`` (inpainter): normalise, concat, permute, cast.
- ``chn.head`` (inpainter): ``conv_first`` and its channels-last copy
  (``RRDBNet.forward`` / ``forward_train``).
- ``chn.pack`` (autograd Functions and the serving weights): packing the
  weights for the kernels; ``RRDBNet.packed`` only when it packs,
  ``TrunkFunction.forward``, ``TailFunction.forward``, and
  ``TrunkFunction.backward``'s pull matrices on the card (the CPU's
  backward packs none).
- ``chn.trunk`` (inpainter): the trunk kernels, K1 / K2, or in training
  ``TrunkFunction``'s forward.
- ``chn.trunk_conv`` (inpainter): ``trunk_conv``, the residual add and the
  layout.
- ``chn.tail`` (inpainter): the tail kernels, K4 / K5, or in training
  ``TailFunction``'s forward.
- ``chn.output`` (inpainter): de-normalise, clamp, composite.
- ``train.step`` (train step): ``train/chn_task.py:make_train_step``'s
  micro-step; ``align``, ``chn``, ``train.loss``, ``train.backward`` and
  ``train.update`` nest under it.
- ``train.loss`` (forward): ``compute_loss``, the VGG loss included.
- ``train.backward`` (backward): ``total.backward()``.
- ``train.update`` (optimizer): ``state.apply_gradients()``: all-reduce,
  clip, Adam, ``zero_grad``, repack.
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL
