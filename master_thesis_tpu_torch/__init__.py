"""PyTorch/CUDA port of ``master_thesis_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; this package keeps its
public layouts (NHWC images, ``(B, F, H, W, C)`` sequences) and its param
names (the reference torch state-dict keys), and replaces each Pallas
kernel on its path with a CUDA C++ kernel for ``sm_90a`` under ``csrc/``.

Importing the package builds nothing and needs neither ``nvcc`` nor a
card: the kernels build at their first launch (:mod:`._build`). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far: the serving step, CPN alignment (:mod:`.models.cpn`) and
the CHN forward (:mod:`.models.chn`) with the fused RDB kernel
(:mod:`.ops.rrdb`) and the tail kernels (:mod:`.ops.tail`); and the CHN
training step (:mod:`.train.chn_task`, :mod:`.train.state`), whose trunk
and tail backward passes are kernels too (:mod:`.ops.rrdb_bwd`,
:mod:`.ops.tail_bwd`); DFPN alignment (:mod:`.models.dfpn`) on the
conv-stack kernels (:mod:`.ops.conv_stack`); and full-video inpainting
(:mod:`.infer`), whose large frames take the banded trunk and tail; and
DFPN training (:mod:`.train.dfpn_task`) with the train loop, checkpoints
and logging (:mod:`.train.loop`); and the host data pipeline
(:mod:`.data`, :mod:`.runtime`) with the command line
(``python -m master_thesis_tpu_torch``, :mod:`.__main__`, :mod:`.config`);
and data and sequence parallelism over a ``(data, model)`` mesh of
``torch.distributed`` processes (:mod:`.parallel`).
"""

from master_thesis_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

__version__ = "0.1.0"
