"""Model construction and the closures the algorithms call
(master_thesis_tpu/train/build.py: build_dfpn, dfpn_align_fn, chn_infer_fn).

:func:`dfpn_align_fn` is the DFPN aligner with ``CPN.align``'s interface:
VGG-16 pool-4 features of the normalised, ``base_size``-resized frames,
then :func:`..models.dfpn.dfpn_infer_apply`, then
:func:`..models.dfpn.dfpn_align`. With ``chn_infer_apply`` after it, that
is the serving step of ``--chn --chn_aligner dfpn``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from master_thesis_tpu_torch.models.chn import CHN, chn_infer_apply
from master_thesis_tpu_torch.models.dfpn import (
    DFPN,
    dfpn_align,
    dfpn_infer_apply,
    prepare_vgg_input,
)
from master_thesis_tpu_torch.models.vgg import VGGFeatures, vgg_pool4_pallas


def build_dfpn(
    *, base_size: int = 256, dtype: torch.dtype = torch.float32, device=None,
    generator: Optional[torch.Generator] = None,
) -> DFPN:
    """A DFPN with random weights from ``generator`` (seed 3 by default, the
    key of the JAX ``build_dfpn``); ``device=None`` means ``cuda``."""
    gen = generator if generator is not None else torch.Generator().manual_seed(3)
    return DFPN(base_size=base_size, dtype=dtype, device=device, generator=gen)


def dfpn_align_fn(
    dfpn: DFPN, vgg: VGGFeatures, *, pallas_sep4d: bool = False, pallas_mixer: bool = True,
    pallas_flow: bool = False, pallas_vgg: bool = False,
) -> Callable:
    """``align_fn(x_t, m_t, x_r, m_r) -> (x_aligned, v_aligned, v_map)``.
    The ``pallas_*`` flags route DFPN's stages (:func:`dfpn_infer_apply`);
    ``pallas_vgg`` runs the pool-4 tower on K8 (:func:`vgg_pool4_pallas`)
    instead of the module, which the JAX package keeps for serving."""
    apply_fn = partial(dfpn_infer_apply, dfpn, pallas_sep4d=pallas_sep4d,
                       pallas_mixer=pallas_mixer, pallas_flow=pallas_flow)
    pool4 = partial(vgg_pool4_pallas, vgg) if pallas_vgg else vgg.pool4

    def align_fn(x_t, m_t, x_r, m_r):
        b, f, h, w, _ = x_r.shape
        base = dfpn.base_size
        with torch.no_grad():
            feats_t = pool4(prepare_vgg_input(x_t, size=base))
            feats_r = pool4(prepare_vgg_input(x_r.reshape(b * f, h, w, 3), size=base))
        feats_r = feats_r.reshape(b, f, *feats_r.shape[1:])
        return dfpn_align(apply_fn, x_t, m_t, x_r, m_r, feats_t, feats_r)

    return align_fn


def chn_infer_fn(chn: CHN) -> Callable:
    """``chn_apply(x_t, v_t, x_refs, v_refs, v_maps) -> (y_hat,
    y_hat_comp)`` through :func:`chn_infer_apply` (the serving routes), the
    closure :class:`..infer.Inpainter` calls."""
    return partial(chn_infer_apply, chn)
