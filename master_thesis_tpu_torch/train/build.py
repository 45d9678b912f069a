"""Model construction, the closures the tasks and algorithms call, and the
loaders (master_thesis_tpu/train/build.py: build_vgg, build_cpn,
build_dfpn, dfpn_align_fn, build_chn, build_lpips, chn_infer_fn,
chn_train_fn, build_loaders), and :func:`build_cpn_context`, the CPN's
context modules, which the JAX package converts but builds nowhere.

:func:`dfpn_align_fn` is the DFPN aligner with ``CPN.align``'s interface:
VGG-16 pool-4 features of the normalised, ``base_size``-resized frames,
then :func:`..models.dfpn.dfpn_infer_apply`, then
:func:`..models.dfpn.dfpn_align`. With ``chn_infer_apply`` after it, that
is the serving step of ``--chn --chn_aligner dfpn``.

Routes: the JAX package takes its Pallas kernels with ``use_pallas`` on a
TPU and its modules elsewhere; the port takes its kernels with
``use_pallas`` on a CUDA device (:func:`use_kernels`) and its modules
elsewhere: the CHN through :meth:`..models.chn.RRDBNet.forward_modules`,
the DFPN aligner with every stage on its module. VGG stays on its module,
as in the JAX CLI.
"""

from __future__ import annotations

import os
import warnings
from functools import partial
from typing import Callable, Optional

import torch

from master_thesis_tpu_torch.models import convert
from master_thesis_tpu_torch.models.chn import CHN, chn_infer_apply
from master_thesis_tpu_torch.models.cpn import CPN, CPNContext
from master_thesis_tpu_torch.models.dfpn import (
    DFPN,
    dfpn_align,
    dfpn_infer_apply,
    prepare_vgg_input,
)
from master_thesis_tpu_torch.models.vgg import VGGFeatures, vgg_pool4_hybrid, vgg_pool4_pallas
from master_thesis_tpu_torch.train.checkpoint import load_weights


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def use_kernels(cfg) -> bool:
    """Whether the run takes the hand-written kernels: ``use_pallas`` on a
    CUDA device."""
    return bool(cfg.use_pallas) and torch.device(cfg.device).type == "cuda"


def _load_weights(module: torch.nn.Module, checkpoint: Optional[str], what: str) -> None:
    """Loads ``checkpoint`` into ``module`` where the file exists
    (:func:`.checkpoint.load_weights`); warns and keeps the random weights
    where a path was given but no file is there."""
    if checkpoint and os.path.exists(checkpoint):
        load_weights(module, checkpoint)
    elif checkpoint:
        warnings.warn(f"{what} checkpoint {checkpoint} not found; random init")


def build_vgg(cfg, checkpoint: Optional[str] = None) -> VGGFeatures:
    """The frozen VGG-16 features (random from seed 1, the JAX key, or a
    torchvision ``vgg16`` state dict)."""
    vgg = VGGFeatures(dtype=compute_dtype(cfg), device=cfg.device,
                      generator=torch.Generator().manual_seed(1))
    _load_weights(vgg, checkpoint, "VGG")
    return vgg.requires_grad_(False).eval()


def _load_cpn_part(module: torch.nn.Module, checkpoint: Optional[str], select: Callable, what: str) -> None:
    """Loads ``select`` of the reference CPN ``weight.pth`` (``module.``
    prefixes dropped) into ``module`` where the file exists; warns and keeps
    the random weights where a path was given but no file is there."""
    if checkpoint and os.path.exists(checkpoint):
        module.load_state_dict(select(convert.load_torch_checkpoint(checkpoint)))
    elif checkpoint:
        warnings.warn(f"{what} checkpoint {checkpoint} not found; random init")


def build_cpn(cfg, checkpoint: Optional[str] = None) -> CPN:
    """The frozen CPN aligner (random from seed 2, or the aligner's part of
    the reference ``weight.pth``, :func:`..models.convert.cpn_state`)."""
    cpn = CPN(dtype=compute_dtype(cfg), device=cfg.device, generator=torch.Generator().manual_seed(2))
    _load_cpn_part(cpn, checkpoint, convert.cpn_state, "CPN")
    return cpn.requires_grad_(False).eval()


def build_cpn_context(cfg, checkpoint: Optional[str] = None) -> CPNContext:
    """The frozen CPN context modules, which no path calls (random from seed
    2, or the ``Encoder`` / ``Decoder`` part of the reference ``weight.pth``,
    :func:`..models.convert.cpn_aux_state`)."""
    ctx = CPNContext(dtype=compute_dtype(cfg), device=cfg.device,
                     generator=torch.Generator().manual_seed(2))
    _load_cpn_part(ctx, checkpoint, convert.cpn_aux_state, "CPN")
    return ctx.requires_grad_(False).eval()


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
    pallas_flow: bool = False, pallas_vgg: bool = False, hybrid_flow: bool = False,
    hybrid_fuse_mids: bool = True, hybrid_c0_mode: str = "pallas", hybrid_vgg: bool = False,
) -> Callable:
    """``align_fn(x_t, m_t, x_r, m_r) -> (x_aligned, v_aligned, v_map)``.
    The ``pallas_*`` and ``hybrid_*`` flags route DFPN's stages
    (:func:`dfpn_infer_apply`); ``pallas_vgg`` runs the pool-4 tower on K8
    (:func:`vgg_pool4_pallas`) and ``hybrid_vgg`` with block 1 phase-packed
    (:func:`vgg_pool4_hybrid`; ``pallas_vgg`` takes precedence) instead of
    the module, which the JAX package keeps for serving. The hybrid flags
    are the JAX A/B's candidates (``scripts/measure/dfpn_serving_ab.py``)."""
    apply_fn = partial(dfpn_infer_apply, dfpn, pallas_sep4d=pallas_sep4d,
                       pallas_mixer=pallas_mixer, pallas_flow=pallas_flow, hybrid_flow=hybrid_flow,
                       hybrid_fuse_mids=hybrid_fuse_mids, hybrid_c0_mode=hybrid_c0_mode)
    if pallas_vgg:
        pool4 = partial(vgg_pool4_pallas, vgg)
    elif hybrid_vgg:
        pool4 = partial(vgg_pool4_hybrid, vgg)
    else:
        pool4 = vgg.pool4

    def align_fn(x_t, m_t, x_r, m_r):
        b, f, h, w, _ = x_r.shape
        base = dfpn.base_size
        with torch.no_grad():
            feats_t = pool4(prepare_vgg_input(x_t, size=base))
            feats_r = pool4(prepare_vgg_input(x_r.reshape(b * f, h, w, 3), size=base))
        feats_r = feats_r.reshape(b, f, *feats_r.shape[1:])
        return dfpn_align(apply_fn, x_t, m_t, x_r, m_r, feats_t, feats_r)

    return align_fn


def build_chn(cfg) -> CHN:
    """A CHN of ``cfg.chn_nb`` RRDBs, random from seed 4 (the JAX key)."""
    return CHN(nb=cfg.chn_nb, dtype=compute_dtype(cfg), device=cfg.device,
               generator=torch.Generator().manual_seed(4))


def build_lpips(cfg, alexnet_checkpoint: Optional[str] = None,
                lpips_checkpoint: Optional[str] = None) -> Optional[Callable]:
    """``lpips_fn(y_hat, y)`` (the batch mean); None unless the metric's
    weights exist (random heads would log meaningless numbers): the lpips
    package's heads in ``lpips_checkpoint``, and the AlexNet trunk in
    ``alexnet_checkpoint`` (torchvision keys) or under ``net.`` in the
    heads' file."""
    from master_thesis_tpu_torch.models.lpips import LPIPS, lpips_distance

    if not (lpips_checkpoint and os.path.exists(lpips_checkpoint)):
        return None
    lins = convert.load_torch_checkpoint(lpips_checkpoint)
    if alexnet_checkpoint and os.path.exists(alexnet_checkpoint):
        trunk = {f"net.{k}": v for k, v in convert.load_torch_checkpoint(alexnet_checkpoint).items()}
    elif any(k.startswith("net.") for k in lins):
        trunk = {}
    else:
        warnings.warn("LPIPS heads found but no AlexNet trunk weights; skipping LPIPS")
        return None
    sd = {**trunk, **{k: v for k, v in lins.items() if k.startswith(("net.features.", "lin"))}}
    model = LPIPS(dtype=compute_dtype(cfg), device=cfg.device)
    model.load_state_dict(sd)
    model.requires_grad_(False).eval()
    return partial(lpips_distance, model)


def chn_infer_fn(chn: CHN, kernels: bool = True) -> Callable:
    """``chn_apply(x_t, v_t, x_refs, v_refs, v_maps) -> (y_hat,
    y_hat_comp)``, the closure :class:`..infer.Inpainter` calls: through
    :func:`chn_infer_apply`'s kernel route (K1 / K4, banded K2 / K5 on large
    frames; the plain versions on a CPU tensor), or with ``kernels=False``
    the module route."""
    if kernels:
        return partial(chn_infer_apply, chn)
    return partial(chn_infer_apply, chn, net=chn.nn.forward_modules)


def chn_train_fn(cfg, chn: CHN) -> Callable:
    """The CHN apply of the train and eval steps: with :func:`use_kernels`
    and ``use_pallas_bwd``, the kernel route, whose training forward and
    backward are K1 / K3 and K4 / K6; otherwise the module route, with
    ``chn_remat`` computing each RRDB again in the backward."""
    if use_kernels(cfg) and cfg.use_pallas_bwd:
        return partial(chn_infer_apply, chn)
    return partial(chn_infer_apply, chn, net=partial(chn.nn.forward_modules, remat=cfg.chn_remat))


def build_loaders(cfg, metas, splits=("train", "validation"), shard=(0, 1)):
    """The :class:`..data.pipeline.Loader` of each split from the five metas
    (``prepare_data``), as the JAX package builds them. ``shard=(data_rank,
    data)``: the train and validation loaders make only that data rank's
    rows of each batch of ``batch_size``."""
    from master_thesis_tpu_torch.data.pipeline import ContentProvider, InpaintingDataset, Loader
    from master_thesis_tpu_torch.ops.movements import MovementSimulator

    train_bgs, train_masks, val_bgs, val_masks, test_meta = metas
    workers = dict(num_workers=max(1, cfg.num_workers), use_processes=cfg.loader_processes)
    loaders = {}
    if "train" in splits:
        bgs = ContentProvider(
            train_bgs, cfg.data_path,
            movement_min_height=cfg.train_size[0] * 2,
            movement_simulator=MovementSimulator(*cfg.bgs_movement_params),
            frames_spacing=cfg.frames_spacing,
            frames_randomize=cfg.frames_randomize,
        )
        masks = ContentProvider(
            train_masks, cfg.data_path,
            movement_simulator=MovementSimulator(*cfg.masks_movement_params),
            frames_spacing=cfg.frames_spacing,
        )
        ds = InpaintingDataset(bgs, masks, "train", cfg)
        loaders["train"] = Loader(ds, cfg.batch_size, seed=cfg.seed, shard=shard, **workers)
    if "validation" in splits:
        bgs = ContentProvider(val_bgs, cfg.data_path, frames_spacing=cfg.frames_spacing,
                              frames_randomize=cfg.frames_randomize)
        masks = ContentProvider(val_masks, cfg.data_path, frames_spacing=cfg.frames_spacing)
        ds = InpaintingDataset(bgs, masks, "validation", cfg)
        loaders["validation"] = Loader(ds, cfg.batch_size, seed=cfg.seed + 1, shard=shard, **workers)
    if "test" in splits:
        bgs = ContentProvider(test_meta, cfg.data_path)
        ds = InpaintingDataset(bgs, None, "test", cfg)
        loaders["test"] = Loader(ds, cfg.batch_size, seed=cfg.seed + 2,
                                 num_workers=max(1, cfg.num_workers), drop_last=False)
    return loaders
