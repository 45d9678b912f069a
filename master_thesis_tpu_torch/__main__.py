"""The command line (master_thesis_tpu/__main__.py): the JAX package's flags
plus ``--device``, and its four run modes, DFPN train / test and CHN train
/ test with a ``cpn`` or ``dfpn`` aligner, on a GOT-10k / YouTube-VOS /
DAVIS-2017 tree.

    python -m master_thesis_tpu_torch                      # train DFPN
    python -m master_thesis_tpu_torch --test --test_checkpoint P
    python -m master_thesis_tpu_torch --chn --chn_aligner cpn \\
        --chn_aligner_checkpoint weight.pth                # train CHN
    python -m master_thesis_tpu_torch --chn --test ...     # full-video inpainting
    python -m master_thesis_tpu_torch ... --device cpu     # without a card

A checkpoint path is a checkpoint of this trainer (a ``step_*.pt`` file or
a ``version_*`` directory), or a reference torch file (``.pth`` /
``.ckpt``), whose parameters load as they are
(:mod:`.train.checkpoint`). Batches go to the device once a step, from
pinned host memory on the card.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from master_thesis_tpu_torch.config import Config


def batch_args(batch, keys: Sequence[str], device: torch.device):
    """The batch's arrays under ``keys`` as tensors on ``device``: one copy
    each, asynchronous from pinned memory on a CUDA device."""
    out = []
    for k in keys:
        t = torch.from_numpy(batch[k])
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out.append(t)
    return tuple(out)


def load_dfpn(cfg, path: Optional[str] = None):
    """A DFPN at ``dfpn_base_size`` (random from seed 3) with the weights of
    ``path``, if given."""
    from master_thesis_tpu_torch.train.build import build_dfpn, compute_dtype
    from master_thesis_tpu_torch.train.checkpoint import load_weights

    dfpn = build_dfpn(base_size=cfg.dfpn_base_size, dtype=compute_dtype(cfg), device=cfg.device)
    return load_weights(dfpn, path)


def build_aligner(cfg, vgg) -> Callable:
    """The frozen aligner CHN trains and tests with: CPN's ``align``, or
    DFPN's (:func:`.train.build.dfpn_align_fn`, the mixer on K7 with the
    kernels)."""
    from master_thesis_tpu_torch.train import build

    if cfg.chn_aligner == "cpn":
        return build.build_cpn(cfg, cfg.chn_aligner_checkpoint).align
    dfpn = load_dfpn(cfg, cfg.chn_aligner_checkpoint).requires_grad_(False).eval()
    return build.dfpn_align_fn(dfpn, vgg, pallas_mixer=build.use_kernels(cfg))


def _fit(cfg, task: str, model, train_step, eval_step, keys, loaders, logger):
    """Makes the train state (resumed as ``--resume_from_checkpoint`` says)
    and runs the :class:`.train.loop.Trainer` over the loaders."""
    from master_thesis_tpu_torch.train.checkpoint import resume_split
    from master_thesis_tpu_torch.train.loop import Trainer
    from master_thesis_tpu_torch.train.state import create_train_state

    params, full = resume_split(cfg.resume_from_checkpoint)
    if params is not None:
        model.load_state_dict(params)
    model.train()
    state = create_train_state(model, cfg, steps_per_epoch=cfg.train_max_iterations)
    if full is not None:
        state.load_state_dict(full)
    device = torch.device(cfg.device)
    args = lambda b: batch_args(b, keys, device)
    trainer = Trainer(cfg, task, logger=logger)
    try:
        trainer.fit(state, train_step, args, loaders["train"], eval_step=eval_step,
                    eval_args=args, val_loader=loaders["validation"])
    finally:
        for loader in loaders.values():
            loader.close()
    return state


def run_dfpn_train(cfg, logger=None):
    """Trains DFPN (reference __main__.py:55-58); returns the train state."""
    from master_thesis_tpu_torch.data import meta
    from master_thesis_tpu_torch.train import build, dfpn_task

    loaders = build.build_loaders(cfg, meta.prepare_data(cfg))
    vgg = build.build_vgg(cfg, cfg.vgg_checkpoint)
    dfpn = load_dfpn(cfg)
    return _fit(cfg, "dfpn", dfpn, dfpn_task.make_train_step(dfpn, vgg),
                dfpn_task.make_eval_step(dfpn, vgg), ("x", "m", "y", "flow_gt", "flows_use"),
                loaders, logger)


def run_dfpn_test(cfg, logger=None):
    """DFPN's six losses over the test clips, supervised by the masks'
    movement (reference model_dfpn.py:197 reads info[5]), and the aligned
    frames' strips logged (model_dfpn.py:207, :411-456). Returns the mean
    of each loss."""
    from master_thesis_tpu_torch.data import meta
    from master_thesis_tpu_torch.train import build, dfpn_task
    from master_thesis_tpu_torch.train.checkpoint import next_version_dir
    from master_thesis_tpu_torch.train.logging import Logger

    loaders = build.build_loaders(cfg, meta.prepare_data(cfg), splits=("test",))
    vgg = build.build_vgg(cfg, cfg.vgg_checkpoint)
    dfpn = load_dfpn(cfg, cfg.test_checkpoint).requires_grad_(False).eval()
    eval_step = dfpn_task.make_eval_step(dfpn, vgg)
    align_fn = build.dfpn_align_fn(dfpn, vgg, pallas_mixer=build.use_kernels(cfg))
    logger = logger or Logger(next_version_dir(cfg.default_root_dir))
    device = torch.device(cfg.device)
    agg = {}
    for i, batch in enumerate(loaders["test"]):
        x, m, y, m_movement, flows_use = batch_args(
            batch, ("x", "m", "y", "m_movement", "flows_use"), device)
        for k, v in eval_step(x, m, y, m_movement, flows_use).items():
            agg.setdefault(k, []).append(float(v))
        dfpn_task.log_alignment_frames(logger, align_fn, x, m, y, step=i)
    logger.flush()
    means = {k: float(np.mean(v)) for k, v in agg.items()}
    for k, v in means.items():
        print(f"test/{k}: {v:.5f}")
    return means


def run_chn_train(cfg, logger=None):
    """Trains CHN behind the frozen aligner (reference __main__.py:33-49);
    returns the train state."""
    from master_thesis_tpu_torch.data import meta
    from master_thesis_tpu_torch.train import build, chn_task

    loaders = build.build_loaders(cfg, meta.prepare_data(cfg))
    vgg = build.build_vgg(cfg, cfg.vgg_checkpoint)
    align_fn = build_aligner(cfg, vgg)
    chn = build.build_chn(cfg)
    chn_apply = build.chn_train_fn(cfg, chn)
    lpips_fn = build.build_lpips(cfg, lpips_checkpoint=cfg.lpips_checkpoint)
    train_step = chn_task.make_train_step(chn, align_fn, vgg, perceptual_grad=cfg.perceptual_grad,
                                          chn_apply=chn_apply)
    eval_step = chn_task.make_eval_step(chn, align_fn, vgg, chn_apply=chn_apply, lpips_fn=lpips_fn)
    return _fit(cfg, "chn", chn, train_step, eval_step, ("x", "m", "y"), loaders, logger)


def run_chn_test(cfg, logger=None, video_writer: Optional[Callable] = None):
    """ff / ip / cp over every test clip (reference __main__.py:43, the
    Inpainter of model_chn.py): PSNR / SSIM (and LPIPS with its weights) of
    each against the decoded frames, logged and printed, and each video
    written by ``video_writer(frames, name)`` (default
    :func:`.infer.video.write_video`, which needs OpenCV). Returns the mean
    of each measure by algorithm."""
    from master_thesis_tpu_torch.data import meta
    from master_thesis_tpu_torch.infer.algorithms import Inpainter
    from master_thesis_tpu_torch.ops import measures
    from master_thesis_tpu_torch.train import build
    from master_thesis_tpu_torch.train.checkpoint import load_weights, next_version_dir
    from master_thesis_tpu_torch.train.logging import Logger

    if video_writer is None:
        from master_thesis_tpu_torch.infer.video import write_video as video_writer
    loaders = build.build_loaders(cfg, meta.prepare_data(cfg), splits=("test",))
    vgg = build.build_vgg(cfg, cfg.vgg_checkpoint)
    align_fn = build_aligner(cfg, vgg)
    chn = load_weights(build.build_chn(cfg), cfg.test_checkpoint).requires_grad_(False).eval()
    inpainter = Inpainter(build.chn_infer_fn(chn, kernels=build.use_kernels(cfg)), align_fn,
                          device=cfg.device)
    lpips_fn = build.build_lpips(cfg, lpips_checkpoint=cfg.lpips_checkpoint)
    device = torch.device(cfg.device)

    @torch.no_grad()
    def quality(y_hat, y):
        y_hat, y = torch.as_tensor(y_hat, device=device), torch.as_tensor(y, device=device)
        out = {"psnr": measures.psnr(y_hat, y), "ssim": measures.ssim(y_hat, y)}
        if lpips_fn is not None:
            out["lpips"] = lpips_fn(y_hat, y)
        return {k: float(v) for k, v in out.items()}

    logger = logger or Logger(next_version_dir(cfg.default_root_dir))
    agg = {}
    for seq_i, batch in enumerate(loaders["test"]):
        x, m, y = batch["x"][0], batch["m"][0], batch["y"][0]
        name = batch["names"][0]
        for algo in ("ff", "ip", "cp"):
            y_hat = getattr(inpainter, f"inpaint_{algo}")(x, m)
            q = quality(y_hat, y)
            for k, v in q.items():
                agg.setdefault(f"{algo}/{k}", []).append(v)
            logger.log_scalars(q, seq_i, prefix=f"test/{algo}/measures_")
            path = video_writer(y_hat, f"{name}_{algo}")
            print(f"wrote {path} " + " ".join(f"{k}={v:.4f}" for k, v in q.items()))
    means = {k: float(np.mean(v)) for k, v in sorted(agg.items())}
    for k, v in means.items():
        logger.log_scalars({f"test/{k}_mean": v}, 0)
        print(f"test/{k}: {v:.5f}")
    logger.flush()
    return means


def main(argv=None, *, logger=None, video_writer: Optional[Callable] = None):
    """Parses ``argv`` and runs its mode on ``--device`` (which raises
    without a card unless it is ``cpu``). ``logger`` replaces the
    TensorBoard logger, ``video_writer`` CHN test's. Returns the mode's
    result: the train state, or the test's mean measures."""
    from master_thesis_tpu_torch.device import resolve_device

    parser = argparse.ArgumentParser("master_thesis_tpu_torch")
    Config.add_argparse_args(parser)
    cfg = Config.from_args(parser.parse_args(argv))
    resolve_device(cfg.device)
    if cfg.chn and cfg.test:
        return run_chn_test(cfg, logger, video_writer)
    if cfg.chn:
        return run_chn_train(cfg, logger)
    if cfg.test:
        return run_dfpn_test(cfg, logger)
    return run_dfpn_train(cfg, logger)


if __name__ == "__main__":
    main()
