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
    torchrun --nproc_per_node N -m master_thesis_tpu_torch --chn --mesh_data N ...

Under ``torchrun`` (``WORLD_SIZE > 1``) the train modes run on a ``(data,
model)`` mesh of the launched processes (``--mesh_data`` / ``--mesh_model``,
:mod:`.parallel.mesh`), one card each (NCCL) or on the CPU (gloo): each
process loads its data rank's rows of every batch, trains on its model
rank's share of the references, sums its grads with the others' at each
update, and rank 0 logs and writes the checkpoints. The test modes run in
one process.

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
from master_thesis_tpu_torch.parallel import mesh as mesh_lib


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


def dfpn_routes(cfg) -> dict:
    """The stage routes of the command line's frozen DFPN aligner
    (:func:`.train.build.dfpn_align_fn`'s ``pallas_*`` flags). With the
    kernels (:func:`.train.build.use_kernels`) the mixer runs on K7; in bf16
    also sep4d on K7, both flow estimators and VGG's pool-4 tower on K8. In
    f32 those three stay on their modules: under cuDNN's TF32, torch's
    default, which the command line keeps, the f32 serving step on an H100
    took 98 ms there against 139 ms on the kernels (PERF.md §6). Without the
    kernels every stage runs on its module."""
    from master_thesis_tpu_torch.train import build

    kernels = build.use_kernels(cfg)
    stages = kernels and build.compute_dtype(cfg) == torch.bfloat16
    return dict(pallas_sep4d=stages, pallas_mixer=kernels, pallas_flow=stages, pallas_vgg=stages)


def build_aligner(cfg, vgg) -> Callable:
    """The frozen aligner CHN trains and tests with: CPN's ``align``, or
    DFPN's (:func:`.train.build.dfpn_align_fn` on :func:`dfpn_routes`)."""
    from master_thesis_tpu_torch.train import build

    if cfg.chn_aligner == "cpn":
        return build.build_cpn(cfg, cfg.chn_aligner_checkpoint).align
    dfpn = load_dfpn(cfg, cfg.chn_aligner_checkpoint).requires_grad_(False).eval()
    return build.dfpn_align_fn(dfpn, vgg, **dfpn_routes(cfg))


def _prepare_data(cfg, mesh=None):
    """The five metas (``prepare_data``): rank 0 scans the tree and writes
    the metadata file, which the other ranks then read."""
    from master_thesis_tpu_torch.data import meta

    if mesh is None or mesh.rank == 0:
        metas = meta.prepare_data(cfg)
        mesh_lib.barrier(mesh)
        return metas
    mesh_lib.barrier(mesh)
    return meta.prepare_data(cfg)


def _shard(mesh):
    return (0, 1) if mesh is None else (mesh.data_rank, mesh.data)


def _fit(cfg, task: str, model, train_step, eval_step, keys, loaders, logger, mesh=None):
    """Makes the train state (resumed as ``--resume_from_checkpoint`` says;
    every rank reads the file) and runs the :class:`.train.loop.Trainer`
    over the loaders."""
    from master_thesis_tpu_torch.train.checkpoint import resume_split
    from master_thesis_tpu_torch.train.loop import Trainer
    from master_thesis_tpu_torch.train.state import create_train_state

    params, full = resume_split(cfg.resume_from_checkpoint)
    if params is not None:
        model.load_state_dict(params)
    model.train()
    state = create_train_state(model, cfg, steps_per_epoch=cfg.train_max_iterations, mesh=mesh)
    if full is not None:
        state.load_state_dict(full)
    mesh_lib.broadcast_params(model, mesh)
    device = torch.device(cfg.device)
    args = lambda b: batch_args(b, keys, device)
    trainer = Trainer(cfg, task, logger=logger, mesh=mesh)
    try:
        trainer.fit(state, train_step, args, loaders["train"], eval_step=eval_step,
                    eval_args=args, val_loader=loaders["validation"])
    finally:
        for loader in loaders.values():
            loader.close()
    return state


def run_dfpn_train(cfg, logger=None, mesh=None):
    """Trains DFPN (reference __main__.py:55-58) on ``mesh`` (None: this
    process alone); returns the train state."""
    from master_thesis_tpu_torch.train import build, dfpn_task

    loaders = build.build_loaders(cfg, _prepare_data(cfg, mesh), shard=_shard(mesh))
    vgg = build.build_vgg(cfg, cfg.vgg_checkpoint)
    dfpn = load_dfpn(cfg)
    return _fit(cfg, "dfpn", dfpn, dfpn_task.make_train_step(dfpn, vgg, mesh=mesh),
                dfpn_task.make_eval_step(dfpn, vgg, mesh=mesh),
                ("x", "m", "y", "flow_gt", "flows_use"), loaders, logger, mesh)


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
    align_fn = build.dfpn_align_fn(dfpn, vgg, **dfpn_routes(cfg))
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


def run_chn_train(cfg, logger=None, mesh=None):
    """Trains CHN behind the frozen aligner (reference __main__.py:33-49) on
    ``mesh`` (None: this process alone); returns the train state."""
    from master_thesis_tpu_torch.train import build, chn_task

    loaders = build.build_loaders(cfg, _prepare_data(cfg, mesh), shard=_shard(mesh))
    vgg = build.build_vgg(cfg, cfg.vgg_checkpoint)
    align_fn = build_aligner(cfg, vgg)
    chn = build.build_chn(cfg)
    chn_apply = build.chn_train_fn(cfg, chn)
    lpips_fn = build.build_lpips(cfg, lpips_checkpoint=cfg.lpips_checkpoint)
    train_step = chn_task.make_train_step(chn, align_fn, vgg, perceptual_grad=cfg.perceptual_grad,
                                          chn_apply=chn_apply, mesh=mesh)
    eval_step = chn_task.make_eval_step(chn, align_fn, vgg, chn_apply=chn_apply, lpips_fn=lpips_fn,
                                        mesh=mesh)
    return _fit(cfg, "chn", chn, train_step, eval_step, ("x", "m", "y"), loaders, logger, mesh)


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
    result: the train state, or the test's mean measures.

    With ``WORLD_SIZE > 1`` a train mode joins the launcher's process group
    (unless the caller has joined one) and leaves it at the end."""
    import torch.distributed as dist

    from master_thesis_tpu_torch.device import resolve_device

    parser = argparse.ArgumentParser("master_thesis_tpu_torch")
    Config.add_argparse_args(parser)
    cfg = Config.from_args(parser.parse_args(argv))
    resolve_device(cfg.device)
    if cfg.test and mesh_lib.launched_world_size() > 1:
        raise ValueError(f"--test runs in one process, not {mesh_lib.launched_world_size()}: "
                         "launch it without torchrun")
    if cfg.chn and cfg.test:
        return run_chn_test(cfg, logger, video_writer)
    if cfg.test:
        return run_dfpn_test(cfg, logger)
    joined = mesh_lib.launched_world_size() > 1 and not dist.is_initialized()
    if joined:
        mesh_lib.init_distributed(cfg.device)
    try:
        mesh = mesh_lib.make_mesh(cfg.mesh_data, cfg.mesh_model)
        return (run_chn_train if cfg.chn else run_dfpn_train)(cfg, logger, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
