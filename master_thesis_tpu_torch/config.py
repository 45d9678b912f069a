"""Typed configuration (master_thesis_tpu/config.py: str2bool, Config).

One dataclass carries the full flag surface of the JAX package's CLI, which
is the reference CLI's (reference: master_thesis/data.py:319-370 declares
the 22 data/optim flags; master_thesis/__main__.py:63-67 the run-mode
flags), with the same names, defaults and rules, plus ``--device``. The
flags that choose TPU machinery keep their JAX names and defaults; their
help says what each does here. The mesh flags lay the launched processes
out as the JAX package lays out its devices (:mod:`.parallel.mesh`).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

from master_thesis_tpu_torch.parallel.mesh import launched_world_size, mesh_shape


def str2bool(v) -> bool:
    """Real boolean flag parsing. The reference declares its boolean flags
    as ``type=bool`` (data.py:336), under which ``--image_resize False``
    silently parses as True; here true/false/1/0/yes/no all work."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


@dataclasses.dataclass
class Config:
    # --- run mode (reference __main__.py:63-67) ---
    test: bool = False
    test_checkpoint: Optional[str] = None
    chn: bool = False
    chn_aligner: str = "cpn"  # {'cpn', 'dfpn'}
    chn_aligner_checkpoint: Optional[str] = None

    # --- data (reference data.py:319-366) ---
    data_path: str = "./data"
    data_ckpt_path: str = "./lightning_logs/data.ckpt"
    image_resize: bool = True
    min_mask_size: float = 0.05
    max_mask_size: Optional[float] = 0.15
    train_size: Tuple[int, int] = (256, 256)
    test_size: Tuple[int, int] = (240, 480)
    frames_n: int = 2
    frames_spacing: int = 10
    frames_randomize: bool = True
    dilatation_filter_size: Tuple[int, int] = (3, 3)
    dilatation_iterations: int = 4
    p_simulator_bgs: float = 0.5
    p_simulator_masks: float = 0.0
    bgs_movement_params: Tuple[float, float, float] = (50, 0.10, 0.20)
    masks_movement_params: Tuple[float, float, float] = (50, 0.10, 0.20)
    batch_size: int = 8
    num_workers: int = 0
    # Worker PROCESSES for the data loader (the reference DataLoader
    # architecture) — threads are GIL-bound in the simulator's numpy warp.
    loader_processes: bool = False
    # Evaluate the movement-simulator warp directly at the train resolution
    # in image_resize mode (exact flows/masks; background values carry a
    # bounded double-bilinear deviation — PARITY.md). False = the
    # reference's warp-at->=2x-size-then-resize pipeline, pixel-exact.
    fast_simulator: bool = True
    # Decode contiguous JPEG backgrounds at a reduced DCT scale when the
    # image_resize target is covered by a fractional-scale decode
    # (libjpeg scale_num; runtime/native.py). False = full-size decode,
    # the reference's jpeg4py path (dataset.py:300-301), pixel-exact.
    fast_decode: bool = True
    train_max_iterations: int = 2000
    validation_max_iterations: int = 200

    # --- optimizer (reference data.py:367-369) ---
    lr: float = 1e-4
    lr_scheduler_step_size: int = 50
    lr_scheduler_gamma: float = 0.5

    # --- trainer (pl.Trainer flags reachable through the reference CLI,
    # reference __main__.py:69; Lightning semantics preserved) ---
    max_epochs: int = 100
    default_root_dir: str = "./lightning_logs"
    seed: int = 0
    resume_from_checkpoint: Optional[str] = None
    accumulate_grad_batches: int = 1  # micro-batches per optimizer update
    gradient_clip_val: float = 0.0  # global-norm clip; 0 disables (pl default)
    # float <= 1: fraction of the train epoch between validations;
    # int > 1: validate every N train steps (pl.Trainer semantics).
    val_check_interval: float = 1.0
    # float <= 1: fraction of the validation epoch; int > 1: batch count.
    limit_val_batches: float = 1.0

    # --- pretrained weight sources (torch state dicts, converted on load;
    # the reference streams VGG from the torchvision hub, model_vgg.py:62) ---
    vgg_checkpoint: Optional[str] = None
    lpips_checkpoint: Optional[str] = None

    # --- the JAX package's own knobs (no reference equivalent) ---
    chn_nb: int = 20  # RRDB block count (reference fixes 20, model_chn.py:31)
    chn_remat: bool = False  # recompute RRDBs in the module route's backward
    # Params are always float32 (converters emit f32; optimizer state f32);
    # only the conv compute dtype is configurable.
    compute_dtype: str = "bfloat16"  # dtype for conv compute inside models
    mesh_data: int = -1  # processes on the data axis; -1: the world / mesh_model
    mesh_model: int = 1  # processes on the reference-frame axis
    donate_buffers: bool = True  # no PyTorch meaning
    use_pallas: bool = True  # the hand-written kernels on a CUDA device
    # DFPN cascade resolution. The reference fixes 256 (model_dfpn.py:74-81)
    # and converted reference checkpoints require it; smaller values keep
    # the same graph shape for cheap CPU tests / scaled-down runs.
    dfpn_base_size: int = 256
    # False: CHN training through the modules' autograd instead of the
    # forward and backward kernels.
    use_pallas_bwd: bool = True
    # The reference's VGG extractor detaches its pool features
    # (model_vgg.py:43), so its CHN perceptual loss contributes no
    # gradient — it only logs. False (default) reproduces that training
    # math exactly; True turns the perceptual term into a live gradient
    # (a documented improvement over the reference, not parity).
    perceptual_grad: bool = False
    profile_dir: Optional[str] = None  # torch.profiler trace output
    # The port's device: "cuda" (the card) or "cpu" (the plain versions of
    # the kernels, as the tests run).
    device: str = "cuda"

    def __post_init__(self):
        if self.chn and self.test:
            # Full-video inference processes one sequence at a time
            # (reference __main__.py:13-15 mutates config the same way).
            self.batch_size = 1
            self.frames_n = -1
        self.train_size = tuple(self.train_size)
        self.test_size = tuple(self.test_size)
        self.dilatation_filter_size = tuple(self.dilatation_filter_size)
        self.bgs_movement_params = tuple(self.bgs_movement_params)
        self.masks_movement_params = tuple(self.masks_movement_params)
        # The mesh must cover the launched processes exactly, give each
        # model rank a reference to train on (frames_n -1, whole clips, is
        # checked per clip) and each data rank whole rows.
        data, model = mesh_shape(self.mesh_data, self.mesh_model, launched_world_size())
        if not self.test and model > 1 and model >= self.frames_n > 0:
            raise ValueError(f"--mesh_model {model}: frames_n {self.frames_n} gives "
                             f"{self.frames_n - 1} references, and each model rank needs one")
        if self.batch_size % data != 0:
            raise ValueError(f"--batch_size {self.batch_size} does not split over {data} data ranks")

    @staticmethod
    def add_argparse_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        """Declares every flag with the reference's exact names/defaults."""
        parser.add_argument("--test", action="store_true")
        parser.add_argument("--test_checkpoint")
        parser.add_argument("--chn", action="store_true")
        parser.add_argument("--chn_aligner", choices=["dfpn", "cpn"], default="cpn")
        parser.add_argument("--chn_aligner_checkpoint")

        parser.add_argument("--data_path", default="./data")
        parser.add_argument("--data_ckpt_path", default="./lightning_logs/data.ckpt")
        boolean = dict(type=str2bool, nargs="?", const=True)
        parser.add_argument("--image_resize", default=True, **boolean)
        parser.add_argument("--min_mask_size", type=float, default=0.05)
        parser.add_argument("--max_mask_size", type=float, default=0.15)
        parser.add_argument("--train_size", type=int, nargs="+", default=[256, 256])
        parser.add_argument("--test_size", type=int, nargs="+", default=[240, 480])
        parser.add_argument("--frames_n", type=int, default=2)
        parser.add_argument("--frames_spacing", type=int, default=10)
        parser.add_argument("--frames_randomize", default=True, **boolean)
        parser.add_argument(
            "--dilatation_filter_size", type=int, nargs="+", default=[3, 3]
        )
        parser.add_argument("--dilatation_iterations", type=int, default=4)
        parser.add_argument("--p_simulator_bgs", type=float, default=0.5)
        parser.add_argument("--p_simulator_masks", type=float, default=0.0)
        parser.add_argument(
            "--bgs_movement_params", type=float, nargs="+", default=[50, 0.10, 0.20]
        )
        parser.add_argument(
            "--masks_movement_params", type=float, nargs="+", default=[50, 0.10, 0.20]
        )
        parser.add_argument("--batch_size", type=int, default=8)
        parser.add_argument("--num_workers", type=int, default=0)
        parser.add_argument("--loader_processes", default=False, **boolean)
        parser.add_argument("--fast_simulator", default=True, **boolean)
        parser.add_argument("--fast_decode", default=True, **boolean)
        parser.add_argument("--perceptual_grad", default=False, **boolean)
        parser.add_argument("--train_max_iterations", type=int, default=2000)
        parser.add_argument("--validation_max_iterations", type=int, default=200)
        parser.add_argument("--lr", type=float, default=1e-4)
        parser.add_argument("--lr_scheduler_step_size", type=int, default=50)
        # The reference declares this flag as int with default 0.5
        # (data.py:369) — we fix the latent type bug and use float.
        parser.add_argument("--lr_scheduler_gamma", type=float, default=0.5)

        parser.add_argument("--max_epochs", type=int, default=100)
        parser.add_argument("--default_root_dir", default="./lightning_logs")
        parser.add_argument("--seed", type=int, default=0)
        parser.add_argument("--resume_from_checkpoint")
        parser.add_argument("--accumulate_grad_batches", type=int, default=1)
        parser.add_argument("--gradient_clip_val", type=float, default=0.0)
        parser.add_argument("--val_check_interval", type=float, default=1.0)
        parser.add_argument("--limit_val_batches", type=float, default=1.0)

        parser.add_argument("--chn_nb", type=int, default=20)
        parser.add_argument(
            "--chn_remat", default=False, help="recompute each RRDB in the backward of the CHN's "
            "module route (--use_pallas false or --use_pallas_bwd false); the kernel route's "
            "backward reads the activations its forward kept", **boolean)
        parser.add_argument("--vgg_checkpoint")
        parser.add_argument("--lpips_checkpoint")
        parser.add_argument("--compute_dtype", default="bfloat16")
        parser.add_argument(
            "--mesh_data", type=int, default=-1,
            help="processes on the data axis (batch rows); -1: the launched processes / "
            "--mesh_model; launch with torchrun --nproc_per_node N")
        parser.add_argument(
            "--mesh_model", type=int, default=1,
            help="processes on the sequence axis (reference frames); at most frames_n - 1; "
            "mesh_data * mesh_model must equal the launched processes")
        parser.add_argument(
            "--donate_buffers", default=True,
            help="a JAX buffer-donation switch; PyTorch updates in place, so it changes nothing",
            **boolean)
        parser.add_argument(
            "--use_pallas", default=True,
            help="on a CUDA device, the hand-written kernels: the CHN on K1 / K4 (serving) and "
            "K3 / K6 (training), DFPN alignment's mixer on K7 (in bf16 also sep4d on K7, the flow "
            "estimators and VGG pool-4 on K8); false: the modules (cuDNN)",
            **boolean)
        parser.add_argument(
            "--use_pallas_bwd", default=True,
            help="with --use_pallas, CHN training on the kernels (K1 / K3, K4 / K6); false: "
            "CHN training through the modules' autograd", **boolean)
        parser.add_argument("--dfpn_base_size", type=int, default=256)
        parser.add_argument("--profile_dir", help="write a torch.profiler trace of training here")
        parser.add_argument(
            "--device", default="cuda",
            help="cuda (the card; raises without one) or cpu (the kernels' plain versions)")
        return parser

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in vars(args).items() if k in names}
        return cls(**kwargs)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
