"""The port's command line (``python -m master_thesis_tpu_torch``): its flags
against the JAX CLI's, the Config rules, the four run modes end to end on
the CPU over the fixture tree, resume from either kind of checkpoint, and
one DFPN-train run of both CLIs from the same weights."""

import argparse
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from master_thesis_tpu.config import Config as JaxConfig
from master_thesis_tpu_torch.__main__ import main
from master_thesis_tpu_torch.config import Config
from master_thesis_tpu_torch.models.vgg import VGGFeatures
from master_thesis_tpu_torch.train.build import build_dfpn
from tests.fixtures import make_fake_data_root

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DFPN_ITEMS = ("corr_loss", "flow_16", "flow_64", "flow_256", "alignment_recons_64",
              "alignment_recons_256", "loss")


class Recorder:
    """A Trainer logger that keeps what it is given."""

    def __init__(self):
        self.scalars = []

    def log_scalars(self, scalars, step, prefix=""):
        self.scalars.append((prefix, step, {k: float(v) for k, v in scalars.items()}))

    def log_images(self, tag, images, step):
        self.scalars.append(("images/", step, {tag: float(np.asarray(images).mean())}))

    def flush(self):
        pass


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """1 intra-op thread: the suite runs several workers at once, and small
    CPU ops spread over every core by each of them wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The fixture tree with its DAVIS clip cut to 3 frames: CHN test's
    algorithms refine each frame from every other, so the clip's length
    sets the mode's time."""
    root = make_fake_data_root(str(tmp_path_factory.mktemp("data")))
    for sub in ("JPEGImages", "Annotations_Dense"):
        for path in glob.glob(os.path.join(root, "DAVIS-2017", sub, "480p", "clip1", "*")):
            if int(os.path.basename(path).split(".")[0]) >= 3:
                os.remove(path)
    return root


def _common(data_root, tmp_path, logs="logs"):
    return ["--device", "cpu", "--data_path", data_root,
            "--data_ckpt_path", str(tmp_path / "data.ckpt"),
            "--default_root_dir", str(tmp_path / logs), "--compute_dtype", "float32",
            "--dfpn_base_size", "64", "--chn_nb", "2", "--num_workers", "1",
            "--train_max_iterations", "2", "--validation_max_iterations", "1", "--max_epochs", "1"]


TRAIN = ["--train_size", "64", "64", "--batch_size", "2"]


def _parser(config_cls):
    parser = argparse.ArgumentParser()
    config_cls.add_argparse_args(parser)
    return parser


def test_flags_equal_jax_cli_plus_device():
    ours = {a.dest: a for a in _parser(Config)._actions if a.dest != "help"}
    theirs = {a.dest: a for a in _parser(JaxConfig)._actions if a.dest != "help"}
    assert set(ours) == set(theirs) | {"device"}
    # Each package has its own str2bool: types compare by name.
    spec = lambda a: (a.option_strings, a.default, getattr(a.type, "__name__", a.type), a.nargs,
                      a.choices, a.const)
    for dest, a in theirs.items():
        assert spec(ours[dest]) == spec(a), dest
    assert ours["device"].default == "cuda"
    out = subprocess.run([sys.executable, "-m", "master_thesis_tpu_torch", "--help"], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for a in ours.values():
        assert a.option_strings[0] in out.stdout


def test_port_and_chip_smoke_import_no_jax():
    """No import line of the port's modules or of ``chip_smoke.py`` names
    jax, flax or the JAX package (a grep, indented imports included), and
    importing every port module, the CLI and the data pipeline with them,
    loads none of them."""
    build = os.path.join(_REPO, "master_thesis_tpu_torch", "build", "")
    files = [p for p in glob.glob(os.path.join(_REPO, "master_thesis_tpu_torch", "**", "*.py"), recursive=True)
             if not p.startswith(build)]  # the git-ignored build directory holds no module
    files.append(os.path.join(_REPO, "chip_smoke.py"))
    modules = []
    for path in files:
        with open(path) as fh:
            for ln in fh:
                ln = ln.strip()
                if ln.startswith(("import ", "from ")):
                    assert ln.split()[1].split(".")[0] not in ("jax", "jaxlib", "flax", "master_thesis_tpu"), \
                        f"{path}: {ln}"
        rel = os.path.relpath(path, _REPO)
        if rel.startswith("master_thesis_tpu_torch"):
            modules.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
    code = ("import importlib, sys\n"
            f"for m in {sorted(modules)!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'master_thesis_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=_REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_config_rules(monkeypatch):
    cfg = Config(chn=True, test=True)
    assert (cfg.batch_size, cfg.frames_n, cfg.device) == (1, -1, "cuda")
    assert Config(chn=True).frames_n == 2
    args = _parser(Config).parse_args(["--chn", "--test", "--train_size", "32", "48",
                                       "--use_pallas", "false", "--device", "cpu"])
    cfg = Config.from_args(args)
    assert (cfg.batch_size, cfg.frames_n, cfg.train_size, cfg.use_pallas, cfg.device) == \
           (1, -1, (32, 48), False, "cpu")
    # The mesh covers the launched processes exactly (WORLD_SIZE, 1 without
    # a launcher), gives each model rank a reference and each data rank
    # whole rows of the batch.
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        Config(mesh_data=2)
    assert Config(mesh_data=1).mesh_data == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert Config(mesh_data=2).mesh_data == 2 and Config().mesh_data == -1  # -1: 2 // 1
    with pytest.raises(ValueError, match="leaves 1 of 2 processes"):
        Config(mesh_data=1)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        Config(mesh_model=3, frames_n=4)
    with pytest.raises(ValueError, match="frames_n 2 gives 1 references"):
        Config(mesh_model=2)
    assert Config(mesh_model=2, frames_n=3).mesh_model == 2
    with pytest.raises(ValueError, match="batch_size 3 does not split over 2"):
        Config(mesh_data=2, batch_size=3)
    # The test modes run in one process.
    with pytest.raises(ValueError, match="runs in one process"):
        main(["--test", "--device", "cpu", "--mesh_data", "2", "--batch_size", "2"])


@pytest.mark.parametrize("remat", [False, True])
def test_chn_module_route_equals_kernel_route(remat):
    """The CHN's module route (``--use_pallas false``, or on the CPU;
    ``--chn_remat`` recomputing each RRDB in the backward) against the
    kernel route's plain versions on the CPU, f32: outputs and grads within
    1e-5 relative L2 (convs summed in another order); remat gives the same
    grads as keeping the activations, bit for bit."""
    from master_thesis_tpu_torch.train.build import build_chn, chn_infer_fn, chn_train_fn

    cfg = Config(device="cpu", compute_dtype="float32", chn_nb=2, chn_remat=remat)
    chn = build_chn(cfg)
    rng = np.random.RandomState(6)
    args = [torch.from_numpy(rng.rand(*shape).astype(np.float32)) for shape in
            ((1, 32, 32, 3), (1, 32, 32, 1), (1, 2, 32, 32, 3), (1, 2, 32, 32, 1), (1, 2, 32, 32, 1))]

    def run(apply):
        chn.zero_grad(set_to_none=True)
        y_hat, y_comp = apply(*args)
        (y_hat * y_comp).sum().backward()
        return [y_hat.detach()] + [p.grad.clone() for p in chn.parameters()]

    rel = lambda a, b: float((a - b).norm() / b.norm())
    kernels = run(chn_infer_fn(chn))
    modules = run(chn_train_fn(cfg, chn))
    assert max(rel(a, b) for a, b in zip(modules, kernels)) < 1e-5
    if remat:
        plain = run(chn_train_fn(cfg.replace(chn_remat=False), chn))
        for a, b in zip(modules, plain):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_main_without_card_raises(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_common(data_root, tmp_path)[2:])  # without --device cpu


def test_four_modes_end_to_end(data_root, tmp_path, monkeypatch):
    """DFPN train, DFPN test, CHN train, CHN test: each leaves its logs, the
    trainers their checkpoints, CHN test its three videos."""
    monkeypatch.chdir(tmp_path)
    common = _common(data_root, tmp_path)
    logs = tmp_path / "logs"
    state = main(common + TRAIN + ["--frames_n", "2"])
    assert state.step == 2 and (logs / "version_0" / "checkpoints" / "step_2.pt").is_file()
    means = main(common + ["--test", "--test_checkpoint", str(logs / "version_0"),
                           "--test_size", "48", "64", "--batch_size", "1"])
    assert set(means) == set(DFPN_ITEMS) and all(np.isfinite(v) for v in means.values())
    state = main(common + TRAIN + ["--chn", "--frames_n", "3"])
    assert state.step == 2 and (logs / "version_2" / "checkpoints" / "step_2.pt").is_file()
    means = main(common + ["--chn", "--test", "--test_checkpoint",
                           str(logs / "version_2" / "checkpoints" / "step_2.pt"),
                           "--test_size", "48", "64"])
    assert set(means) == {f"{a}/{k}" for a in ("ff", "ip", "cp") for k in ("psnr", "ssim")}
    assert all(m > 0 for k, m in means.items() if k.endswith("psnr"))
    for algo in ("ff", "ip", "cp"):
        assert os.path.getsize(tmp_path / "generated_sequences" / f"clip1_{algo}.avi") > 0
    for v in range(4):
        assert glob.glob(str(logs / f"version_{v}" / "events.out.tfevents.*"))


def test_resume_full_state_and_reference_params(data_root, tmp_path):
    """A port checkpoint restores the whole train state (parameters, Adam,
    counts); a reference ``.pth`` (a ``state_dict`` level, ``module.``
    prefixes) the parameters only."""
    common = _common(data_root, tmp_path) + TRAIN + ["--frames_n", "2"]
    first = main(common)
    ckpt = torch.load(tmp_path / "logs" / "version_0" / "checkpoints" / "step_2.pt", weights_only=True)
    # max_epochs 1 is reached already: the resumed state is the checkpoint's.
    resumed = main(common + ["--resume_from_checkpoint", str(tmp_path / "logs" / "version_0")])
    assert (resumed.step, resumed.updates, resumed.micro) == (2, 2, 0)
    for k, v in resumed.model.state_dict().items():
        torch.testing.assert_close(v, ckpt["model"][k], rtol=0, atol=0)
        torch.testing.assert_close(v, first.model.state_dict()[k], rtol=0, atol=0)
    for a, b in zip(resumed.optimizer.state.values(), first.optimizer.state.values()):
        torch.testing.assert_close(a["exp_avg"], b["exp_avg"], rtol=0, atol=0)
    # One epoch more runs steps 3-4 into a new version directory.
    more = main(common + ["--max_epochs", "2", "--resume_from_checkpoint",
                          str(tmp_path / "logs" / "version_0" / "checkpoints" / "step_2.pt")])
    assert more.step == 4
    assert [os.path.basename(p) for p in glob.glob(str(tmp_path / "logs" / "version_2" / "checkpoints" / "*"))] \
        == ["step_4.pt"]

    ref = build_dfpn(base_size=64, device="cpu", generator=torch.Generator().manual_seed(11))
    path = tmp_path / "reference.pth"
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": v for k, v in ref.state_dict().items()}}, path)
    params_only = main(common + ["--max_epochs", "0", "--resume_from_checkpoint", str(path)])
    assert (params_only.step, params_only.updates) == (0, 0) and not params_only.optimizer.state
    for k, v in params_only.model.state_dict().items():
        torch.testing.assert_close(v, ref.state_dict()[k], rtol=0, atol=0)


def test_cli_chn_train_on_two_gloo_ranks_equals_one_process(data_root, tmp_path):
    """``main([--chn, --mesh_data 2, --device cpu, ...])`` in two spawned
    gloo ranks (one row of each batch of 2 a rank) for 2 steps on the
    fixture tree: one checkpoint, rank 0's, and parameters within atol 1e-5
    of the one-process CLI run's, bit-equal across the ranks."""
    from tests.test_torch_parallel import spawned

    def argv(logs, mesh_data):
        return _common(data_root, tmp_path, logs) + TRAIN + [
            "--chn", "--chn_nb", "1", "--data_ckpt_path", str(tmp_path / f"{logs}.ckpt"),
            "--mesh_data", mesh_data]

    (tmp_path / "argv.json").write_text(json.dumps(argv("ranks", "2")))
    with spawned("cli", 2, tmp_path):
        one = main(argv("one", "-1"), logger=Recorder())
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=True) for r in range(2)]
    assert one.step == outs[0]["step"] == outs[1]["step"] == 2
    for k, v in one.model.state_dict().items():
        torch.testing.assert_close(outs[0]["params"][k], v, rtol=0, atol=1e-5)
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k]), k
    assert [os.path.relpath(p, tmp_path / "ranks") for p in glob.glob(str(tmp_path / "ranks" / "*" / "checkpoints" / "*"))] \
        == [os.path.join("version_0", "checkpoints", "step_2.pt")]


def _jax_first_losses(logdir, items=DFPN_ITEMS):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(logdir)
    acc.Reload()
    return {k: acc.Scalars(f"training/{k}")[0] for k in items}


def _jax_env():
    return dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=1",
                JAX_DEFAULT_MATMUL_PRECISION="highest")


def test_chn_with_dfpn_aligner_first_losses_equal_jax_cli(data_root, tmp_path):
    """``--chn --chn_aligner dfpn --chn_aligner_checkpoint <file>`` (the
    reference's mode 3 with its DFPN aligner, as tests/test_cli.py:99 runs
    the JAX CLI) at --compute_dtype float32 in both CLIs, from one
    reference-key file each for the DFPN aligner, the CHN and VGG, on the
    same tree and seed, so their loaders give the same batch: every CHN
    loss item logged at step 1 agrees within 2e-5 relative (f32 sums in
    another order through VGG, the DFPN aligner's correlation and flow
    cascade, the warp and the CHN; they read 2.0e-6 at most, the
    perceptual item)."""
    from master_thesis_tpu_torch.models.chn import CHN

    torch.save(build_dfpn(base_size=64, device="cpu", generator=torch.Generator().manual_seed(14)).state_dict(),
               tmp_path / "dfpn.pth")
    torch.save(VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(15)).state_dict(),
               tmp_path / "vgg.pth")
    torch.save(CHN(nb=1, device="cpu", generator=torch.Generator().manual_seed(16)).state_dict(),
               tmp_path / "chn.pth")
    args = ["--data_path", data_root, "--compute_dtype", "float32", "--dfpn_base_size", "64",
            "--num_workers", "1", "--train_max_iterations", "1", "--validation_max_iterations", "1",
            "--max_epochs", "1", "--train_size", "64", "64", "--batch_size", "2", "--frames_n", "3",
            "--seed", "4", "--chn", "--chn_nb", "1", "--chn_aligner", "dfpn",
            "--chn_aligner_checkpoint", str(tmp_path / "dfpn.pth"), "--vgg_checkpoint",
            str(tmp_path / "vgg.pth"), "--resume_from_checkpoint", str(tmp_path / "chn.pth")]
    out = subprocess.run(
        [sys.executable, "-m", "master_thesis_tpu", *args, "--data_ckpt_path",
         str(tmp_path / "jax_data.ckpt"), "--default_root_dir", str(tmp_path / "jax")],
        env=_jax_env(), capture_output=True, text=True, timeout=900, cwd=_REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = Recorder()
    main(args + ["--device", "cpu", "--data_ckpt_path", str(tmp_path / "data.ckpt"),
                 "--default_root_dir", str(tmp_path / "port")], logger=rec)
    got = next(s for prefix, step, s in rec.scalars if prefix == "training/" and step == 1)
    items = [k for k in got if k != "step_time_s"]
    want = _jax_first_losses(str(tmp_path / "jax" / "version_0"), items)
    assert "loss" in items and len(items) > 1
    for k in items:
        np.testing.assert_allclose(got[k], want[k].value, rtol=2e-5, err_msg=k)


def test_dfpn_train_first_losses_equal_jax_cli(data_root, tmp_path):
    """Both CLIs start DFPN training from one reference-key torch file (the
    DFPN's) and one torchvision-key VGG file, in f32 (JAX at its highest
    matmul precision), on the same tree and seed, so their loaders give the
    same batch: the six loss items and the total logged at step 1 agree
    within 1e-5 relative (f32 sums in another order through VGG, the 4-D
    correlation and the flow cascade; they read 7.1e-7 at most)."""
    dfpn = build_dfpn(base_size=64, device="cpu", generator=torch.Generator().manual_seed(12))
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(13))
    torch.save(dfpn.state_dict(), tmp_path / "dfpn.pth")
    torch.save(vgg.state_dict(), tmp_path / "vgg.pth")
    args = ["--data_path", data_root, "--compute_dtype", "float32", "--dfpn_base_size", "64",
            "--num_workers", "1", "--train_max_iterations", "1", "--validation_max_iterations", "1",
            "--max_epochs", "1", "--train_size", "64", "64", "--batch_size", "2", "--frames_n", "2",
            "--p_simulator_bgs", "1.0", "--seed", "4", "--vgg_checkpoint", str(tmp_path / "vgg.pth"),
            "--resume_from_checkpoint", str(tmp_path / "dfpn.pth")]
    env = _jax_env()
    out = subprocess.run(
        [sys.executable, "-m", "master_thesis_tpu", *args, "--data_ckpt_path",
         str(tmp_path / "jax_data.ckpt"), "--default_root_dir", str(tmp_path / "jax")],
        env=env, capture_output=True, text=True, timeout=900, cwd=_REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    want = _jax_first_losses(str(tmp_path / "jax" / "version_0"))

    rec = Recorder()
    main(args + ["--device", "cpu", "--data_ckpt_path", str(tmp_path / "data.ckpt"),
                 "--default_root_dir", str(tmp_path / "port")], logger=rec)
    got = next(s for prefix, step, s in rec.scalars if prefix == "training/" and step == 1)
    assert want["flow_256"].value > 0  # the simulator's flows are supervised
    for k in DFPN_ITEMS:
        np.testing.assert_allclose(got[k], want[k].value, rtol=1e-5, err_msg=k)
