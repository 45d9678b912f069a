"""The port's data and sequence parallelism (``master_thesis_tpu_torch/
parallel``) against the JAX package's unsharded steps, on the CPU.

- The mesh's layout (``rank = data_rank * model + model_rank``, JAX's
  ``devices.reshape(data, model)``), its errors, ``shard_batch`` and
  ``ref_slice``, without a process group.
- The reduction rule, without processes: a batch split by hand over 2-4
  ranks (by rows, by references, both), ``global_sum`` summed in this
  process; each rank's loss is its numerator over the whole batch's
  denominator, so the ranks' losses (and grads) sum to the one-process
  ones, for every loss term and measure. A naive mean of per-rank losses
  differs where the masks' densities differ.
- The loader's shard: its batches equal ``shard_batch`` of the whole batch.
- Spawned gloo processes (this file run as ``python -m
  tests.test_torch_parallel MODE RANK WORLD DIR``; the ranks import torch
  and the port only, never JAX): the CHN step on meshes 2x1 and 1x2
  against the JAX package's unsharded step, the Trainer at k = 2 with a
  checkpoint written by rank 0 and a resume, and the DFPN step on a 2x2
  mesh against ``jax.grad`` of the unsharded ``forward_and_loss``. Every
  rank is joined with a timeout and a hung one is killed.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from master_thesis_tpu_torch.config import Config
from master_thesis_tpu_torch.models.chn import CHN
from master_thesis_tpu_torch.models.dfpn import DFPN
from master_thesis_tpu_torch.models.vgg import VGGFeatures
from master_thesis_tpu_torch.ops import losses, measures
from master_thesis_tpu_torch.ops.flows import identity_grid
from master_thesis_tpu_torch.parallel import mesh as mesh_lib
from master_thesis_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_params,
    init_distributed,
    make_mesh,
    mesh_shape,
    reducer,
    ref_slice,
    shard_batch,
    sum_scalars,
)
from master_thesis_tpu_torch.train import chn_task, dfpn_task, state
from master_thesis_tpu_torch.train.checkpoint import restore_train_state
from master_thesis_tpu_torch.train.loop import LoopConfig, Trainer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each spawned run joins its ranks within this many seconds, or fails.
JOIN_TIMEOUT = 120
# The spawned CHN: the JAX test's (tests/test_parallel.py) widths and batch
# at 32x32, the least VGG's five pools take.
CHN_NB, CHN_NF, CHN_GC, CHN_HW, CHN_B, CHN_F = 1, 8, 4, 32, 8, 3
# The spawned DFPN: tests/test_parallel.py's base 64, 32x32, b=4, f=3; with
# this seed every grad at these shapes is live.
DFPN_BASE, DFPN_HW, DFPN_B, DFPN_F, DFPN_SEED = 64, 32, 4, 3, 5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """2 intra-op threads: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def identity_align(x_t, m_t, x_r, m_r):
    """The JAX tests' aligner: the references as they are."""
    v_aligned = 1 - m_r
    return x_r, v_aligned, (v_aligned - (1 - m_t[:, None])).clip(0, 1)


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("data,model", [(2, 2), (4, 1)])
def test_mesh_layout_is_jax_row_major(data, model):
    assert mesh_shape(-1, model, 4) == (data, model)
    grid = np.arange(4).reshape(data, model)  # JAX: devices.reshape(data, model)
    for rank in range(4):
        m = Mesh(data, model, rank)
        assert grid[m.data_rank, m.model_rank] == rank
        assert m.rank == m.data_rank * model + m.model_rank
        assert m.shape == {"data": data, "model": model}


def test_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="needs more than 4"):
        mesh_shape(4, 2, 4)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        mesh_shape(-1, 3, 4)
    with pytest.raises(ValueError, match="without a place"):
        mesh_shape(1, 2, 4)
    with pytest.raises(ValueError, match="outside"):
        Mesh(2, 1, 2)
    with pytest.raises(ValueError, match="does not split evenly"):
        shard_batch({"x": np.zeros((3, 2))}, Mesh(2, 1, 0))
    with pytest.raises(ValueError, match="holds none of 1"):
        ref_slice(1, Mesh(1, 2, 1))
    # No process group: the 1x1 mesh, which issues no collective; a launched
    # world without one raises.
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert make_mesh() == Mesh() and not make_mesh().distributed and reducer(make_mesh()) is None
    with pytest.raises(ValueError, match="needs more than 1"):
        make_mesh(2, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()


def test_shard_batch_rows_and_leaves():
    batch = {"x": np.arange(16).reshape(8, 2), "t": torch.arange(8), "names": list("abcdefgh"),
             "scalar": np.float32(3)}
    for rank in range(4):
        m = Mesh(2, 2, rank)
        out = shard_batch(batch, m)
        rows = slice(4 * m.data_rank, 4 * m.data_rank + 4)
        np.testing.assert_array_equal(out["x"], batch["x"][rows])
        assert torch.equal(out["t"], batch["t"][rows])
        assert out["names"] is batch["names"] and out["scalar"] is batch["scalar"]
    out = shard_batch(batch, None)
    assert out.keys() == batch.keys() and all(out[k] is batch[k] for k in batch)


@pytest.mark.parametrize("refs_n", [2, 3, 4, 5])
@pytest.mark.parametrize("model", [1, 2])
def test_ref_slice_is_tensor_split(refs_n, model):
    want = torch.tensor_split(torch.arange(refs_n), model)
    for k in range(model):
        got = torch.arange(refs_n)[ref_slice(refs_n, Mesh(1, model, k))]
        assert torch.equal(got, want[k])


# ------------------------------------------- the reduction rule, in process


class _InProcessSum:
    """Stands in for ``global_sum`` over ranks run one after another in this
    process: a first pass records each rank's local values in call order,
    a second returns at each call the sum over ranks of the values the
    first pass recorded at that call (the collectives' order is the same on
    every rank, and no denominator depends on an earlier one)."""

    def __init__(self):
        self.seen, self.calls = {}, None

    def __call__(self, t, mesh):
        if self.calls is None:
            self.seen.setdefault(mesh.rank, []).append(t.detach().clone())
            return t
        i = self.calls[mesh.rank]
        self.calls[mesh.rank] += 1
        return sum(v[i] for _, v in sorted(self.seen.items()))


def _ranks(monkeypatch, shape, run):
    """``run(mesh)`` for every rank of a ``shape`` mesh with the collectives
    summed in this process; returns the ranks' results."""
    fake = _InProcessSum()
    monkeypatch.setattr(mesh_lib, "global_sum", fake)
    meshes = [Mesh(*shape, rank=r, distributed=True) for r in range(shape[0] * shape[1])]
    with torch.no_grad():
        for m in meshes:
            run(m)
    fake.calls = {m.rank: 0 for m in meshes}
    return [run(m) for m in meshes]


def _local(a, mesh):
    """This rank's rows, and its share of the references on axis 1."""
    a = shard_batch({"a": a}, mesh)["a"]
    return a[:, ref_slice(a.shape[1], mesh)]


MESHES = [(2, 1), (4, 1), (1, 2), (1, 3), (2, 2)]
B, R, H, W = 4, 3, 16, 16


def _loss_inputs():
    """(B, R, H, W, C) predictions, targets and masks whose density differs
    by row and by reference (dense rows 0-1, sparse rows 2-3), a batch mask
    that leaves rows 2-3 out, and a frame with no error."""
    g = torch.Generator().manual_seed(0)
    y_hat, y = torch.rand(B, R, H, W, 3, generator=g), torch.rand(B, R, H, W, 3, generator=g)
    density = torch.tensor([0.5, 0.4, 0.05, 0.02])[:, None, None, None, None] \
        * torch.tensor([1.0, 0.5, 1.5])[None, :, None, None, None]
    mask = (torch.rand(B, R, H, W, 1, generator=g) < density).float()
    y_hat[0, 0] = y[0, 0]
    return y_hat, y, mask, torch.tensor([True, True, False, False])


def _fold(a):
    return a.reshape(-1, *a.shape[2:])


LOSS_CASES = {
    "masked_l1_sum": lambda yh, y, m, bm, red: losses.masked_l1(yh, y, m, reduction="sum", weight=0.5,
                                                                reduce=red),
    "masked_l1_mean": lambda yh, y, m, bm, red: losses.masked_l1(yh, y, m, reduce=red),
    "masked_l1_batch_mask": lambda yh, y, m, bm, red: losses.masked_l1(yh, y, m, batch_mask=bm,
                                                                       reduce=red),
    "perceptual": lambda yh, y, m, bm, red: losses.perceptual([yh, yh[..., :2] * m], [y, y[..., :2]],
                                                              weight=0.5, reduce=red),
    "grad": lambda yh, y, m, bm, red: losses.grad(_fold(yh), _fold(y), reduce=red),
    "psnr": lambda yh, y, m, bm, red: measures.psnr(_fold(yh), _fold(y), reduce=red),
    "ssim": lambda yh, y, m, bm, red: measures.ssim(_fold(yh), _fold(y), reduce=red),
}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_rank_losses_sum_to_the_whole_batch(monkeypatch, case, shape):
    """Each loss and measure: the ranks' values sum to the one-process value
    (f32, rtol 1e-6), rows and references split unevenly as they come
    (3 references over 2 model ranks: 2 and 1); under a 2- or 4-way row
    split a rank's rows carry no batch-masked row."""
    fn = LOSS_CASES[case]
    yh, y, m, bm = _loss_inputs()
    want = fn(yh, y, m, bm, None)

    def run(mesh):
        local_bm = shard_batch({"bm": bm}, mesh)["bm"]
        return fn(_local(yh, mesh), _local(y, mesh), _local(m, mesh), local_bm, reducer(mesh))

    got = _ranks(monkeypatch, shape, run)
    np.testing.assert_allclose(sum(g.item() for g in got), want.item(), rtol=1e-6)


def test_naive_mean_of_rank_losses_differs():
    """Where the two data ranks' masks differ in density, the mean of their
    losses, each over its own denominator (what averaging per-rank losses
    computes), is not the whole batch's loss; the rule's sum is."""
    yh, y, m, _ = _loss_inputs()
    want = losses.masked_l1(yh, y, m, reduction="sum").item()
    halves = [losses.masked_l1(yh[s], y[s], m[s], reduction="sum").item()
              for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(halves) - want) > 0.05 * want
    dense, sparse = m[:2].mean().item(), m[2:].mean().item()
    assert dense > 5 * sparse


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (1, 3), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_chn_loss_items_and_grads_sum_to_the_whole_batch(monkeypatch, shape):
    """The five-part CHN loss (perceptual with its gradient on, so every
    term carries one): each item and the total summed over the ranks equals
    the one-process one, and the ranks' grads w.r.t. ``y_hat`` (each on its
    rows and references) are the one-process grad. Each item is a sum over
    references, so no term is counted once a model rank: a term that did
    not depend on the references would be counted ``model`` times here."""
    g = torch.Generator().manual_seed(1)
    b, r, hw = 4, 3, 32
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(2)).requires_grad_(False)
    y_t = torch.rand(b, hw, hw, 3, generator=g)
    v_t = (torch.rand(b, hw, hw, 1, generator=g) > torch.tensor([0.2, 0.3, 0.9, 0.95])[:, None, None, None]).float()
    v_map = (torch.rand(b, r, hw, hw, 1, generator=g) > 0.7).float() * (1 - v_t[:, None])
    y_hat = torch.rand(b, r, hw, hw, 3, generator=g).requires_grad_(True)

    def loss(yh, yt, vt, vm, red):
        comp = vt[:, None] * yt[:, None] + (1 - vt[:, None]) * yh
        return chn_task.compute_loss(yt, vt, yh, comp, vm, vgg, perceptual_grad=True, reduce=red)

    want_total, want_items = loss(y_hat, y_t, v_t, v_map, None)
    want_grad, = torch.autograd.grad(want_total, y_hat)

    def run(mesh):
        rows = shard_batch({"yt": y_t, "vt": v_t}, mesh)
        return loss(_local(y_hat, mesh), rows["yt"], rows["vt"], _local(v_map, mesh), reducer(mesh))

    got = _ranks(monkeypatch, shape, run)
    for k in chn_task.LOSSES_NAMES:
        np.testing.assert_allclose(sum(items[k].item() for _, items in got), want_items[k].item(),
                                   rtol=1e-6, err_msg=k)
    total = sum(t for t, _ in got)
    np.testing.assert_allclose(total.item(), want_total.item(), rtol=1e-6)
    got_grad, = torch.autograd.grad(total, y_hat)
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-5, atol=1e-9)


def _dfpn_inputs(b, f, hw, seed=0):
    """A batch with masks of different density by row, smooth flows that
    leave the frame in places, and ``flows_use`` on the first half of the
    rows only (a row split leaves a rank without a supervised flow)."""
    rng = np.random.RandomState(seed)
    y = rng.rand(b, f, hw, hw, 3).astype(np.float32)
    dens = np.linspace(0.3, 0.02, b)[:, None, None, None, None]
    m = (rng.rand(b, f, hw, hw, 1) < dens).astype(np.float32)
    x = (1 - m) * y
    flow = identity_grid(hw, hw).numpy()[None, None] + rng.uniform(-0.15, 0.15, (b, f, 1, 1, 2))
    flows_use = np.arange(b) < b // 2
    return [torch.from_numpy(np.asarray(a)) for a in (x, m, y, flow.astype(np.float32), flows_use)]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_dfpn_loss_items_and_grads_sum_to_the_whole_batch(monkeypatch, shape):
    """The six-part DFPN loss: each item and the total summed over the
    ranks equals the one-process one (rtol 1e-6; the corr loss's features
    come from convs over other batch sizes, so 2e-6 there), and so do the
    parameter grads, the ranks' summed: rtol 1e-4, atol 1e-6 of the largest
    grad (flow_256's first convs carry grads ~1e-6 of it, where the convs'
    rounding over other batch sizes reads up to 6e-4 of themselves, 2.5e-9
    absolute)."""
    net = DFPN(base_size=DFPN_BASE, device="cpu", generator=torch.Generator().manual_seed(DFPN_SEED))
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(2)).requires_grad_(False)
    batch = _dfpn_inputs(4, 3, DFPN_HW)
    want_total, want_items = dfpn_task.forward_and_loss(net, vgg, *batch)
    want_grads = torch.autograd.grad(want_total, list(net.parameters()))

    def run(mesh):
        local = shard_batch(dict(enumerate(batch)), mesh)
        return dfpn_task.forward_and_loss(net, vgg, *(local[i] for i in range(5)), mesh=mesh)

    got = _ranks(monkeypatch, shape, run)
    for k in dfpn_task.LOSSES_NAMES:
        np.testing.assert_allclose(sum(items[k].item() for _, items in got), want_items[k].item(),
                                   rtol=2e-6 if k == "corr_loss" else 1e-6, err_msg=k)
    total = sum(t for t, _ in got)
    np.testing.assert_allclose(total.item(), want_total.item(), rtol=1e-6)
    atol = 1e-6 * max(b.abs().max().item() for b in want_grads)
    for a, b in zip(torch.autograd.grad(total, list(net.parameters())), want_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


# --------------------------------------------------------- the loader shard


def test_loader_shard_equals_shard_batch(tmp_path):
    """``Loader(shard=(r, d))`` gives ``shard_batch`` of the whole batch bit
    for bit, train and validation, and decodes only its rows."""
    from master_thesis_tpu_torch.data import meta
    from master_thesis_tpu_torch.train.build import build_loaders
    from tests.fixtures import make_fake_data_root

    root = make_fake_data_root(str(tmp_path / "data"))
    cfg = Config(data_path=root, data_ckpt_path=str(tmp_path / "d.ckpt"), train_size=(56, 56),
                 frames_n=3, batch_size=4, train_max_iterations=2, validation_max_iterations=1,
                 min_mask_size=0.0, max_mask_size=1.0, num_workers=0, seed=3, p_simulator_bgs=0.5,
                 device="cpu")
    metas = meta.prepare_data(cfg)
    whole = {k: list(v) for k, v in build_loaders(cfg, metas).items()}
    keys = ("x", "m", "y", "flow_gt", "m_movement", "flows_use")
    for d in (2, 4):
        for r in range(d):
            part = build_loaders(cfg, metas, shard=(r, d))
            for split, loader in part.items():
                got = list(loader)
                assert len(got) == len(whole[split])
                for g, w in zip(got, whole[split]):
                    want = shard_batch(w, Mesh(d, 1, r))
                    rows = slice(r * 4 // d, (r + 1) * 4 // d)
                    for k in keys:
                        assert g[k].shape[0] == 4 // d
                        np.testing.assert_array_equal(g[k], want[k], err_msg=k)
                    assert g["names"] == w["names"][rows] and g["indexes"] == w["indexes"][rows]
    with pytest.raises(ValueError, match="does not split evenly"):
        build_loaders(cfg, metas, shard=(0, 3))


# ------------------------------------------------------ spawned gloo ranks


@contextlib.contextmanager
def spawned(mode: str, world: int, workdir: Path, timeout: float = JOIN_TIMEOUT):
    """Starts ``world`` ranks of this file's ``mode`` (each ``python -m
    tests.test_torch_parallel``, a gloo group through a file in
    ``workdir``), runs the body meanwhile, then waits for the ranks: at most
    ``timeout`` seconds from their start, after which they are killed and
    the test fails; a rank's non-zero exit fails it with the rank's output."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_parallel", mode, str(r),
                               str(world), str(workdir)], cwd=_REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        yield
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" + \
            (workdir / f"rank{r}.log").read_text()[-6000:]


class Recorder:
    def __init__(self):
        self.scalars = []

    def log_scalars(self, scalars, step, prefix=""):
        self.scalars.append((prefix, step, {k: float(v) for k, v in scalars.items()}))

    def log_images(self, tag, images, step):
        pass

    def flush(self):
        pass


def _chn(sd):
    chn = CHN(nb=CHN_NB, nf=CHN_NF, gc=CHN_GC, device="cpu")
    chn.load_state_dict(sd)
    return chn


def _vgg(sd):
    vgg = VGGFeatures(device="cpu")
    vgg.load_state_dict(sd)
    return vgg.requires_grad_(False)


def _chn_loop(case, mesh, root, epochs, resume=None):
    """The Trainer over the case's 4 batches an epoch at k = 2 with a
    validation batch, from the case's weights or ``resume``; returns the
    state and the logger."""
    chn = _chn(case["chn"])
    vgg = _vgg(case["vgg"])
    st = state.create_train_state(chn, state.OptimConfig(lr=1e-3, accumulate_grad_batches=2),
                                  steps_per_epoch=4, mesh=mesh)
    if resume is not None:
        restore_train_state(st, resume)
    broadcast_params(chn, mesh)
    cfg = LoopConfig(max_epochs=epochs, default_root_dir=str(root), train_max_iterations=4,
                     validation_max_iterations=1)
    rec = Recorder()
    args = lambda b: (b["x"], b["m"], b["y"])
    Trainer(cfg, "chn", logger=rec, mesh=mesh).fit(
        st, chn_task.make_train_step(chn, identity_align, vgg, mesh=mesh), args,
        [shard_batch(b, mesh) for b in case["loop"]],
        eval_step=chn_task.make_eval_step(chn, identity_align, vgg, mesh=mesh), eval_args=args,
        val_loader=[shard_batch(case["val"], mesh)])
    return st, rec


def _chn_rank(rank, workdir):
    case = torch.load(workdir / "case.pt", weights_only=True)
    out = {}
    for data, model in ((2, 1), (1, 2)):
        mesh = make_mesh(data, model)
        chn, vgg = _chn(case["chn"]), _vgg(case["vgg"])
        st = state.create_train_state(chn, state.OptimConfig(lr=1e-3), steps_per_epoch=10, mesh=mesh)
        broadcast_params(chn, mesh)
        local = shard_batch(case["step"], mesh)
        items = chn_task.make_train_step(chn, identity_align, vgg, mesh=mesh)(
            st, local["x"], local["m"], local["y"])
        out[f"{data}x{model}"] = {"items": sum_scalars(items, mesh), "params": chn.state_dict()}
    mesh = make_mesh(2, 1)
    _, first = _chn_loop(case, mesh, workdir / "logs", epochs=1)
    # Every rank resumes from rank 0's file.
    st, second = _chn_loop(case, mesh, workdir / "logs", epochs=2,
                           resume=str(workdir / "logs" / "version_0" / "checkpoints" / "step_4.pt"))
    out["loop"] = {"params": st.model.state_dict(), "scalars": first.scalars + second.scalars}
    torch.save(out, workdir / f"out{rank}.pt")


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def test_chn_step_dp_and_sp_match_jax_unsharded_step(tmp_path):
    """Two gloo ranks, meshes 2x1 (rows) and 1x2 (references), one CHN
    step at lr 1e-3 from the same weights and batch: the summed loss within
    rtol 1e-5 of the JAX package's unsharded ``make_train_step``, every
    parameter within atol 1e-5 of its update, the two ranks' parameters
    bit-equal. Then the Trainer over two epochs of 4 micro-steps at k = 2
    on the 2x1 mesh, epoch 2 resumed from the checkpoint rank 0 alone
    wrote: its parameters within atol 1e-5 of one process's uninterrupted
    run, its logged training and validation items within rtol 1e-5, and one
    version directory, rank 0's, a run."""
    import jax
    import jax.numpy as jnp

    from master_thesis_tpu.config import Config as JaxConfig
    from master_thesis_tpu.models import convert as jconvert
    from master_thesis_tpu.models.chn import CHN as JaxCHN
    from master_thesis_tpu.models.vgg import VGGFeatures as JaxVGG
    from master_thesis_tpu.train import chn_task as jtask
    from master_thesis_tpu.train import state as jstate
    from master_thesis_tpu_torch.models.convert import chn_from_jax

    chn = CHN(nb=CHN_NB, nf=CHN_NF, gc=CHN_GC, device="cpu", generator=torch.Generator().manual_seed(0))
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(1)).requires_grad_(False)
    rng = np.random.RandomState(0)

    def batch(b):
        y = rng.rand(b, CHN_F, CHN_HW, CHN_HW, 3).astype(np.float32)
        m = (rng.rand(b, CHN_F, CHN_HW, CHN_HW, 1) > 0.8).astype(np.float32)
        return {"x": torch.from_numpy((1 - m) * y + m * 0.45), "m": torch.from_numpy(m),
                "y": torch.from_numpy(y)}

    case = {"chn": chn.state_dict(), "vgg": vgg.state_dict(), "step": batch(CHN_B),
            "loop": [batch(4) for _ in range(4)], "val": batch(4)}
    torch.save(case, tmp_path / "case.pt")
    with spawned("chn", 2, tmp_path):
        jchn = JaxCHN(nb=CHN_NB, nf=CHN_NF, gc=CHN_GC)
        jparams = {"params": jconvert.chn_from_torch({k: v.numpy() for k, v in case["chn"].items()},
                                                     nb=CHN_NB)}
        jvgg = {"params": jconvert.vgg16_from_torch({k: v.numpy() for k, v in case["vgg"].items()})}
        vgg_apply = lambda x, normalize_input=True: JaxVGG().apply(jvgg, x, normalize_input=normalize_input)
        with jax.default_matmul_precision("highest"):
            st = jstate.create_train_state(jchn.apply, jparams, JaxConfig(lr=1e-3), steps_per_epoch=10)
            st, items = jtask.make_train_step(jchn.apply, identity_align, vgg_apply, donate=False)(
                st, *(jnp.asarray(case["step"][k].numpy()) for k in "xmy"))
        want = chn_from_jax(_np_tree(st.params["params"]), nb=CHN_NB)
        # One process, two epochs uninterrupted.
        one, rec = _chn_loop(case, None, tmp_path / "one", epochs=2)

    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=True) for r in range(2)]
    for key in ("2x1", "1x2"):
        got = outs[0][key]
        np.testing.assert_allclose(got["items"]["loss"], float(items["loss"]), rtol=1e-5, err_msg=key)
        for k in chn_task.LOSSES_NAMES:
            np.testing.assert_allclose(got["items"][k], float(items[k]), rtol=1e-5, atol=1e-8,
                                       err_msg=f"{key} {k}")
        for k, v in got["params"].items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=f"{key} {k}")
            assert torch.equal(v, outs[1][key]["params"][k]), f"{key} {k}: ranks differ"

    loop = outs[0]["loop"]
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(loop["params"][k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
        assert torch.equal(loop["params"][k], outs[1]["loop"]["params"][k]), f"loop {k}: ranks differ"
    # Step 1's items and the validations after steps 4 and 8, logged by rank 0.
    want_logs = {(p, s): v for p, s, v in rec.scalars}
    assert [(p, s) for p, s, _ in loop["scalars"]] == list(want_logs) == \
        [("training/", 1), ("validation/", 4), ("validation/", 8)]
    assert outs[1]["loop"]["scalars"] == []
    for prefix, step, scalars in loop["scalars"]:
        assert scalars.keys() == want_logs[(prefix, step)].keys()
        for k, v in scalars.items():
            if k != "step_time_s":
                np.testing.assert_allclose(v, want_logs[(prefix, step)][k], rtol=1e-5,
                                           err_msg=f"{prefix}{k} at {step}")
    ckpts = sorted(p.relative_to(tmp_path / "logs").as_posix()
                   for p in (tmp_path / "logs").glob("version_*/checkpoints/*.pt"))
    assert ckpts == ["version_0/checkpoints/step_4.pt", "version_1/checkpoints/step_8.pt"]


def _dfpn_rank(rank, workdir):
    case = torch.load(workdir / "case.pt", weights_only=True)
    mesh = make_mesh(2, 2)
    net = DFPN(base_size=DFPN_BASE, device="cpu")
    net.load_state_dict(case["dfpn"])
    vgg = _vgg(case["vgg"])
    st = state.create_train_state(net, state.OptimConfig(lr=1e-3), steps_per_epoch=10, mesh=mesh)
    broadcast_params(net, mesh)
    grads = {}
    # After the grads' all-reduce, before Adam: the step's global grads.
    st.optimizer.register_step_pre_hook(
        lambda *_: grads.update({k: p.grad.clone() for k, p in net.named_parameters()}))
    local = shard_batch(dict(enumerate(case["batch"])), mesh)
    items = dfpn_task.make_train_step(net, vgg, mesh=mesh)(st, *(local[i] for i in range(5)))
    torch.save({"items": sum_scalars(items, mesh), "grads": grads, "params": net.state_dict()},
               workdir / f"out{rank}.pt")


def test_dfpn_step_dp_sp_matches_jax_grad_of_unsharded_loss(tmp_path):
    """Four gloo ranks, mesh 2x2 (2 rows x 1 reference each), one DFPN step:
    the summed loss within rtol 1e-5 of the JAX package's unsharded
    ``forward_and_loss``, the all-reduced grads within atol 1e-4 / rtol
    1e-3 of its ``jax.grad`` (as tests/test_parallel.py holds the JAX
    sharded step), and every rank's grads and parameters bit-equal."""
    import jax
    import jax.numpy as jnp

    from master_thesis_tpu.models import convert as jconvert
    from master_thesis_tpu.models import dfpn as jdfpn
    from master_thesis_tpu.models.vgg import VGGFeatures as JaxVGG
    from master_thesis_tpu.train import dfpn_task as jtask
    from master_thesis_tpu_torch.models.convert import dfpn_from_jax

    net = DFPN(base_size=DFPN_BASE, device="cpu", generator=torch.Generator().manual_seed(DFPN_SEED))
    vgg = VGGFeatures(device="cpu", generator=torch.Generator().manual_seed(2)).requires_grad_(False)
    batch = _dfpn_inputs(DFPN_B, DFPN_F, DFPN_HW, seed=1)
    torch.save({"dfpn": net.state_dict(), "vgg": vgg.state_dict(), "batch": batch}, tmp_path / "case.pt")
    with spawned("dfpn", 4, tmp_path):
        module = jdfpn.DFPN(dtype=jnp.float32, base_size=DFPN_BASE)
        params = {"params": jconvert.dfpn_from_torch(net.state_dict())}
        vgg_params = {"params": jconvert.vgg16_from_torch({k: v.numpy() for k, v in vgg.state_dict().items()})}

        def loss_fn(p, vgg_p, *arrays):
            vgg_apply = lambda x, normalize_input=True: JaxVGG().apply(
                vgg_p, x, normalize_input=normalize_input)
            return jtask.forward_and_loss(module.apply, p, vgg_apply, *arrays, base_size=DFPN_BASE)

        with jax.default_matmul_precision("highest"):
            (total, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                params, vgg_params, *(jnp.asarray(a.numpy()) for a in batch))
        want = dfpn_from_jax(_np_tree(jgrads["params"]))

    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=True) for r in range(4)]
    np.testing.assert_allclose(outs[0]["items"]["loss"], float(total), rtol=1e-5)
    for k, g in outs[0]["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4, rtol=1e-3, err_msg=k)
    for r in range(1, 4):
        assert outs[r]["items"] == outs[0]["items"]
        for part in ("grads", "params"):
            for k, v in outs[0][part].items():
                assert torch.equal(outs[r][part][k], v), f"rank {r} {part} {k}"


def _cli_rank(rank, workdir):
    from master_thesis_tpu_torch.__main__ import main

    argv = json.loads((workdir / "argv.json").read_text())
    st = main(argv, logger=Recorder())
    torch.save({"params": st.model.state_dict(), "step": st.step}, workdir / f"out{rank}.pt")


def _child(mode, rank, world, workdir):
    rank, workdir = int(rank), Path(workdir)
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{workdir / 'rendezvous'}", rank=rank,
                     world_size=int(world))
    try:
        {"chn": _chn_rank, "dfpn": _dfpn_rank, "cli": _cli_rank}[mode](rank, workdir)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(*sys.argv[1:])
