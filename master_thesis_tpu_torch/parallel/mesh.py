"""Data and sequence parallelism over a ``(data, model)`` mesh of processes
(master_thesis_tpu/parallel/mesh.py: make_mesh, batch_sharding, replicated,
shard_batch).

The JAX package lays its devices out as ``devices.reshape(data, model)``
and lets XLA's SPMD partitioner insert the collectives: the batch is
sharded over ``data``, the ``(B, F-1)`` reference stacks over ``(data,
model)`` (sequence parallelism: each reference is aligned and inpainted
independently of the others), and the step computes the loss of the whole
batch. Here each device is one process of a ``torch.distributed`` group
(NCCL on the card, gloo on the CPU), laid out the same way, row-major:
``rank = data_rank * model + model_rank``. A process holds its data rank's
rows of the batch (:func:`shard_batch`) and its model rank's share of the
references (:func:`ref_slice`); the collectives are explicit and there are
three kinds, all ``all_reduce`` / ``broadcast``:

- the denominators of the losses and measures, summed over the world
  (:func:`global_sum`), so that each rank's loss is its local numerator
  over the global denominator and the sum of the ranks' losses is the loss
  of the whole batch (a mean of per-rank ratios is not the ratio of the
  sums where the ranks' masks differ in density);
- the gradients, summed over the world once an update
  (:func:`all_reduce_grads`, one flat f32 buffer), so every rank applies
  the same update and the parameters stay bit-identical across ranks;
- the parameters, broadcast from rank 0 after a build or a restore
  (:func:`broadcast_params`, JAX's ``replicated``), and the logged scalars
  (:func:`sum_scalars`).

Without a process group (and ``WORLD_SIZE`` unset or 1) the mesh is 1x1 and
no collective is ever issued.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from master_thesis_tpu_torch.device import resolve_device


def launched_world_size() -> int:
    """The number of processes of this run: the process group's size, else
    the launcher's ``WORLD_SIZE`` (``torchrun`` sets it), else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(
    device, backend: Optional[str] = None, init_method: Optional[str] = None,
    rank: Optional[int] = None, world_size: Optional[int] = None,
) -> torch.device:
    """Joins this process to the run's process group and returns its device.

    ``rank`` and ``world_size`` default to the launcher's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``); a ``file://`` path or a ``tcp://`` address may be
    given instead. A ``cuda`` device without an index is
    ``cuda:{LOCAL_RANK}``, and becomes the current device. ``backend=None``
    is NCCL for ``cuda`` and gloo for ``cpu``; gloo on ``cuda`` puts several
    ranks on one card, which NCCL refuses (its collectives stage through
    host memory, :func:`_all_reduce`). A failure to join raises: nothing
    retries on another backend or device.
    """
    dev = torch.device(device)
    if rank is None or world_size is None:
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed: {', '.join(missing)} not set; launch with torchrun "
                               "or pass rank and world_size")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        resolve_device(dev)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kwargs)
    return dev


def mesh_shape(data: int, model: int, world: int) -> Tuple[int, int]:
    """``(data, model)`` of a mesh over ``world`` processes, with the JAX
    ``make_mesh``'s rules: ``data=-1`` takes ``world // model``, and a mesh
    larger than the world raises. A mesh smaller than the world raises too:
    every process holds a place in it."""
    if model < 1 or data == 0 or data < -1:
        raise ValueError(f"mesh {data}x{model}: the axes are positive (data may be -1)")
    if data == -1:
        if world % model != 0:
            raise ValueError(f"{world} devices not divisible by model={model}")
        data = world // model
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} needs more than {world} devices")
    if data * model < world:
        raise ValueError(f"mesh {data}x{model} leaves {world - data * model} of {world} processes "
                         "without a place")
    return data, model


@dataclass(frozen=True)
class Mesh:
    """This process's place in the ``(data, model)`` mesh.

    ``distributed``: whether collectives are issued (a process group
    exists); a mesh made by hand without one is for arithmetic that needs
    only the layout (:func:`shard_batch`, :func:`ref_slice`).
    ``data_group`` / ``model_group``: the process groups of this rank's data
    column (the ranks of its model rank) and model row (the ranks of its
    data rank). ``device``: where the collectives' own buffers live (the
    card with NCCL, the host with gloo)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    distributed: bool = False
    backend: Optional[str] = None
    device: torch.device = torch.device("cpu")
    data_group: Any = None
    model_group: Any = None

    def __post_init__(self):
        if not 0 <= self.rank < self.data * self.model:
            raise ValueError(f"rank {self.rank} is outside the {self.data}x{self.model} mesh")

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh of this run's process group, ``devices.reshape(data,
    model)`` row-major as in JAX. Without a process group it is the 1x1
    mesh, and ``WORLD_SIZE > 1`` raises (join the group first:
    :func:`init_distributed`)."""
    if not (dist.is_available() and dist.is_initialized()):
        world = launched_world_size()
        if world > 1:
            raise RuntimeError(f"WORLD_SIZE={world} but this process has joined no process group; "
                               "call parallel.init_distributed first")
        mesh_shape(data, model, 1)
        return Mesh()
    data, model = mesh_shape(data, model, dist.get_world_size())
    rank = dist.get_rank()
    # Every rank creates every group, in the same order (new_group is a
    # collective of the whole world).
    cols = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    rows = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    backend = dist.get_backend()
    device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" \
        else torch.device("cpu")
    return Mesh(data, model, rank, True, backend, device, cols[rank % model], rows[rank // model])


def _rows(n: int, mesh: Mesh) -> slice:
    if n % mesh.data != 0:
        raise ValueError(f"a batch of {n} does not split evenly over {mesh.data} data ranks")
    per = n // mesh.data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(batch: dict, mesh: Optional[Mesh]) -> dict:
    """This data rank's contiguous rows of every array leaf of ``batch``
    (numpy arrays or tensors; JAX's ``device_put`` with ``P("data")``);
    other leaves (names, indexes) pass through. A batch that does not split
    evenly raises."""
    if mesh is None or mesh.data == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1:
            out[k] = v[_rows(v.shape[0], mesh)]
        else:
            out[k] = v
    return out


def ref_slice(refs_n: int, mesh: Optional[Mesh]) -> slice:
    """This model rank's contiguous share of ``refs_n`` references, in
    ``torch.tensor_split`` order (the first ``refs_n % model`` ranks hold
    one more); JAX's ``P("data", "model")`` on the ``(B, F-1)`` stacks. A
    rank left without a reference raises."""
    if mesh is None or mesh.model == 1:
        return slice(0, refs_n)
    per, extra = divmod(refs_n, mesh.model)
    r = mesh.model_rank
    start = r * per + min(r, extra)
    stop = start + per + (r < extra)
    if stop == start:
        raise ValueError(f"model rank {r} of {mesh.model} holds none of {refs_n} references")
    return slice(start, stop)


def _staged(op: Callable[[torch.Tensor], Any], t: torch.Tensor, mesh: Mesh) -> None:
    """Runs the collective ``op`` on ``t`` in place. With gloo a card tensor
    goes through a pinned host buffer: that backend is how several ranks
    share one card, and its collectives run on the host."""
    if mesh.backend == "gloo" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        op(host)
        t.copy_(host)
    else:
        op(t)


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> None:
    """Sums ``t`` over the world in place."""
    _staged(dist.all_reduce, t, mesh)


def _flat(tensors, op: Callable[[torch.Tensor], None]) -> None:
    """Runs ``op`` in place on one flat buffer holding ``tensors`` (of one
    dtype), then copies the result back into each."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


def global_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` (a denominator: a mask sum or an element count, no grad)
    summed over the world; ``t`` itself where no collective is issued."""
    if mesh is None or not mesh.distributed:
        return t
    out = t.detach().clone()
    _all_reduce(out, mesh)
    return out


def reducer(mesh: Optional[Mesh]) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The ``reduce`` argument of the losses and measures for ``mesh``:
    :func:`global_sum` over it, or None (the one-process arithmetic) where
    no collective is issued."""
    if mesh is None or not mesh.distributed:
        return None
    # Looked up at each call, so a test can stand in for the collective.
    return lambda t: global_sum(t, mesh)


def all_reduce_grads(params: Iterable[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sums the ``grad`` of every parameter that has one over the world, in
    place: one collective over one flat f32 buffer. Every rank must hold
    grads for the same parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh is None or not mesh.distributed or not grads:
        return
    _flat(grads, lambda flat: _all_reduce(flat, mesh))


def broadcast_params(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Gives every rank rank 0's parameters and buffers (JAX's
    ``replicated``), one collective a dtype, and drops every packed copy of
    the weights (``repack``). Run after a build or a restore."""
    if mesh is None or not mesh.distributed:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            _flat([t for t in tensors if t.dtype == dtype],
                  lambda flat: _staged(lambda t: dist.broadcast(t, 0), flat, mesh))
    for m in module.modules():
        if hasattr(m, "repack"):
            m.repack()


def sum_scalars(values: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, float]:
    """``values`` (0-dim tensors or numbers) as floats, each summed over the
    world in one collective: the logged loss items, which are each rank's
    contribution to the whole batch's."""
    if mesh is None or not mesh.distributed or not values:
        return {k: float(v) for k, v in values.items()}
    buf = torch.stack([torch.as_tensor(v).detach().to(mesh.device, torch.float64).reshape(())
                       for v in values.values()])
    _all_reduce(buf, mesh)
    return dict(zip(values, buf.tolist()))


def barrier(mesh: Optional[Mesh]) -> None:
    """Waits for every rank (after rank 0 writes what the others read)."""
    if mesh is not None and mesh.distributed:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()
