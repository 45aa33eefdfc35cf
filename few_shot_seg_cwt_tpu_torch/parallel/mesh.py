"""Data parallelism over episodes with ``torch.distributed``.

Counterpart of ``few_shot_seg_cwt_tpu.parallel.mesh``. The JAX package
shards the episode batch over a device mesh and lets ``jit`` insert the
collectives; the reference trains with NCCL DDP (src/train_ddp.py:358-366).
The port does what the reference does, by hand:

* one process per card, started by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); ``distributed_init``
  joins the group and binds the process to ``cuda:LOCAL_RANK``;
* parameters replicated by a broadcast from rank 0 (``broadcast_module``,
  the counterpart of ``replicate``);
* every step's gradients averaged over the ranks by one all-reduce of one
  flat buffer (``all_reduce_grads``): the losses are means over the global
  batch, and each rank holds an equal slice of it, so the mean of the
  ranks' gradients is the gradient of the global batch;
* each rank loads its own slice (``train.common``); per-episode outputs
  come back to every rank in rank order through ``to_host``, the
  counterpart of ``process_allgather(tiled=True)``.

Every gather is an all-reduce into a zero-filled (world, ...) buffer on the
tensor's own device (``gather_rows``): gloo takes only ``broadcast`` and
``all_reduce`` on CUDA tensors, so one code path serves gloo on the CPU,
gloo on the card and NCCL. Adding zeros is exact, so the gather is too.

Without a process group (no ``WORLD_SIZE`` in the environment) every
function here is the single-process identity and the port runs as it
always did. ``make_mesh``, ``data_sharding``, ``replicated_sharding``,
``shard_batch`` and ``replicate`` have no counterpart: the mesh is the
process group, one data axis of ``WORLD_SIZE`` cards, and a batch is
sharded by each rank loading its own slice. A ``mesh_shape`` other than
``[WORLD_SIZE]`` or more than one ``mesh_axes`` entry raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def active() -> bool:
    """Is this process in a process group?"""
    return dist.is_available() and dist.is_initialized()


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if active():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """True on the rank that writes logs and checkpoints (rank 0)."""
    return rank_world()[0] == 0


def check_mesh(cfg, world: int) -> None:
    """Refuse mesh settings the port cannot run: one data axis over every
    process (``mesh_shape`` ``[world]`` or unset)."""
    if cfg is None:
        return
    axes = cfg.get("mesh_axes") or ["data"]
    if len(axes) > 1:
        raise ValueError(f"mesh_axes {list(axes)}: the port runs one data axis "
                         "(one process per card)")
    shape = cfg.get("mesh_shape")
    if shape and (len(shape) != 1 or int(shape[0]) != world):
        raise ValueError(f"mesh_shape {list(shape)}: the port's mesh is one data axis of "
                         f"WORLD_SIZE = {world} processes, so it must be [{world}] or unset")


def distributed_init(cfg=None, backend: Optional[str] = None, device="cuda",
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group that ``torchrun`` describes in the environment
    and return the device this rank runs on.

    Without ``WORLD_SIZE`` in the environment nothing is joined and
    ``device`` comes back as given; ``multi_host`` or ``distributed`` in the
    config then raises, since a run meant for several processes must not
    quietly train on one. With it, ``RANK`` and ``LOCAL_RANK`` are read; a
    CUDA device without an index becomes ``cuda:LOCAL_RANK``, which must
    exist (it raises otherwise: ranks never share a card unless the caller
    names one, ``"cuda:0"``); ``backend`` None is ``nccl`` on a CUDA device
    and ``gloo`` on the CPU; ``init_method`` None is ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``). ``FSS_DIST_DEVICE`` and
    ``FSS_DIST_BACKEND`` in the environment, where set, name the device and
    the backend instead (every rank on one card: ``FSS_DIST_DEVICE=cuda:0
    FSS_DIST_BACKEND=gloo``, since NCCL refuses two ranks on one card).
    Idempotent: a second call returns the device bound by the first.
    """
    device = torch.device(device)
    if active():
        if device.type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return device
    world = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if world <= 0:
        if cfg is not None and (cfg.get("multi_host") or cfg.get("distributed")):
            raise ValueError("multi_host / distributed is set but WORLD_SIZE is not: launch "
                             "with torchrun --nproc_per_node N -m <entry point>")
        check_mesh(cfg, 1)
        return device
    check_mesh(cfg, world)
    if "RANK" not in os.environ:
        raise ValueError(f"WORLD_SIZE={world} without RANK: start the processes with "
                         "torchrun --nproc_per_node N -m <entry point>")
    device = torch.device(os.environ.get("FSS_DIST_DEVICE") or device)
    backend = backend or os.environ.get("FSS_DIST_BACKEND") or None
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device; pass device='cpu'")
        index = local if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} (LOCAL_RANK {local}) needs cuda:{index}, but "
                               f"{torch.cuda.device_count()} card(s) are visible: start at "
                               "most one process per card")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world, **kwargs)
    return device


def shutdown() -> None:
    """Leave the process group, if any (the end of an entry point)."""
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def _reduce_device(t: torch.Tensor) -> torch.device:
    """Where ``t`` is reduced: its own device, but the bound card for a host
    tensor under NCCL (which reduces CUDA tensors only)."""
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` itself without
    a group)."""
    if not active():
        return t
    out = t.to(_reduce_device(t), copy=True)
    dist.all_reduce(out)
    return out.to(t.device)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Each rank's ``t`` (equal shapes), joined along the leading axis in
    rank order on every rank; a 0-d ``t`` gives a (world,) tensor. An
    all-reduce into a zero-filled (world, ...) buffer on ``t``'s device."""
    if not active():
        return t if t.ndim else t[None]
    rank, world = rank_world()
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    buf = src.new_zeros((world,) + tuple(src.shape), device=_reduce_device(t))
    buf[rank] = src
    dist.all_reduce(buf)
    buf = buf.to(device=t.device, dtype=t.dtype)
    return buf.reshape((world * t.shape[0],) + tuple(t.shape[1:])) if t.ndim else buf


def to_host(tree: Any) -> Any:
    """Per-rank (E_local, ...) outputs gathered in rank order to host numpy
    arrays on every rank (``process_allgather(tiled=True)``); a scalar
    becomes a (world,) array. Without a group: each leaf to numpy."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if torch.is_tensor(tree):
        out = gather_rows(tree.detach()) if active() else tree.detach()
        return out.cpu().numpy()
    return np.asarray(tree)


def _flat_groups(tensors: Iterable[torch.Tensor]) -> Dict[Tuple, list]:
    groups: Dict[Tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Replace every parameter and buffer of ``module`` by rank ``src``'s,
    one flat broadcast per dtype (the counterpart of ``replicate``)."""
    if not active():
        return
    tensors = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for group in _flat_groups(tensors).values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> int:
    """Average the gradients of ``params`` over the ranks in place: one
    all-reduce of one flat buffer per dtype, which also carries a flag per
    parameter. A parameter without a gradient on every rank keeps none; one
    that has it on some ranks only counts zeros for the others. Returns the
    bytes reduced (0 without a group)."""
    if not active():
        return 0
    world = rank_world()[1]
    params = [p for p in params if p.requires_grad]
    nbytes = 0
    with torch.no_grad():
        for (dtype, device), group in _flat_groups(params).items():
            parts = [p.grad.reshape(-1) if p.grad is not None
                     else torch.zeros(p.numel(), dtype=dtype, device=device) for p in group]
            flags = torch.tensor([p.grad is not None for p in group], dtype=dtype,
                                 device=device)
            flat = torch.cat(parts + [flags])
            dist.all_reduce(flat)
            nbytes += flat.numel() * flat.element_size()
            counts = flat[-len(group):].tolist()
            offset = 0
            for p, count in zip(group, counts):
                view = flat[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
                if count > 0:
                    p.grad = view / world
    return nbytes


def check_replicas(module: torch.nn.Module, *states: torch.Tensor) -> None:
    """Raise unless every rank holds the same parameters and buffers of
    ``module`` (and the same ``states``, such as the state of a generator
    that every rank draws alike): per tensor the float64 sum and sum of
    squares, and each state itself, gathered from every rank and compared
    exactly. Equal averaged gradients and equal optimizer states keep the
    replicas equal bit for bit; a rank that did not resume, or drew other
    inits, shows here."""
    if not active():
        return
    with torch.no_grad():
        sums = [torch.stack([t.double().sum(), t.double().square().sum()])
                for t in list(module.parameters()) + list(module.buffers())
                if t.is_floating_point()]
        rows = [gather_rows(torch.stack(sums)[None])]
        rows += [gather_rows(s.to(torch.int32)[None]) for s in states]
    for name, gathered in zip(["parameters"] + [f"state {i}" for i in range(len(states))],
                              rows):
        for r in range(1, gathered.shape[0]):
            if not torch.equal(gathered[r], gathered[0]):
                raise RuntimeError(f"rank {r}'s {name} differ from rank 0's: the replicas "
                                   "have diverged")
