"""Data-parallel meshes over ``torch.distributed``.

Counterpart of ``motionmixerconv_tpu/parallel/mesh.py``. The JAX package
runs one controller over a 1-D device mesh: batches sharded on its 'data'
axis, parameters replicated, and XLA inserts the all-reduces. The port
runs one process a rank (``launch``) and says where the collectives go:

- a trainer (``train.Trainer(mesh=)``) takes the contiguous rows
  ``[r*B/n, (r+1)*B/n)`` of every global batch (``batch_sharding``), sums
  the gradients with one all-reduce and steps every rank alike from rank
  0's parameters (``replicated_sharding``); BatchNorm and Dropout take the
  global batch (``models/common.py``), so a run on n ranks computes what
  one rank computes on the whole batch;
- a ``Predictor(mesh=)`` spreads a bulk batch over ``mesh.devices`` in one
  process (``make_mesh`` outside a process group) and needs no
  collective.

Only ``broadcast`` and ``all_reduce`` are used: they are gloo's
collectives on CUDA tensors as well as NCCL's, so the cross-rank
semantics can be exercised by several gloo ranks on one card.

The models are small (< 5M parameters): data parallelism is the one axis
that carries load, as in the JAX package.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


@dataclass
class DataMesh:
    """A 1-D data-parallel mesh.

    ``group``: the process group of the ranks (None for one process);
    ``rank`` and ``size``: this process's place in it; ``devices``: this
    rank's device (a trainer's mesh) or, for one process, the devices a
    ``Predictor`` spreads a bulk batch over.
    """

    group: Optional[Any]
    rank: int
    size: int
    devices: List[torch.device] = field(default_factory=list)

    @property
    def device(self) -> torch.device:
        """The device of this rank."""
        return self.devices[0]

    @property
    def backend(self) -> Optional[str]:
        """'nccl', 'gloo' or None (one process, no collectives)."""
        return None if self.group is None else dist.get_backend(self.group)

    def rows(self, batch: int) -> slice:
        """This rank's contiguous rows of a global batch of ``batch``."""
        if batch % self.size:
            raise ValueError(
                f"the batch of {batch} rows does not divide over the mesh's "
                f"{self.size} ranks")
        n = batch // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_autograd(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, with a backward that sums the
        gradient over the ranks (each rank's loss reads the sum)."""
        if self.group is None:
            return t
        return _AllReduceSum.apply(t, self.group)

    def all_reduce_grads(self, params: Sequence[nn.Parameter]) -> None:
        """Sum the gradients of ``params`` over the ranks as one flat
        buffer (not DDP's mean: each rank's loss is already divided by the
        global weight sum)."""
        grads = [p.grad for p in params if p.grad is not None]
        if self.group is None or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def broadcast(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` with rank 0's, in place."""
        if self.group is None:
            return
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=dist.get_global_rank(self.group, 0),
                               group=self.group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def make_mesh(devices: Optional[Sequence] = None) -> DataMesh:
    """Inside an initialised process group: its mesh, one rank a device,
    the rank's device ``devices[0]`` where given, else
    ``cuda:<LOCAL_RANK>`` (the rank when ``LOCAL_RANK`` is unset).
    Outside one: a one-process mesh over ``devices`` (default every
    visible CUDA device), the kind ``Predictor(mesh=)`` spreads its bulk
    batches over."""
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        if devices is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            devices = [f"cuda:{local}"]
        return DataMesh(dist.group.WORLD, rank, dist.get_world_size(),
                        [torch.device(devices[0])])
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if not devices:
        raise RuntimeError(
            "make_mesh: torch sees no CUDA device; pass devices=['cpu', ...]")
    devices = [torch.device(d) for d in devices]
    return DataMesh(None, 0, len(devices), devices)


def batch_sharding(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of the global batch ``x`` (axis 0): the
    JAX package's ``P('data')`` placement of a batch."""
    return x[mesh.rows(x.shape[0])]


def replicated_sharding(mesh: DataMesh, module: nn.Module) -> nn.Module:
    """``module``'s parameters and buffers overwritten with rank 0's on
    every rank: the JAX package's replicated placement of parameters."""
    mesh.broadcast([*module.parameters(), *module.buffers()])
    return module


def _rank_main(rank: int, fn: Callable, nprocs: int, backend: str,
               device: str, init: str, out_dir: str, args: tuple) -> None:
    if backend == "nccl":
        # a collective captured in a CUDA graph has no event the watchdog
        # could poll
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    dist.init_process_group(backend, init_method=init, world_size=nprocs,
                            rank=rank)
    try:
        from ..serving import resolve_device

        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank)
        dev = resolve_device(dev)  # float32 convolutions, as the reference
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = fn(make_mesh([dev]), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, backend: Optional[str] = None,
           device: str = "cuda", args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` new ranks and return each
    rank's result (saved with ``torch.save``), rank 0's first.

    The ranks meet at a ``file://`` rendezvous in a temporary directory, so
    concurrent launches never collide on a port. ``device``: 'cuda' puts
    rank r on ``cuda:r``; a device with an index ('cuda:0') puts every rank
    there (several gloo ranks on one card); 'cpu' runs on the CPU.
    ``backend``: 'nccl' on cards, 'gloo' on the CPU (the default follows
    ``device``). ``fn`` must be importable by name: the ranks are spawned
    processes."""
    backend = backend or ("gloo" if torch.device(device).type == "cpu"
                          else "nccl")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, nprocs, backend, device, init, tmp, args),
            nprocs=nprocs, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
