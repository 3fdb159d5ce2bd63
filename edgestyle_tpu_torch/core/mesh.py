"""Process groups, the (data, model) device mesh, and rows over ranks.

Counterpart of edgestyle_tpu/core/mesh.py. The reference trains data
parallel only (DDP through Accelerate); the JAX package shards the batch
axis over a ``data`` mesh axis, replicates the params, and keeps a
``model`` axis for tensor parallelism (core/partitioning.py). Here the
devices are ``torch.distributed`` ranks, one process each, as ``torchrun``
starts them: :func:`init_distributed` joins the group from torchrun's
environment, :func:`make_mesh` lays the ranks out as a ``DeviceMesh``
(``init_device_mesh``, dims named ``data`` and ``model``, model fastest),
:func:`shard_batch` takes this rank's rows of a global batch and
:func:`gather_rows` puts the ranks' rows back together; every rank then
holds the global result. :func:`replicate_params` broadcasts a tree from
rank 0 of each data group.

Collectives are ``all_reduce`` and ``broadcast`` only: ``gloo`` carries
those two for CUDA tensors, so one code path serves ``nccl``, ``gloo`` on
the card and ``gloo`` on the CPU. Nothing falls back quietly: a missing
device, a missing environment variable or a failed rank raises.

:func:`run_ranks` starts ranks on one host, with the environment torchrun
would give them (the tests, ``entry.dryrun_multichip`` and chip_smoke use
it; on a host with several cards ``torchrun --nproc_per_node N`` does the
same for the apps).
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import socket
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


def world_size() -> int:
    """The ranks torchrun started (``WORLD_SIZE``, 1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device: DeviceLike = "cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device.

    ``device``: "cuda" means ``cuda:LOCAL_RANK``; a device with an index is
    taken as named (two ranks may share a card under ``gloo``); "cpu" runs
    on the CPU. ``backend``: default ``nccl`` for a card, ``gloo`` for the
    CPU. Without a card a CUDA device raises, as core/device.py does; so
    does an index beyond the cards there are. The group is formed once a
    process (a second call, say a second ``main`` in one rank, joins the
    same group) and destroyed at exit."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed needs torchrun's environment; missing "
                           f"{', '.join(missing)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: {dev} does not exist ({torch.cuda.device_count()} "
                               f"cards on this host)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized():
        if dist.get_backend() != backend or dist.get_world_size() != world:
            raise RuntimeError(f"a process group is already up ({dist.get_backend()}, "
                               f"{dist.get_world_size()} ranks), not {backend} x {world}")
        return dev
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    atexit.register(_destroy)
    return dev


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(spec: Optional[MeshSpec] = None, device: DeviceLike = "cuda"):
    """The (data, model) ``DeviceMesh`` of the group's ranks, row-major:
    rank r sits at data r // model, model r % model. Default: every rank
    on the data axis."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    spec = spec or MeshSpec(data=world, model=1)
    if spec.num_devices != world:
        raise ValueError(f"MeshSpec wants {spec.num_devices} devices, got {world}")
    return init_device_mesh(torch.device(device).type, (spec.data, spec.model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def rows(mesh, b: int) -> slice:
    """This rank's rows of a global batch of ``b``: its block of b / data
    rows, by its data coordinate."""
    nd = axis_size(mesh, DATA_AXIS)
    if b % nd:
        raise ValueError(f"global batch {b} is not divisible by the data axis size {nd} "
                         f"(each device takes B/{nd} rows)")
    i = axis_index(mesh, DATA_AXIS)
    return slice(i * b // nd, (i + 1) * b // nd)


def shard_batch(mesh, batch, axis: int = 0):
    """This rank's rows (:func:`rows`) of every tensor or array of a dict (or
    a single one) along ``axis``: 0 for (B, ...) inputs, 1 for the
    trainers' (grad_accum, micro_bs, ...) batches."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    sl = rows(mesh, batch.shape[axis])
    return batch[(slice(None),) * axis + (sl,)]


def gather_rows(mesh, local: torch.Tensor, b: int) -> torch.Tensor:
    """The global (b, ...) tensor from each rank's :func:`rows`: a zero
    buffer with this rank's rows written, all-reduced over the data group
    (x + 0 is exact, so the rows arrive bit for bit)."""
    out = local.new_zeros((b, *local.shape[1:]))
    out[rows(mesh, b)] = local
    dist.all_reduce(out, group=mesh.get_group(DATA_AXIS))
    return out


ALL_REDUCE_BYTES = [0]


def all_mean_grads(grads: Dict, losses: List[torch.Tensor], group):
    """The data-parallel step's one collective: the fp32 gradients (a flat
    dict) and the micro-batch losses, each averaged over ``group``'s ranks
    through one all-reduce of one flat buffer. Returns (grads, losses);
    ``ALL_REDUCE_BYTES`` counts the bytes reduced."""
    keys = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in keys] + [torch.stack(losses).float()])
    ALL_REDUCE_BYTES[0] += flat.numel() * flat.element_size()
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    parts = flat.split([grads[k].numel() for k in keys] + [len(losses)])
    return ({k: p.view_as(grads[k]) for k, p in zip(keys, parts)}, list(parts[-1].unbind()))


def replicate_params(mesh, params):
    """Broadcast every tensor of ``params`` (nested dicts) from rank 0 of
    this rank's data group, in place, so each rank holds rank 0's bits;
    returns ``params``."""
    group = mesh.get_group(DATA_AXIS)
    src = dist.get_global_rank(group, 0)

    def walk(node):
        for v in node.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                dist.broadcast(v, src=src, group=group)

    walk(params)
    return params


def is_rank0() -> bool:
    """True on rank 0, and in a process with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def on_rank0(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` on rank 0 alone while a group is up, the other
    ranks waiting at a barrier until it is done (a file written once);
    without a group, simply called. Returns its result on rank 0, None on
    the others."""
    out = fn(*args, **kwargs) if is_rank0() else None
    if dist.is_initialized():
        dist.barrier()
    return out


# ------------------------------------------------------------ one host
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, out_dir: str, threads: int,
               args) -> None:
    torch.set_num_threads(threads)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        result = fn(*args)
    finally:
        _destroy()
    torch.save(result, os.path.join(out_dir, f"{rank}.pt"))


def run_ranks(fn: Callable, world: int, args: Sequence = ()) -> list:
    """Run ``fn(*args)`` in ``world`` new processes on this host, one rank
    each, with torchrun's environment (``localhost``, a free port); the
    ranks' return values, in rank order (each goes through ``torch.save``).
    A rank that raises ends the others, and the error is raised here.
    ``fn`` must be importable by name (a module-level function). Each rank
    runs torch on its share of this process's threads."""
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="edgestyle_ranks_") as out_dir:
        mp.start_processes(_rank_main,
                           args=(fn, world, free_port(), out_dir, threads, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(world)]
