"""Process groups and device meshes for sharded runs, on ``torch.distributed``.

The receiver's mesh has two named dimensions (``config.time_axis``,
``config.channel_axis``), those of softgnss_tpu.parallel.mesh:

* ``'time'`` partitions the capture into contiguous blocks,
* ``'channel'`` partitions tracking channels and acquisition PRNs.

The JAX package drives a mesh of local devices from one process
(``shard_map``).  Here every rank is a process (``torchrun``, or
:func:`spawn_world`) that calls the same entry point with the same
arguments and gets the whole result back: each rank computes its shard on
its own device, and the results are gathered.

The collectives run on **gloo** over host tensors, and they only gather
results: what is exchanged is exactly what the JAX code reads back to the
host anyway.  gloo and not NCCL because NCCL does not allow two ranks of
one communicator on the same GPU, so on a machine with one card a
multi-rank world could not run on NCCL at all.  A rank's compute device is
its own (:func:`initialize_distributed`); two ranks on one card is then
the same code path as two cards.

A rank that fails must not leave the others waiting in a collective:
:func:`run_together` runs one rank's share and raises on every rank when
any of them failed.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from softgnss_tpu_torch.config import ReceiverConfig
from softgnss_tpu_torch.device import resolve


def _rank_device(device, local_rank: int) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve("cuda")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_rank: int | None = None, device=None) -> torch.device:
    """Join this process's gloo process group and pick its compute device.

    The arguments default to torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``);
    ``coordinator_address`` is ``host:port``.  With neither and a world
    size of 1, a one-process group starts in the process, so a ``1x1`` mesh
    needs no launcher.  In a process whose group exists already it only
    picks the device.

    ``device="cpu"`` keeps the rank's work on the host; otherwise the rank
    runs on card ``local_rank % torch.cuda.device_count()``, made current
    (raising without a card).  Returns the device."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if process_id is None else int(process_id)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    if dist.is_initialized():
        return dev
    world = int(env.get("WORLD_SIZE", 1)) if num_processes is None else int(num_processes)
    if coordinator_address is not None:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank)
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        dist.init_process_group("gloo", init_method="env://", world_size=world, rank=rank)
    elif world == 1:
        dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    else:
        raise ValueError(f"a world of {world} processes needs coordinator_address= or "
                         "MASTER_ADDR / MASTER_PORT (torchrun sets them)")
    return dev


def make_mesh(axis_sizes: dict[str, int]):
    """A DeviceMesh with the ``{dimension name: size}`` layout over the
    world's ranks (gloo, host tensors; each rank computes on its own
    device).  Raises when the sizes' product is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() first")
    shape = tuple(int(v) for v in axis_sizes.values())
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n} ranks, but the world size "
                         f"is {world}")
    return init_device_mesh("cpu", shape, mesh_dim_names=tuple(axis_sizes))


def receiver_mesh(config: ReceiverConfig, n_time: int = 1, n_channel: int | None = None):
    """The receiver's (time, channel) mesh over the world's ranks;
    ``n_channel`` defaults to the ranks left after the time dimension."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() first")
    total = dist.get_world_size()
    if n_channel is None:
        if total % n_time:
            raise ValueError(f"{total} ranks not divisible by n_time={n_time}")
        n_channel = total // n_time
    return make_mesh({config.time_axis: n_time, config.channel_axis: n_channel})


class MeshPosition(NamedTuple):
    """This rank's place on the receiver's mesh: its index and the size of
    the time and the channel dimension (a dimension the mesh lacks has size
    1), and each dimension's group (None where it has one rank)."""

    t: int
    n_t: int
    c: int
    n_c: int
    time_group: object
    channel_group: object


def mesh_position(config: ReceiverConfig, mesh) -> MeshPosition:
    """This rank's :class:`MeshPosition`, by ``config.time_axis`` and
    ``config.channel_axis``."""
    names = mesh.mesh_dim_names or ()

    def dim(name):
        if name not in names or mesh.size(names.index(name)) == 1:
            return 0, 1, None
        return mesh.get_local_rank(name), mesh.size(names.index(name)), mesh.get_group(name)

    t, n_t, tg = dim(config.time_axis)
    c, n_c, cg = dim(config.channel_axis)
    return MeshPosition(t, n_t, c, n_c, tg, cg)


def rank_grid(config: ReceiverConfig, mesh) -> np.ndarray:
    """(n_t, n_c) global ranks of the mesh, time index by channel index."""
    names = list(mesh.mesh_dim_names or ())
    grid = mesh.mesh.numpy()
    order = [names.index(a) for a in (config.time_axis, config.channel_axis) if a in names]
    grid = grid.transpose(order + [i for i in range(grid.ndim) if i not in order])
    pos = mesh_position(config, mesh)
    return grid.reshape(pos.n_t, pos.n_c)


def run_together(fn, group=None):
    """``fn()`` on this rank, returning ``(value, count)``; then one MAX
    all_reduce over ``group`` (the world by default) of (failed rank + 1,
    ``count``).  An exception on any rank raises on every rank — the
    failing rank's own, a RuntimeError naming it elsewhere — where the
    others would otherwise wait in the next collective for ever.  Returns
    ``(value, largest count over the group)``, so that a data-dependent
    check on it (a frame overflow) raises on every rank too."""
    try:
        value, count = fn()
        err = None
    except Exception as exc:        # re-raised below, once every rank knows
        value, count, err = None, 0, exc
    flag = torch.tensor([0 if err is None else dist.get_rank() + 1, int(count)],
                        dtype=torch.int64)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if err is not None:
        raise err
    if flag[0]:
        raise RuntimeError(f"rank {int(flag[0]) - 1} failed; its error is in its own output")
    return value, int(flag[1])


def all_gather_host(tensors: list[torch.Tensor], group=None) -> list[list[torch.Tensor]]:
    """Every rank's ``tensors`` (the same shapes and dtypes on every rank),
    on every rank of ``group``: host copies packed as bytes into one gloo
    ``all_gather``.  Returns one list of CPU tensors per group rank, in
    group-rank order."""
    host = [t.detach().cpu().contiguous() for t in tensors]
    buf = torch.cat([t.reshape(-1).view(torch.uint8) for t in host])
    outs = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, buf, group=group)
    sizes = [t.numel() * t.element_size() for t in host]
    return [[piece.clone().view(t.dtype).reshape(t.shape)
             for piece, t in zip(out.split(sizes), host)] for out in outs]


def _world_main(rank: int, world_size: int, address: str, device, fn, args) -> None:
    torch.set_num_threads(1)
    initialize_distributed(address, world_size, rank, local_rank=rank, device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world_size: int, args: tuple = (), device=None, timeout: float = 600.0):
    """Run ``fn(*args)`` in ``world_size`` new processes, one rank each, on
    this host: a gloo world on a free localhost port, each rank computing on
    ``device`` (``"cpu"``, or its card as :func:`initialize_distributed`
    picks it) with one intra-op thread.  ``fn`` must be importable (a
    module-level function).  Raises when a rank fails, and kills the world
    and raises TimeoutError when it has not ended within ``timeout``
    seconds."""
    import socket
    import time

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    ctx = mp.start_processes(_world_main, args=(world_size, address, device, fn, args),
                             nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"a world of {world_size} ranks did not end in "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
