"""Multi-process start-up and the serving mesh over torch.distributed.

Port of crisperwhisper_tpu/parallel/multihost.py. PyTorch runs one
process per card: torchrun (or the caller) starts N processes, each
calls ``init_multihost``, and the "model" axis of the serving mesh is
pinned inside one host, because its all-reduces fire in every layer. The
"data" axis spans the remaining ranks and hosts: windows are independent,
so steady-state serving sends only the gathered per-row results across it.

    # on every rank, e.g. under torchrun --nproc-per-node 2:
    init_multihost(autodetect=True)
    mesh = make_serving_mesh(model=2)           # TP within the host
    pipe = hub.load_pipeline(ckpt, mesh=mesh)   # each rank loads its slices
    if torch.distributed.get_rank() == 0:
        print(pipe(audio)["text"]); pipe.close()
    else:
        pipe.follow()                           # until rank 0 closes
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA, axis_sizes, make_mesh, mesh_device


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   local_device_ids: list[int] | None = None,
                   autodetect: bool = False,
                   backend: str = "nccl",
                   timeout: float | None = None) -> None:
    """Idempotent ``init_process_group`` wrapper (multihost.py:42-74).

    Does nothing in a one-process world (every argument None or absent):
    one-card serving needs no coordinator. ``autodetect=True`` reads the
    world from torchrun's environment (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK); the flag is required
    because an all-None call cannot tell a launcher's world from the
    one-process no-op. Otherwise pass the coordinator ("host:port"), the
    world size and this process's rank.

    local_device_ids: this rank's card is ``local_device_ids[0]``
      (default under autodetect: LOCAL_RANK), set with
      ``torch.cuda.set_device`` before the group starts.
    backend: "nccl" for the card; "gloo" must be asked for (CPU ranks, or
      two ranks sharing one card). The JAX signature has no such argument:
      jax.distributed has no backend to choose.
    timeout: seconds a collective may wait before it fails (torch's
      default when None)."""
    if dist.is_initialized():
        return
    if (not autodetect and coordinator_address is None
            and num_processes in (None, 1)):
        return                       # one process: nothing to do
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_multihost: NCCL needs a CUDA card; pass "
                           "backend=\"gloo\" for CPU ranks")
    if local_device_ids is None and autodetect \
            and "LOCAL_RANK" in os.environ:
        local_device_ids = [int(os.environ["LOCAL_RANK"])]
    if local_device_ids and torch.cuda.is_available():
        torch.cuda.set_device(local_device_ids[0])
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    if autodetect:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kw)


def _hosts() -> list:
    """The host of every rank. Under torchrun a node's ranks are
    contiguous, LOCAL_WORLD_SIZE of them; otherwise the ranks' host names
    are gathered."""
    world = dist.get_world_size()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local:
        return [r // int(local) for r in range(world)]
    names: list = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return names


def make_serving_mesh(model: int = 1, data: int | None = None,
                      device: torch.device | str | None = None):
    """("data", "model") mesh over every rank of the job with the model
    axis inside one host (multihost.py:77-121).

    model: the TP degree; it must divide the number of ranks on a host, so
    that a TP group never leaves its host. data: the data-parallel degree,
    every remaining rank by default (a smaller one would idle cards).
    device: as in ``make_mesh``."""
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh: no process group; call "
                           "init_multihost first")
    hosts = _hosts()
    order = sorted(range(len(hosts)), key=lambda r: (hosts[r], r))
    per_host = {h: hosts.count(h) for h in hosts}
    n_local = per_host[hosts[dist.get_rank()]]
    n_hosts = len(per_host)
    if model < 1 or n_local % model:
        raise ValueError(
            f"model axis {model} must divide the per-host device count "
            f"{n_local} (TP all-reduces must stay inside one host)")
    data_per_host = n_local // model
    full_data = data_per_host * n_hosts
    if data is None:
        data = full_data
    if data != full_data:
        raise ValueError(
            f"data axis {data} must equal per-host data ({data_per_host})"
            f" x hosts ({n_hosts}) = {full_data}; shrink the job instead "
            f"of idling devices")
    # host-major rank layout: each model row is `model` ranks of one host,
    # so its all-reduces never leave the host
    grid = np.array(order).reshape(data, model)
    for row in grid:
        owners = {hosts[r] for r in row}
        assert len(owners) == 1, f"model group spans hosts {owners}"
    return make_mesh(data, model, devices=grid.reshape(-1).tolist(),
                     device=device)


def process_local_batch(global_batch: int, mesh) -> int:
    """The rows of a data-sharded batch this rank feeds (multihost.py:
    124-131). The JAX function divides by the process count, since one JAX
    process feeds every device it drives. A torch rank drives one device,
    and the ranks of one model group feed the same data row, so the batch
    divides by the mesh's data axis; the mesh is therefore required."""
    n = axis_sizes(mesh)[DATA]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must be a "
                         f"multiple of the data axis {n}")
    return global_batch // n


def host_local_array(data, mesh):
    """The global data-sharded batch from each rank's rows
    (multihost.py:134-138): a DTensor whose local tensor is ``data`` on
    this rank's device, sharded over "data" and replicated over "model";
    its ``.shape`` is the global one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    local = torch.as_tensor(np.asarray(data)).to(mesh_device(mesh))
    return DTensor.from_local(local, mesh, [Shard(0), Replicate()],
                              run_check=False)
