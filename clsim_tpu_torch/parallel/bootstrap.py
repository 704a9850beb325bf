"""Multi-process bootstrap (PyTorch counterpart of
clsim_tpu.parallel.bootstrap): one process per rank replaces the
reference's ZMQ client/server stack (private/clsim/I3CLSimServer.cxx:81-370).

Every rank runs the same program.  `initialize_distributed` joins the
processes into one torch.distributed process group, `global_photon_mesh`
gives this process's place in it (parallel/mesh.PhotonMesh), and
`process_step_slice` the slot range this process feeds.  Histograms,
counters and fit gradients then combine by all_reduce: there is no
message-routing layer and no batching handshake.

    torchrun --nproc-per-node 4 my_sim.py        # one process per GPU
    # in my_sim.py:
    initialize_distributed()                     # reads torchrun's variables
    sim = Simulation(medium, geometry, config, mesh=global_photon_mesh())

Without a launcher, pass the rendezvous explicitly:
initialize_distributed("tcp://10.0.0.1:29500", world_size=2, rank=0).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import PhotonMesh, local_rank, make_mesh


def _launcher_env():
    """(world_size, rank, local_world_size) from torchrun's RANK /
    WORLD_SIZE / LOCAL_WORLD_SIZE or Open MPI's OMPI_COMM_WORLD_*, or None
    outside a launcher.  Both rendezvous through MASTER_ADDR / MASTER_PORT
    (env://)."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        ws = int(env["WORLD_SIZE"])
        return ws, int(env["RANK"]), int(env.get("LOCAL_WORLD_SIZE", ws))
    if "OMPI_COMM_WORLD_SIZE" in env:
        ws = int(env["OMPI_COMM_WORLD_SIZE"])
        return (ws, int(env["OMPI_COMM_WORLD_RANK"]),
                int(env.get("OMPI_COMM_WORLD_LOCAL_SIZE", ws)))
    return None


def default_backend(local_world_size: int) -> str:
    """"nccl" when every rank on this host has a CUDA device of its own
    (local_world_size <= the visible device count), else "gloo" (CPU
    ranks, or several ranks sharing one card, which NCCL refuses; gloo's
    all_reduce takes CUDA tensors too)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if 0 < local_world_size <= n else "gloo"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join this process to the default torch.distributed process group.

    With `init_method` (e.g. "tcp://host:port") the explicit arguments are
    used, world_size and rank included; without it a launcher's environment
    is read (torchrun's RANK / WORLD_SIZE / MASTER_ADDR, or Open MPI's
    OMPI_COMM_WORLD_* with MASTER_ADDR / MASTER_PORT set).  Returns True
    when a process group is up (already, or now), False when there is no
    launcher and no explicit rendezvous: a harmless no-op, so the same
    script runs alone and under a launcher.

    `backend` defaults to default_backend(): "nccl" when each rank of this
    host has its own CUDA device, "gloo" otherwise.  With NCCL the current
    CUDA device is set to the rank's (parallel/mesh.local_rank)."""
    if dist.is_initialized():
        return True
    if init_method is not None:
        if world_size is None or rank is None:
            raise ValueError("an explicit init_method needs world_size and "
                             "rank")
        local_size = world_size
    else:
        found = _launcher_env()
        if found is None:
            return False
        world_size, rank, local_size = found
        init_method = "env://"
    backend = backend or default_backend(local_size)
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return True


def global_photon_mesh(device=None) -> PhotonMesh:
    """The photon mesh over every rank of the default process group (call
    after initialize_distributed; a one-rank mesh without one).  `device`
    defaults to this rank's CUDA device."""
    return make_mesh(device=device)


def process_step_slice(n_total_slots: int) -> slice:
    """The slot range this process feeds of a globally slot-assigned step
    batch (each process materializes only its own shard)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if n_total_slots % n_proc:
        raise ValueError(f"{n_total_slots} slots not divisible by "
                         f"{n_proc} processes")
    per = n_total_slots // n_proc
    i = dist.get_rank() if dist.is_initialized() else 0
    return slice(i * per, (i + 1) * per)
