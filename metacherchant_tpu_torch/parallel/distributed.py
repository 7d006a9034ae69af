"""Multi-process initialisation and input sharding, on torch.distributed.

Counterpart of metacherchant_tpu/parallel/distributed.py. One process per
device: rank r of the group owns one table shard (parallel/sharded_count.py)
and reads the input files r, r + n, ... The group's backend follows the
device, nccl for cuda and gloo for cpu, and is never switched quietly.

MC_COORDINATOR (host:port of rank 0's store), MC_NUM_PROCESSES and
MC_PROCESS_ID are the variables the JAX package reads. Without a
coordinator the process forms a group of world size 1 on a free local port,
so the collectives still run (the counterpart of JAX's mesh of the local
devices).
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_device(device: torch.device) -> torch.device:
    """This rank's device: cuda:(rank mod device count) for cuda, else
    `device` itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device: torch.device) -> None:
    """Join (or form) the default process group for `device`; a group that
    exists already is reused, and must have the backend `device` needs.
    Raises when the group cannot be formed."""
    device = torch.device(device)
    backend = _backend(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group exists; device "
                f"{device} needs {backend}")
        return
    coordinator = coordinator or os.environ.get("MC_COORDINATOR")
    if coordinator is None:
        coordinator, world, rank = f"127.0.0.1:{_free_port()}", 1, 0
    else:
        world = num_processes or int(os.environ.get("MC_NUM_PROCESSES", "1"))
        rank = (process_id if process_id is not None
                else int(os.environ.get("MC_PROCESS_ID", "0")))
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)


def shard_files_for_host(files: list[str]) -> list[str]:
    """Disjoint per-rank file assignment, round-robin by rank (every k-mer
    is still counted once: each rank inserts only its own files' keys and
    the shards' merge is a commutative sum)."""
    rank, n = dist.get_rank(), dist.get_world_size()
    return [f for i, f in enumerate(files) if i % n == rank]


def global_mesh() -> tuple[dist.ProcessGroup, int]:
    """The default group and its size (JAX's global 1-D mesh)."""
    return dist.group.WORLD, dist.get_world_size()
