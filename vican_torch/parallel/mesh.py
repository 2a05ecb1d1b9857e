"""The mesh of the sharded paths: one process per card, one
``torch.distributed`` process group over them.

The JAX package builds a ``jax.sharding.Mesh`` over the devices of one
controller (``vican_tpu/parallel/mesh.py``).  Here every rank is its own
process that drives one card (its ``LOCAL_RANK``), and a mesh is a 1-D
``DeviceMesh`` named ``"edges"`` over all ranks.  The sharded solvers split
the edge (time) axis over it and all-reduce the small camera-space partials;
perception splits its batches.  Launch with ``torchrun --nproc-per-node N``
(NCCL, a card per rank), or give every process its address, world size and
rank (gloo for ``device="cpu"``).
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from ..utils import resolve_device

EDGE_AXIS = "edges"

__all__ = ["make_mesh", "init_distributed", "global_mesh", "EDGE_AXIS"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> None:
    """Initialize the default process group: NCCL on the card
    (``device=None``), gloo for ``device="cpu"``.

    ``coordinator_address``: ``"host:port"`` or an init-method URL
    (``tcp://...``, ``file://...``); ``num_processes``, ``process_id``: the
    world size and this rank.  Arguments left out come from ``torchrun``'s
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); with none of those, a world of one on a free localhost port.
    On the card each rank takes the card of ``LOCAL_RANK`` (else its rank
    modulo the cards).  A second call is a no-op."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init_method = "env://"
        elif world == 1:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
        else:
            raise ValueError("init_distributed: no coordinator address for a world of "
                             f"{world} (pass one, or launch with torchrun)")
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            world_size=world, rank=rank)


def global_mesh(device=None):
    """1-D ``"edges"`` mesh over every rank of every host; initializes the
    process group first where no one has (:func:`init_distributed`)."""
    return make_mesh(device=device)


def make_mesh(n_devices: int | None = None, devices=None, device=None):
    """1-D ``DeviceMesh`` named ``"edges"`` over every rank, one card per
    rank (``device=None``) or the CPU (``device="cpu"``, gloo).

    ``n_devices``, or the length of ``devices``, must be the world size:
    each rank drives exactly one card, so a mesh over a subset of the ranks
    would leave ranks without work in every collective."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    init_distributed(device=dev)
    world = dist.get_world_size()
    want = len(devices) if devices is not None else n_devices
    if want is not None and want != world:
        raise ValueError(f"make_mesh: {want} devices asked for a world of {world} ranks "
                         "(one card per rank)")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(EDGE_AXIS,))
