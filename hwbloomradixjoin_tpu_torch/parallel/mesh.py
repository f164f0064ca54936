"""Process groups: the port's device mesh.

Counterpart of ``hwbloomradixjoin_tpu/parallel/mesh.py``.  The JAX package
builds one mesh axis over every device of every host; here each device is
one process of a ``torch.distributed`` group, and a mesh of n devices is the
group of the first n ranks.  NCCL carries the collectives between cards and
gloo between CPU processes; gloo also takes CUDA tensors, which lets several
processes share one card.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def backend_of(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init(backend: str, address: str, world_size: int, rank: int,
          device) -> None:
    kw = {}
    device = torch.device(device)
    if backend == "nccl":
        # one process a card: bind the communicator to this process's card
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank, **kw)


def init_distributed(device="cuda", backend: str | None = None) -> bool:
    """Join the world a launcher describes in the environment.

    HBRJ_COORDINATOR (host:port of rank 0), HBRJ_NUM_PROCS (the world's
    size) and HBRJ_PROC_ID (this process's rank), as the JAX package's
    init_distributed reads them.  backend: NCCL for a CUDA device and gloo
    for the CPU unless named.  Returns True if it initialized a group;
    without the environment it does nothing and returns False.
    """
    coord = os.environ.get("HBRJ_COORDINATOR")
    if not coord:
        return False
    _init(backend or backend_of(device), coord,
          int(os.environ["HBRJ_NUM_PROCS"]), int(os.environ["HBRJ_PROC_ID"]),
          device)
    return True


def free_address() -> str:
    """host:port of a free local port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def make_mesh(n_devices: int | None = None, device="cuda"):
    """The process group of the first n_devices ranks (all of them if None).

    With no group initialized, a mesh of one device starts a world of one
    on this process (NCCL on the card, gloo on the CPU); a larger one
    raises, as the JAX make_mesh does when it lacks devices: several ranks
    come only from a launcher (multiproc.py).  Every rank of the world must
    call this; a rank outside the first n gets dist.GroupMember.NON_GROUP_MEMBER.
    """
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"need {n_devices} devices, have 1")
        _init(backend_of(device), free_address(), 1, 0, device)
    have = dist.get_world_size()
    if n_devices is None or n_devices == have:
        return dist.group.WORLD
    if have < n_devices:
        raise ValueError(f"need {n_devices} devices, have {have}")
    return dist.new_group(list(range(n_devices)))


def in_mesh(group) -> bool:
    """Whether this process is a rank of the group."""
    return group != dist.GroupMember.NON_GROUP_MEMBER
