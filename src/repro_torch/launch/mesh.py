"""The data-parallel process group: the port's counterpart of the
reference's mesh ``"data"`` axis (its ``"model"`` axis has size 1 here:
tensor parallelism is not ported, ROADMAP queue 1, item 6; the ``"pod"``
axis waits for multi-node, item 13).

NCCL on the card, a world of one included, with gloo beside it for CPU
tensors (backend ``"cpu:gloo,cuda:nccl"``: each collective goes to the
backend of its tensors' device, so one process can run a step on the
card and its CPU twin); gloo alone on the CPU. Nothing on
the machine tells a program of a cluster, so the caller gives the
rendezvous address (``tcp://localhost:<port>``), the world size and the
rank; :func:`free_port` finds a port on this host.
"""
from __future__ import annotations

import contextlib
import socket
from typing import Iterator, Optional

import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device) -> str:
    return ("cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda"
            else "gloo")


def init_data_parallel(device, *, rank: int = 0, world_size: int = 1,
                       init_method: Optional[str] = None) -> bool:
    """Join (or create) the default process group for ``device``'s
    backend. Returns True when this call created it (the caller then
    tears it down), False when one was already initialized."""
    if dist.is_initialized():
        need = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if need not in dist.get_backend():
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"initialized; {device} needs {need}")
        return False
    if world_size > 1 and init_method is None:
        raise ValueError("a world of several ranks needs their common "
                         "init_method (tcp://localhost:<port>)")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(dev),
        init_method=init_method or f"tcp://localhost:{free_port()}",
        world_size=world_size, rank=rank)
    return True


def teardown_data_parallel():
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def data_parallel(device, *, rank: int = 0, world_size: int = 1,
                  init_method: Optional[str] = None) -> Iterator[object]:
    """Context with the default process group up; yields it
    (``dist.group.WORLD``) and tears it down on exit if it created it."""
    created = init_data_parallel(device, rank=rank, world_size=world_size,
                                 init_method=init_method)
    try:
        yield dist.group.WORLD
    finally:
        if created:
            teardown_data_parallel()
