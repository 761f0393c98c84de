"""What the collective layer of this PyTorch build offers: the questions
the JAX package's ``parallel/_compat.py`` answers, asked of
``torch.distributed``.

There is no ``shard_map`` to resolve: a mesh dispatch here is a loop over
the shards this process holds (:mod:`.sharded`), and the only collective
it needs is one ``all_reduce`` per stripe-mode segment across processes.
What is left to ask is whether a collective backend is there (NCCL for
processes that each own a card, gloo for the CPU and for ranks that share
one), whether this process already joined a process group, and which
backend a job of a given shape takes (:func:`choose_backend`).
"""

from __future__ import annotations

import os

import torch


def distributed_available() -> bool:
    """Whether this build has ``torch.distributed`` at all."""
    return torch.distributed.is_available()


def nccl_available() -> bool:
    """Whether the NCCL backend is built in (CUDA builds only)."""
    return distributed_available() and torch.distributed.is_nccl_available()


def gloo_available() -> bool:
    """Whether the gloo backend is built in (CPU processes, and CUDA
    tensors through the host)."""
    return distributed_available() and torch.distributed.is_gloo_available()


def distributed_is_initialized() -> bool:
    """Whether this process has joined a process group."""
    return distributed_available() and torch.distributed.is_initialized()


def local_world_size(world_size: int) -> int:
    """Processes of the job on this host: torchrun's ``LOCAL_WORLD_SIZE``,
    else the whole job (one host)."""
    try:
        return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    except ValueError:
        return world_size


def choose_backend(device_type: str, world_size: int) -> str:
    """The backend a job of ``world_size`` processes on ``device_type``
    takes: NCCL when the job computes on CUDA and every process of this
    host has a card of its own, gloo otherwise (CPU processes, the gloo
    CPU collectives of the JAX package's ``enable_cpu_collectives``, and
    ranks that share one card, which NCCL refuses).  The choice is made up
    front: a failed init raises, it never falls to the other backend."""
    if device_type == "cuda" and torch.cuda.is_available():
        if local_world_size(world_size) <= torch.cuda.device_count():
            return "nccl"
    return "gloo"
