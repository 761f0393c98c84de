"""Multi-process initialisation on ``torch.distributed``: the counterpart
of the JAX package's ``parallel/distributed.py``.

The reference's communication backend is PCIe copies and pthread barriers
inside one process (SURVEY §2); it cannot leave one machine.  The port
scales past a process with a ``torch.distributed`` process group: every
process runs the same program, :func:`initialize` joins the group, and a
mesh built after it (:func:`global_mesh`) spans every process's devices.
The file operations then become collectives (``api._encode_file_multiprocess``
and its decode and repair twins), and the stripe mode's reduction becomes
one ``all_reduce`` per segment.

Configuration is torchrun's: ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (where the JAX package reads
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``),
or the arguments.  ``RS_DISTRIBUTED=auto`` initialises from the
environment as given (``init_method="env://"``).  With nothing configured
:func:`initialize` is a no-op, so the same entry scripts work everywhere.

Backend: NCCL when the job computes on CUDA and every process of the host
has a card of its own, gloo otherwise (:func:`._compat.choose_backend`).
NCCL refuses two ranks on one card, so ranks that share one exchange CUDA
tensors through gloo, which copies them through the host itself.  A failed
init raises; nothing retries with the other backend.

Every cross-process wait has a timeout: the group's (:data:`TIMEOUT_S`)
bounds every barrier and collective.
"""

from __future__ import annotations

import atexit
import datetime
import os

import numpy as np
import torch

from . import _compat


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


TIMEOUT_S = 300.0  # bounds every barrier and collective of the group


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return torch.distributed.get_rank() if _compat.distributed_is_initialized() else 0


def world_size() -> int:
    """Processes in the group (1 outside one)."""
    return torch.distributed.get_world_size() if _compat.distributed_is_initialized() else 1


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK``, else the rank (one host)."""
    v = _env_int("LOCAL_RANK")
    return rank() if v is None else v


def backend() -> str | None:
    return torch.distributed.get_backend() if _compat.distributed_is_initialized() else None


def initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
               auto: bool = False, device=None) -> None:
    """Join the job's process group (a no-op with nothing configured, and
    idempotent: the library and the CLI may both call it).

    Explicit configuration comes from the arguments or torchrun's variables;
    if any of ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` is present (or an
    argument is given) the group is initialised over
    ``tcp://MASTER_ADDR:MASTER_PORT`` (``init_method`` when given).
    ``auto=True`` or ``RS_DISTRIBUTED=auto`` initialises from the
    environment (``env://``).  ``device``: what the job computes on (None:
    CUDA), which picks the backend.
    """
    if _compat.distributed_is_initialized():
        _mark_telemetry_epoch()
        return
    auto = auto or os.environ.get("RS_DISTRIBUTED") == "auto"
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    addr = os.environ.get("MASTER_ADDR")
    if not auto and init_method is None and world_size is None and rank is None and addr is None:
        return  # single process, nothing configured
    if not _compat.distributed_available():
        raise RuntimeError("torch.distributed is not available in this build")
    if init_method is None:
        if auto:
            init_method = "env://"
        else:
            port = os.environ.get("MASTER_PORT")
            if addr is None or port is None:
                raise ValueError("multi-process init needs MASTER_ADDR and MASTER_PORT (or init_method)")
            init_method = f"tcp://{addr}:{port}"
    if not auto and (world_size is None or rank is None):
        raise ValueError("multi-process init needs WORLD_SIZE and RANK (or the arguments)")
    dev_type = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    ws = world_size if world_size is not None else _env_int("WORLD_SIZE") or 1
    chosen = _compat.choose_backend(dev_type, ws)
    if chosen == "nccl":
        lr = _env_int("LOCAL_RANK")
        torch.cuda.set_device((lr if lr is not None else rank or 0) % torch.cuda.device_count())
    torch.distributed.init_process_group(
        chosen, init_method=init_method, world_size=world_size if world_size is not None else -1,
        rank=rank if rank is not None else -1,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # The group is torn down before the interpreter's own teardown: left to
    # it, the backend's threads can outlive their owner and abort the
    # process ("terminate called without an active exception") after the
    # work is done.
    atexit.register(_destroy)
    barrier("rs_init")
    _mark_telemetry_epoch()


def _destroy() -> None:
    if _compat.distributed_is_initialized():
        torch.distributed.destroy_process_group()


def _mark_telemetry_epoch() -> None:
    """The shared trace-alignment epoch (obs/aggregate.py): the init
    barrier is crossed by every process at nearly the same time, so the
    wall clock right after it is the common anchor that lets per-process
    traces fuse onto one axis.  Marked once (the earliest anchor stays)."""
    from ..obs import tracing

    if tracing._EPOCH is None:
        tracing.mark_epoch(process_index=rank())


def global_mesh(stripe: int = 1, device=None):
    """Mesh over every device of the (possibly multi-process) job."""
    from .mesh import make_mesh

    return make_mesh(stripe=stripe, device=device)


# -- the collectives the file operations use ---------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A small tensor where the backend takes it: NCCL moves CUDA tensors
    only."""
    if backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def barrier(name: str) -> None:
    """A named barrier of every process of the group (bounded by the
    group's timeout).  ``name`` is the JAX package's
    ``sync_global_devices`` name, for the reader."""
    if world_size() <= 1:
        return
    if backend() == "nccl":
        torch.distributed.barrier(device_ids=[torch.cuda.current_device()])
    else:
        torch.distributed.barrier()


def broadcast(arr: np.ndarray, src: int) -> np.ndarray:
    """``arr`` from process ``src`` to every process (an int array of the
    same shape everywhere)."""
    if world_size() <= 1:
        return arr
    t = _wire(torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)))
    torch.distributed.broadcast(t, src)
    return t.cpu().numpy().astype(arr.dtype)


def all_ok(err: BaseException | None, what: str) -> None:
    """The all-ok exchange before a barrier: every process says whether
    its part of ``what`` failed; if any did, every process raises (the one
    that failed its own error, the others a RuntimeError naming it)
    instead of waiting at the next barrier for a peer that will not come."""
    if world_size() <= 1:
        if err is not None:
            raise err
        return
    flags = _wire(torch.zeros(world_size(), dtype=torch.int64))
    flags[rank()] = 1 if err is not None else 0
    torch.distributed.all_reduce(flags)
    failed = [int(i) for i in torch.nonzero(flags.cpu()).flatten()]
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"{what} failed on process(es) {failed}; see their logs for the cause")
